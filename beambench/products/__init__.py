"""Products of the deployed loop: ``products/<name>.py`` holds what the
harness does with each product a traffic mix names in ``products``, found
by that name as kinds and metric readers are.

Each module holds

- ``NUMBERS``: the names of the numbers it returns, each held to the limit
  of that name in the configuration's ``checks``;
- ``compare(ctx, ref, got) -> {name: value}``: its numbers for one sampled
  block, from the reference's products of that block's content (``ref``,
  ``check.Reference``: ``power``, ``inco``, ``sk``, float64 on the check's
  device) and the data the program returned for it (``got``, None where it
  returned none).  ``ctx`` (``check.Context``) is the run's: the
  configuration, the seed, the outcome, the device, whether this is the
  control, and the reference's 8-bit scales.  The check keeps each
  number's largest over the blocks;

and, for a product that a kind does not build itself,

- ``attach(run, cfg, bf, keep, tracer)``: called by the ring kind once the
  ``StreamingBeamformer`` ``bf`` is built and before its warm-up; hooks the
  product onto the loop (a monitor, a sink) and returns an object whose
  ``kept`` maps each ``seq`` of ``keep`` that it saw to the data the check
  is given for that block.
"""

from __future__ import annotations

import importlib

import torch


def module(name: str):
    """The module of product ``name``."""
    return importlib.import_module(f"beambench.products.{name}")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap of ``got`` from ``want``, relative to
    ``max(|want|, 1)``."""
    gap = (got.to(torch.float64) - want).abs()
    return float((gap / want.abs().clamp_min(1.0)).max())
