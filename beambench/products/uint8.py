"""``uint8``: the kernel's 8-bit beam powers at the sink's scales,
``[F', T', B]`` as the detect call returns them, and those scales.

- ``power_err``: over every sample of the block, how far the count lies
  outside the half count of rounding around the reference's scaled power
  ``r`` (clipped to [0, 255]), relative to ``max(r, 1)``: the
  configuration's power bar, carried through the 8-bit rounding;
- ``scale_err``: the largest relative gap between the program's 8-bit
  scales, which its sink set from its own powers of block 0, and the
  reference's.  A gain in all the program's powers leaves the counts as
  they were (the scales take it back) and shows here alone.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NUMBERS = ("power_err", "scale_err")


def _power_err(counts: torch.Tensor, power: torch.Tensor,
               scales: torch.Tensor) -> float:
    r = (power * scales).clamp(0.0, 255.0)
    gap = ((counts.to(torch.float64) - r).abs() - 0.5).clamp_min(0.0)
    return float((gap / r.clamp_min(1.0)).max())


def counts_err(ctx, ref, counts: Optional[torch.Tensor]) -> dict:
    """The numbers of one block's ``[F', T', B]`` counts on the check's
    device (None where the program returned none)."""
    out = {"power_err": math.inf, "scale_err": math.inf}
    if counts is not None:
        out["power_err"] = _power_err(counts, ref.power, ctx.scales)
    if ctx.outcome.scales is not None:
        got = torch.as_tensor(ctx.outcome.scales, dtype=torch.float64,
                              device=ctx.device)
        out["scale_err"] = float(((got - ctx.scales).abs() / ctx.scales).max())
    return out


def compare(ctx, ref, got) -> dict:
    return counts_err(ctx, ref, None if got is None
                      else torch.from_numpy(got).to(ctx.device))
