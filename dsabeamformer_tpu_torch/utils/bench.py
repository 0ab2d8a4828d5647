"""Single-device benchmarks: the north-star measurement (the realtime
factor against the DSA-10 stream rate, and voltage GB/s).

The counterpart of ``dsabeamformer_tpu/utils/bench.py``.  Two modes:

- ``stream``: end-to-end host-to-device ingest through the streaming
  loop (``run_stream`` from a ``SyntheticSource``): what the observatory
  would sustain, the host's staging and copies included.
- ``kernel``: the device-resident loop: ``n_distinct`` blocks resident on
  the device, ``n_blocks`` back-to-back ``beamform_power`` launches, one a
  block (the production streaming shape), wall time over ``n_blocks``,
  best of ``repeats``.  Each timed loop ends with
  ``torch.cuda.synchronize()`` on a card, so the interval closes when the
  last launch has run.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.ingest.generator import make_random_bytes_block
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops.gemm import beamform_power, device_wire_view
from dsabeamformer_tpu_torch.ops.quantize import quantize_weights
from dsabeamformer_tpu_torch.pipeline import SyntheticSource, run_stream
from dsabeamformer_tpu_torch.utils.device import resolve_device
from dsabeamformer_tpu_torch.utils.metrics import (LOOP_KEYS,
                                                tensor_core_utilization)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _weights(cfg: ObsConfig, dev: torch.device):
    return quantize_weights(make_weights(cfg, device=dev), cfg.weight_mode,
                            cfg.a_compute)


def _blocks(cfg: ObsConfig, n: int) -> list:
    """``make_random_bytes_block`` of seeds ``0 .. n-1``, made on two
    threads (NumPy's generator runs without the GIL): the same bytes."""
    with ThreadPoolExecutor(max_workers=2) as maker:
        return list(maker.map(lambda s: make_random_bytes_block(cfg, seed=s),
                              range(n)))


def bench_kernel(cfg: ObsConfig, n_blocks: int = 16, n_distinct: int = 2,
                 repeats: int = 3, device="cuda") -> dict:
    """The device-resident record of ``cfg`` on ``device`` (the card unless
    the caller names another)."""
    dev = resolve_device(device)
    qw = _weights(cfg, dev)
    blocks = [torch.from_numpy(device_wire_view(b, cfg)).to(dev)
              for b in _blocks(cfg, n_distinct)]
    beamform_power(blocks[0], qw, cfg)  # build + warm
    _sync(dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for i in range(n_blocks):
            beamform_power(blocks[i % n_distinct], qw, cfg)
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / n_blocks)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    util = tensor_core_utilization(cfg.macs_per_block * cfg.n_weight_terms,
                                   best, cfg, kind)
    return {
        "mode": "kernel",
        "config": cfg.name,
        "ms_per_block": best * 1e3,
        "gb_per_s": cfg.wire_block_bytes / best / 1e9,
        "realtime_factor": cfg.block_duration_s / best,
        "tc_utilization_issued": None if util is None else util["issued"],
        "tc_utilization_padded_k": None if util is None else util["padded_k"],
    }


def bench_stream(cfg: ObsConfig, n_blocks: int = 16, n_distinct: int = 4,
                 depth: int = 4, device="cuda") -> dict:
    """The streamed record of ``cfg`` on ``device``: ``StreamStats.record``
    with the mode and ms/block added."""
    dev = resolve_device(device)
    qw = _weights(cfg, dev)
    blocks = _blocks(cfg, n_distinct)
    # Warm-up run: builds the kernel and primes the transfers.
    run_stream(cfg, qw, SyntheticSource(cfg, blocks, n_blocks=2), depth=depth)
    src = SyntheticSource(cfg, blocks, n_blocks=n_blocks)
    stats = run_stream(cfg, qw, src, depth=depth)
    # The JAX package's bench record: the loop's own counters left out.
    rec = {k: v for k, v in stats.record(cfg).items() if k not in LOOP_KEYS}
    rec["mode"] = "stream"
    rec["ms_per_block"] = stats.wall_s / max(stats.n_blocks, 1) * 1e3
    return rec


def run_benchmark(cfg: ObsConfig, n_blocks: int = 16, mode: str = "stream",
                  device="cuda") -> dict:
    if mode == "kernel":
        return bench_kernel(cfg, n_blocks=n_blocks, device=device)
    return bench_stream(cfg, n_blocks=n_blocks, device=device)
