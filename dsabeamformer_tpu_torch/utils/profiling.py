"""Profiler integration: ``torch.profiler`` traces of the port's block step.

A trace is written as a Chrome-trace ``.trace.json.gz`` (viewable in
Perfetto or ``chrome://tracing``) and summarized per op: the measured
stage breakdown (the detect kernel against layout copies and host calls)
and, on a card, the device's busy time over the traced window.  On a card
the profiler records CUDA activity (CUPTI) as well as the host's; on the
CPU only the host's.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["trace", "annotate", "summarize_trace", "trace_events",
           "profile_block_step", "DEFAULT_LOG_DIR"]

#: Where ``trace`` writes when the caller names no directory.
DEFAULT_LOG_DIR = os.path.join(tempfile.gettempdir(), "dsabf-trace")


@contextlib.contextmanager
def trace(log_dir: str | Path = DEFAULT_LOG_DIR, device="cpu"):
    """Context manager: capture a trace around the enclosed block and write
    it to ``log_dir`` as ``<pid>.<ns>.trace.json.gz``.  ``device`` of type
    ``cuda`` adds the card's activity (kernels, copies) to the host's.
    Yields ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield str(log_dir)
    finally:
        prof.stop()
        prof.export_chrome_trace(
            str(log_dir / f"{os.getpid()}.{time.time_ns()}.trace.json.gz"))


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


def trace_events(log_dir: str | Path) -> list:
    """The complete (``"ph": "X"``) events of the newest
    ``*.trace.json.gz`` under ``log_dir``."""
    traces = sorted(Path(log_dir).glob("**/*.trace.json.gz"),
                    key=lambda p: p.stat().st_mtime)
    if not traces:
        raise FileNotFoundError(f"no .trace.json.gz under {log_dir}")
    with gzip.open(traces[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X"]


def summarize_trace(log_dir: str | Path, top: int = 12) -> list[dict]:
    """Aggregate per-op durations from the newest captured trace: the
    ``top`` names by total duration as ``{"name", "count", "total_ms"}``
    dicts."""
    agg: dict = {}
    for e in trace_events(log_dir):
        rec = agg.setdefault(e.get("name", "?"), [0, 0.0])
        rec[0] += 1
        rec[1] += float(e.get("dur", 0)) / 1e3  # us -> ms
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
    return [
        {"name": n, "count": c, "total_ms": round(ms, 3)}
        for n, (c, ms) in rows
    ]


def profile_block_step(cfg, n_blocks: int = 3,
                       log_dir: str | Path = DEFAULT_LOG_DIR,
                       device="cuda") -> list[dict]:
    """Trace ``n_blocks`` fused block steps (``beamform_power`` of one
    random block, each under ``annotate("beamform_power")``) on ``device``
    and return the per-op duration summary (the `trace` command).  The
    weights are made and one step runs before the trace starts.  On a card
    a trace that holds no kernel raises: the summary would be the host's
    alone."""
    from dsabeamformer_tpu_torch.ingest.generator import make_random_bytes_block
    from dsabeamformer_tpu_torch.models.weights import make_weights
    from dsabeamformer_tpu_torch.ops.gemm import beamform_power
    from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
    from dsabeamformer_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    qw = prepare_weights(cfg, make_weights(cfg, device=dev))
    wire = torch.from_numpy(make_random_bytes_block(cfg, seed=0)).to(dev)
    beamform_power(wire, qw, cfg).sum().item()  # build + warm up untraced
    with trace(log_dir, dev) as d:
        for _ in range(n_blocks):
            with annotate("beamform_power"):
                out = beamform_power(wire, qw, cfg)
        out.sum().item()
    if dev.type == "cuda" and not any(e.get("cat") == "kernel"
                                      for e in trace_events(d)):
        raise RuntimeError(
            f"the trace under {d} holds no CUDA kernel event (is CUPTI "
            f"available to torch.profiler?)")
    return summarize_trace(d)
