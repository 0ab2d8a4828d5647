"""Profiler integration: ``torch.profiler`` traces of the port's block step.

A trace is written as a Chrome-trace ``.trace.json.gz`` (viewable in
Perfetto or ``chrome://tracing``) and summarized per op: the measured
stage breakdown (the detect kernel against layout copies and host calls)
and, on a card, the device's busy time over the traced window.  On a card
the profiler records CUDA activity (CUPTI) as well as the host's; on the
CPU only the host's.

The streaming loop marks its stages with ``annotate`` (``dsabf.<layer>.<what>``
spans) and each block's spans with ``mark_block``: both are a check of the
profiler's own flag unless a trace is recording, and ``record_function``
ranges on the trace's clock while one is.  ``BlockTrace`` records a window of
a live stream's drained blocks (``dsabf-torch run --trace-blocks``).
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "annotate", "mark_block", "BLOCK_MARK", "Recording",
           "BlockTrace", "summarize_trace", "trace_events",
           "profile_block_step", "DEFAULT_LOG_DIR"]

#: Where ``trace`` writes when the caller names no directory.
DEFAULT_LOG_DIR = os.path.join(tempfile.gettempdir(), "dsabf-trace")

#: Name prefix of the zero-length mark that ties a span to its block's
#: ``seq`` (``dsabf.block.<seq>``, nested in the span it marks).
BLOCK_MARK = "dsabf.block."

_NULL = contextlib.nullcontext()


class Recording:
    """A ``torch.profiler`` recording started and stopped by hand, written
    to ``log_dir`` as ``<pid>.<ns>.trace.json.gz`` when it stops.  ``device``
    of type ``cuda`` adds the card's activity (kernels, copies) to the
    host's."""

    def __init__(self, log_dir: str | Path = DEFAULT_LOG_DIR, device="cpu"):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.log_dir = Path(log_dir)
        self._prof = torch.profiler.profile(activities=activities)

    def start(self) -> None:
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._prof.start()

    def stop(self) -> str:
        """Stop recording and write the trace; returns the file's path."""
        self._prof.stop()
        path = str(self.log_dir / f"{os.getpid()}.{time.time_ns()}"
                                  f".trace.json.gz")
        self._prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def trace(log_dir: str | Path = DEFAULT_LOG_DIR, device="cpu"):
    """Context manager: capture a trace around the enclosed block and write
    it to ``log_dir`` (``Recording``).  Yields ``log_dir``."""
    rec = Recording(log_dir, device)
    rec.start()
    try:
        yield str(rec.log_dir)
    finally:
        rec.stop()


def annotate(name: str):
    """Named region in a profiler timeline: a ``record_function`` range while
    a trace records, else a null context (the profiler's flag is the whole
    cost)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)


def mark_block(seq: int) -> None:
    """While a trace records, a zero-length ``dsabf.block.<seq>`` range: put
    inside a span, it names the block the span worked on (a range's own
    arguments do not survive the Chrome-trace export)."""
    if _autograd_profiler._is_profiler_enabled:
        with torch.profiler.record_function(f"{BLOCK_MARK}{seq}"):
            pass


class BlockTrace:
    """A recording of ``n_blocks`` drained blocks of a live stream, begun
    once ``skip`` blocks have drained: call ``drained`` from the stream's
    ``on_block``, and ``stop`` when the stream ends early."""

    def __init__(self, n_blocks: int, skip: int,
                 log_dir: str | Path = DEFAULT_LOG_DIR, device="cpu"):
        if n_blocks < 1 or skip < 1:
            raise ValueError(f"n_blocks and skip must be >= 1, got "
                             f"{n_blocks} and {skip}")
        self._rec = Recording(log_dir, device)
        self.n_blocks = n_blocks
        self.skip = skip
        self._seen = 0
        self._recording = False

    def drained(self) -> Optional[str]:
        """Count one drained block; the trace's path once it is written."""
        self._seen += 1
        if self._seen == self.skip:
            self._rec.start()
            self._recording = True
        elif self._seen == self.skip + self.n_blocks:
            return self.stop()
        return None

    def stop(self) -> Optional[str]:
        """Stop a recording in progress: its path, or None without one."""
        if not self._recording:
            return None
        self._recording = False
        return self._rec.stop()


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
