"""The traced sub-window of a ``--trace 1`` run, and what is read from it.

``Tracer`` prepares a ``torch.profiler`` trace (host and CUDA activity) in
set-up, where its first-use cost falls, starts recording inside the measured
window and marks the sub-window's ends with two annotations; recording stops
once the run's window is over, so no stop stalls it.  The benchmark's
own spans (``span``) sit around its calls into each layer: the ring's reads
and releases, the sinks' writes, the drain hook and the resident launch
loop.  Without ``--trace 1`` a span is a null context.

``TraceView`` holds the complete events of the window, in the trace's own
microseconds: device operations (kernels, copies, memsets), the H2D copies,
the benchmark's spans, the program's own spans (``dsabf.*``, which
``spans.py`` reads) and the runtime's copy calls, each naming its device
copy by the ``correlation`` both carry.  A view with no CUDA kernel event
raises: no number of the device is ever read from the host's activity
alone.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

import torch

_OPEN, _CLOSE = "bb.window_open", "bb.window_close"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self._prof = None
        self.t_open = self.t_close = None
        self.open_ms = None  # how long starting the recording took

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bb.{name}")

    @property
    def active(self) -> bool:
        return self.t_open is not None and self.t_close is None

    def prepare(self) -> None:
        """Set the profiler up (in set-up: its first use is slow)."""
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.prepare_trace()

    def open(self) -> None:
        t = time.perf_counter()
        self._prof.start_trace()
        with torch.profiler.record_function(_OPEN):
            self.t_open = time.perf_counter()
        self.open_ms = (self.t_open - t) * 1e3

    def close(self) -> None:
        with torch.profiler.record_function(_CLOSE):
            self.t_close = time.perf_counter()

    def finish(self) -> None:
        """Stop recording (after the measured window)."""
        if self._prof is None or self.t_open is None:
            return
        if self.t_close is None:
            self.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop_trace()

    def view(self) -> "TraceView":
        """The window's events (the trace goes through a temporary file,
        removed at once)."""
        if self._prof is None or self.t_close is None:
            raise RuntimeError("the traced window was never opened and closed")
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        return TraceView([e for e in events if e.get("ph") == "X"])


class TraceView:
    def __init__(self, events: list):
        marks = {e["name"]: e for e in events
                 if e.get("name") in (_OPEN, _CLOSE)
                 and e.get("cat") == "user_annotation"}
        if len(marks) != 2:
            raise RuntimeError("the trace lacks the window's marks")
        self.t0 = float(marks[_OPEN]["ts"])
        self.t1 = float(marks[_CLOSE]["ts"]) + float(marks[_CLOSE]["dur"])
        self.device_ops = [e for e in events if e.get("cat") in _DEVICE_CATS]
        self.kernels = [e for e in self.device_ops if e["cat"] == "kernel"]
        if not self.kernels:
            raise RuntimeError("the trace holds no CUDA kernel event: no "
                               "device metric can be read from it")
        self.spans = [e for e in events if e.get("cat") == "user_annotation"
                      and e.get("name", "").startswith("bb.")
                      and e["name"] not in (_OPEN, _CLOSE)]
        self.program_spans = [e for e in events
                              if e.get("cat") == "user_annotation"
                              and e.get("name", "").startswith("dsabf.")]
        self.copy_calls = [e for e in events
                           if e.get("cat") == "cuda_runtime"
                           and "Memcpy" in e.get("name", "")]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _clip(self, e) -> tuple:
        a = max(float(e["ts"]), self.t0)
        b = min(float(e["ts"]) + float(e.get("dur", 0)), self.t1)
        return a, b

    def kernel_s(self) -> float:
        """Device time of every kernel in the window, whatever its name."""
        return sum(max(0.0, b - a) for a, b in map(self._clip, self.kernels)
                   ) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, in the window."""
        spans = sorted(iv for iv in map(self._clip, self.device_ops)
                       if iv[1] > iv[0])
        out: list = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list:
        """``(start, end)`` of each stretch of the window with no device
        operation running."""
        gaps, at = [], self.t0
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def h2d_copies(self, min_bytes: int) -> list:
        """Host-to-device copies of at least ``min_bytes`` that start in the
        window, in start order."""
        out = [e for e in self.device_ops if e["cat"] == "gpu_memcpy"
               and "HtoD" in e.get("name", "")
               and int(e.get("args", {}).get("bytes", 0)) >= min_bytes
               and self.t0 <= float(e["ts"]) < self.t1]
        return sorted(out, key=lambda e: float(e["ts"]))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps'
        seconds by the benchmark span the host was in (``(no span)`` where
        it was in none)."""
        by_op: dict = {}
        for e in self.device_ops:
            a, b = self._clip(e)
            if b > a:
                by_op[e["name"]] = by_op.get(e["name"], 0.0) + (b - a) / 1e6
        by_span: dict = {}
        spans = sorted((float(s["ts"]), float(s["ts"]) + float(s["dur"]),
                        s["name"][3:]) for s in self.spans)
        starts = [sp[0] for sp in spans]
        longest = max((b - a for a, b, _ in spans), default=0.0)
        for a, b in self.idle_gaps():
            covered = 0.0
            for sa, sb, name in spans[bisect.bisect_left(starts, a - longest):
                                      bisect.bisect_left(starts, b)]:
                o = min(b, sb) - max(a, sa)
                if o > 0:
                    by_span[name] = by_span.get(name, 0.0) + o / 1e6
                    covered += o
            rest = (b - a) - covered
            if rest > 0:
                by_span["(no span)"] = by_span.get("(no span)", 0.0) + rest / 1e6

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    ][:top]
        return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}
