"""The program's own spans in a traced window, and what is read from them
about the streaming loop: the split of the H2D gap, the loop's own time, how
long a finished product waits for its drain, the device's idle time by the
innermost program span and the pieces of a paced block's latency.

The port marks its streaming loop with ``dsabf.<layer>.<what>`` spans on
the profiler's clock.  Its per-block spans (the read, the H2D wait, the
enqueue, the drain) each hold a zero-length ``dsabf.block.<seq>`` mark; a
span nested in one of them on the same host thread is the same block's.  A
device copy belongs to the span in which the host's runtime call that
launched it lies: the copy and the call carry the same ``correlation``.
Blocks are paired by ``seq``, never by position, so a change of the drain
policy leaves the pairing right.

Every function here reads the benchmark's ``TraceView``, which keeps the
program's spans (``program_spans``) and the runtime's copy calls
(``copy_calls``); ``SpanView`` is another name for it.  No per-layer metric
of ``BENCHMARK.json`` reads this module yet; a reader in
``layer_metrics/`` can, with no edit elsewhere.

Host and device events share the trace's clock only as far as the profiler
lines them up, and in some processes the device's times drift from the
host's by up to half a millisecond over a window: behind it (a wire copy
then appears to start before the call that launched it) or ahead of it (a
copy appears to end after the wait on it returned).  Every time read across
the two (a device copy's end against a host span's) is therefore first
moved by the drift ``ProgramSpans.skew`` finds.  Where the device lags, that
is the least shift that puts each wire copy launched by the loop at or
after its call; where it leads, the least shift back that puts each such
copy's end at or before the end of the ``dsabf.loop.h2d_wait`` on it; each
over a copy and its neighbours.  Where every copy already lies between its
call and its wait's end, nothing moves.

Every function gives None, or nothing, for a trace without the program's
spans (a program that has none).

    python3 -m beambench.spans --workload <cell> --seed <n> --seconds <s>

runs one traced window of a cell on the card and prints one JSON line: the
H2D gap's split, the loop's own time and the drain hold, the device's idle
time by the innermost program span the host was in, and, for a paced cell,
each piece of the due -> drain latency of the blocks drained in the traced
window.
"""

from __future__ import annotations

import bisect
import statistics
from typing import NamedTuple, Optional

from beambench.trace import TraceView

BLOCK = "dsabf.block."
NO_SPAN = "(no span)"
#: Wire copies on each side whose launches set one copy's clock shift.
SKEW_NEIGHBOURS = 8
H2D_WAIT, H2D_LAUNCH = "dsabf.loop.h2d_wait", "dsabf.loop.h2d_launch"
D2H_LAUNCH, DRAIN = "dsabf.loop.d2h_launch", "dsabf.loop.drain"
DRAIN_WAIT, READ = "dsabf.loop.drain_wait", "dsabf.source.read"
ON_BLOCK = "dsabf.loop.on_block"


class Span(NamedTuple):
    name: str
    a: float            # start, trace microseconds
    b: float            # end
    tid: object
    seq: Optional[int]  # the block it worked on, None outside any block


def _end(e) -> float:
    return float(e["ts"]) + float(e.get("dur", 0))


#: The view every function here reads: the benchmark's own.
SpanView = TraceView


class ProgramSpans:
    """The trace's program spans, each with the ``seq`` of its block."""

    def __init__(self, view: TraceView):
        self.view = view
        raw, marks = [], []
        for e in view.program_spans:
            if e["name"].startswith(BLOCK):
                marks.append((float(e["ts"]), e.get("tid"),
                              int(e["name"][len(BLOCK):])))
            else:
                raw.append((float(e["ts"]), -_end(e), e["name"], e.get("tid")))
        raw.sort(key=lambda r: (r[0], r[1]))
        own = self._own_marks(raw, marks)
        # A marked span holds no other: on each thread they are disjoint.
        carriers: dict = {}
        for i, seq in own.items():
            a, neg_b, _, tid = raw[i]
            carriers.setdefault(tid, []).append((a, -neg_b, seq))
        for lst in carriers.values():
            lst.sort()
        self._carriers = {tid: ([c[0] for c in lst], lst)
                          for tid, lst in carriers.items()}
        self.spans = [Span(name, a, -neg_b, tid, self.seq_at(tid, a, -neg_b))
                      for a, neg_b, name, tid in raw]
        self._named: dict = {}
        for s in self.spans:
            self._named.setdefault(s.name, []).append(s)
        # The host's copy calls by thread, and the device copies they made.
        self._calls: dict = {}
        for e in view.copy_calls:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                self._calls.setdefault(e.get("tid"), []).append(
                    (float(e["ts"]), corr))
        for lst in self._calls.values():
            lst.sort()
        self._copy_of = {e["args"]["correlation"]: e for e in view.device_ops
                         if e["cat"] == "gpu_memcpy"
                         and "correlation" in e.get("args", {})}
        self._call_of = {corr: (ts, tid) for tid, lst in self._calls.items()
                         for ts, corr in lst}
        # Each wire copy the loop launched: (its call, call - start, end of
        # the wait on it - end), the least and the most shift it allows.
        waits = self.by_seq(H2D_WAIT)
        bounds = []
        for s in self.named(H2D_LAUNCH):
            wait = waits.get(s.seq)
            for e in self.copies_in(s, "HtoD"):
                call = self._call_of[e["args"]["correlation"]][0]
                bounds.append((call, call - float(e["ts"]),
                               wait.b - _end(e) if wait else float("inf")))
        bounds.sort()
        n = SKEW_NEIGHBOURS
        self._skew_t = [t for t, _, _ in bounds]
        self._skew = []
        for i in range(len(bounds)):
            near = bounds[max(0, i - n):i + n + 1]
            least = max(lo for _, lo, _ in near)
            most = min(hi for _, _, hi in near)
            self._skew.append(least if least > 0 else min(0.0, most))

    @staticmethod
    def _own_marks(raw, marks) -> dict:
        """Index into ``raw`` -> seq: each mark goes to the innermost span
        of its thread open at its time (a sweep with one stack a thread)."""
        items = sorted([(a, 0, i) for i, (a, _, _, _) in enumerate(raw)]
                       + [(ts, 1, j) for j, (ts, _, _) in enumerate(marks)])
        stacks: dict = {}
        own: dict = {}
        for t, kind, k in items:
            tid = raw[k][3] if kind == 0 else marks[k][1]
            stack = stacks.setdefault(tid, [])
            while stack and -raw[stack[-1]][1] < t:
                stack.pop()
            if kind == 0:
                stack.append(k)
            elif stack:
                own.setdefault(stack[-1], marks[k][2])
        return own

    def seq_at(self, tid, a: float, b: Optional[float] = None):
        """The seq of the marked span of thread ``tid`` that holds ``[a, b]``
        (``b`` defaults to ``a``), or None."""
        starts, lst = self._carriers.get(tid, ((), ()))
        i = bisect.bisect_right(starts, a) - 1
        if i < 0:
            return None
        sa, sb, seq = lst[i]
        return seq if sb >= (a if b is None else b) else None

    def named(self, name: str) -> list:
        """Spans of one name, in start order."""
        return self._named.get(name, [])

    def by_seq(self, name: str) -> dict:
        """seq -> the first span of one name that block holds."""
        out: dict = {}
        for s in self.named(name):
            if s.seq is not None:
                out.setdefault(s.seq, s)
        return out

    def copies_in(self, span: Span, direction: str) -> list:
        """Device copies (``"HtoD"`` or ``"DtoH"``) launched by host calls
        inside ``span``, in start order."""
        calls = self._calls.get(span.tid, [])
        i = bisect.bisect_left(calls, (span.a,))
        out = []
        for ts, corr in calls[i:]:
            if ts > span.b:
                break
            e = self._copy_of.get(corr)
            if e is not None and direction in e.get("name", ""):
                out.append(e)
        return sorted(out, key=lambda e: float(e["ts"]))

    def skew(self, t: float) -> float:
        """Microseconds to add to a device time near host time ``t`` to put
        it on the host's clock (the nearest wire copy's shift)."""
        ts = self._skew_t
        if not ts:
            return 0.0
        i = bisect.bisect_left(ts, t)
        if i == len(ts) or (i > 0 and t - ts[i - 1] < ts[i] - t):
            i -= 1
        return self._skew[i]

    def launch_of(self, copy) -> Optional[tuple]:
        """``(ts, seq)`` of the host call that launched a device copy."""
        corr = copy.get("args", {}).get("correlation")
        if corr not in self._call_of:
            return None
        ts, tid = self._call_of[corr]
        return ts, self.seq_at(tid, ts)

    def clipped_us(self, names) -> float:
        """Time in spans of ``names`` inside the window, in microseconds."""
        v = self.view
        return sum(max(0.0, min(s.b, v.t1) - max(s.a, v.t0))
                   for name in names for s in self.named(name))

    def drains_in_window(self) -> list:
        v = self.view
        return [s for s in self.named(DRAIN) if v.t0 <= s.a < v.t1]


def h2d_split(view, min_bytes: int) -> list:
    """``(gap, wake, refill)`` in microseconds for each pair of consecutive
    wire copies in the window (``TraceView.h2d_copies``) whose first copy's
    ``dsabf.loop.h2d_wait`` and second copy's launch are in the trace:
    wake = first copy's end (on the host's clock, ``ProgramSpans.skew``)
    -> end of the wait on it; refill = that end -> the host's call that
    launched the second copy.  The rest of the gap is the call itself and
    the copy engine's start of the copy."""
    ps = ProgramSpans(view)
    waits = ps.by_seq(H2D_WAIT)
    copies = view.h2d_copies(min_bytes)
    out = []
    for c, d in zip(copies, copies[1:]):
        lc, ld = ps.launch_of(c), ps.launch_of(d)
        if lc is None or ld is None or lc[1] not in waits:
            continue
        wait = waits[lc[1]]
        end = _end(c) + ps.skew(ld[0])
        out.append((float(d["ts"]) - _end(c), wait.b - end, ld[0] - wait.b))
    return out


def loop_busy_us(view) -> Optional[float]:
    """The loop thread's own time a block drained in the window: the window
    less its time in ``dsabf.loop.h2d_wait`` and ``dsabf.loop.drain_wait``,
    over the ``dsabf.loop.drain`` spans that start in it."""
    ps = ProgramSpans(view)
    n = len(ps.drains_in_window())
    if not n:
        return None
    waited = ps.clipped_us((H2D_WAIT, DRAIN_WAIT))
    return ((view.t1 - view.t0) - waited) / n


def drain_holds(view) -> dict:
    """seq -> microseconds from the end of the block's last D2H copy on the
    card (on the host's clock, ``ProgramSpans.skew``) to the start of its
    ``dsabf.loop.drain``, for each block whose drain starts in the window
    and whose D2H launches are in the trace."""
    ps = ProgramSpans(view)
    launches = ps.by_seq(D2H_LAUNCH)
    out = {}
    for drain in ps.drains_in_window():
        launch = launches.get(drain.seq)
        copies = ps.copies_in(launch, "DtoH") if launch else []
        if copies:
            end = max(_end(e) for e in copies) + ps.skew(drain.a)
            out[drain.seq] = drain.a - end
    return out


def idle_by_span(view) -> dict:
    """The device's idle seconds in the window by the innermost program
    span the host was in (``(no span)`` where it was in none), each idle
    stretch put on the host's clock (``ProgramSpans.skew``)."""
    ps = ProgramSpans(view)
    spans = sorted(ps.spans, key=lambda s: s.a)
    starts = [s.a for s in spans]
    longest = max((s.b - s.a for s in spans), default=0.0)
    by: dict = {}
    for a, b in view.idle_gaps():
        k = ps.skew(a)
        a, b = a + k, b + k
        near = [s for s in spans[bisect.bisect_left(starts, a - longest):
                                 bisect.bisect_left(starts, b)]
                if s.b > a]
        cuts = sorted({a, b, *(t for s in near for t in (s.a, s.b)
                               if a < t < b)})
        for x, y in zip(cuts, cuts[1:]):
            m = (x + y) / 2
            inner = [s for s in near if s.a <= m < s.b]
            name = max(inner, key=lambda s: (s.a, -s.b)).name if inner \
                else NO_SPAN
            by[name] = by.get(name, 0.0) + (y - x) / 1e6
    return by


def latency_pieces(view, out) -> Optional[dict]:
    """Due -> drain of each block due in a paced window and drained in the
    traced one, taken apart in ms along its spans and copies: ``pickup``
    (due -> its read returned), ``enqueue`` (-> its wire copy starts on
    the card), ``h2d`` (the copy), ``device`` (-> its last D2H copy ends:
    kernel, layout, D2H and the waits between), ``hold`` (-> its drain
    starts) and ``drain`` (-> the loop's ``on_block``, where the benchmark
    stamps the drain).  The due times, on the host's clock, are put on the
    trace's by the offset between the benchmark's drain stamps and the
    starts of the ``dsabf.loop.on_block`` spans (each stamp is taken at its
    span's start, within microseconds), the device's times by
    ``ProgramSpans.skew``.  Returns each piece's median, their sum, the
    blocks' median latency and their count."""
    ps = ProgramSpans(view)
    on_block, drains = ps.by_seq(ON_BLOCK), ps.by_seq(DRAIN)
    reads, h2d, d2h = ps.by_seq(READ), ps.by_seq(H2D_LAUNCH), \
        ps.by_seq(D2H_LAUNCH)
    stamped = dict(out.drains)
    offsets = [s.a - stamped[q] * 1e6 for q, s in on_block.items()
               if q in stamped]
    if not offsets or not out.due:
        return None
    offset = statistics.median(offsets)
    rows = []
    for q, due in out.due.items():
        if q not in stamped or q not in drains or q not in on_block \
                or not view.t0 <= drains[q].a < view.t1:
            continue
        wire = ps.copies_in(h2d[q], "HtoD") if q in h2d else []
        back = ps.copies_in(d2h[q], "DtoH") if q in d2h else []
        if q not in reads or not wire or not back:
            continue
        k = ps.skew(drains[q].a)
        t = [due * 1e6 + offset, reads[q].b, float(wire[0]["ts"]) + k,
             _end(wire[0]) + k, max(_end(e) for e in back) + k, drains[q].a,
             on_block[q].a]
        rows.append([(y - x) / 1e3 for x, y in zip(t, t[1:])]
                    + [(stamped[q] - due) * 1e3])
    if not rows:
        return None
    names = ("pickup", "enqueue", "h2d", "device", "hold", "drain")
    med = {n: statistics.median(r[i] for r in rows)
           for i, n in enumerate(names)}
    return {"pieces_ms": med, "sum_ms": sum(med.values()),
            "latency_ms": statistics.median(r[-1] for r in rows),
            "blocks": len(rows)}


def main(argv=None) -> int:
    import argparse
    import importlib
    import json

    from beambench import run as bench
    from beambench.layer_metrics import h2d_gap_ms
    from beambench.layer_metrics.h2d_gbps import _wire_bytes

    p = argparse.ArgumentParser(prog="python3 -m beambench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = bench.cell_entry(bench.benchmark(), args.workload)
    r = bench.make_run(cell, args.seconds, args.seed, True, "cuda:0")
    kind = importlib.import_module(f"beambench.kinds.{r.mix['kind']}")
    out = kind.run(r)
    view = out.trace
    idle = idle_by_span(view)
    split = h2d_split(view, _wire_bytes(r.config["obs"]))
    busy, holds = loop_busy_us(view), drain_holds(view)
    rec = {"workload": args.workload, "seed": args.seed,
           "device": r.device_kind, "window_s": view.window_s,
           "h2d_gap_ms": h2d_gap_ms.read(r, out), "h2d_pairs": len(split),
           # mean gap, wake and refill over the pairs h2d_split pairs
           "h2d_split_ms": [statistics.mean(x[i] for x in split) / 1e3
                            for i in range(3)] if split else None,
           "loop_busy_ms": None if busy is None else busy / 1e3,
           "drain_hold_ms": statistics.mean(holds.values()) / 1e3
           if holds else None,
           "idle_s": sum(idle.values()),
           "idle_by_span_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
           "no_span_share": idle.get(NO_SPAN, 0.0) / sum(idle.values())
           if idle else None,
           "latency": latency_pieces(view, out)}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
