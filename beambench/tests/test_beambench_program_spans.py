"""The program-span readings on hand-made traces: the H2D gap's split, the
loop's own time, the drain hold paired by ``seq`` (also where pairing by
position would go wrong), the idle time by innermost span, and the
benchmark's own view and readers unchanged by the program's spans."""

import types

import pytest

from beambench import spans
from beambench.core import Outcome
from beambench.layer_metrics import (detect_roofline, device_idle_pct,
                                     h2d_gap_ms, h2d_gbps)
from beambench.spans import SpanView
from beambench.tests.test_beambench_trace import _ev, _events
from beambench.trace import TraceView

OBS = {"t_block": 10, "n_chan": 10, "n_pol": 2, "n_ant": 20,
       "n_ant_active": 2, "n_beams": 4, "navg_time": 2, "navg_freq": 1}
WIRE = 4000  # bytes of a wire block of OBS


def _span(name, ts, dur, tid=1):
    e = _ev(name, "user_annotation", ts, dur)
    e["tid"] = tid
    return e


def _mark(seq, ts, tid=1):
    return _span(f"dsabf.block.{seq}", ts, 0, tid)


def _call(ts, corr, tid=1):
    e = _ev("cudaMemcpyAsync", "cuda_runtime", ts, 2, correlation=corr)
    e["tid"] = tid
    return e


def _copy(direction, ts, dur, corr, nbytes=WIRE):
    kind = "Pinned -> Device" if direction == "HtoD" else "Device -> Pinned"
    return _ev(f"Memcpy {direction} ({kind})", "gpu_memcpy", ts, dur,
               bytes=nbytes, correlation=corr)


def _enqueue(seq, t, h2d_call, d2h_call=None):
    """A block's enqueue at ``t`` with its wire copy's call at ``h2d_call``
    (correlation 10 + seq) and its product's at ``d2h_call`` (20 + seq)."""
    ev = [_span("dsabf.loop.enqueue", t, 60), _mark(seq, t + 1),
          _span("dsabf.loop.h2d_launch", t + 2, h2d_call - t + 5),
          _call(h2d_call, 10 + seq)]
    if d2h_call is not None:
        ev += [_span("dsabf.loop.d2h_launch", d2h_call - 2, 8),
               _call(d2h_call, 20 + seq)]
    return ev


def _drain(seq, t, wait):
    return [_span("dsabf.loop.drain", t, wait + 30), _mark(seq, t),
            _span("dsabf.loop.drain_wait", t + 1, wait),
            _span("dsabf.loop.on_block", t + wait + 10, 5)]


def _stream(drain1_at=1200):
    """Three wire blocks (seq 1-3) in a 3000-us window: copies at 100, 610
    and 1130 for 400 us; waits ending at 520 and 1050; launches at 590 and
    1110.  Block 0 drains at 650 (its enqueue is not in the trace), block
    1, whose D2H copy ends at 560, at ``drain1_at``."""
    ev = [_ev("bb.window_open", "user_annotation", 0, 1),
          _ev("bb.window_close", "user_annotation", 2999, 1),
          _ev("detect", "kernel", 1600, 100),
          _copy("HtoD", 100, 400, 11), _copy("HtoD", 610, 400, 12),
          _copy("HtoD", 1130, 400, 13), _copy("DtoH", 520, 40, 21)]
    ev += _enqueue(1, 40, 50, d2h_call=70)
    ev += [_span("dsabf.loop.h2d_wait", 300, 220), _mark(1, 301),
           _span("dsabf.source.release", 525, 5),
           _span("dsabf.source.read", 530, 30), _mark(2, 559)]
    ev += _enqueue(2, 570, 590)
    ev += [_span("dsabf.loop.h2d_wait", 900, 150), _mark(2, 901)]
    ev += _enqueue(3, 1060, 1110)
    ev += _drain(0, 650, 45) + _drain(1, drain1_at, 49)
    return ev


def _run_out(events, view=SpanView):
    run = types.SimpleNamespace(config={"obs": OBS},
                                device_kind="NVIDIA H100 80GB HBM3")
    out = Outcome(t0=0, t1=1, setup_s=0, attempted=2, failed=0, kept=[],
                  trace=view(events), trace_blocks=2)
    return run, out


def test_h2d_gap_splits_into_wake_refill_and_launch():
    run, out = _run_out(_stream())
    split = spans.h2d_split(out.trace, WIRE)
    assert split == [(110.0, 20.0, 70.0), (120.0, 40.0, 60.0)]
    gap = h2d_gap_ms.read(run, out)
    wake = sum(w for _, w, _ in split) / len(split) / 1e3
    refill = sum(r for _, _, r in split) / len(split) / 1e3
    assert gap == pytest.approx(0.115)
    assert wake == pytest.approx(0.030)
    assert refill == pytest.approx(0.065)
    assert wake + refill <= gap


def test_device_times_that_lag_the_host_are_moved_back():
    """Device times 80 us behind the host's (each copy would start before
    its call): the shift that puts the earliest start at its call is
    added back before a device time meets a host one."""
    lagged = [dict(e, ts=e["ts"] - 80) if e["cat"] == "gpu_memcpy" else e
              for e in _stream()]
    ps = spans.ProgramSpans(SpanView(lagged))
    assert ps.skew(50) == ps.skew(1110) == 60.0   # launch -> start -60
    assert spans.ProgramSpans(SpanView(_stream())).skew(590) == 0.0
    split = spans.h2d_split(SpanView(lagged), WIRE)
    assert split == [(110.0, 40.0, 70.0), (120.0, 60.0, 60.0)]
    assert min(g - w - r for g, w, r in split) == 0.0
    assert spans.drain_holds(SpanView(lagged)) == {1: 660.0}


def test_device_times_that_lead_the_host_are_moved_back():
    """Device times 80 us ahead of the host's (the copies would end after
    the waits on them returned): the shift back that puts the tightest
    copy's end at its wait's end is taken before a device time meets a
    host one; the launches alone would move nothing."""
    ahead = [dict(e, ts=e["ts"] + 80) if e["cat"] == "gpu_memcpy" else e
             for e in _stream()]
    ps = spans.ProgramSpans(SpanView(ahead))
    assert ps.skew(50) == ps.skew(1110) == -60.0   # 520 - (500 + 80)
    split = spans.h2d_split(SpanView(ahead), WIRE)
    assert split == [(110.0, 0.0, 70.0), (120.0, 20.0, 60.0)]
    assert min(w for _, w, _ in split) == 0.0
    assert spans.drain_holds(SpanView(ahead)) == {1: 620.0}


def test_loop_busy_is_the_window_less_the_waits_per_drain():
    waited = 220 + 150 + 45 + 49
    assert spans.loop_busy_us(SpanView(_stream())) == pytest.approx(
        (3000 - waited) / 2)


@pytest.mark.parametrize("drain1_at,hold_us", [
    (1200, 640.0),   # drained once two later blocks are in flight
    (740, 180.0),    # drained right after the block before it
])
def test_drain_hold_pairs_by_seq(drain1_at, hold_us):
    """Block 0's drain opens the window with no D2H copy in the trace; by
    position it would take block 1's copy and block 1's drain none."""
    holds = spans.drain_holds(SpanView(_stream(drain1_at)))
    assert holds == {1: hold_us}
    by_position = 650 - 560
    assert hold_us != by_position


def test_blocks_follow_their_marks():
    ps = spans.ProgramSpans(SpanView(_stream()))
    launches = ps.by_seq("dsabf.loop.h2d_launch")
    assert sorted(launches) == [1, 2, 3]
    assert ps.by_seq("dsabf.source.read") and \
        ps.by_seq("dsabf.source.read")[2].a == 530
    assert ps.by_seq("dsabf.loop.drain_wait")[1].a == 1201
    assert all(s.seq is None for s in ps.named("dsabf.source.release"))


def test_idle_by_innermost_span():
    ev = [_ev("bb.window_open", "user_annotation", 0, 1),
          _ev("bb.window_close", "user_annotation", 999, 1),
          _ev("detect", "kernel", 0, 100), _ev("detect", "kernel", 400, 600),
          _span("dsabf.loop.drain", 50, 250),
          _span("dsabf.loop.drain_wait", 150, 100)]
    idle = spans.idle_by_span(SpanView(ev))
    assert idle == {"dsabf.loop.drain": pytest.approx(100e-6),
                    "dsabf.loop.drain_wait": pytest.approx(100e-6),
                    spans.NO_SPAN: pytest.approx(100e-6)}


def test_a_trace_without_program_spans_reads_nothing():
    run, out = _run_out(_events())
    assert spans.h2d_split(out.trace, WIRE) == []
    assert spans.loop_busy_us(out.trace) is None
    assert spans.drain_holds(out.trace) == {}
    assert spans.latency_pieces(out.trace, out) is None


def test_program_spans_leave_the_benchmark_view_unchanged():
    """``breakdown()`` and the four existing readers read the same with and
    without the program's spans and copy calls in the trace, through the
    benchmark's view and through ``SpanView``."""
    program = [e for e in _stream() if e["cat"] in ("user_annotation",
                                                     "cuda_runtime")
               and not e["name"].startswith("bb.")]
    plain, both = _events(), _events() + program
    values = []
    for events, view in [(plain, TraceView), (both, TraceView),
                         (both, SpanView)]:
        run, out = _run_out(events, view)
        values.append([out.trace.breakdown(), out.trace.spans,
                       out.trace.busy_s(), out.trace.idle_gaps(),
                       h2d_gbps.read(run, out), h2d_gap_ms.read(run, out),
                       device_idle_pct.read(run, out),
                       detect_roofline.read(run, out)])
    assert values[0] == values[1] == values[2]
    assert SpanView(both).program_spans and not SpanView(plain).program_spans
    assert SpanView(both).copy_calls and not SpanView(plain).copy_calls
