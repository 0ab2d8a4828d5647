"""The trace view and the per-layer readers on a hand-made trace."""

import types

import pytest

from beambench.core import Outcome
from beambench.layer_metrics import (detect_roofline, device_idle_pct,
                                     h2d_gap_ms, h2d_gbps)
from beambench.trace import TraceView


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _events(with_kernel=True):
    ev = [_ev("bb.window_open", "user_annotation", 0, 1),
          _ev("bb.window_close", "user_annotation", 999, 1),
          _ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 0, 400,
              bytes=4000),
          _ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 500, 400,
              bytes=4000),
          _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 950, 10,
              bytes=8),
          _ev("bb.ring.open_read", "user_annotation", 400, 100),
          _ev("cudaLaunchKernel", "cuda_runtime", 0, 5)]
    if with_kernel:
        ev += [_ev("detect", "kernel", 100, 200), _ev("layout", "kernel",
                                                      950, 50)]
    return ev


def test_view_busy_idle_and_breakdown():
    v = TraceView(_events())
    assert v.window_s == pytest.approx(1000e-6)
    assert v.kernel_s() == pytest.approx(250e-6)
    assert v.busy_s() == pytest.approx(850e-6)
    assert v.idle_gaps() == [(400.0, 500.0), (900.0, 950.0)]
    b = v.breakdown()
    assert b["device_ops"][0] == ["Memcpy HtoD (Pinned -> Device)",
                                  pytest.approx(800e-6)]
    assert b["idle_gaps"] == [["ring.open_read", pytest.approx(100e-6)],
                              ["(no span)", pytest.approx(50e-6)]]


def test_a_trace_without_kernels_raises():
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        TraceView(_events(with_kernel=False))


def test_readers():
    obs = {"t_block": 10, "n_chan": 10, "n_pol": 2, "n_ant": 20,
           "n_ant_active": 2, "n_beams": 4, "navg_time": 2, "navg_freq": 1}
    run = types.SimpleNamespace(config={"obs": obs},
                                device_kind="NVIDIA H100 80GB HBM3")
    out = Outcome(t0=0, t1=1, setup_s=0, attempted=2, failed=0, kept=[],
                  trace=TraceView(_events()), trace_blocks=2)
    assert h2d_gbps.read(run, out) == pytest.approx(8000 / 800e-6 / 1e9)
    assert h2d_gap_ms.read(run, out) == pytest.approx(0.1)
    assert device_idle_pct.read(run, out) == pytest.approx(15.0)
    roof = detect_roofline.read(run, out)
    assert 0 < roof < 100
    run.device_kind = "cpu"
    assert detect_roofline.read(run, out) is None
