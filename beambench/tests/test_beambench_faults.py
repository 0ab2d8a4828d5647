"""A run whose timed path is broken underneath comes out not correct: the
step that returns its last state unchanged, half of each block's samples
left out (the rest's sum doubled), one answer altered where it is made,
and a gain in every beam power, which the 8-bit scales made from those
powers take back out of the counts.  The cells run on one chip, so no
exchange between chips can be left out."""

import pytest
import torch

from beambench.tests.conftest import cpu_run
from dsabeamformer_tpu_torch import pipeline
from dsabeamformer_tpu_torch.ops import gemm

REAL = gemm.beamform_power


def stale():
    last = {}  # the last output of each variant

    def detect(wire, qw, cfg, **kw):
        variant = (kw.get("incoherent"), kw.get("sk_stats"),
                   kw.get("quant8_scales") is None)
        out = REAL(wire, qw, cfg, **kw)
        prev = last.get(variant, out)
        last[variant] = out
        return prev
    return detect


def half():
    def detect(wire, qw, cfg, **kw):
        w = wire.clone().reshape(cfg.t_block, -1)
        w[cfg.t_block // 2:] = 0
        q = kw.get("quant8_scales")
        if q is not None:
            kw = dict(kw, quant8_scales=q * 2)
        out = REAL(w.reshape(wire.shape), qw, cfg, **kw)
        parts = list(out) if isinstance(out, tuple) else [out]
        parts = [p if (i == 0 and q is not None) else p * 2
                 for i, p in enumerate(parts)]
        return tuple(parts) if isinstance(out, tuple) else parts[0]
    return detect


def altered():
    def detect(wire, qw, cfg, **kw):
        out = REAL(wire, qw, cfg, **kw)
        first = out[0] if isinstance(out, tuple) else out
        flat = first.view(-1)
        flat[flat.numel() // 3] += 3 if flat.dtype == torch.uint8 else 3.0
        return out
    return detect


def gain():
    def detect(wire, qw, cfg, **kw):
        q = kw.get("quant8_scales")
        if q is not None:
            return REAL(wire, qw, cfg, **dict(kw, quant8_scales=q * 1.5))
        out = REAL(wire, qw, cfg, **kw)
        if isinstance(out, tuple):
            return (out[0] * 1.5,) + tuple(out[1:])
        return out * 1.5
    return detect


@pytest.mark.parametrize("fault, caught_by", [
    (stale, "power_err"), (half, "power_err"), (altered, "power_err"),
    (gain, "scale_err")])
@pytest.mark.parametrize("traffic", ["ring_saturated", "resident"])
def test_a_broken_path_is_not_correct(tiny, monkeypatch, fault, caught_by,
                                      traffic):
    broken = fault()
    monkeypatch.setattr(pipeline, "beamform_power", broken)
    monkeypatch.setattr(gemm, "beamform_power", broken)
    result, _ = cpu_run(tiny, traffic, seed=2**31 + 21)
    checks = result["checks"]
    assert result["correct"] is False
    assert checks[caught_by]["value"] > checks[caught_by]["limit"]
    if fault is gain:  # the counts are as they were: power_err sees nothing
        assert checks["power_err"]["value"] <= checks["power_err"]["limit"]
