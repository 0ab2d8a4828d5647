"""The port's fringe tracker (``models/tracking.py``) and the streaming
loop's ``tracker=`` hook on the CPU: the JAX package's tracking tests, the
tracker keeping an excision through an update, and the tracked weights
against the JAX tracker's (the two packages' ``make_weights`` agree to
1e-6, so the quantized tables are compared dequantized)."""

import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.models.tracking as jtr
import dsabeamformer_tpu.models.weights as jw
import dsabeamformer_tpu_torch.config as pcfg
from dsabeamformer_tpu_torch.ingest.generator import make_point_source_block
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.tracking import EARTH_ROT_RAD_S, FringeTracker
from dsabeamformer_tpu_torch.models.weights import flag_antennas, zap_weights
from dsabeamformer_tpu_torch.ops.gemm import beamform_power
from dsabeamformer_tpu_torch.pipeline import (
    CollectSink,
    StreamingBeamformer,
    SyntheticSource,
)

CFG = pcfg.TINY
#: Dequantized tracked weights, port against JAX (make_weights agrees to
#: 1e-6; one int8 step of a sub-term may round the other way).
DEQUANT_ATOL = 2e-3


def _tracker(**kw):
    return FringeTracker(CFG, device="cpu", **kw)


def test_update_interval_scales_with_phase_budget():
    t1 = _tracker(max_phase_error_rad=0.05)
    t2 = _tracker(max_phase_error_rad=0.10)
    assert t2.update_interval_s > t1.update_interval_s > 0
    assert t1.update_interval_s == pytest.approx(
        jtr.FringeTracker(jcfg.TINY).update_interval_s, rel=1e-12)


def test_maybe_update_cadence():
    tr = _tracker()
    dt = tr.update_interval_s
    assert tr.maybe_update(0.0) is not None
    assert tr.maybe_update(0.1 * dt) is None
    assert tr.maybe_update(1.1 * dt) is not None
    assert tr.n_updates == 2
    tr.invalidate()
    assert tr.maybe_update(1.2 * dt) is not None


def test_cal_update_forces_regeneration():
    tr = _tracker()
    assert tr.maybe_update(0.0) is not None
    assert tr.maybe_update(0.0) is None
    tr.set_calibration(CalTable.random(CFG, seed=5))
    assert tr.maybe_update(0.0) is not None


@pytest.mark.parametrize("t_s", [0.0, 1000.0, 86400.0])
@pytest.mark.parametrize("dec", [0.0, 0.7])
def test_tracked_weights_match_jax(t_s, dec):
    port = _tracker(declination_rad=dec, pointing0_rad=0.01).weights_at(t_s)
    ref = jtr.FringeTracker(jcfg.TINY, declination_rad=dec,
                            pointing0_rad=0.01).weights_at(t_s)
    assert port.scales.device == torch.device("cpu")
    np.testing.assert_allclose(port.dequantize().numpy(),
                               np.asarray(ref.dequantize()),
                               atol=DEQUANT_ATOL)


def test_tracked_stream_follows_source():
    """A source drifting at the sidereal rate stays in the same beam when
    the tracker updates the pointing, and walks out of it when the weights
    are frozen."""
    angles = CFG.beam_angles_rad()
    target = len(angles) // 2
    t_step = 2 * np.diff(angles).mean() / EARTH_ROT_RAD_S
    tr = _tracker(pointing0_rad=0.0)
    qw0 = tr.weights_at(0.0)
    peaks_tracked, peaks_frozen = [], []
    for i in range(3):
        t = i * t_step
        wire = torch.from_numpy(make_point_source_block(
            CFG, angles[target] + EARTH_ROT_RAD_S * t, noise_rms=0.0,
            seed=i))
        p_tracked = beamform_power(wire, tr.weights_at(t), CFG).numpy()
        p_frozen = beamform_power(wire, qw0, CFG).numpy()
        peaks_tracked.append(int(np.argmax(p_tracked.sum(axis=(0, 1)))))
        peaks_frozen.append(int(np.argmax(p_frozen.sum(axis=(0, 1)))))
    assert peaks_tracked == [target] * 3, peaks_tracked
    assert peaks_frozen[0] == target
    assert peaks_frozen[-1] > target


def test_pipeline_applies_tracker_updates():
    tr = _tracker(max_phase_error_rad=1e-9)  # update every block
    blocks = [make_point_source_block(CFG, 0.0, noise_rms=0.5, seed=9)]
    sink = CollectSink()
    bf = StreamingBeamformer(CFG, tr.weights_at(0.0),
                             SyntheticSource(CFG, blocks, n_blocks=3), sink,
                             depth=0, tracker=tr)
    stats = bf.run()
    assert stats.n_blocks == 3 and len(sink.outputs) == 3
    assert tr.n_updates == 3  # polled and refreshed each block
    want = beamform_power(torch.from_numpy(blocks[0]),
                          tr.weights_at(2 * CFG.block_duration_s), CFG)
    assert np.array_equal(sink.outputs[2][1], want.numpy())


def test_tracker_defaults_to_the_card(monkeypatch):
    """The tracker makes weights on the card unless told otherwise; with no
    card that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        FringeTracker(CFG)


def test_tracker_preserves_excision():
    """The edit hook re-applies zap / flag excision to every regenerated
    table, so an update does not undo it."""

    def edit(w):
        return flag_antennas(zap_weights(w, [1], CFG), [0], CFG)

    tr = _tracker(edit=edit)
    qw = tr.weights_at(1000.0)
    for t in qw.terms:
        assert (t[1] == 0).all()  # zapped channel: the whole K x 2B block
    ref = jtr.FringeTracker(jcfg.TINY, edit=lambda w: jw.flag_antennas(
        jw.zap_weights(w, [1], jcfg.TINY), [0], jcfg.TINY)).weights_at(1000.0)
    np.testing.assert_allclose(qw.dequantize().numpy(),
                               np.asarray(ref.dequantize()),
                               atol=DEQUANT_ATOL)
