"""The port's multi-beam and streaming search (``ops/dedisperse.py``) on the
CPU against the JAX package's: the chunk loop, the beam-batched search
against the per-beam one, and the live ``SearchMonitor`` (offline
agreement, gap reset, incoherent and Stokes extraction, the loop's
``observe_selected`` way in, beam sets with coincidence).  The helpers and
tolerances are ``tests/test_torch_dedisperse.py``'s."""

import dataclasses

import numpy as np
import pytest
import torch

import dsabeamformer_tpu.ops.dedisperse as J
from dsabeamformer_tpu_torch.ops.dedisperse import (
    SearchMonitor,
    dedisperse_bank,
    dm_trial_grid,
    search_spectrogram,
    search_spectrograms,
)
from test_torch_dedisperse import (
    CPU,
    F_HI,
    F_LO,
    TSAMP,
    _freqs,
    _pulse_spectrogram,
    _same_candidates,
)


def test_search_chunked_matches_whole():
    dm_true, t0 = 120.0, 1500
    x, freqs = _pulse_spectrogram(4096, 64, dm_true, t0, 4, amp=1.0, seed=5)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    whole = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                               device=CPU)
    chunked = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                                 chunk_t=1024, device=CPU)
    _same_candidates(chunked, J.search_spectrogram(
        x, freqs, TSAMP, dms, threshold=7.5, chunk_t=1024))
    assert whole and chunked
    assert abs(whole[0].t_samp - chunked[0].t_samp) <= 4
    assert abs(whole[0].dm - chunked[0].dm) <= 2 * (dms[1] - dms[0])
    assert len([c for c in chunked if abs(c.t_samp - t0) < 64]) == 1


@pytest.mark.parametrize("method", ["direct", "subband", "conv"])
def test_batched_search_matches_per_beam(method):
    """search_spectrograms equals search_spectrogram per beam, across chunk
    boundaries and a partial beam group, and the reference's one for one."""
    freqs = _freqs(64)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0)
    spectra = []
    for b in range(5):
        x, _ = _pulse_spectrogram(1500, 64, 90.0, 400 + 50 * b, 4,
                                  amp=0.8 if b % 2 else 0.0, seed=b)
        spectra.append((b, x))
    kw = dict(threshold=7.0, chunk_t=512, method=method)
    by_beam = search_spectrograms(spectra, freqs, TSAMP, dms, beam_batch=2,
                                  device=CPU, **kw)
    ref_by_beam = J.search_spectrograms(spectra, freqs, TSAMP, dms,
                                        beam_batch=2, **kw)
    for b, x in spectra:
        ref = search_spectrogram(x, freqs, TSAMP, dms, device=CPU, **kw)
        got = by_beam[b]
        assert len(got) == len(ref), (method, b)
        for cg, cr in zip(got, ref):
            assert cg == dataclasses.replace(cr, beam=b), (method, b)
        _same_candidates(got, ref_by_beam[b], method)


def test_batched_search_validation():
    freqs = _freqs(16)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=50.0)
    x = np.zeros((256, 16), np.float32)
    with pytest.raises(ValueError, match="no spectra"):
        search_spectrograms([], freqs, TSAMP, dms, device=CPU)
    with pytest.raises(ValueError, match="duplicate"):
        search_spectrograms([(0, x), (0, x)], freqs, TSAMP, dms, device=CPU)
    with pytest.raises(ValueError, match="shapes differ"):
        search_spectrograms([(0, x), (1, x[:-1])], freqs, TSAMP, dms,
                            device=CPU)


def _feed(mon, x, t_out, beam=1, n_beams=4, seq0=0, skip=None):
    """Slice ``[T, F]`` into ``[F, t_out, n_beams]`` product blocks
    (spectrogram in ``beam``, noise elsewhere) and feed ``mon``."""
    rng = np.random.default_rng(99)
    for i in range(x.shape[0] // t_out):
        if skip is not None and i == skip:
            continue
        sl = x[i * t_out: (i + 1) * t_out]
        block = rng.normal(size=(x.shape[1], t_out, n_beams)
                           ).astype(np.float32)
        block[:, :, beam] = sl.T
        mon.observe(seq0 + i, block)


def _monitor_pair(freqs, dms, **kw):
    return (SearchMonitor(freqs, TSAMP, dms, device=CPU, **kw),
            J.SearchMonitor(freqs, TSAMP, dms, **kw))


@pytest.mark.parametrize("method", ["direct", "conv"])
def test_search_monitor_matches_offline_and_jax(method):
    dm_true, t0 = 90.0, 700
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, 4, amp=1.0, seed=21)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    mon, jmon = _monitor_pair(freqs, dms, beam=1, threshold=7.5,
                              chunk_t=512, method=method)
    for m in (mon, jmon):
        _feed(m, x, t_out=128)
        m.flush()
    _same_candidates(mon.candidates, jmon.candidates, method)
    assert mon.searched_windows == jmon.searched_windows >= 3
    if method == "direct":
        offline = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                                     chunk_t=512, device=CPU)
        best_off = offline[0]
        best_live = max(mon.candidates, key=lambda c: c.snr)
        assert best_live.t_samp == best_off.t_samp
        assert best_live.dm == best_off.dm
        assert best_live.snr == pytest.approx(best_off.snr, rel=1e-5)
    assert len([c for c in mon.candidates if abs(c.t_samp - t0) < 64]) == 1


def test_search_monitor_gap_resets():
    x, freqs = _pulse_spectrogram(1024, 64, 90.0, 200, 4, amp=1.0, seed=4)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    mon, jmon = _monitor_pair(freqs, dms, beam=1, threshold=7.5,
                              chunk_t=512)
    for m in (mon, jmon):
        _feed(m, x, t_out=128, skip=5)  # drop block 5 (t 640-768)
        m.flush()
    assert mon.gaps == jmon.gaps == 1
    assert any(abs(c.t_samp - 200) < 32 for c in mon.candidates)
    _same_candidates(mon.candidates, jmon.candidates, "conv")


def test_search_monitor_incoherent_and_stokes_extraction():
    x, freqs = _pulse_spectrogram(512, 32, 60.0, 100, 4, amp=1.5, seed=8)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=150.0, tol=1.25)
    mon, jmon = _monitor_pair(freqs, dms, incoherent=True, threshold=7.0,
                              chunk_t=256)
    assert not mon.wants_beams
    for m in (mon, jmon):
        for i in range(4):
            m.observe(i, None, inco=x[i * 128:(i + 1) * 128].T)
        m.flush()
    assert any(abs(c.t_samp - 100) < 16 for c in mon.candidates)
    _same_candidates(mon.candidates, jmon.candidates, "conv")
    with pytest.raises(ValueError, match="incoherent"):
        mon.observe(99, np.zeros((32, 8, 2), np.float32), inco=None)
    mon2 = SearchMonitor(freqs, TSAMP, dms, beam=0, threshold=7.0,
                         chunk_t=256, device=CPU)
    for i in range(4):
        blk = np.zeros((32, 128, 4, 2), np.float32)
        blk[:, :, 0, 0] = x[i * 128:(i + 1) * 128].T
        blk[:, :, 1:, :] = 0.1
        mon2.observe(i, blk)
    mon2.flush()
    assert any(abs(c.t_samp - 100) < 16 for c in mon2.candidates)
    mon3 = SearchMonitor(freqs, TSAMP, dms, beam=7, chunk_t=256, device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        mon3.observe(0, np.zeros((32, 128, 2), np.float32))


def test_search_monitor_observe_selected_equals_observe():
    """The streaming loop's way in (beams selected from the product, here
    on the CPU) equals the whole-product way in, for one beam and a set,
    float32 and uint8."""
    rng = np.random.default_rng(12)
    freqs = _freqs(16)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=100.0)
    for beam in (2, [0, 2, 3]):
        for dtype in (np.float32, np.uint8):
            a = SearchMonitor(freqs, TSAMP, dms, beam=beam, chunk_t=64,
                              device=CPU)
            b = SearchMonitor(freqs, TSAMP, dms, beam=beam, chunk_t=64,
                              device=CPU)
            for i in range(6):
                blk = (rng.random((16, 32, 4)) * 200).astype(dtype)
                a.observe(i, blk)
                sel = b.select_beams(torch.from_numpy(blk)).numpy()
                b.observe_selected(i, sel)
                assert np.array_equal(a._concat(), b._concat())
            a.flush()
            b.flush()
            assert a.candidates == b.candidates


def test_search_monitor_multibeam_coincidence():
    """beam='all' searches every beam batched: broadband RFI in all beams is
    rejected per window, the localized pulse survives with its beam; a beam
    set and coincidence=False behave as documented; one for one with the
    reference's monitor."""
    dm_true, t0 = 90.0, 700
    n_beams, t_out, T = 8, 128, 2048
    xs, freqs = [], None
    for b in range(n_beams):
        x, freqs = _pulse_spectrogram(T, 64, dm_true, t0, 4,
                                      amp=1.0 if b in (3, 4) else 0.0,
                                      seed=60 + b)
        x[300:302, :] += 3.0  # broadband RFI in every beam
        xs.append(x)
    blocks = [np.stack([xs[b][i * t_out:(i + 1) * t_out].T
                        for b in range(n_beams)], axis=-1)
              for i in range(T // t_out)]
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)

    def run(**kw):
        rfi_log, jrfi_log = [], []
        mon, jmon = _monitor_pair(freqs, dms, threshold=7.0, chunk_t=512,
                                  **kw)
        mon.on_rfi, jmon.on_rfi = rfi_log.append, jrfi_log.append
        for m in (mon, jmon):
            for i, blk in enumerate(blocks):
                m.observe(i, blk)
            m.flush()
        _same_candidates(mon.candidates, jmon.candidates, "conv")
        assert mon.rfi_rejected == jmon.rfi_rejected
        assert [e["t_samp"] for e in rfi_log] \
            == [e["t_samp"] for e in jrfi_log]
        return mon, rfi_log

    mon, rfi_log = run(beam="all")
    assert mon.wants_beams
    assert mon.rfi_rejected >= 1 and rfi_log
    assert max(ev["n_beams"] for ev in rfi_log) >= 6
    hits = {c.beam for c in mon.candidates if abs(c.t_samp - t0) < 32}
    assert hits and hits <= {3, 4}
    assert not any(abs(c.t_samp - 300) < 16 for c in mon.candidates)

    mon2, _ = run(beam=[2, 3, 4, 5])
    assert mon2.rfi_rejected >= 1
    assert {c.beam for c in mon2.candidates} <= {2, 3, 4, 5}
    assert any(abs(c.t_samp - t0) < 32 for c in mon2.candidates)

    mon3, _ = run(beam="all", coincidence=False)
    assert mon3.rfi_rejected == 0
    assert any(abs(c.t_samp - 300) < 16 for c in mon3.candidates)

    with pytest.raises(ValueError, match="duplicate"):
        SearchMonitor(freqs, TSAMP, dms, beam=[1, 1], device=CPU)
    with pytest.raises(ValueError, match="empty"):
        SearchMonitor(freqs, TSAMP, dms, beam=[], device=CPU)
    with pytest.raises(ValueError, match="incoherent"):
        SearchMonitor(freqs, TSAMP, dms, beam="all", incoherent=True,
                      device=CPU)
    mon4 = SearchMonitor(freqs, TSAMP, dms, beam=[1, 99], device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        mon4.observe(0, np.zeros((64, 128, 8), np.float32))


def test_search_monitor_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        SearchMonitor(_freqs(16), TSAMP, np.array([0.0, 10.0]))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        dedisperse_bank(np.zeros((64, 16), np.float32),
                        np.zeros((2, 16), np.int32))
