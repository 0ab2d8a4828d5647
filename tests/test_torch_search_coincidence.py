"""Cross-beam coincidence, live and offline, in both packages on the same
multi-beam spectrogram: the port's ``SearchMonitor`` (coincidence on, fed
block by block) against the JAX package's, and the offline path
(``search_spectrograms`` then ``coincidence_filter``) of each.

The input is a ``[B, T, F]`` spectrogram from a numpy seed: several
dispersed arrivals of one pulse, at full strength in one beam and weaker in
its neighbours (a point source's sidelobes), and one broadband burst in
every beam (RFI).  Both packages must agree one for one in each path:
candidates (DM, time, width, beam equal, S/N within 1e-5), the count of
rejected clusters, and the clusters themselves.

The reference itself keeps other arrivals live than offline on this input:
live, coincidence and the top-k act per window; offline, over the whole
run.  That is a property of the reference, not of the port."""

import numpy as np
import pytest

import dsabeamformer_tpu.ops.dedisperse as J
import dsabeamformer_tpu_torch.ops.dedisperse as P
from dsabeamformer_tpu_torch.config import dm_delays_s
from test_torch_dedisperse import (
    CPU,
    F_HI,
    F_LO,
    TSAMP,
    _freqs,
    _same_candidates,
)

N_BEAMS, N_SAMP, N_CHAN, T_OUT = 16, 1536, 32, 128
PULSE_DM, PULSE_WIDTH = 90.0, 4
ARRIVALS = [150, 450, 750, 1050, 1350]
PULSE_BEAM = 7
RFI_T = 900
CHUNK = 512
#: The S/N of the rejected clusters' brightest members, rounded to 0.01 in
#: the events: the conv bank's S/N (within 1e-5) may round the other way.
EVENT_SNR_ATOL = 0.01


def _spectrogram():
    rng = np.random.default_rng(2026)
    freqs = _freqs(N_CHAN)
    shifts = np.rint(dm_delays_s(freqs, PULSE_DM, freqs[-1])
                     / TSAMP).astype(int)
    x = rng.normal(size=(N_BEAMS, N_SAMP, N_CHAN)).astype(np.float32)
    gain = np.abs(np.sinc((np.arange(N_BEAMS) - PULSE_BEAM) / 2.5))
    for k, t0 in enumerate(ARRIVALS):
        amp = 1.6 * (0.5 + 0.25 * k)
        for f in range(N_CHAN):
            a = t0 + shifts[f]
            x[:, a:a + PULSE_WIDTH, f] += (amp * gain)[:, None]
    x[:, RFI_T:RFI_T + 2, :] += 3.0
    return x, freqs


def _arrivals_in_pulse_beam(cands) -> list:
    near = [min(ARRIVALS, key=lambda a: abs(a - c.t_samp)) for c in cands
            if c.beam == PULSE_BEAM
            and min(abs(a - c.t_samp) for a in ARRIVALS) < 32]
    return sorted(set(near))


def _same_events(port, ref):
    assert len(port) == len(ref), (port, ref)
    for ep, er in zip(port, ref):
        assert ep["snr"] == pytest.approx(er["snr"], abs=EVENT_SNR_ATOL)
        assert {k: v for k, v in ep.items() if k != "snr"} \
            == {k: v for k, v in er.items() if k != "snr"}


@pytest.fixture(scope="module")
def data():
    x, freqs = _spectrogram()
    dms = P.dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    return x, freqs, dms


def test_live_coincidence_equals_jax(data):
    """Block by block through both monitors (method conv, beam 'all',
    coincidence on): the same candidates, the same rejected clusters."""
    x, freqs, dms = data
    blocks = [np.ascontiguousarray(
        x[:, i * T_OUT:(i + 1) * T_OUT].transpose(2, 1, 0))
        for i in range(N_SAMP // T_OUT)]
    mons, events = [], []
    for mod, kw in ((P, {"device": CPU}), (J, {})):
        ev = []
        mon = mod.SearchMonitor(freqs, TSAMP, dms, beam="all",
                                threshold=7.0, chunk_t=CHUNK,
                                on_rfi=ev.append, **kw)
        for i, blk in enumerate(blocks):
            mon.observe(i, blk)
        mon.flush()
        mons.append(mon)
        events.append(ev)
    mon, jmon = mons
    _same_candidates(mon.candidates, jmon.candidates, "conv")
    assert mon.rfi_rejected == jmon.rfi_rejected == len(events[0]) >= 2
    _same_events(*events)
    assert any(e["t_samp"] == RFI_T and e["n_beams"] == N_BEAMS
               for e in events[0])
    # The strongest arrival lights enough sidelobes to be vetoed per window.
    assert _arrivals_in_pulse_beam(mon.candidates) == [150, 450, 750, 1050]


def test_offline_coincidence_equals_jax(data):
    """search_spectrograms (method direct, the CLI's default) then
    coincidence_filter through both packages: bit-equal candidates, the
    same kept set and rejected clusters; and the reference's own live /
    offline difference on this input."""
    x, freqs, dms = data
    spectra = [(b, x[b]) for b in range(N_BEAMS)]
    span = P.delay_table(freqs, dms, TSAMP).max(axis=1)
    out = []
    for mod, kw in ((P, {"device": CPU}), (J, {})):
        by_beam = mod.search_spectrograms(spectra, freqs, TSAMP, dms,
                                          threshold=7.0, **kw)
        kept, rfi = mod.coincidence_filter(by_beam, span,
                                           n_beams_searched=N_BEAMS)
        out.append((by_beam, kept, rfi))
    (pb, pk, pr), (jb, jk, jr) = out
    for b in range(N_BEAMS):
        _same_candidates(pb[b], jb[b])
        _same_candidates(pk[b], jk[b])
    assert pr == jr and [(e["t_samp"], e["n_beams"]) for e in pr] \
        == [(RFI_T, N_BEAMS)]
    offline = _arrivals_in_pulse_beam(c for cs in pk.values() for c in cs)
    assert offline == [750, 1050, 1350]
    # Beside the live monitor's [150, 450, 750, 1050]: the windows' top-k
    # and normalization keep the weak early arrivals that the whole run's
    # drop, and the window that holds the strongest arrival sees it in
    # enough beams to veto it, where the whole run does not.
    assert all(c.beam == b for b, cs in pk.items() for c in cs)
