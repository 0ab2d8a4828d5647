"""The port's dedispersion search (``ops/dedisperse.py``) on the CPU, where
every bank runs its kernels' plain versions: the JAX package's search tests
on the port, and the same seeded inputs through both packages: the trial
grid and delay table exact, the ``direct`` and ``subband`` banks equal bit
for bit (both sum the same float32 values in the same order from zero), the
``conv`` bank within float tolerance up to ``valid_len - max_err`` (the
reference sums it in a convolution, in another order; past that the plan
may read the tail fill), and the candidates one for one, S/N included.
The multi-beam and streaming searches are in
``tests/test_torch_dedisperse_search.py``."""

import dataclasses

import numpy as np
import pytest

import dsabeamformer_tpu.ops.dedisperse as J
import dsabeamformer_tpu_torch.ops.dedisperse as P
from dsabeamformer_tpu_torch.config import DM_CONST_S, DSA10, dm_delays_s
from dsabeamformer_tpu_torch.ops.dedisperse import (
    Candidate,
    SearchMonitor,
    coincidence_filter,
    conv_dedisperse_bank,
    conv_dedisperse_bank_batch,
    dedisperse_bank,
    dedisperse_bank_batch,
    delay_table,
    dm_trial_grid,
    preprocess_spectrogram,
    read_candidates,
    search_spectrogram,
    subband_dedisperse_bank,
    subband_dedisperse_bank_batch,
    subband_plan,
    write_candidates,
)

F_LO, F_HI = 1280.0, 1530.0  # MHz, the dsa10 band
TSAMP = 1.048576e-3          # s
CPU = "cpu"
#: conv bank against the reference's one-hot convolution (another float32
#: summation order over the same values).
CONV_RTOL, CONV_ATOL = 1e-5, 1e-4
#: S/N on the conv bank against the reference's (the bank's rounding).
CONV_SNR_RTOL = 1e-5


def _freqs(nf):
    return np.linspace(F_LO, F_HI, nf)


def _pulse_spectrogram(t, nf, dm, t0, width, amp, seed=0):
    """White noise plus a dispersed boxcar pulse of per-channel height
    ``amp`` sigma, arriving at the band top at sample ``t0``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, nf)).astype(np.float32)
    freqs = _freqs(nf)
    shifts = np.rint(dm_delays_s(freqs, dm, freqs[-1]) / TSAMP).astype(int)
    for f in range(nf):
        a = t0 + shifts[f]
        x[a: a + width, f] += amp
    return x, freqs


def _same_candidates(port, ref, method="direct"):
    """One for one, every field equal; the S/N too for the ``direct`` and
    ``subband`` banks (the same banks, the same cumulative-sum order,
    ``_cumsum_blocked``, and the same float64 scaling); within
    ``CONV_SNR_RTOL`` for ``conv``, whose reference bank rounds in another
    order."""
    assert len(port) == len(ref), (port, ref)
    for cp, cr in zip(port, ref):
        if method == "conv":
            assert cp.snr == pytest.approx(cr.snr, rel=CONV_SNR_RTOL)
            cp = dataclasses.replace(cp, snr=cr.snr)
        assert dataclasses.asdict(cp) == dataclasses.asdict(cr)


def test_dm_grid_spacing_and_validation():
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=500.0, tol=1.25)
    assert np.array_equal(dms, J.dm_trial_grid(F_LO, F_HI, TSAMP, 500.0))
    assert dms[0] == 0.0 and dms[-1] >= 500.0
    step = dms[1] - dms[0]
    span = DM_CONST_S * step * (F_LO ** -2.0 - F_HI ** -2.0)
    assert span == pytest.approx(1.25 * TSAMP, rel=1e-12)
    assert np.allclose(np.diff(dms), step)
    with pytest.raises(ValueError):
        dm_trial_grid(F_HI, F_LO, TSAMP, 100.0)
    with pytest.raises(ValueError):
        dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=1.0, dm_min=2.0)
    assert dm_trial_grid(F_LO, F_HI, TSAMP, 7.0, dm_min=7.0).tolist() == [7.0]


@pytest.mark.parametrize("nf,dms", [(64, [0.0, 50.0, 300.0]),
                                    (96, None), (2048, None)])
def test_delay_table_equals_jax(nf, dms):
    freqs = _freqs(nf)
    if dms is None:
        dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=400.0)
    dms = np.asarray(dms)
    d = delay_table(freqs, dms, TSAMP)
    assert d.dtype == np.int32 and d.shape == (len(dms), nf)
    assert np.array_equal(d, J.delay_table(freqs, dms, TSAMP))
    assert np.all(d[:, -1] == 0) and np.all(np.diff(d, axis=1) <= 0)
    expect = np.rint(dm_delays_s(freqs, dms[-1], freqs[-1]) / TSAMP)
    assert np.array_equal(d[-1], expect.astype(np.int32))


def test_dedisperse_bank_matches_numpy_golden():
    rng = np.random.default_rng(7)
    t, nf = 128, 16
    x = rng.normal(size=(t, nf)).astype(np.float32)
    dms = np.array([0.0, 30.0, 120.0, 400.0])
    delays = delay_table(_freqs(nf), dms, TSAMP * 50)
    assert delays.max() > 0
    bank, valid = dedisperse_bank(x, delays, device=CPU)
    bank = bank.numpy()
    fill = np.median(x, axis=0)
    padded = np.concatenate(
        [x, np.broadcast_to(fill, (int(delays.max()), nf))], axis=0)
    golden = np.zeros((len(dms), t), np.float64)
    for d in range(len(dms)):
        for f in range(nf):
            golden[d] += padded[delays[d, f]: delays[d, f] + t, f]
    assert np.allclose(bank, golden, rtol=1e-5, atol=1e-4)
    assert np.array_equal(valid, t - delays.max(axis=1))
    assert np.allclose(bank[0], x.sum(axis=1), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fn", [dedisperse_bank, subband_dedisperse_bank,
                                conv_dedisperse_bank])
def test_banks_reject_bad_tables(fn):
    x = np.zeros((32, 8), np.float32)
    with pytest.raises(ValueError, match="channels"):
        fn(x, np.zeros((2, 4), np.int32), device=CPU)
    with pytest.raises(ValueError, match="negative"):
        fn(x, np.full((2, 8), -1, np.int32), device=CPU)


BANK_CASES = {
    "pad96": (768, 96, 300.0, 3),      # 96 channels: pad path at n_sub 10
    "small": (512, 32, 200.0, 2),
    "uint8": (1024, 64, 250.0, 7),
}


def _bank_input(case):
    t, nf, dm_max, seed = BANK_CASES[case]
    rng = np.random.default_rng(seed)
    if case == "uint8":
        x = rng.integers(0, 256, size=(t, nf), dtype=np.uint8)
    else:
        x = rng.normal(size=(t, nf)).astype(np.float32)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=dm_max)
    return x, delay_table(_freqs(nf), dms, TSAMP)


@pytest.mark.parametrize("case", sorted(BANK_CASES))
def test_direct_bank_equals_jax_bit_for_bit(case):
    x, delays = _bank_input(case)
    bp, vp = dedisperse_bank(x, delays, device=CPU)
    bj, vj = J.dedisperse_bank(x, delays)
    assert np.array_equal(vp, vj)
    assert np.array_equal(bp.numpy(), np.asarray(bj))


#: (case, n_sub): padded last groups (96 / 10, 32 / 6, 64 / 10) and none.
SUB_CASES = [(c, n) for c in sorted(BANK_CASES)
             for n in ((4, 6) if c == "small" else (4, 10))]


@pytest.mark.parametrize("case,n_sub", SUB_CASES)
def test_subband_bank_equals_jax_bit_for_bit(case, n_sub):
    x, delays = _bank_input(case)
    bp, vp = subband_dedisperse_bank(x, delays, n_sub=n_sub, device=CPU)
    bj, vj = J.subband_dedisperse_bank(x, delays, n_sub=n_sub)
    assert np.array_equal(vp, vj)
    assert np.array_equal(bp.numpy(), np.asarray(bj))


@pytest.mark.parametrize("case,n_sub", SUB_CASES + [
    (c, None) for c in sorted(BANK_CASES)])
def test_conv_bank_equals_jax_up_to_valid_len(case, n_sub):
    """Past ``valid_len - max_err`` the plan's shifts may read the tail
    fill; before it, the same sums as the reference's."""
    x, delays = _bank_input(case)
    bp, vp = conv_dedisperse_bank(x, delays, n_sub=n_sub, device=CPU)
    bj, vj = J.conv_dedisperse_bank(x, delays, n_sub=n_sub)
    assert np.array_equal(vp, vj)
    bp, bj = bp.numpy(), np.asarray(bj)
    for d in range(len(vp)):
        n = max(0, int(vp[d]) - 1)
        np.testing.assert_allclose(bp[d, :n], bj[d, :n], rtol=CONV_RTOL,
                                   atol=CONV_ATOL)


@pytest.mark.parametrize("method", ["direct", "subband", "conv"])
def test_batched_banks_equal_jax_and_per_beam(method):
    rng = np.random.default_rng(5)
    xb = rng.normal(size=(3, 512, 32)).astype(np.float32)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=150.0, tol=1.25)
    delays = delay_table(_freqs(32), dms, TSAMP)
    port = {"direct": (dedisperse_bank_batch, dedisperse_bank, {}),
            "subband": (subband_dedisperse_bank_batch,
                        subband_dedisperse_bank, {"n_sub": 4}),
            "conv": (conv_dedisperse_bank_batch, conv_dedisperse_bank,
                     {"n_sub": 4})}[method]
    ref = {"direct": J.dedisperse_bank_batch,
           "subband": J.subband_dedisperse_bank_batch,
           "conv": J.conv_dedisperse_bank_batch}[method]
    bb, vb = port[0](xb, delays, device=CPU, **port[2])
    jb, jv = ref(xb, delays, **port[2])
    assert np.array_equal(vb, jv)
    if method == "conv":
        np.testing.assert_allclose(bb.numpy()[..., :int(vb.min()) - 1],
                                   np.asarray(jb)[..., :int(vb.min()) - 1],
                                   rtol=CONV_RTOL, atol=CONV_ATOL)
    else:
        assert np.array_equal(bb.numpy(), np.asarray(jb))
    for i in range(3):
        bi, vi = port[1](xb[i], delays, device=CPU, **port[2])
        assert np.array_equal(vb, vi)
        assert np.array_equal(bb[i].numpy(), bi.numpy())


def test_conv_plan_cache():
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=150.0, tol=1.25)
    delays = delay_table(_freqs(32), dms, TSAMP)
    assert P._conv_plan(delays, 4, 1) is P._conv_plan(delays, 4, 1)


@pytest.mark.parametrize("budget", [0, 1])
def test_two_stage_banks_exact_at_zero_budget(budget):
    """max_err_samples=0: the two-stage banks equal the brute-force bank to
    float tolerance (the same sums, grouped)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(512, 32)).astype(np.float32)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=200.0, tol=1.25)
    delays = delay_table(_freqs(32), dms, TSAMP)
    b0, v0 = dedisperse_bank(x, delays, device=CPU)
    for fn in (subband_dedisperse_bank, conv_dedisperse_bank):
        b1, v1 = fn(x, delays, n_sub=4, max_err_samples=budget, device=CPU)
        assert np.array_equal(v0, v1)
        if budget == 0:
            assert np.allclose(b0.numpy(), b1.numpy(), rtol=1e-4, atol=1e-3)


def test_subband_plan_error_bound_and_equals_jax():
    freqs = _freqs(96)  # not divisible by n_sub=10 -> exercises pad
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=400.0, tol=1.25)
    delays = delay_table(freqs, dms, TSAMP)
    n_sub, err = 10, 1
    plan = subband_plan(delays, n_sub, err)
    for a, b in zip(plan, J.subband_plan(delays, n_sub, err)):
        assert np.array_equal(a, b)
    intra_c, inter, rep_of, pad_f = plan
    g, n_coarse, c = intra_c.shape
    assert g == n_sub and pad_f == n_sub * c - 96
    assert n_coarse < len(dms) / 3
    padded = np.concatenate(
        [delays, np.zeros((len(dms), pad_f), delays.dtype)], axis=1)
    intra = padded.reshape(len(dms), n_sub, c) - inter[:, :, None]
    intra[:, -1, c - pad_f:] = 0
    for d in range(len(dms)):
        assert np.abs(intra[d] - intra_c[:, rep_of[d], :]).max() <= err
    recon = inter[:, :, None] + intra
    assert np.array_equal(recon.reshape(len(dms), -1)[:, :96], delays)


def test_conv_auto_n_sub_equals_jax():
    """The auto group count at DSA-10 width, with the reference's
    +-1-sample quirk included (the worst span at the pick <= 64)."""
    cfg = DSA10
    ts = cfg.sample_period_s * cfg.navg_time
    f = cfg.freqs_hz() / 1e6
    picks = {}
    for dm in (100.0, 300.0, 1000.0):
        dms = dm_trial_grid(float(f.min()), float(f.max()), ts, dm_max=dm)
        delays = delay_table(f, dms, ts)
        picks[dm] = P._conv_auto_n_sub(delays)
        assert picks[dm] == J._conv_auto_n_sub(delays)
    assert picks[100.0] == 16 and picks[1000.0] > picks[100.0]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(512, 64)).astype(np.float32)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=200.0, tol=1.25)
    delays = delay_table(_freqs(64), dms, TSAMP)
    b_auto, v_auto = conv_dedisperse_bank(x, delays, device=CPU)
    b_ref, v_ref = subband_dedisperse_bank(
        x, delays, n_sub=P._conv_auto_n_sub(delays), device=CPU)
    assert np.array_equal(v_auto, v_ref)
    assert np.allclose(b_auto.numpy(), b_ref.numpy(), rtol=1e-4, atol=1e-3)


def test_conv_bank_uint8_equals_float_path():
    """uint8 input (the fused 8-bit products) gives the float input's bank
    in the data-covered region: the fill is rounded, the sums exact."""
    rng = np.random.default_rng(7)
    x8 = rng.integers(0, 256, size=(1024, 64), dtype=np.uint8)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=250.0, tol=1.25)
    delays = delay_table(_freqs(64), dms, TSAMP)
    b8, v8 = conv_dedisperse_bank(x8, delays, device=CPU)
    bf, vf = conv_dedisperse_bank(x8.astype(np.float32) + 0.0, delays,
                                  device=CPU)
    assert np.array_equal(v8, vf)
    a8, af = b8.numpy(), bf.numpy()
    for d in range(len(dms)):
        n = max(0, int(v8[d]) - 1)
        assert np.array_equal(a8[d, :n], af[d, :n]), d


@pytest.mark.parametrize("method", ["direct", "subband", "conv"])
def test_search_recovers_injected_pulse_as_jax(method):
    """The injected-pulse drill: found at its DM, time and width, one
    cluster, and candidates one for one with the reference's."""
    dm_true, t0, w_true = 90.0, 700, 4
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, w_true, amp=1.0)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    kw = dict(threshold=7.0, method=method, n_sub=8)
    cands = search_spectrogram(x, freqs, TSAMP, dms, device=CPU, **kw)
    _same_candidates(cands, J.search_spectrogram(x, freqs, TSAMP, dms, **kw),
                     method)
    best = cands[0]
    assert best.snr > 10.0
    step = dms[1] - dms[0]
    assert abs(best.dm - dm_true) <= 2 * step
    assert abs(best.t_samp - t0) <= 2 * w_true
    assert best.width in (w_true // 2, w_true, 2 * w_true)
    assert best.members > 1
    dupes = [c for c in cands[1:]
             if abs(c.t_samp - t0) < 32 and abs(c.dm - dm_true) < 4 * step]
    assert not dupes


@pytest.mark.parametrize("method", ["direct", "subband", "conv"])
def test_search_pure_noise_is_quiet(method):
    rng = np.random.default_rng(3 if method == "direct" else 6)
    x = rng.normal(size=(2048, 64)).astype(np.float32)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    assert search_spectrogram(x, _freqs(64), TSAMP, dms, threshold=8.0,
                              method=method, n_sub=8, device=CPU) == []


@pytest.mark.parametrize("method", ["subband", "conv"])
def test_two_stage_search_recovers_pulse_comparably(method):
    dm_true, t0 = 150.0, 900
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, 4, amp=1.0,
                                  seed=31)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    direct = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                                device=CPU)
    approx = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                                method=method, n_sub=8, device=CPU)
    assert direct and approx
    d0, s0 = direct[0], approx[0]
    assert abs(s0.t_samp - d0.t_samp) <= 4
    assert abs(s0.dm - d0.dm) <= 4 * (dms[1] - dms[0])
    assert s0.snr > 0.9 * d0.snr


def test_search_method_validation():
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=100.0, tol=1.25)
    with pytest.raises(ValueError, match="conv|direct|subband"):
        SearchMonitor(_freqs(32), TSAMP, dms, method="fft", device=CPU)
    x = np.zeros((256, 32), np.float32)
    with pytest.raises(ValueError, match="conv|direct|subband"):
        search_spectrogram(x, _freqs(32), TSAMP, dms, method="fft",
                           device=CPU)


def test_zerodm_kills_broadband_rfi_keeps_pulse():
    dm_true, t0 = 90.0, 700
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, 4, amp=1.2,
                                  seed=13)
    x[300:302, :] += 4.0  # broadband impulsive RFI, all channels
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    dirty = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                               device=CPU)
    rfi_hits = [c for c in dirty if abs(c.t_samp - 300) < 16]
    assert rfi_hits and rfi_hits[0].dm < 10.0
    clean = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                               zerodm=True, device=CPU)
    _same_candidates(clean, J.search_spectrogram(
        x, freqs, TSAMP, dms, threshold=7.5, zerodm=True))
    assert not [c for c in clean if abs(c.t_samp - 300) < 16]
    pulse = [c for c in clean if abs(c.t_samp - t0) < 32]
    assert pulse and abs(pulse[0].dm - dm_true) < 10.0


def test_zap_kills_bursty_channel_keeps_pulse():
    rng = np.random.default_rng(17)
    dm_true, t0 = 90.0, 700
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, 4, amp=1.2,
                                  seed=17)
    bursts = rng.choice(1800, size=40, replace=False)
    x[bursts, 20] += 30.0  # hot bursty channel
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    dirty = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                               device=CPU)
    clean = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                               zap=[20], device=CPU)
    assert len(clean) < len(dirty)
    pulse = [c for c in clean if abs(c.t_samp - t0) < 32]
    assert pulse and abs(pulse[0].dm - dm_true) < 10.0
    assert len(clean) == 1


def test_preprocess_validation_and_equals_jax():
    x = np.ones((16, 4), np.float32)
    with pytest.raises(ValueError, match="outside"):
        preprocess_spectrogram(x, zap=[4])
    with pytest.raises(ValueError, match="every channel"):
        preprocess_spectrogram(x, zap=[0, 1, 2, 3])
    y = preprocess_spectrogram(x, zap=[1], zerodm=True)
    assert np.all(y[:, 1] == 0.0)
    assert np.allclose(y[:, [0, 2, 3]], 0.0)
    assert x[0, 1] == 1.0  # input untouched
    z = np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)
    assert np.array_equal(preprocess_spectrogram(z, zap=[3, 5], zerodm=True),
                          J.preprocess_spectrogram(z, zap=[3, 5],
                                                   zerodm=True))


def test_coincidence_filter_unit():
    """A cluster hitting most beams is RFI; a two-beam pulse is kept; the
    reference's filter agrees."""
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    span = delay_table(_freqs(64), dms, TSAMP).max(axis=1)

    def by_beam(cls):
        out = {}
        for b in range(24):
            cs = []
            if b < 20:  # broadband RFI fires low-DM in 20 of 24 beams
                cs.append(cls(snr=9.0 + 0.1 * b, t_samp=300,
                              time_s=300 * TSAMP, width=2, dm_idx=1,
                              dm=float(dms[1]), members=5,
                              dm_lo=float(dms[1]), dm_hi=float(dms[1]),
                              beam=b))
            if b in (3, 4):  # the sky pulse: two adjacent beams
                cs.append(cls(snr=14.0 - b, t_samp=700, time_s=700 * TSAMP,
                              width=4, dm_idx=30, dm=float(dms[30]),
                              members=5, dm_lo=float(dms[30]),
                              dm_hi=float(dms[30]), beam=b))
            out[b] = cs
        return out

    kept, rfi = coincidence_filter(by_beam(Candidate), span,
                                   n_beams_searched=24)
    jkept, jrfi = J.coincidence_filter(by_beam(J.Candidate), span,
                                       n_beams_searched=24)
    assert rfi == jrfi
    assert len(rfi) == 1 and rfi[0]["n_beams"] == 20
    assert rfi[0]["t_samp"] == 300
    remaining = [c for cs in kept.values() for c in cs]
    assert sorted(c.beam for c in remaining) == [3, 4] \
        == sorted(c.beam for cs in jkept.values() for c in cs)
    with pytest.raises(ValueError):
        coincidence_filter(by_beam(Candidate), span, 24, frac=0.0)


def test_write_candidates_roundtrip(tmp_path):
    c = Candidate(snr=12.5, t_samp=700, time_s=0.7339, width=4, dm_idx=31,
                  dm=90.2, members=17, dm_lo=85.0, dm_hi=95.5)
    p = tmp_path / "out.cand"
    write_candidates(p, [c], {"threshold": 7.0, "file": "x.fil"})
    assert p.read_text() == _jax_cand_text(tmp_path, c)
    lines = p.read_text().splitlines()
    assert any(line.startswith("# threshold = 7.0") for line in lines)
    row = lines[-1].split()
    assert float(row[0]) == 12.5 and int(row[1]) == 700
    assert float(row[5]) == pytest.approx(90.2)
    meta, back = read_candidates(p)
    assert meta["threshold"] == 7.0 and meta["file"] == "x.fil"
    assert len(back) == 1 and back[0] == dataclasses.replace(c, beam=-1)
    p9 = tmp_path / "old.cand"
    p9.write_text(" ".join(c.row().split()[:9]) + "\n")
    _, old = read_candidates(p9)
    assert old[0].beam == -1 and old[0].t_samp == 700
    pbad = tmp_path / "bad.cand"
    pbad.write_text("1 2 3\n")
    with pytest.raises(ValueError, match="columns"):
        read_candidates(pbad)


def _jax_cand_text(tmp_path, c) -> str:
    q = tmp_path / "jax.cand"
    J.write_candidates(q, [J.Candidate(**dataclasses.asdict(c))],
                       {"threshold": 7.0, "file": "x.fil"})
    return q.read_text()
