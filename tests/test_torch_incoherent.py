"""The port's ``ops/incoherent.py`` (torch ops) against the JAX package's
XLA versions on the same wire: the incoherent sum, the drive-level
diagnostics, the spectral-kurtosis accumulators and the host helpers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ops.incoherent as jinc
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ops.incoherent as pinc
from dsabeamformer_tpu.ingest.generator import make_tone_block as jmake_tone_block
from dsabeamformer_tpu.models.weights import parse_zap
from dsabeamformer_tpu_torch.ingest.generator import (
    make_noise_block,
    make_random_bytes_block,
    make_tone_block,
)
from dsabeamformer_tpu_torch.ops.gemm import device_wire_view

#: wire_level_stats: both sum float32 values, in different orders.
LEVEL_RTOL = 1e-6
#: SK accumulators: JAX sums in float32, the port exactly in int64.
SK_RTOL = 1e-6

CFGS = {
    "tiny": (jcfg.TINY, pcfg.TINY),
    "dsa10_small": (jcfg.DSA10.replace(n_chan=8, t_block=64, time_tile=64),
                    pcfg.DSA10.replace(n_chan=8, t_block=64)),
}


def _cfgs(name="tiny", **kw):
    return tuple(c.replace(**kw) for c in CFGS[name])


@pytest.mark.parametrize("navg_freq", [1, 2])
@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_incoherent_power_equal_jax(name, layout, navg_freq):
    jc, pc = _cfgs(name, input_layout=layout, navg_freq=navg_freq)
    wire = make_noise_block(pc, rms=2.5, seed=42)
    want = np.asarray(jinc.incoherent_power(jnp.asarray(wire), jc))
    got = pinc.incoherent_power(wire, pc)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (pc.n_chan // navg_freq,
                                pc.t_block // pc.navg_time)
    np.testing.assert_array_equal(got.numpy(), want)
    # The canonical device form gives the same.
    dev = pinc.incoherent_power(torch.from_numpy(device_wire_view(wire, pc)),
                                pc)
    assert torch.equal(dev, got)
    np.testing.assert_allclose(got.numpy(),
                               jinc.incoherent_power_golden(wire, jc),
                               rtol=1e-12)  # the f64 golden's rounding


@pytest.mark.parametrize("flags", [(1,), (0, 5)])
def test_incoherent_flag_ants_equal_jax(flags):
    jc, pc = _cfgs()
    wire = make_noise_block(pc, rms=2.0, seed=22)
    want = np.asarray(jinc.incoherent_power(jnp.asarray(wire), jc,
                                            flag_ants=flags))
    got = pinc.incoherent_power(wire, pc, flag_ants=flags)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got < pinc.incoherent_power(wire, pc)).all()
    np.testing.assert_array_equal(
        pinc.incoherent_power_golden(wire, pc, flags),
        jinc.incoherent_power_golden(wire, jc, flags))
    with pytest.raises(ValueError, match="out of range"):
        pinc.incoherent_power(wire, pc, flag_ants=(pc.n_ant_active,))


@pytest.mark.parametrize("rms", [1.0, 6.0])
def test_wire_level_stats_vs_jax(rms):
    jc, pc = _cfgs()
    wire = make_noise_block(pc, rms=rms, seed=3)
    want = jinc.wire_level_stats(jnp.asarray(wire), jc)
    got = pinc.wire_level_stats(wire, pc)
    assert got["rms"].shape == (pc.n_ant_active,)
    for k in ("rms", "clip_fraction"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=LEVEL_RTOL)
    if rms == 1.0:
        assert np.all(np.abs(got["rms"].numpy() - 1.0) < 0.1)
    else:
        assert np.all(got["clip_fraction"].numpy() > 0.2)


def test_wire_level_stats_railed_antenna():
    """An antenna sitting on the -8 rail: rms 8, every component clipped
    (the float32 sums keep this finite at DSA-10 block lengths, where an
    int32 sum of 33.5M samples x 128 would overflow)."""
    cfg = pcfg.DSA10.replace(n_chan=16, t_block=256)
    wire = make_noise_block(cfg, rms=2.0, seed=4).reshape(
        cfg.wire_block_shape).copy()
    wire[..., 0] = 0x88  # re = im = -8 on antenna 0
    got = pinc.wire_level_stats(wire, cfg)
    assert float(got["rms"][0]) == 8.0
    assert float(got["clip_fraction"][0]) == 1.0
    assert (got["rms"][1:] < 3.0).all()


@pytest.mark.parametrize("axis", ["chan", "ant", "both"])
@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_sk_block_stats_vs_jax(name, layout, axis):
    jc, pc = _cfgs(name, input_layout=layout)
    wire = make_random_bytes_block(pc, seed=9)
    want = jinc.sk_block_stats(jnp.asarray(wire), jc, axis=axis)
    got = pinc.sk_block_stats(wire, pc, axis=axis)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=SK_RTOL)
    assert pinc.sk_samples_per_block(pc, "chan") == \
        jinc.sk_samples_per_block(jc, "chan")
    assert pinc.sk_samples_per_block(pc, "ant") == \
        jinc.sk_samples_per_block(jc, "ant")


def test_sk_estimate_flags_and_zap_spec_match_jax():
    jc, pc = _cfgs()
    wire = make_noise_block(pc, rms=2.0, seed=9)
    st = pinc.sk_block_stats(wire, pc)
    m = pinc.sk_samples_per_block(pc)
    sk = pinc.sk_estimate(st["s1"], st["s2"], m)
    np.testing.assert_array_equal(sk, jinc.sk_estimate(st["s1"].numpy(),
                                                       st["s2"].numpy(), m))
    assert np.all(np.abs(sk - 1.0) < 0.5)
    for vec in (sk, np.array([1.0, 1.01, 0.2, np.nan, 0.99]),
                np.array([np.nan, np.nan])):
        assert pinc.sk_flags(vec, m) == pytest.approx(jinc.sk_flags(vec, m),
                                                      nan_ok=True)
    for chans in ([], [5], [1, 2, 3], [0, 2, 3, 4, 9], [7, 7, 6]):
        spec = pinc.format_zap_spec(chans)
        assert spec == jinc.format_zap_spec(chans)
        assert parse_zap(spec) == sorted(set(chans))


def test_sk_flags_tone_and_impulse():
    """A CW carrier drives SK far below 1, an impulsive burst far above;
    both are flagged, and nothing else (mirrors the JAX package's test on
    the port's generator and ops)."""
    cfg = pcfg.TINY
    wire = make_noise_block(cfg, rms=2.0, seed=10).reshape(
        cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
    tone = make_tone_block(cfg, chan=2, amplitude=6.0).reshape(
        cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant)
    wire[:, 2] = tone[:, 2]                 # CW carrier in channel 2
    wire[: cfg.t_block - 4, 5] = 0          # channel 5: 4-sample burst
    st = pinc.sk_block_stats(wire.reshape(cfg.wire_block_shape), cfg)
    m = pinc.sk_samples_per_block(cfg)
    sk = pinc.sk_estimate(st["s1"], st["s2"], m)
    assert sk[2] < 0.3 and sk[5] > 3.0
    flagged, med, sigma = pinc.sk_flags(sk, m)
    assert 2 in flagged and 5 in flagged
    assert all(c in (2, 5) for c in flagged)
    assert abs(med - 1.0) < 0.3 and sigma > 0


def test_sk_dead_channel_and_bad_antenna():
    cfg = pcfg.TINY
    wire = make_noise_block(cfg, rms=2.0, seed=11).reshape(
        cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
    wire[:, 3] = 0  # dead channel: S1 == 0 -> NaN SK, always flagged
    st = pinc.sk_block_stats(wire.reshape(cfg.wire_block_shape), cfg)
    sk = pinc.sk_estimate(st["s1"], st["s2"], pinc.sk_samples_per_block(cfg))
    assert np.isnan(sk[3])
    assert 3 in pinc.sk_flags(sk, pinc.sk_samples_per_block(cfg))[0]
    wire = make_noise_block(cfg, rms=2.0, seed=14).reshape(
        cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
    wire[:, :, :, 4] = 0
    wire[:4, :, :, 4] = 0x77  # antenna 4: silent but for a burst
    st = pinc.sk_block_stats(wire.reshape(cfg.wire_block_shape), cfg,
                             axis="ant")
    m = pinc.sk_samples_per_block(cfg, axis="ant")
    flagged, med, _ = pinc.sk_flags(pinc.sk_estimate(st["s1"], st["s2"], m),
                                    m)
    assert flagged == [4] and abs(med - 1.0) < 0.3


@pytest.mark.parametrize("bad", ["axis", "dtype", "shape"])
def test_errors_match_jax(bad):
    jc, pc = _cfgs()
    wire = make_noise_block(pc, rms=2.0, seed=1)
    if bad == "axis":
        with pytest.raises(ValueError) as ej:
            jinc.sk_block_stats(jnp.asarray(wire), jc, axis="pol")
        with pytest.raises(ValueError) as ep:
            pinc.sk_block_stats(wire, pc, axis="pol")
        assert str(ep.value) == str(ej.value)
        return
    wire = wire.astype(np.uint16) if bad == "dtype" else wire[:-1]
    with pytest.raises(ValueError):
        jinc.incoherent_power(jnp.asarray(wire), jc)
    with pytest.raises(ValueError, match="uint8" if bad == "dtype"
                       else "neither"):
        pinc.incoherent_power(wire, pc)


def test_tone_generator_byte_equal_jax():
    jc, pc = _cfgs()
    for layout in ("tfpa", "ftpa"):
        np.testing.assert_array_equal(
            make_tone_block(pc.replace(input_layout=layout), chan=3,
                            amplitude=5.0, phase_step=0.2),
            jmake_tone_block(jc.replace(input_layout=layout), chan=3,
                             amplitude=5.0, phase_step=0.2))
