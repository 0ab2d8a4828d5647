"""The deployed path's outputs of the port's ``beamform_power`` (its plain
version, which a CPU tensor takes): the uint8 filterbank epilogue, the
incoherent sum and the spectral-kurtosis accumulators, against the JAX
package's fused Pallas kernel in interpret mode and its standalone ops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ops.gemm as jgemm
import dsabeamformer_tpu.ops.incoherent as jinc
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ops.gemm as pgemm
import dsabeamformer_tpu_torch.ops.incoherent as pinc
import dsabeamformer_tpu_torch.ops.quantize as pq
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu_torch.ingest.generator import (
    make_noise_block,
    make_random_bytes_block,
)
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.utils.testing import relative_power_error

#: Port vs JAX float32 product (identical integers, f32 order only).
JAX_RTOL = 1e-6
#: SK accumulators vs JAX (JAX sums in float32, the port exactly in int64
#: with one rounding to float32).
SK_RTOL = 1e-6

GEOMS = {
    "tiny": (jcfg.TINY, pcfg.TINY),
    "dsa10_small": (jcfg.DSA10.replace(n_chan=8, t_block=64, time_tile=64),
                    pcfg.DSA10.replace(n_chan=8, t_block=64)),
    "dsa10c_small": (jcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64,
                                                time_tile=64),
                     pcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64)),
}


def _pair(geom, layout="tfpa", seed=5, **kw):
    jc, pc = (c.replace(input_layout=layout, **kw) for c in GEOMS[geom])
    qj = jq.prepare_weights(jc, jmake_weights(jc, cal=JCal.random(jc, seed=seed)))
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    return jc, pc, qj, qp


def _beam_scales(p32, n_beams, seed=5):
    rng = np.random.default_rng(seed)
    return (64.0 / np.median(p32) * rng.uniform(0.5, 2.0, n_beams)) \
        .astype(np.float32)


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_fused_quant8_byte_equal_two_pass(geom, layout):
    """quant8_scales: byte for byte the rint/clip of the port's own float32
    product times the scales (the two-pass path)."""
    _, pc, _, qp = _pair(geom, layout)
    wire = make_noise_block(pc, rms=2.0, seed=71)
    p32 = pgemm.beamform_power(wire, qp, pc)
    scales = _beam_scales(p32.numpy(), pc.n_beams)
    want = np.clip(np.rint(p32.numpy() * scales[None, None, :]), 0, 255) \
        .astype(np.uint8)
    got = pgemm.beamform_power(wire, qp, pc, quant8_scales=scales)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # The rails engage (the clip matters).
    assert (want == 255).any() and (want == 0).any() or scales.max() * \
        float(p32.max()) < 255


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_quant8_vs_jax(geom, layout):
    """Port vs JAX ``beamform_power(quant8_scales=)``: byte-equal wherever
    the two float32 products are bit-equal, within 1 count elsewhere."""
    jc, pc, qj, qp = _pair(geom, layout)
    wire = make_random_bytes_block(pc, seed=17)
    pj32 = np.asarray(jgemm.beamform_power(jnp.asarray(wire), qj, jc))
    pp32 = pgemm.beamform_power(wire, qp, pc).numpy()
    assert relative_power_error(pp32, pj32) <= JAX_RTOL
    scales = _beam_scales(pj32, pc.n_beams)
    uj = np.asarray(jgemm.beamform_power(jnp.asarray(wire), qj, jc,
                                         quant8_scales=jnp.asarray(scales)))
    up = pgemm.beamform_power(wire, qp, pc, quant8_scales=scales).numpy()
    assert uj.dtype == up.dtype == np.uint8
    diff = np.abs(uj.astype(int) - up.astype(int))
    assert diff.max() <= 1
    assert not diff[pj32 == pp32].any()


def test_fused_quant8_with_incoherent():
    """quant8 composes with the incoherent output: uint8 product, float32
    incoherent plane equal to the golden model, one call."""
    cfg = pcfg.TINY
    wire = make_noise_block(cfg, rms=2.0, seed=72)
    qw = pq.prepare_weights(cfg, make_weights(cfg, device="cpu"))
    scales = np.full(cfg.n_beams, 0.5, np.float32)
    p, inco = pgemm.beamform_power(wire, qw, cfg, incoherent=True,
                                   quant8_scales=scales)
    assert p.dtype == torch.uint8 and inco.dtype == torch.float32
    p32 = pgemm.beamform_power(wire, qw, cfg).numpy()
    np.testing.assert_array_equal(
        p.numpy(), np.clip(np.rint(p32 * 0.5), 0, 255).astype(np.uint8))
    # The float64 golden model carries ~1e-13 summation rounding.
    np.testing.assert_allclose(inco.numpy(),
                               pinc.incoherent_power_golden(wire, cfg),
                               rtol=1e-12)


@pytest.mark.parametrize("bad", ["navg_freq", "n_beams"])
def test_quant8_errors_match_jax(bad):
    jc, pc, qj, qp = _pair("tiny")
    wire = make_noise_block(pc, rms=2.0, seed=73)
    n = 3 if bad == "n_beams" else pc.n_beams
    if bad == "navg_freq":
        jc, pc = jc.replace(navg_freq=2), pc.replace(navg_freq=2)
    scales = np.ones(n, np.float32)
    with pytest.raises(ValueError, match=bad) as ej:
        jgemm.beamform_power(jnp.asarray(wire), qj, jc,
                             quant8_scales=jnp.asarray(scales))
    with pytest.raises(ValueError, match=bad) as ep:
        pgemm.beamform_power(wire, qp, pc, quant8_scales=scales)
    assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_sk_stats_vs_jax_and_standalone(geom, layout):
    """sk_stats: S1/S2 of the port against the JAX kernel's and the
    standalone ``sk_block_stats`` of both packages, composed with the
    incoherent and uint8 outputs."""
    jc, pc, qj, qp = _pair(geom, layout)
    wire = make_noise_block(pc, rms=2.0, seed=81)
    _, skj = jgemm.beamform_power(jnp.asarray(wire), qj, jc, sk_stats=True)
    p, sk = pgemm.beamform_power(wire, qp, pc, sk_stats=True)
    assert sk.dtype == torch.float32 and tuple(sk.shape) == (pc.n_chan, 2)
    np.testing.assert_allclose(sk.numpy(), np.asarray(skj), rtol=SK_RTOL)
    ref = jinc.sk_block_stats(jnp.asarray(wire), jc)
    own = pinc.sk_block_stats(wire, pc)
    np.testing.assert_allclose(sk[:, 0].numpy(), np.asarray(ref["s1"]),
                               rtol=SK_RTOL)
    np.testing.assert_allclose(sk[:, 1].numpy(), np.asarray(ref["s2"]),
                               rtol=SK_RTOL)
    assert torch.equal(sk, torch.stack([own["s1"], own["s2"]], dim=1))
    torch.testing.assert_close(p, pgemm.beamform_power(wire, qp, pc),
                               rtol=0, atol=0)
    _, _, sk2 = pgemm.beamform_power(wire, qp, pc, incoherent=True,
                                     sk_stats=True)
    scales = np.full(pc.n_beams, 0.5, np.float32)
    pq8, sk3 = pgemm.beamform_power(wire, qp, pc, sk_stats=True,
                                    quant8_scales=scales)
    assert pq8.dtype == torch.uint8
    assert torch.equal(sk2, sk) and torch.equal(sk3, sk)


@pytest.mark.parametrize("flags", [(), (1,), (0, 2), (5,)])
@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_incoherent_flag_ants_equal_jax(layout, flags):
    """The incoherent output with flag_ants equals the JAX kernel's (and
    the float64 golden model's): exact integers in both."""
    jc, pc, qj, qp = _pair("tiny", layout)
    wire = make_noise_block(pc, rms=2.0, seed=23)
    _, ij = jgemm.beamform_power(jnp.asarray(wire), qj, jc, incoherent=True,
                                 flag_ants=flags)
    _, ip = pgemm.beamform_power(wire, qp, pc, incoherent=True,
                                 flag_ants=flags)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(
        ip.numpy(), pinc.incoherent_power_golden(wire, pc, flag_ants=flags),
        rtol=1e-12)  # the float64 golden's summation rounding


def test_incoherent_freq_averaging_equal_jax():
    jc, pc, qj, qp = _pair("tiny", navg_freq=2)
    wire = make_noise_block(pc, rms=2.0, seed=9)
    _, ij = jgemm.beamform_power(jnp.asarray(wire), qj, jc, incoherent=True)
    _, ip = pgemm.beamform_power(wire, qp, pc, incoherent=True)
    assert tuple(ip.shape) == (pc.n_chan // 2, pc.t_block // pc.navg_time)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))


def test_flag_ants_range_error_matches_jax():
    jc, pc, qj, qp = _pair("tiny")
    wire = make_noise_block(pc, rms=2.0, seed=23)
    bad = (pc.n_ant_active,)
    with pytest.raises(ValueError, match="out of range") as ej:
        jgemm.beamform_power(jnp.asarray(wire), qj, jc, incoherent=True,
                             flag_ants=bad)
    with pytest.raises(ValueError, match="out of range") as ep:
        pgemm.beamform_power(wire, qp, pc, incoherent=True, flag_ants=bad)
    assert str(ep.value) == str(ej.value)


VARIANTS = [(q8, inco, sk) for q8 in (False, True) for inco in (False, True)
            for sk in (False, True)]


@pytest.mark.parametrize("q8,inco,sk", VARIANTS,
                         ids=lambda v: str(int(v)))
def test_every_combination_matches_jax(q8, inco, sk):
    """Each of the 8 output combinations, the JAX return order
    ``(out[, inco][, sk])`` and each output against JAX."""
    jc, pc, qj, qp = _pair("dsa10_small")
    wire = make_random_bytes_block(pc, seed=31)
    kw = dict(incoherent=inco, sk_stats=sk, flag_ants=(3,) if inco else ())
    scales = np.full(pc.n_beams, 1e-3, np.float32)
    if q8:
        kw["quant8_scales"] = scales
    jo = jgemm.beamform_power(jnp.asarray(wire), qj, jc, **dict(
        kw, quant8_scales=jnp.asarray(scales) if q8 else None))
    po = pgemm.beamform_power(wire, qp, pc, **kw)
    jo = jo if isinstance(jo, tuple) else (jo,)
    po = po if isinstance(po, tuple) else (po,)
    assert len(po) == len(jo) == 1 + inco + sk
    out_j, out_p = np.asarray(jo[0]), po[0].numpy()
    assert out_p.dtype == out_j.dtype
    if q8:
        assert np.abs(out_j.astype(int) - out_p.astype(int)).max() <= 1
    else:
        assert relative_power_error(out_p, out_j) <= JAX_RTOL
    if inco:
        np.testing.assert_array_equal(po[1].numpy(), np.asarray(jo[1]))
    if sk:
        np.testing.assert_allclose(po[-1].numpy(), np.asarray(jo[-1]),
                                   rtol=SK_RTOL)


def test_plain_side_outputs_are_exact_integers():
    """detect_power_plain's incoherent and SK outputs (the kernel's plain
    version) in its own units: int64 per-antenna S1/S2 summing to the
    standalone stats, and the variant names the launch counter uses."""
    cfg = pcfg.TINY
    wire = make_random_bytes_block(cfg, seed=2)
    qw = pq.prepare_weights(cfg, make_weights(cfg, device="cpu"))
    x, tm = pgemm._prepare_wire(wire, cfg)
    out, inco, sk = pgemm.detect_power_plain(
        x, qw.terms, qw.scales, cfg, tm, inco_mask=pgemm.incoherent_mask(cfg),
        sk=True, chan_chunk=3)
    assert sk.dtype == torch.int64 and tuple(sk.shape) == (
        cfg.n_chan, 2, cfg.a_compute)
    assert not sk[:, :, cfg.n_ant_active:].any()  # padded slots are zero
    st = pinc.sk_block_stats(wire, cfg)
    np.testing.assert_array_equal(sk.sum(dim=2)[:, 0].numpy(), st["s1"])
    np.testing.assert_array_equal(inco.numpy(),
                                  pinc.incoherent_power(wire, cfg).numpy())
    assert pgemm.incoherent_mask(cfg, (0, 5)) == 0b011110
    assert [pgemm.variant_name(*v) for v in VARIANTS] == [
        "base", "sk", "inco", "sk+inco", "q8", "sk+q8", "q8+inco",
        "sk+q8+inco"]
    assert not any(pgemm.fused_detect.launches.values())


def test_jax_interpret_mode_is_what_is_compared():
    """The comparisons above run the JAX package's Pallas kernel as its own
    CPU tests do (interpret mode on a non-TPU backend)."""
    assert jax.default_backend() == "cpu"
    assert jgemm._default_interpret()
