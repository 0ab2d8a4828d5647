"""Port vs JAX package: steering weights, zap/flag edits, quantization in
every weight mode and the weight-table file format."""

import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.models.weights as jw
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.models.weights as pw
import dsabeamformer_tpu_torch.ops.quantize as pq
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu_torch.models.calibration import CalTable as PCal
from dsabeamformer_tpu_torch.ops.cplx import CVec

#: make_weights vs JAX (both float64 phase on the CPU, float32 output).
WEIGHTS_ATOL = 1e-6

GEOMS = {
    "tiny": (jcfg.TINY, pcfg.TINY),
    "dsa10_small": (jcfg.DSA10.replace(n_chan=8, t_block=64, time_tile=64),
                    pcfg.DSA10.replace(n_chan=8, t_block=64)),
    "dsa10c_small": (jcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64,
                                                time_tile=64),
                     pcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64)),
}


def _both_weights(geom, cal_seed=None, pointing=0.0, fringe=0.0):
    jc, pc = GEOMS[geom]
    jcal = pcal = None
    if cal_seed is not None:
        jcal = JCal.random(jc, seed=cal_seed, amp_sigma=0.3)
        pcal = PCal(gains=jcal.gains)
    a = jw.make_weights(jc, cal=jcal, pointing_rad=pointing,
                        fringe_delay_s=fringe)
    b = pw.make_weights(pc, cal=pcal, pointing_rad=pointing,
                        fringe_delay_s=fringe, device="cpu")
    return (jc, pc), a, b


@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("cal_seed,pointing,fringe", [
    (None, 0.0, 0.0), (3, 0.01, 0.0), (5, -0.02, 3.3e-9)])
def test_make_weights_matches_jax(geom, cal_seed, pointing, fringe):
    _, a, b = _both_weights(geom, cal_seed, pointing, fringe)
    assert b.re.dtype == torch.float32 and b.shape == a.re.shape
    assert np.max(np.abs(b.re.numpy() - np.asarray(a.re))) <= WEIGHTS_ATOL
    assert np.max(np.abs(b.im.numpy() - np.asarray(a.im))) <= WEIGHTS_ATOL


def test_make_weights_vs_numpy_golden():
    (jc, pc), _, b = _both_weights("dsa10_small", cal_seed=2)
    cal = PCal(gains=JCal.random(jc, seed=2, amp_sigma=0.3).gains)
    gold = pw.weights_numpy_golden(pc, cal=cal)
    np.testing.assert_array_equal(
        gold, jw.weights_numpy_golden(jc, cal=JCal(gains=cal.gains)))
    assert np.max(np.abs(b.to_numpy() - gold)) <= 1e-6


def test_make_weights_rejects_mismatched_tables():
    pc = pcfg.TINY
    with pytest.raises(ValueError, match="calibration table shaped"):
        pw.make_weights(pc, cal=PCal.unity(pc.replace(n_chan=4)),
                        device="cpu")
    from dsabeamformer_tpu_torch.models.arrays import linear_array

    with pytest.raises(ValueError, match="active antennas"):
        pw.make_weights(pc, layout=linear_array(16, 5, 5.0), device="cpu")
    with pytest.raises(ValueError, match="antennas, config"):
        pw.make_weights(pc, layout=linear_array(20, 6, 5.0), device="cpu")


@pytest.mark.parametrize("spec", ["12,100-110,500", " 3 , 5-5,,7", "0-2"])
def test_parse_zap_matches_jax(spec):
    assert pw.parse_zap(spec) == jw.parse_zap(spec)


@pytest.mark.parametrize("what,arg", [
    ("zap", "1,3-4"), ("zap", [0, 7]), ("flag", "2"), ("flag", [0, 5])])
def test_zap_and_flag_match_jax(what, arg):
    (jc, pc), a, b = _both_weights("tiny", cal_seed=1)
    if what == "zap":
        ja, pb = jw.zap_weights(a, arg, jc), pw.zap_weights(b, arg, pc)
    else:
        ja, pb = jw.flag_antennas(a, arg, jc), pw.flag_antennas(b, arg, pc)
    assert np.max(np.abs(pb.re.numpy() - np.asarray(ja.re))) <= WEIGHTS_ATOL
    assert np.max(np.abs(pb.im.numpy() - np.asarray(ja.im))) <= WEIGHTS_ATOL
    assert pw.zap_weights(b, "", pc) is b


def test_zap_and_flag_range_errors():
    _, _, b = _both_weights("tiny")
    with pytest.raises(ValueError, match="out of range"):
        pw.zap_weights(b, [8], pcfg.TINY)
    with pytest.raises(ValueError, match="out of range"):
        pw.flag_antennas(b, "6", pcfg.TINY)
    with pytest.raises(ValueError, match="bad zap range"):
        pw.parse_zap("5-3")


def _wc(geom, seed):
    jc, _ = GEOMS[geom]
    w = jw.make_weights(jc, cal=JCal.random(jc, seed=seed, amp_sigma=0.5))
    return np.asarray(jq.cat_weights(w, jc.a_compute))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("mode", sorted(pq.TERM_DTYPES))
def test_quantizers_byte_identical(mode, geom, seed):
    """Same Wc into both -> the same terms, byte for byte, and equal
    scales, in every weight mode."""
    wc = _wc(geom, seed)
    jterms, jscales = jq._QUANTIZERS[mode](wc)
    pterms, pscales = pq._QUANTIZERS[mode](torch.from_numpy(wc.copy()))
    assert len(pterms) == len(jterms)
    for a, b in zip(jterms, pterms):
        assert b.dtype == pq.TERM_DTYPES[mode]
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(_bits(pq._term_to_numpy(b)),
                                      _bits(np.asarray(a)))
    np.testing.assert_array_equal(pscales.numpy(), np.asarray(jscales))


def _bits(a: np.ndarray) -> np.ndarray:
    """The array's bytes (bfloat16 arrives as an extension dtype or as
    two-byte records)."""
    return np.ascontiguousarray(a).view(np.uint8)


def _carried(a) -> CVec:
    """The JAX package's weights as the port's (same float32 values: the
    two make_weights agree to WEIGHTS_ATOL, not to the bit)."""
    return CVec(re=torch.from_numpy(np.array(a.re)),
                im=torch.from_numpy(np.array(a.im)))


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_cat_weights_and_prepare_match_jax(geom):
    (jc, pc), a, _ = _both_weights(geom, cal_seed=4)
    b = _carried(a)
    np.testing.assert_array_equal(pq.cat_weights(b, pc.a_compute).numpy(),
                                  np.asarray(jq.cat_weights(a, jc.a_compute)))
    ja, pb = jq.prepare_weights(jc, a), pq.prepare_weights(pc, b)
    for x, y in zip(ja.terms, pb.terms):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    np.testing.assert_array_equal(pb.scales.numpy(), np.asarray(ja.scales))
    assert (pb.n_terms, pb.n_chan) == (2, pc.n_chan)
    np.testing.assert_allclose(pb.dequantize().numpy(),
                               pq.cat_weights(b, pc.a_compute).numpy(),
                               atol=1e-4)


def test_weight_files_load_in_both_packages(tmp_path):
    (jc, pc), a, _ = _both_weights("dsa10_small", cal_seed=6)
    ja, pb = jq.prepare_weights(jc, a), pq.prepare_weights(pc, _carried(a))
    jq.save_quant_weights(str(tmp_path / "jax.npz"), ja)
    pq.save_quant_weights(str(tmp_path / "port.npz"), pb)
    from_jax = pq.load_quant_weights(str(tmp_path / "jax.npz"), device="cpu")
    from_port = jq.load_quant_weights(str(tmp_path / "port.npz"))
    for x, y, z in zip(ja.terms, from_jax.terms, from_port.terms):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        np.testing.assert_array_equal(np.asarray(z), np.asarray(x))
    np.testing.assert_array_equal(from_jax.scales.numpy(), np.asarray(ja.scales))
    np.testing.assert_array_equal(np.asarray(from_port.scales),
                                  np.asarray(ja.scales))
    # The round-1 stacked format loads too.
    np.savez(tmp_path / "stacked.npz", scales=np.asarray(ja.scales),
             terms=np.stack([np.asarray(t) for t in ja.terms]))
    st = pq.load_quant_weights(str(tmp_path / "stacked.npz"), device="cpu")
    np.testing.assert_array_equal(st.terms[1].numpy(), np.asarray(ja.terms[1]))


def test_carry_across_from_numpy():
    (jc, _), a, _ = _both_weights("tiny", cal_seed=2)
    ja = jq.prepare_weights(jc, a)
    qw = pq.quant_weights_from_numpy([np.asarray(t) for t in ja.terms],
                                     np.asarray(ja.scales), device="cpu")
    assert qw.device == torch.device("cpu") and qw.n_terms == 2
    for x, y in zip(ja.terms, qw.terms):
        assert y.dtype == torch.int8 and y.is_contiguous()
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    assert qw.scales.dtype == torch.float32


def test_quantize_rejects_unknown_mode_and_width():
    w = CVec.from_numpy(np.ones((2, 4, 8), np.complex64), device="cpu")
    with pytest.raises(ValueError, match="unknown weight mode"):
        pq.quantize_weights(w, "int4")
    with pytest.raises(ValueError, match="out of range"):
        pq.cat_weights(w, a_compute=9)
    with pytest.raises(ValueError, match="none of int8, float32"):
        pq.quant_weights_from_numpy([np.zeros((1, 2, 2), np.float64)],
                                    np.ones((1, 1), np.float32), device="cpu")


@pytest.mark.parametrize("navg_freq", [1, 2, 4])
@pytest.mark.parametrize("spec", ["0", "1,3-4", [7, 2, 2], []])
def test_zap_mask_avg_matches_jax(spec, navg_freq):
    """The incoherent product's averaged-channel excision mask: 0 for any
    averaged group holding a zapped raw channel."""
    jc, pc = (c.replace(navg_freq=navg_freq) for c in GEOMS["tiny"])
    got = pw.zap_mask_avg(spec, pc)
    assert got.dtype == np.float32 and got.shape == (pc.n_chan // navg_freq,)
    np.testing.assert_array_equal(got, jw.zap_mask_avg(spec, jc))
