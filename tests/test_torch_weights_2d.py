"""Port vs JAX package: the 2-D (l, m) beam grids (``make_weights_lm``,
``weights_lm_numpy_golden``) and ``beam_response_lm``, on the CPU at
``tiny`` with 36 beams over a seeded 2-D layout (tests/test_weights_2d.py's
geometry).

Bars: the weights within ``WEIGHTS_ATOL`` of JAX's (both phases in float64,
float32 out); the golden byte-equal; powers on the same quantized weights
within ``JAX_RTOL`` (exact integers in both, float32 summation order only),
on each package's own weights within ``POWER_RTOL``; the responses within
``RESPONSE_RTOL`` of JAX's, relative to their peak."""

import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.models.weights as jw
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.models.weights as pw
import dsabeamformer_tpu_torch.ops.quantize as pq
from dsabeamformer_tpu.models.arrays import ArrayLayout as JLayout
from dsabeamformer_tpu.models.beampattern import beam_response_lm as jresp_lm
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu.ops.gemm import beamform_power as jpower
from dsabeamformer_tpu_torch.config import SPEED_OF_LIGHT_M_S
from dsabeamformer_tpu_torch.ingest.generator import _emit
from dsabeamformer_tpu_torch.models.arrays import ArrayLayout
from dsabeamformer_tpu_torch.models.beampattern import beam_response_lm
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.ops.gemm import beamform_power
from dsabeamformer_tpu_torch.utils.testing import (
    POWER_RTOL,
    relative_power_error,
)

#: make_weights_lm vs JAX (tests/test_torch_weights.py's bar).
WEIGHTS_ATOL = 1e-6
#: Port vs JAX on the same quantized weights (tests/test_torch_gemm.py).
JAX_RTOL = 1e-6
#: beam_response_lm vs JAX: the same float64 / complex128 arithmetic.
RESPONSE_RTOL = 1e-12
#: The issue's grid beam for the point source (tests/test_weights_2d.py).
TARGET = 27

JCFG = jcfg.TINY.replace(n_beams=36)
PCFG = pcfg.TINY.replace(n_beams=36)


def _layouts(seed=1234):
    rng = np.random.default_rng(seed)
    ew = np.zeros(PCFG.n_ant)
    ns = np.zeros(PCFG.n_ant)
    a = PCFG.n_ant_active
    ew[:a] = rng.uniform(-20, 20, a)
    ns[:a] = rng.uniform(-20, 20, a)
    return (JLayout(positions_m=ew, n_active=a, positions_ns_m=ns),
            ArrayLayout(positions_m=ew, n_active=a, positions_ns_m=ns))


def _beam_grid(cfg):
    n_side = int(np.sqrt(cfg.n_beams))
    half = np.sin(np.deg2rad(cfg.beam_span_deg / 2))
    side = np.linspace(-half, half, n_side)
    ll, mm = np.meshgrid(side, side, indexing="ij")
    return ll.ravel(), mm.ravel()


def _cals(cal_seed):
    if cal_seed is None:
        return None, None
    jcal = JCal.random(JCFG, seed=cal_seed, amp_sigma=0.3)
    return jcal, CalTable(gains=jcal.gains)


@pytest.mark.parametrize("cal_seed", [None, 3, 8])
def test_make_weights_lm_matches_jax(cal_seed):
    jl, pl = _layouts()
    jcal, pcal = _cals(cal_seed)
    l, m = _beam_grid(PCFG)
    a = jw.make_weights_lm(JCFG, l, m, layout=jl, cal=jcal)
    b = pw.make_weights_lm(PCFG, l, m, layout=pl, cal=pcal, device="cpu")
    assert b.re.dtype == torch.float32 and b.shape == a.re.shape
    assert b.device == torch.device("cpu")
    assert np.max(np.abs(b.re.numpy() - np.asarray(a.re))) <= WEIGHTS_ATOL
    assert np.max(np.abs(b.im.numpy() - np.asarray(a.im))) <= WEIGHTS_ATOL
    gold = pw.weights_lm_numpy_golden(PCFG, l, m, layout=pl, cal=pcal)
    np.testing.assert_array_equal(
        gold, jw.weights_lm_numpy_golden(JCFG, l, m, layout=jl, cal=jcal))
    assert np.max(np.abs(b.to_numpy() - gold)) <= WEIGHTS_ATOL


def test_make_weights_lm_checks_the_beam_count():
    l, m = _beam_grid(PCFG)
    for which, cfg in ((jw, JCFG), (pw, PCFG)):
        kw = {} if which is jw else {"device": "cpu"}
        with pytest.raises(ValueError, match="beam grid has 35 beams"):
            which.make_weights_lm(cfg, l[:-1], m[:-1], **kw)
        with pytest.raises(ValueError, match="config expects 36"):
            which.make_weights_lm(cfg, l, m[:-1], **kw)


def test_lm_reduces_to_the_1d_fan():
    """With m = 0 and no NS offsets, the lm path is the 1-D fan."""
    cfg = pcfg.TINY
    angles = cfg.beam_angles_rad()
    fan = pw.make_weights(cfg, device="cpu").to_numpy()
    lm = pw.make_weights_lm(cfg, np.sin(angles), np.zeros_like(angles),
                            device="cpu").to_numpy()
    np.testing.assert_allclose(lm, fan, atol=WEIGHTS_ATOL)


def _point_source_wire(cfg, layout, l0, m0, seed=1234):
    """tests/test_weights_2d.py's 2-D point source (same draws)."""
    rng = np.random.default_rng(seed)
    f = cfg.freqs_hz()[:, None, None]
    a = cfg.n_ant_active
    steer = np.exp(
        2j * np.pi * f
        * (layout.positions_m[None, None, :a] * l0
           + layout.ns[None, None, :a] * m0)
        / SPEED_OF_LIGHT_M_S
    )
    sig = 5.0 / np.sqrt(2) * (
        rng.standard_normal((cfg.n_chan, cfg.t_block, cfg.n_pol))
        + 1j * rng.standard_normal((cfg.n_chan, cfg.t_block, cfg.n_pol))
    )
    v = sig[..., None] * steer[:, :, None, :]
    shape = (cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant)
    re = np.zeros(shape)
    im = np.zeros(shape)
    re[..., :a] = v.real
    im[..., :a] = v.imag
    return _emit(cfg, re, im)


@pytest.mark.parametrize("layout_name", ["tfpa", "ftpa"])
def test_2d_point_source_peaks_in_its_beam(layout_name):
    jc = JCFG.replace(input_layout=layout_name)
    pc = PCFG.replace(input_layout=layout_name)
    jl, pl = _layouts()
    l, m = _beam_grid(pc)
    wire = _point_source_wire(pc, pl, l[TARGET], m[TARGET])
    qp = pq.quantize_weights(
        pw.make_weights_lm(pc, l, m, layout=pl, device="cpu"), pc.weight_mode)
    p = beamform_power(torch.from_numpy(wire), qp, pc).numpy()
    assert int(np.argmax(p.sum(axis=(0, 1)))) == TARGET
    qj = jq.quantize_weights(jw.make_weights_lm(jc, l, m, layout=jl),
                             jc.weight_mode)
    p_jax = np.asarray(jpower(wire, qj, jc))
    assert int(np.argmax(p_jax.sum(axis=(0, 1)))) == TARGET
    assert relative_power_error(p, p_jax) <= POWER_RTOL
    # The JAX package's integers and scales through the port's product.
    carried = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                          np.asarray(qj.scales), device="cpu")
    p_carried = beamform_power(torch.from_numpy(wire), carried, pc).numpy()
    assert relative_power_error(p_carried, p_jax) <= JAX_RTOL


@pytest.mark.parametrize("chan", [None, 0, 5])
def test_beam_response_lm_matches_jax(chan):
    jl, pl = _layouts()
    n = 6
    grid = np.linspace(-0.01, 0.01, n)
    ll, mm = np.meshgrid(grid, grid, indexing="ij")
    bl, bm = ll.ravel(), mm.ravel()
    rng = np.random.default_rng(5)
    sl = np.concatenate([bl, rng.uniform(-0.02, 0.02, 20)])
    sm = np.concatenate([bm, rng.uniform(-0.02, 0.02, 20)])
    got = beam_response_lm(PCFG, bl, bm, sl, sm, layout=pl, chan=chan,
                           device="cpu")
    want = jresp_lm(JCFG, bl, bm, sl, sm, layout=jl, chan=chan)
    assert got.shape == want.shape == (56, PCFG.n_beams)
    assert relative_power_error(got, want) <= RESPONSE_RTOL
    # Sweep point i == beam direction i: the diagonal dominates.
    assert (np.argmax(got[:36], axis=1) == np.arange(36)).all()
    assert np.abs(np.diag(got[:36]) - 1.0).max() < 1e-6
