"""a_compute off the multiples of 8 and past 128, port against the JAX
package: DSA-10's wire in auto mode (10, 12 and 20 slots: a_compute 10, 12
and 20, pol y's rows starting off a 4-byte boundary) and a_compute 224.
The port's plain versions (which a CPU tensor takes) against the JAX
package's Pallas kernels in interpret mode for ``beamform_power``,
``beamform_stokes`` and ``beamform_voltages`` in int8x2 and bf16x2; the
card kernels' operand layouts (``_mma_operands``, ``_bf16_operands``) at
those widths against the plain GEMM; the random geometries whose antenna
counts are no multiple of 8; and the public names of every ported JAX
subpackage."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ops.gemm as jgemm
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ops.gemm as pgemm
import dsabeamformer_tpu_torch.ops.quantize as pq
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu_torch.ingest.generator import (
    make_noise_block,
    make_random_bytes_block,
)
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import (
    make_weights,
    weights_numpy_golden,
)
from dsabeamformer_tpu_torch.ops.reference import beamform_block_ref
from dsabeamformer_tpu_torch.utils.testing import (
    FUZZ_RTOL,
    random_geometry_odd_ants,
    relative_power_error,
)

#: Float modes: the float32 K-sum runs in XLA's order there and in the CPU
#: BLAS's here; held to this share of the block's peak (as
#: tests/test_torch_modes.py).
FLOAT_ATOL = 2e-6
#: int8 and int13 Stokes: the cross terms differ by float32 rounding, held
#: to this share of the I peak (as tests/test_torch_modes.py).
STOKES_ATOL = 1e-6
MODES = ("int8x2", "bf16x2")


def _cfgs(width, mode, layout="tfpa"):
    """(JAX config, port config) contracting ``width`` antennas: DSA-10's
    10, 12 or 20 slots on TINY in auto mode, or a DSA-110 slice of 224."""
    if width == 224:
        kw = dict(n_chan=2, t_block=32, n_beams=32, n_ant=224,
                  n_ant_active=200, n_ant_compute=224, weight_mode=mode,
                  input_layout=layout)
        return (jcfg.DSA110.replace(time_tile=32, chan_tile=2, **kw),
                pcfg.DSA110.replace(**kw))
    kw = dict(n_ant=width, n_ant_active=min(width, 10), weight_mode=mode,
              input_layout=layout)
    return jcfg.TINY.replace(**kw), pcfg.TINY.replace(**kw)


def _carried_weights(jc, seed):
    qj = jq.prepare_weights(jc, jmake_weights(jc, cal=JCal.random(jc,
                                                                 seed=seed)))
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    return qj, qp


def _close(got, want, mode, peak=None):
    """Equal to the bit in int8x2, within FLOAT_ATOL of the peak in the
    float mode."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if mode not in pgemm.FLOAT_MODES:
        np.testing.assert_array_equal(got, want)
        return
    scale = np.abs(want).max() if peak is None else peak
    assert np.abs(got - want).max() <= FLOAT_ATOL * scale


WIDTHS = (10, 12, 20, 224)
CASES = [(w, m, layout) for w in WIDTHS for m in MODES
         for layout in ("tfpa", "ftpa")]


@pytest.mark.parametrize("width", (10, 12, 20))
def test_dsa10_slots_power_equals_jax_bit_for_bit(width):
    """``TINY.replace(n_ant=n, n_ant_active=min(n, 10))``, seed 0, the
    default mode (int8x2): power equal to the JAX package's to the bit, and
    the widths the card kernels take."""
    jc, pc = (c.replace(n_ant=width, n_ant_active=min(width, 10))
              for c in (jcfg.TINY, pcfg.TINY))
    assert pc.a_compute == jc.a_compute == width
    assert pgemm.kernel_path(pc) == "wgmma"
    wire = make_random_bytes_block(pc, seed=0)
    qj, qp = _carried_weights(jc, seed=0)
    want = np.asarray(jgemm.beamform_power(jnp.asarray(wire), qj, jc))
    got = pgemm.beamform_power(torch.from_numpy(wire), qp, pc).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width,mode,layout", CASES)
def test_beamform_power_matches_jax(width, mode, layout):
    jc, pc = _cfgs(width, mode, layout)
    assert pc.a_compute == width
    wire = make_random_bytes_block(pc, seed=width)
    qj, qp = _carried_weights(jc, seed=width)
    want = np.asarray(jgemm.beamform_power(jnp.asarray(wire), qj, jc))
    got = pgemm.beamform_power(torch.from_numpy(wire), qp, pc)
    assert tuple(got.shape) == pc.out_block_shape
    _close(got.numpy(), want, mode)


@pytest.mark.parametrize("width,mode,layout", CASES)
def test_beamform_stokes_matches_jax(width, mode, layout):
    """int8x2 Stokes to the bit (the plain version mirrors XLA's detection
    arithmetic), bf16x2 within FLOAT_ATOL of the I peak; the I plane is the
    power product."""
    jc, pc = _cfgs(width, mode, layout)
    wire = make_random_bytes_block(pc, seed=width + 1)
    qj, qp = _carried_weights(jc, seed=width + 1)
    want = np.asarray(jgemm.beamform_stokes(jnp.asarray(wire), qj, jc))
    got = pgemm.beamform_stokes(torch.from_numpy(wire), qp, pc).numpy()
    _close(got, want, mode, peak=np.abs(want[:, :, 0]).max())
    _close(got[:, :, 0], np.asarray(
        jgemm.beamform_power(jnp.asarray(wire), qj, jc)), mode)


@pytest.mark.parametrize("width,mode,layout", CASES)
def test_beamform_voltages_matches_jax(width, mode, layout):
    jc, pc = _cfgs(width, mode, layout)
    wire = make_random_bytes_block(pc, seed=width + 2)
    qj, qp = _carried_weights(jc, seed=width + 2)
    want = np.asarray(jgemm.beamform_voltages(jnp.asarray(wire), qj, jc))
    got = pgemm.beamform_voltages(torch.from_numpy(wire), qp, pc)
    assert tuple(got.shape) == (pc.n_chan, pc.t_block, 2, 2 * pc.n_beams)
    _close(got.numpy(), want, mode)


# ----------------- the card kernels' operands at these widths -------------- #

#: One a_compute past each mode's staged-tile edge at navg 16 (the widest
#: multiple of 8 whose weight tile fit beside an output row, plus 8), where
#: the card's detect kernel takes the K loop.
PAST_EDGE = {"f32": 280, "int13": 392, "bf16x2": 400, "int8x2": 712,
             "int8": 1160}


@pytest.mark.parametrize("mode", sorted(PAST_EDGE))
def test_past_the_staged_edge_matches_jax(mode):
    """Power, Stokes and voltages of a 2-channel, 32-sample DSA-110 slice
    contracting ``PAST_EDGE[mode]`` antennas against the JAX package: the
    int modes' power and voltages (and int8x2's Stokes) to the bit, int8's
    and int13's Stokes within STOKES_ATOL of the I peak (their cross terms
    differ by float32 rounding, as tests/test_torch_modes.py holds them),
    the float modes within FLOAT_ATOL of the peak; the detect kernel's path
    there is the K loop."""
    ac = PAST_EDGE[mode]
    kw = dict(n_chan=2, t_block=32, n_beams=32, n_ant=ac,
              n_ant_active=ac - 10, n_ant_compute=ac, weight_mode=mode)
    jc = jcfg.DSA110.replace(time_tile=32, chan_tile=2, **kw)
    pc = pcfg.DSA110.replace(**kw)
    assert pc.a_compute == jc.a_compute == ac
    assert pgemm.kernel_path(pc) == pgemm.KLOOP_MMA
    wire = make_random_bytes_block(pc, seed=ac)
    qj, qp = _carried_weights(jc, seed=ac)
    x = torch.from_numpy(wire)
    want = np.asarray(jgemm.beamform_power(jnp.asarray(wire), qj, jc))
    _close(pgemm.beamform_power(x, qp, pc).numpy(), want, mode)
    want = np.asarray(jgemm.beamform_stokes(jnp.asarray(wire), qj, jc))
    got = pgemm.beamform_stokes(x, qp, pc).numpy()
    if mode in ("int8", "int13"):
        assert got.shape == want.shape
        assert np.abs(got - want).max() \
            <= STOKES_ATOL * np.abs(want[:, :, 0]).max()
    else:
        _close(got, want, mode, peak=np.abs(want[:, :, 0]).max())
    _close(pgemm.beamform_voltages(x, qp, pc).numpy(),
           np.asarray(jgemm.beamform_voltages(jnp.asarray(wire), qj, jc)),
           mode)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mode", ("int8", "int8x2", "int12", "int13"))
def test_int8_operands_at_width(mode, width):
    """The int8 kernels' k32 steps at a_compute 10, 12, 20 and 224: the
    last step zero past a_compute in both operands, and the tensor-core
    integers (times the product scale: 16 for int8 and int8x2 up to 255)
    equal the plain GEMM's, below 2^31."""
    _, pc = _cfgs(width, mode)
    if mode == "int13" and width == 20:
        pc = pc.replace(n_ant_compute=0)      # int13 rounds 10 up to 16
    ac = pc.a_compute
    qw = pq.prepare_weights(pc, make_weights(
        pc, cal=CalTable.random(pc, seed=ac), device="cpu"))
    x, tm = pgemm._prepare_wire(make_random_bytes_block(pc, seed=ac), pc)
    re, im = pgemm._unpack_chunk(x, pc, tm, 0, pc.n_chan)
    want = pgemm._gemm_chunk(re, im, qw.terms, 0, pc.n_chan, mode)
    xk, subs = pgemm._mma_operands(re, im, qw.terms, pc)
    n_steps = -(-ac // 16)
    tail = ac - 16 * (n_steps - 1)
    last = xk[..., 32 * (n_steps - 1):].reshape(*xk.shape[:3], 2, 16)
    assert not last[..., tail:].any()
    for sub in subs:
        assert sub.shape[1] == 32 * n_steps
    ps = pgemm._product_scale(pc)
    assert ps == (1 if mode in pq.FOLDED_SUBTERMS else 16)
    got = pgemm._mma_product(xk, subs, pc)
    assert int(got.abs().max()) * ps < 2 ** 31
    f, t, p, b = got.shape[:4]
    flat = torch.cat([got[..., 0], got[..., 1]], dim=-1)
    flat = flat.permute(0, 2, 1, 3).reshape(f, p * t, 2 * b)
    assert torch.equal(flat.to(torch.float32), want)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mode", ("bf16", "bf16x2", "f32"))
def test_bf16_operands_at_width(mode, width):
    """The bf16 kernels' k16 steps at a_compute 10, 12, 20 and 224: zero
    past a_compute in both operands, and the product (exact in float64)
    within float32 rounding of the plain GEMM."""
    _, pc = _cfgs(width, mode)
    ac = pc.a_compute
    qw = pq.prepare_weights(pc, make_weights(
        pc, cal=CalTable.random(pc, seed=ac), device="cpu"))
    x, tm = pgemm._prepare_wire(make_random_bytes_block(pc, seed=ac), pc)
    wire = pgemm._wire_chunk(x, pc, tm, 0, pc.n_chan)
    xk, subs = pgemm._bf16_operands(wire, qw.terms, pc)
    n_steps = -(-ac // 8)
    assert xk.shape[-1] == 16 * n_steps
    tail = ac - 8 * (n_steps - 1)
    last = xk[..., 16 * (n_steps - 1):].reshape(*xk.shape[:3], 2, 8)
    assert not last[..., tail:].float().any()
    for sub in subs:
        lw = sub[:, 16 * (n_steps - 1):].reshape(sub.shape[0], 2, 8,
                                                 *sub.shape[2:])
        assert not lw[:, :, tail:].float().any()
    got = pgemm._bf16_product(xk, subs)
    re, im = pgemm._unpack_chunk(x, pc, tm, 0, pc.n_chan)
    want = pgemm._gemm_chunk(re, im, qw.terms, 0, pc.n_chan, mode)
    f, t, p, b = got.shape[:4]
    flat = torch.cat([got[..., 0], got[..., 1]], dim=-1)
    flat = flat.permute(0, 2, 1, 3).reshape(f, p * t, 2 * b)
    assert float((flat - want.double()).abs().max()) \
        <= 1e-5 * float(want.abs().max())


# ------------- random geometries whose n_ant is no multiple of 8 ----------- #

@pytest.mark.parametrize("i", range(6))
def test_odd_antenna_geometry_matches_golden(i):
    """``random_geometry_odd_ants``: any antenna count from 9 to 31 that is
    no multiple of 8 (auto a_compute up to n_ant), both layouts, five
    modes; the plain version against the float64 golden model at the
    mode's fuzz bar, and the widths the card kernels take."""
    cfg = random_geometry_odd_ants(i)
    assert cfg.n_ant % 8 and cfg.a_compute == min(
        cfg.n_ant, -(-cfg.n_ant_active // (16 if cfg.weight_mode == "int13"
                                           else 32))
        * (16 if cfg.weight_mode == "int13" else 32))
    assert pgemm.kernel_path(cfg) == "wgmma"
    cal = CalTable.random(cfg, seed=i)
    wire = make_noise_block(cfg, rms=2.0, seed=i)
    qw = pq.prepare_weights(cfg, make_weights(cfg, cal=cal, device="cpu"))
    got = pgemm.beamform_power(wire, qw, cfg).numpy()
    ref = beamform_block_ref(weights_numpy_golden(cfg, cal=cal), wire,
                             cfg.input_layout, cfg.navg_time, cfg.navg_freq)
    assert got.shape == cfg.out_block_shape
    assert relative_power_error(got, ref) <= FUZZ_RTOL[cfg.weight_mode]


# ------------------------------ public names ------------------------------ #

@pytest.mark.parametrize("sub", ["", ".ops", ".models", ".ingest", ".utils"])
def test_every_jax_export_is_ported(sub):
    """Every name in the ``__all__`` of a JAX (sub)package whose modules
    the port has is in the port's counterpart's ``__all__`` and importable
    from it."""
    jmod = importlib.import_module("dsabeamformer_tpu" + sub)
    pmod = importlib.import_module("dsabeamformer_tpu_torch" + sub)
    missing = [n for n in jmod.__all__
               if n not in pmod.__all__ or not hasattr(pmod, n)]
    assert not missing, f"dsabeamformer_tpu_torch{sub} lacks {missing}"
