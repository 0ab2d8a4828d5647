"""The port's antenna (tensor-parallel) split (``parallel/tensor.py``) on CPU
slots against the JAX package's ``tp_beamformer`` on its virtual CPU devices
(tests/test_tensor_parallel.py's cases, seeds and sizes): the split table
byte for byte, the products within JAX_RTOL, and the float64 golden
model's bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.parallel.tensor as jtp
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.parallel.tensor as ptp
from dsabeamformer_tpu.ops.quantize import QuantWeights as JQuantWeights
from jax.sharding import NamedSharding, PartitionSpec as P
from dsabeamformer_tpu_torch.ingest.generator import (
    make_noise_block,
    make_point_source_block,
)
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import weights_numpy_golden
from dsabeamformer_tpu_torch.ops.gemm import beamform_power
from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops.reference import (
    beamform_block_ref,
    beamform_stokes_ref,
)
from dsabeamformer_tpu_torch.utils.testing import (
    assert_power_close,
    relative_power_error,
)

#: Port against JAX on identical wire and weights (float32 order only).
JAX_RTOL = 1e-6


def _meshes(nc, na):
    return (ptp.make_tp_mesh(nc, na, devices=["cpu"] * (nc * na)),
            jtp.make_tp_mesh(nc, na))


def _golden(cfg, wire, cal=None):
    return beamform_block_ref(weights_numpy_golden(cfg, cal=cal), wire,
                              cfg.input_layout, cfg.navg_time, cfg.navg_freq)


def _whole(qw_tp, nc, na):
    """The slots' terms and scales put back on the JAX package's global
    ``[F, K, 2B]`` / ``[F, n_terms]`` grid."""
    terms = [torch.cat([torch.cat([qw_tp[c * na + g].terms[k]
                                   for g in range(na)], dim=1)
                        for c in range(nc)])
             for k in range(len(qw_tp[0].terms))]
    scales = torch.cat([qw_tp[c * na].scales for c in range(nc)]).numpy()
    return terms, scales


def _same_bytes(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return tuple(got.shape) == want.shape \
        and got.contiguous().view(torch.uint8).numpy().tobytes() \
        == want.tobytes()


def _to_jax(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _both(pc, jc, nc, na, wire, products="power", cal=None):
    """Both packages' products of ``wire`` on an (nc, na) mesh.  Without a
    calibration table each package makes its own split table, and the two
    are held equal byte for byte; with one, JAX takes the port's (the
    calibrated weights themselves agree within a float32 rounding,
    tests/test_torch_weights.py)."""
    pmesh, jmesh = _meshes(nc, na)
    qp = ptp.shard_weights_tp(pc, pmesh, cal=cal)
    terms, scales = _whole(qp, nc, na)
    if cal is None:
        qj = jtp.shard_weights_tp(jc, jmesh)
        for got, want in zip(terms, qj.terms):
            assert _same_bytes(got, want)
        assert np.array_equal(scales, np.asarray(qj.scales))
    else:
        qj = JQuantWeights(
            terms=tuple(jax.device_put(_to_jax(t), NamedSharding(
                jmesh, P(jtp.CHAN_AXIS, jtp.ANT_AXIS, None)))
                for t in terms),
            scales=jax.device_put(scales, NamedSharding(
                jmesh, P(jtp.CHAN_AXIS, None))))
    p = ptp.tp_beamformer(pc, pmesh, products=products)(wire, qp).numpy()
    j = np.asarray(jtp.tp_beamformer(jc, jmesh, products=products)(
        jax.device_put(np.asarray(wire), jtp.tp_wire_sharding(jc, jmesh)),
        qj))
    return p, j


@pytest.mark.parametrize("mode,rtol", [("f32", 1e-5), ("int8x2", 3e-4),
                                       ("bf16x2", 1e-4)])
def test_antenna_sharded_matches_jax_and_golden(mode, rtol):
    pc, jc = (c.replace(weight_mode=mode) for c in (pcfg.TINY, jcfg.TINY))
    cal = CalTable.random(pc, seed=5)
    wire = make_noise_block(pc, rms=2.0, seed=11)
    p, j = _both(pc, jc, 1, 2, wire, cal=cal)
    assert p.shape == pc.out_block_shape
    assert relative_power_error(p, j) <= JAX_RTOL
    assert_power_close(p, _golden(pc, wire, cal=cal), rtol=rtol,
                       what=f"antenna-sharded {mode}")


@pytest.mark.parametrize("mode", ["int8x2", "f32"])
def test_chan_x_ant_2d_mesh(mode):
    """Composed 2-D mesh: 4 channel groups x 2 antenna groups."""
    pc = pcfg.TINY.replace(n_chan=8, n_chan_total=8, weight_mode=mode)
    jc = jcfg.TINY.replace(n_chan=8, n_chan_total=8, chan_tile=2,
                           weight_mode=mode)
    wire = make_noise_block(pc, rms=2.0, seed=13)
    p, j = _both(pc, jc, 4, 2, wire)
    assert relative_power_error(p, j) <= JAX_RTOL
    assert_power_close(p, _golden(pc, wire), rtol=3e-4,
                       what="2-D chan x ant")


def test_antenna_sharded_point_source_peak():
    cfg = pcfg.TINY
    pmesh, _ = _meshes(2, 4)
    # 16 antennas in 4 groups: 4 rows each, refused.
    with pytest.raises(ValueError, match="multiple of 8"):
        ptp.tp_beamformer(cfg, pmesh)
    target = 9
    wire = make_point_source_block(cfg, cfg.beam_angles_rad()[target],
                                   noise_rms=0.2, seed=3)
    p, j = _both(cfg, jcfg.TINY, 2, 2, wire)
    assert int(np.argmax(p.sum(axis=(0, 1)))) == target
    assert relative_power_error(p, j) <= JAX_RTOL
    assert_power_close(p, _golden(cfg, wire), what="tp point source")


@pytest.mark.parametrize("mode", ["int12", "int13", "int8"])
def test_unsupported_mode_rejected(mode):
    pmesh, jmesh = _meshes(1, 2)
    with pytest.raises(ValueError, match="antenna sharding supports") as p:
        ptp.tp_beamformer(pcfg.TINY.replace(weight_mode=mode), pmesh)
    with pytest.raises(ValueError, match="antenna sharding supports") as j:
        jtp.tp_beamformer(jcfg.TINY.replace(weight_mode=mode), jmesh)
    assert str(p.value) == str(j.value)
    with pytest.raises(ValueError, match="not divisible by 3"):
        ptp.tp_beamformer(pcfg.TINY, ptp.make_tp_mesh(
            3, 1, devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="requested 4 devices, have 2"):
        ptp.make_tp_mesh(2, 2, devices=["cpu"] * 2)


@pytest.mark.parametrize("mode", ["f32", "int8x2"])
def test_antenna_sharded_stokes(mode):
    """Full Stokes over the antenna sum: every plane within JAX_RTOL of
    JAX (of the I peak) and the golden's bar."""
    pc, jc = (c.replace(weight_mode=mode) for c in (pcfg.TINY, jcfg.TINY))
    wire = make_noise_block(pc, rms=2.0, seed=31)
    st, j = _both(pc, jc, 2, 2, wire, products="stokes")
    ref = beamform_stokes_ref(weights_numpy_golden(pc), wire,
                              pc.input_layout, pc.navg_time, pc.navg_freq)
    assert st.shape == ref.shape == j.shape
    scale = np.abs(ref[:, :, 0]).max()
    assert np.abs(st - ref).max() / scale < (1e-5 if mode == "f32" else 3e-4)
    assert np.abs(st - j).max() / np.abs(j[:, :, 0]).max() <= JAX_RTOL


def test_antenna_sharded_matches_single_device():
    """The antenna sum against the single-device fused product of the same
    table (the card's bar for it: 1e-5), and the wire split as JAX's."""
    cfg = pcfg.TINY.replace(weight_mode="int8x2", input_layout="ftpa")
    pmesh, _ = _meshes(2, 2)
    wire = make_noise_block(cfg, rms=2.0, seed=7)
    parts = ptp.tp_wire_sharding(cfg, pmesh).put(wire)
    for s, part in enumerate(parts):
        c, g = divmod(s, 2)
        assert part.is_contiguous()
        assert np.array_equal(part.numpy(),
                              wire[4 * c:4 * c + 4, :, :, 8 * g:8 * g + 8])
    p = ptp.tp_beamformer(cfg, pmesh)(parts, ptp.shard_weights_tp(cfg,
                                                                  pmesh))
    single = beamform_power(wire, prepare_weights(
        cfg, make_weights(cfg, device="cpu")), cfg)
    assert relative_power_error(p.numpy(), single.numpy()) <= 1e-5
