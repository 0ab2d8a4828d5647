"""The port's ``beamform_power`` (its plain version, which a CPU tensor
takes) against the JAX package's fused Pallas kernel in interpret mode, the
float64 golden model and the recorded golden block; input checks mirrored
from the JAX package."""

from pathlib import Path

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
    make_point_source_block,
    make_random_bytes_block,
)
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import make_weights, weights_numpy_golden
from dsabeamformer_tpu_torch.ops.reference import beamform_block_ref
from dsabeamformer_tpu_torch.utils.testing import assert_power_close, relative_power_error

#: Port vs JAX on identical wire and weights: the integers are exact in
#: both, only float32 summation order differs.
JAX_RTOL = 1e-6

FIXTURE = Path(__file__).parent / "data" / "golden_tiny_block.npz"

GEOMS = {
    "tiny": (jcfg.TINY, pcfg.TINY),
    "dsa10_small": (jcfg.DSA10.replace(n_chan=8, t_block=64, time_tile=64),
                    pcfg.DSA10.replace(n_chan=8, t_block=64)),
    "dsa10c_small": (jcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64,
                                                time_tile=64),
                     pcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64)),
}


def _carried_weights(jc, seed=5):
    """The JAX package's quantized weights, and the same integers and
    scales as the port's."""
    qj = jq.prepare_weights(jc, jmake_weights(jc, cal=JCal.random(jc, seed=seed)))
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    return qj, qp


@pytest.mark.parametrize("case", [
    ("tiny", "tfpa", "int8x2", 1),
    ("tiny", "ftpa", "int8x2", 1),
    ("tiny", "tfpa", "int8", 1),
    ("tiny", "tfpa", "int8x2", 2),
    ("dsa10_small", "tfpa", "int8x2", 1),
    ("dsa10_small", "ftpa", "int8", 2),
    ("dsa10c_small", "tfpa", "int8x2", 1),
    ("dsa10c_small", "ftpa", "int8x2", 1),
], ids=lambda c: "-".join(map(str, c)))
def test_beamform_power_matches_jax(case):
    geom, layout, mode, navg_freq = case
    jc, pc = (c.replace(input_layout=layout, weight_mode=mode,
                        navg_freq=navg_freq) for c in GEOMS[geom])
    wire = make_random_bytes_block(pc, seed=17)
    qj, qp = _carried_weights(jc)
    want = np.asarray(jgemm.beamform_power(jnp.asarray(wire), qj, jc))
    got = pgemm.beamform_power(torch.from_numpy(wire), qp, pc)
    assert got.dtype == torch.float32 and tuple(got.shape) == pc.out_block_shape
    assert relative_power_error(got.numpy(), want) <= JAX_RTOL


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", ["tiny", "dsa10_small"])
def test_point_source_vs_golden(geom, layout):
    pc = GEOMS[geom][1].replace(input_layout=layout)
    target = pc.n_beams // 3
    wire = make_point_source_block(pc, angle_rad=pc.beam_angles_rad()[target],
                                   noise_rms=0.4, seed=7)
    p = pgemm.beamform_power(
        wire, pq.prepare_weights(pc, make_weights(pc, device="cpu")),
        pc).numpy()
    ref = beamform_block_ref(weights_numpy_golden(pc), wire, layout,
                             pc.navg_time)
    assert int(np.argmax(p.sum(axis=(0, 1)))) == target
    assert_power_close(p, ref, what=f"{geom} {layout}")


@pytest.mark.parametrize("mode,rtol", [("int8x2", 2e-4), ("int8", 2e-2)])
def test_noise_vs_golden_with_calibration(mode, rtol):
    pc = pcfg.TINY.replace(weight_mode=mode)
    cal = CalTable.random(pc, seed=11)
    wire = make_noise_block(pc, rms=2.5, seed=21)
    p = pgemm.beamform_power(wire, pq.prepare_weights(
        pc, make_weights(pc, cal=cal, device="cpu")), pc).numpy()
    ref = beamform_block_ref(weights_numpy_golden(pc, cal=cal), wire,
                             pc.input_layout, pc.navg_time)
    assert_power_close(p, ref, rtol=rtol, what=mode)


def test_recorded_golden_block():
    """tests/data/golden_tiny_block.npz through the port, as
    test_golden_block.py runs it through the JAX package."""
    d = np.load(FIXTURE)
    cfg = pcfg.TINY
    cal = CalTable(gains=d["cal_gains"])
    qw = pq.quantize_weights(make_weights(cfg, cal=cal, device="cpu"),
                             cfg.weight_mode)
    p = pgemm.beamform_power(d["wire"], qw, cfg).numpy()
    assert_power_close(p, d["powers"], what="recorded block")
    assert int(np.argmax(p.sum(axis=(0, 1)))) == int(d["target_beam"])


def test_wire_forms_and_chunking_agree():
    pc = GEOMS["dsa10_small"][1]
    wire = make_random_bytes_block(pc, seed=4)
    qw = pq.prepare_weights(pc, make_weights(pc, device="cpu"))
    p4 = pgemm.beamform_power(wire, qw, pc)
    dev = pgemm.device_wire_view(wire, pc)
    assert dev.shape == pc.device_wire_shape
    p2 = pgemm.beamform_power(torch.from_numpy(dev), qw, pc)
    torch.testing.assert_close(p2, p4, rtol=0, atol=0)
    x, tm = pgemm._prepare_wire(dev, pc)
    one = pgemm.detect_power_plain(x, qw.terms, qw.scales, pc, tm,
                                   chan_chunk=1)[0]
    torch.testing.assert_close(one, p4, rtol=0, atol=0)
    with pytest.raises(ValueError, match="host form"):
        pgemm.device_wire_view(dev, pc)


@pytest.mark.parametrize("bad", ["beams", "scales", "k"])
def test_check_weights_errors_match_jax(bad):
    jc, pc = GEOMS["tiny"]
    qj, qp = _carried_weights(jc)
    if bad == "beams":
        jc, pc = jc.replace(n_beams=64), pc.replace(n_beams=64)
    elif bad == "scales":
        qj = qj._replace(scales=qj.scales[:4])
        qp = qp._replace(scales=qp.scales[:4])
    else:
        jc, pc = jc.replace(n_ant_compute=8), pc.replace(n_ant_compute=8)
    with pytest.raises(ValueError) as ej:
        jgemm._check_weights(qj, jc)
    with pytest.raises(ValueError) as ep:
        pgemm._check_weights(qp, pc)
    assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("bad", ["dtype", "shape", "layout_shape"])
def test_prepare_wire_errors_match_jax(bad):
    jc, pc = GEOMS["tiny"]
    wire = make_random_bytes_block(pc, seed=1)
    if bad == "dtype":
        wire = wire.astype(np.uint16)
    elif bad == "shape":
        wire = wire[:-1]
    else:
        jc, pc = (c.replace(input_layout="ftpa") for c in (jc, pc))
    with pytest.raises(ValueError) as ej:
        jgemm._prepare_wire(jnp.asarray(wire), jc)
    with pytest.raises(ValueError) as ep:
        pgemm._prepare_wire(torch.from_numpy(wire), pc)
    assert str(ep.value) == str(ej.value)


def test_no_fallback_for_other_devices():
    """A tensor that is not on the CPU never takes the plain version."""
    pc = pcfg.TINY
    qw = pq.prepare_weights(pc, make_weights(pc, device="cpu"))
    meta = torch.empty(pc.device_wire_shape, dtype=torch.uint8, device="meta")
    mq = pq.QuantWeights(tuple(t.to("meta") for t in qw.terms),
                         qw.scales.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        pgemm.beamform_power(meta, mq, pc)
    with pytest.raises(ValueError, match="weights are on"):
        pgemm.beamform_power(make_random_bytes_block(pc), mq, pc)
    assert not any(pgemm.fused_detect.launches.values())


INT_MODES = ("int8", "int8x2", "int12", "int13")


@pytest.mark.parametrize("ac", [8, 24, 32, 112, 128])
@pytest.mark.parametrize("mode", INT_MODES)
def test_tensor_core_operands_give_the_plain_integers(mode, ac):
    """The int8 detect kernel's operand layouts, stated in torch
    (``_mma_operands``: K in steps of [re of 16 antennas | im of the same
    16] with the tail zero-filled, a beam's Re and Im columns side by side)
    and its one-accumulator algebra (``_mma_product``: int8x2's sums times
    256 before the lo term, the folded modes' 16 x against the hi
    sub-terms) give the integers of ``detect_power_plain``'s GEMM."""
    cfg = pcfg.DSA110.replace(weight_mode=mode, n_ant=128, n_ant_active=ac - 3,
                              n_ant_compute=ac, n_chan=2, t_block=32,
                              n_beams=16)
    qw = pq.prepare_weights(cfg, make_weights(
        cfg, cal=CalTable.random(cfg, seed=2), device="cpu"))
    x, tm = pgemm._prepare_wire(make_random_bytes_block(cfg, seed=ac), cfg)
    re, im = pgemm._unpack_chunk(x, cfg, tm, 0, cfg.n_chan)
    want = pgemm._gemm_chunk(re, im, qw.terms, 0, cfg.n_chan, mode)
    xk, subs = pgemm._mma_operands(re, im, qw.terms, cfg)
    n_steps = -(-ac // 16)
    assert xk.dtype == torch.int8 and len(subs) == pgemm.n_subterms(cfg)
    assert tuple(xk.shape) == (2, 32, 2, 32 * n_steps)
    for sub in subs:
        assert sub.dtype == torch.int8
        assert tuple(sub.shape) == (2, 32 * n_steps, 16, 2)
    # The zero tail of the last step, in both operands.
    tail = ac - 16 * (n_steps - 1)
    last = xk[..., 32 * (n_steps - 1):].reshape(2, 32, 2, 2, 16)
    assert not last[..., tail:].any() and last[..., :tail].any()
    assert not subs[0][:, 32 * (n_steps - 1):].reshape(
        2, 2, 16, 16, 2)[:, :, tail:].any()
    got = pgemm._mma_product(xk, subs, cfg)                # [F, T, P, B, 2]
    assert got.dtype == torch.int32 and int(got.abs().max()) < 2 ** 27
    flat = torch.cat([got[..., 0], got[..., 1]], dim=-1)   # [F, T, P, 2B]
    flat = flat.permute(0, 2, 1, 3).reshape(2, 2 * 32, 2 * 16)
    assert torch.equal(flat.to(torch.float32), want)
    assert float(want.abs().max()) > 0
