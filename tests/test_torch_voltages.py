"""The port's unfused beam voltages on the CPU (the plain version of the
voltage kernel) against the JAX package's ``beamform_voltages`` in interpret
mode, the float64 golden model, and the port's own fused detection
products (the check the voltage path exists for)."""

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
from dsabeamformer_tpu_torch.models.weights import (
    make_weights,
    weights_numpy_golden,
)
from dsabeamformer_tpu_torch.ops.packing import unpack_wire_to_complex
from dsabeamformer_tpu_torch.ops.reference import (
    average_ref,
    beamform_voltages_ref,
    detect_ref,
    stokes_ref,
)
from dsabeamformer_tpu_torch.utils.testing import assert_power_close

GEOMS = {
    "tiny": (jcfg.TINY, pcfg.TINY),
    "dsa10_small": (jcfg.DSA10.replace(n_chan=8, t_block=64, time_tile=64),
                    pcfg.DSA10.replace(n_chan=8, t_block=64)),
    "dsa10c_small": (jcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64,
                                                time_tile=64),
                     pcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64)),
}


def _pair(geom="tiny", layout="tfpa", mode="int8x2", seed=7):
    jc, pc = (c.replace(input_layout=layout, weight_mode=mode)
              for c in GEOMS[geom])
    qj = jq.prepare_weights(jc, jmake_weights(jc, cal=JCal.random(jc,
                                                                  seed=seed)))
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    return jc, pc, qj, qp


@pytest.mark.parametrize("mode", ["int8x2", "int8"])
@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_voltages_equal_jax(geom, layout, mode):
    """The exact integer GEMM times one float32 scale: equal to the JAX
    kernel's voltages bit for bit."""
    jc, pc, qj, qp = _pair(geom, layout, mode)
    wire = make_random_bytes_block(pc, seed=3)
    vj = np.asarray(jgemm.beamform_voltages(jnp.asarray(wire), qj, jc))
    vp = pgemm.beamform_voltages(wire, qp, pc)
    assert vp.dtype == torch.float32
    assert tuple(vp.shape) == vj.shape == (pc.n_chan, pc.t_block, pc.n_pol,
                                           2 * pc.n_beams)
    np.testing.assert_array_equal(vp.numpy(), vj)


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_voltages_vs_golden(layout):
    """Within 2e-4 of the peak of the float64 golden voltages, as
    tests/test_gemm.py holds the JAX kernel."""
    cfg = pcfg.TINY.replace(input_layout=layout)
    wire = make_noise_block(cfg, rms=2.0, seed=31)
    qw = pq.prepare_weights(cfg, make_weights(cfg, device="cpu"))
    bv = pgemm.voltages_to_complex(pgemm.beamform_voltages(wire, qw,
                                                           cfg).numpy())
    ref = beamform_voltages_ref(weights_numpy_golden(cfg),
                                unpack_wire_to_complex(wire, layout))
    assert bv.shape == ref.shape and bv.dtype == np.complex64
    np.testing.assert_allclose(bv, ref, atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_fused_equals_unfused(geom, layout):
    """The fused products against detection applied to the unfused
    voltages, same quantized weights: power within 1e-5 (relative power
    error), each Stokes plane within 1e-5 of the I peak."""
    _, pc, _, qp = _pair(geom, layout)
    wire = make_noise_block(pc, rms=2.0, seed=41)
    bv = pgemm.voltages_to_complex(pgemm.beamform_voltages(wire, qp,
                                                           pc).numpy())
    bv = bv.astype(np.complex128)
    p_fused = pgemm.beamform_power(wire, qp, pc).numpy()
    p_unfused = average_ref(detect_ref(bv), pc.navg_time, pc.navg_freq)
    assert_power_close(p_fused, p_unfused, rtol=1e-5, what="fused vs unfused")
    st = pgemm.beamform_stokes(wire, qp, pc).numpy()
    f, t = st.shape[:2]
    st_unfused = stokes_ref(bv).reshape(f, t, pc.navg_time, 4,
                                        pc.n_beams).sum(axis=2)
    peak = np.abs(st_unfused[:, :, 0]).max()
    for k in range(4):
        assert np.abs(st[:, :, k] - st_unfused[:, :, k]).max() <= 1e-5 * peak


def test_voltages_to_complex_forms():
    rng = np.random.default_rng(0)
    bv = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    c = pgemm.voltages_to_complex(bv)
    assert c.shape == (2, 3, 2, 4) and c.dtype == np.complex64
    np.testing.assert_array_equal(c.real, bv[..., :4])
    np.testing.assert_array_equal(c.imag, bv[..., 4:])
    ct = pgemm.voltages_to_complex(torch.from_numpy(bv))
    assert ct.dtype == torch.complex64
    np.testing.assert_array_equal(ct.numpy(), c)


def test_plain_voltages_chunking_and_counter():
    """The plain version does not depend on its channel chunk, and a CPU
    call launches nothing."""
    _, pc, _, qp = _pair("dsa10_small")
    wire = make_random_bytes_block(pc, seed=8)
    x, tm = pgemm._prepare_wire(wire, pc)
    before = pgemm.beamform_voltages.launches
    whole = pgemm.beamform_voltages(wire, qp, pc)
    one = pgemm.voltages_plain(x, qp.terms, qp.scales, pc, tm, chan_chunk=3)
    assert torch.equal(whole, one)
    assert pgemm.beamform_voltages.launches == before == 0


def test_voltage_errors():
    _, pc, _, qp = _pair()
    wire = make_noise_block(pc, seed=1)
    with pytest.raises(ValueError, match="takes 1 bfloat16 weight term"):
        pgemm.beamform_voltages(wire, qp, pc.replace(weight_mode="bf16"))
    with pytest.raises(ValueError, match="does not match"):
        pgemm.beamform_voltages(wire, qp, pc.replace(n_beams=64))
    with pytest.raises(ValueError, match="neither"):
        pgemm.beamform_voltages(wire[:, :4], qp, pc)
    with pytest.raises(ValueError, match="uint8"):
        pgemm.beamform_voltages(wire.astype(np.int16), qp, pc)
    with pytest.raises(ValueError, match="weights are on"):
        pgemm.beamform_voltages(torch.from_numpy(wire).to("meta"), qp, pc)
