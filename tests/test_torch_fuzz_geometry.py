"""Random valid geometries through the port (its plain version, which a CPU
tensor takes) against the JAX package's fused kernel in interpret mode and
the float64 golden model: the geometries and seeds of
``tests/test_fuzz_geometry.py`` (``utils.testing.random_geometry``), n_ant
8-32 with zero padding and auto slicing, 8-32 beams, navg_time 2-16, one to
three windows a block, navg_freq 1-2, both layouts, five weight modes.  The
card tests (``tests/test_torch_cuda.py``) hold the CUDA kernels to the plain
version on the same cases."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ops.gemm as jgemm
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu_torch.ops.gemm as pgemm
import dsabeamformer_tpu_torch.ops.quantize as pq
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu_torch.ingest.generator import make_noise_block
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import make_weights, weights_numpy_golden
from dsabeamformer_tpu_torch.ops.reference import (
    beamform_block_ref,
    beamform_stokes_ref,
)
from dsabeamformer_tpu_torch.utils.testing import (
    FUZZ_RTOL,
    FUZZ_SEED,
    assert_power_close,
    random_geometry,
)

N_GEOMETRIES = 10
#: Port vs JAX on identical wire and weights, as a share of the block's peak:
#: the integer modes' GEMM is the same integer in both and the float32
#: detection sums differ in order only; the float modes' K-sums too.
JAX_ATOL = 2e-6


def _jax_cfg(pc, tiles):
    fields = {f.name: getattr(pc, f.name) for f in dataclasses.fields(pc)}
    return jcfg.ObsConfig(**fields, **tiles)


def _jax_fuzz_module():
    spec = importlib.util.spec_from_file_location(
        "jax_fuzz_geometry", Path(__file__).parent / "test_fuzz_geometry.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_geometries_are_the_jax_tests():
    """Field for field the cases of tests/test_fuzz_geometry.py, and between
    them every a_compute from 8 to 32, both layouts and all five modes."""
    jmod = _jax_fuzz_module()
    seen = set()
    for i in range(N_GEOMETRIES):
        pc, tiles = random_geometry(i)
        want = jmod._random_cfg(np.random.default_rng(FUZZ_SEED + i), i)
        assert _jax_cfg(pc, tiles) == want
        assert pc.a_compute == want.a_compute
        assert pc.out_block_shape == want.out_block_shape
        assert FUZZ_RTOL == jmod.RTOL
        seen.add((pc.a_compute, pc.input_layout, pc.weight_mode))
    assert {a for a, _, _ in seen} >= {8, 16, 24, 32}
    assert {l for _, l, _ in seen} == {"tfpa", "ftpa"}
    assert len({m for _, _, m in seen}) == 5


@pytest.mark.parametrize("i", range(N_GEOMETRIES))
def test_random_geometry_matches_jax_and_golden(i):
    pc, tiles = random_geometry(i)
    jc = _jax_cfg(pc, tiles)
    what = (f"{pc.name} {pc.weight_mode} A={pc.n_ant}/{pc.n_ant_active} "
            f"a_c={pc.a_compute} {pc.input_layout}")
    wire = make_noise_block(pc, rms=2.0, seed=i)
    # The JAX package's weights, carried over bit for bit.
    qj = jq.quantize_weights(jmake_weights(jc, cal=JCal.random(jc, seed=i)),
                             jc.weight_mode, jc.a_compute)
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    want = np.asarray(jgemm.beamform_power(wire, qj, jc))
    got = pgemm.beamform_power(wire, qp, pc).numpy()
    assert got.shape == pc.out_block_shape == want.shape
    assert np.abs(got - want).max() <= JAX_ATOL * np.abs(want).max(), what
    # The port's own weights against the float64 golden model.
    cal = CalTable.random(pc, seed=i)
    qw = pq.prepare_weights(pc, make_weights(pc, cal=cal, device="cpu"))
    p = pgemm.beamform_power(wire, qw, pc).numpy()
    golden = weights_numpy_golden(pc, cal=cal)
    ref = beamform_block_ref(golden, wire, pc.input_layout, pc.navg_time,
                             pc.navg_freq)
    assert_power_close(p, ref, rtol=FUZZ_RTOL[pc.weight_mode], what=what)
    # The canonical device-wire form agrees bit for bit with the host form.
    p_dev = pgemm.beamform_power(pgemm.device_wire_view(wire, pc), qw,
                                 pc).numpy()
    np.testing.assert_array_equal(p, p_dev)
    if i % 3 == 0:
        st = pgemm.beamform_stokes(wire, qw, pc).numpy()
        np.testing.assert_allclose(st[:, :, 0], p, rtol=1e-6)
        st_ref = beamform_stokes_ref(golden, wire, pc.input_layout,
                                     pc.navg_time, pc.navg_freq)
        scale = np.abs(st_ref[:, :, 0]).max()
        assert np.abs(st - st_ref).max() / scale <= FUZZ_RTOL[pc.weight_mode]
        sj = np.asarray(jgemm.beamform_stokes(wire, qj, jc))
        sp = pgemm.beamform_stokes(wire, qp, pc).numpy()
        assert np.abs(sp - sj).max() <= JAX_ATOL * np.abs(sj[:, :, 0]).max()
