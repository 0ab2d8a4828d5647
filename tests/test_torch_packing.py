"""Port vs JAX package: 4R4I packing, synthetic generators, array and
calibration tables, planar complex, and the float64 golden model -- all
bit- or byte-exact."""

import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ingest.generator as jgen
import dsabeamformer_tpu.models.arrays as jarrays
import dsabeamformer_tpu.models.calibration as jcal
import dsabeamformer_tpu.ops.packing as jpack
import dsabeamformer_tpu.ops.reference as jref
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ingest.generator as pgen
import dsabeamformer_tpu_torch.models.arrays as parrays
import dsabeamformer_tpu_torch.models.calibration as pcal
import dsabeamformer_tpu_torch.ops.packing as ppack
import dsabeamformer_tpu_torch.ops.reference as pref
from dsabeamformer_tpu_torch.ops.cplx import CVec

ALL_BYTES = np.arange(256, dtype=np.uint8)

GEOMS = {
    "tiny": (jcfg.TINY, pcfg.TINY),
    "dsa10_small": (jcfg.DSA10.replace(n_chan=8, t_block=64, time_tile=64),
                    pcfg.DSA10.replace(n_chan=8, t_block=64)),
    "dsa10c_small": (jcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64,
                                                time_tile=64),
                     pcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64)),
}


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_unpack_all_bytes_matches_jax(kind):
    jre, jim = jpack.unpack_4r4i(ALL_BYTES)
    b = torch.from_numpy(ALL_BYTES) if kind == "torch" else ALL_BYTES
    re, im = ppack.unpack_4r4i(b)
    re, im = np.asarray(re), np.asarray(im)
    assert re.dtype == np.int8 and im.dtype == np.int8
    np.testing.assert_array_equal(re, jre)
    np.testing.assert_array_equal(im, jim)
    # Round trip: every byte value survives unpack -> pack.
    back = ppack.pack_4r4i(*ppack.unpack_4r4i(b))
    np.testing.assert_array_equal(np.asarray(back), ALL_BYTES)


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_pack_matches_jax_with_saturation(kind):
    vals = np.arange(-10, 10)
    re, im = (a.ravel() for a in np.meshgrid(vals, vals))
    want = jpack.pack_4r4i(re, im)
    if kind == "torch":
        got = ppack.pack_4r4i(torch.from_numpy(re), torch.from_numpy(im))
        assert got.dtype == torch.uint8
        got = got.numpy()
    else:
        got = ppack.pack_4r4i(re, im)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_unpack_wire_to_complex_matches_jax(layout):
    rng = np.random.default_rng(5)
    wire = rng.integers(0, 256, size=(6, 4, 2, 8), dtype=np.uint8)
    want = jpack.unpack_wire_to_complex(wire, layout)
    got_np = ppack.unpack_wire_to_complex(wire, layout)
    assert got_np.dtype == np.complex128
    np.testing.assert_array_equal(got_np, want)
    got_t = ppack.unpack_wire_to_complex(torch.from_numpy(wire), layout)
    assert got_t.dtype == torch.complex64
    np.testing.assert_array_equal(got_t.numpy(), want)
    with pytest.raises(ValueError, match="unknown layout"):
        ppack.unpack_wire_to_complex(wire, "tpfa")


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("gen", ["random_bytes", "noise", "point_source"])
def test_generators_byte_identical_to_jax(gen, geom, layout):
    jc, pc = (c.replace(input_layout=layout) for c in GEOMS[geom])
    if gen == "random_bytes":
        want = jgen.make_random_bytes_block(jc, seed=3)
        got = pgen.make_random_bytes_block(pc, seed=3)
    elif gen == "noise":
        want = jgen.make_noise_block(jc, rms=2.5, seed=3)
        got = pgen.make_noise_block(pc, rms=2.5, seed=3)
    else:
        g = pcal.CalTable.random(pc, seed=4).gains
        angle = pc.beam_angles_rad()[5]
        want = jgen.make_point_source_block(jc, angle, noise_rms=0.4, seed=3,
                                            instrumental_gains=g)
        got = pgen.make_point_source_block(pc, angle, noise_rms=0.4, seed=3,
                                           instrumental_gains=g)
    assert got.dtype == np.uint8 and got.shape == pc.wire_block_shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_array_and_calibration_copies_match_jax(geom, tmp_path):
    jc, pc = GEOMS[geom]
    ja, pa = jarrays.array_for(jc), parrays.array_for(pc)
    np.testing.assert_array_equal(pa.positions_m, ja.positions_m)
    assert pa.n_active == ja.n_active and pa.n_ant == ja.n_ant
    np.testing.assert_array_equal(pa.padded(pa.n_ant + 4).positions_m,
                                  ja.padded(ja.n_ant + 4).positions_m)
    np.testing.assert_array_equal(pcal.CalTable.unity(pc).gains,
                                  jcal.CalTable.unity(jc).gains)
    np.testing.assert_array_equal(pcal.CalTable.random(pc, seed=9).gains,
                                  jcal.CalTable.random(jc, seed=9).gains)
    # Files written by one package load in the other.
    ja.save(str(tmp_path / "layout.npz"))
    np.testing.assert_array_equal(
        parrays.ArrayLayout.load(str(tmp_path / "layout.npz")).positions_m,
        ja.positions_m)
    pcal.CalTable.random(pc, seed=9).save(str(tmp_path / "cal.npz"))
    np.testing.assert_array_equal(
        jcal.CalTable.load(str(tmp_path / "cal.npz")).gains,
        jcal.CalTable.random(jc, seed=9).gains)


def test_text_position_table(tmp_path):
    path = tmp_path / "ants.txt"
    path.write_text("# ew ns\n0 1\n5 2\n10 0\n")
    lay = parrays.ArrayLayout.load(str(path))
    np.testing.assert_array_equal(lay.positions_m, [0.0, 5.0, 10.0])
    np.testing.assert_array_equal(lay.ns, [1.0, 2.0, 0.0])
    assert lay.n_active == 3 and lay.padded(8).n_ant == 8
    with pytest.raises(ValueError, match="cannot pad"):
        lay.padded(2)


def test_cvec_roundtrip():
    rng = np.random.default_rng(2)
    z = rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))
    c = CVec.from_numpy(z, device="cpu")
    assert c.re.dtype == torch.float32 and c.shape == (3, 4)
    assert c.device == torch.device("cpu")
    np.testing.assert_allclose(c.to_numpy(), z, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_golden_model_matches_jax(layout):
    jc, pc = (c.replace(input_layout=layout) for c in GEOMS["tiny"])
    wire = pgen.make_noise_block(pc, rms=2.0, seed=8)
    w = (np.random.default_rng(1).standard_normal((8, 32, 16))
         + 1j * np.random.default_rng(2).standard_normal((8, 32, 16)))
    want = jref.beamform_block_ref(w, wire, layout, 16, 2)
    got = pref.beamform_block_ref(w, wire, layout, 16, 2)
    np.testing.assert_array_equal(got, want)
