"""The port's channel mesh (``parallel/sharding.py``) on eight CPU slots
against the JAX package's ``sharded_beamformer`` on its eight virtual CPU
devices (tests/test_sharding.py's cases, seeds and sizes), against the
port's single-device product (byte for byte: the per-channel arithmetic does
not depend on the channel count) and against the float64 golden model."""

import jax
import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ops.gemm as jgemm
import dsabeamformer_tpu.parallel.sharding as jsh
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.parallel as ppar
import dsabeamformer_tpu_torch.parallel.sharding as psh
from dsabeamformer_tpu_torch.ingest.generator import (
    make_noise_block,
    make_point_source_block,
)
from dsabeamformer_tpu_torch.models.weights import weights_numpy_golden
from dsabeamformer_tpu_torch.ops.gemm import beamform_power, beamform_stokes
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
#: The band against the product's own channel sum (the JAX test's bar).
BAND_RTOL = 1e-5

#: TINY with the DSA-110 sharding structure: 16 channels over 8 slots.
PCFG = pcfg.TINY.replace(n_chan=16, n_chan_total=16)
JCFG = jcfg.TINY.replace(n_chan=16, n_chan_total=16, chan_tile=2)
#: The DSA-110 structure (128 slots, 110 active, 512 -> 64 beams) at test
#: size, as tests/test_sharding.py::test_dsa110_structure_compiles_small.
PCFG110 = pcfg.DSA110.replace(n_chan=16, n_chan_total=2048, t_block=64,
                              n_beams=64)
JCFG110 = jcfg.DSA110.replace(n_chan=16, n_chan_total=2048, t_block=64,
                              time_tile=32, chan_tile=2, n_beams=64)


@pytest.fixture(scope="module")
def pmesh():
    return psh.make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_mesh(8)


def _run_jax(jc, jmesh, wire, **kw):
    step = jsh.sharded_beamformer(jc, jmesh, **kw)
    wire_sh = jax.device_put(jgemm.device_wire_view(wire, jc),
                             jsh.sharded_wire_sharding(jc, jmesh))
    res = step(wire_sh, jsh.shard_weights(jc, jmesh))
    return [np.asarray(r) for r in res] if isinstance(res, tuple) \
        else np.asarray(res)


def _run_port(pc, pmesh, wire, **kw):
    res = psh.sharded_beamformer(pc, pmesh, **kw)(
        wire, psh.shard_weights(pc, pmesh))
    return [r.numpy() for r in res] if isinstance(res, tuple) \
        else res.numpy()


def _single_table(pc, pmesh):
    """The split table made whole again."""
    qw = psh.shard_weights(pc, pmesh)
    return type(qw[0])(
        terms=tuple(torch.cat([q.terms[i] for q in qw])
                    for i in range(len(qw[0].terms))),
        scales=torch.cat([q.scales for q in qw]))


def _single(pc, pmesh, wire, detect=beamform_power, **kw):
    """The port's single-device product with the same table."""
    return detect(wire, _single_table(pc, pmesh), pc, **kw)


def test_mesh_and_weights_as_jax(pmesh, jmesh):
    """The mesh's shape, the split table byte for byte the JAX package's
    channel-sharded one, the wire parts contiguous subbands."""
    assert pmesh.shape == {"chan": 8} == dict(jmesh.shape)
    assert pmesh.slots == [torch.device("cpu")] * 8
    qp = psh.shard_weights(PCFG, pmesh)
    qj = jsh.shard_weights(JCFG, jmesh)
    assert len(qp) == 8
    for k in range(2):
        got = torch.cat([q.terms[k] for q in qp]).numpy()
        assert np.array_equal(got, np.asarray(qj.terms[k]))
    assert np.array_equal(torch.cat([q.scales for q in qp]).numpy(),
                          np.asarray(qj.scales))
    for layout in ("tfpa", "ftpa"):
        pc = PCFG.replace(input_layout=layout)
        wire = make_noise_block(pc, rms=2.0, seed=1)
        parts = psh.sharded_wire_sharding(pc, pmesh).put(wire)
        local = pc.replace(n_chan=2)
        full = wire.reshape(pc.device_wire_shape)
        for k, part in enumerate(parts):
            assert part.is_contiguous()
            assert tuple(part.shape) == local.device_wire_shape
            sub = wire[:, 2 * k:2 * k + 2] if layout == "tfpa" \
                else wire[2 * k:2 * k + 2]
            assert np.array_equal(part.numpy().ravel(), sub.ravel())
        assert full.shape == pc.device_wire_shape


def test_make_mesh_refusals():
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        psh.make_mesh(9, devices=["cpu"] * 8)
    # The default is the visible cards, each once: none here.
    with pytest.raises(ValueError,
                       match=f"requested 2 devices, have "
                             f"{torch.cuda.device_count()}"):
        psh.make_mesh(2)
    assert psh.make_mesh(devices=["cpu"] * 3).shape == {"chan": 3}
    assert psh.make_mesh(2, devices=["cpu"] * 8).size == 2


def test_sharded_matches_single_device(pmesh, jmesh):
    wire = make_noise_block(PCFG, rms=2.0, seed=1)
    got = _run_port(PCFG, pmesh, wire)
    assert np.array_equal(got, _single(PCFG, pmesh, wire).numpy())
    assert relative_power_error(got, _run_jax(JCFG, jmesh, wire)) <= JAX_RTOL


def test_sharded_ftpa_matches_single_device(pmesh):
    pc = PCFG.replace(input_layout="ftpa")
    wire = make_noise_block(pc, rms=2.0, seed=2)
    assert np.array_equal(_run_port(pc, pmesh, wire),
                          _single(pc, pmesh, wire).numpy())


def test_sharded_point_source_peak(pmesh, jmesh):
    target = 7
    wire = make_point_source_block(PCFG, PCFG.beam_angles_rad()[target],
                                   noise_rms=0.2, seed=3)
    p = _run_port(PCFG, pmesh, wire)
    assert int(np.argmax(p.sum(axis=(0, 1)))) == target
    assert relative_power_error(p, _run_jax(JCFG, jmesh, wire)) <= JAX_RTOL
    ref = beamform_block_ref(weights_numpy_golden(PCFG), wire,
                             PCFG.input_layout, PCFG.navg_time,
                             PCFG.navg_freq)
    assert_power_close(p, ref, what="sharded point source")


def test_band_power_psum(pmesh, jmesh):
    wire = make_noise_block(PCFG, rms=2.0, seed=5)
    powers, band = _run_port(PCFG, pmesh, wire, with_band_power=True)
    jpowers, jband = _run_jax(JCFG, jmesh, wire, with_band_power=True)
    assert band.shape == (PCFG.t_block // PCFG.navg_time,)
    np.testing.assert_allclose(band, powers.sum(axis=(0, 2)), rtol=BAND_RTOL)
    np.testing.assert_allclose(band, jband, rtol=JAX_RTOL)
    assert relative_power_error(powers, jpowers) <= JAX_RTOL


def test_dsa110_structure_small(pmesh, jmesh):
    """The DSA-110 structure (128 slots, 110 active, a_compute 128) on 8
    slots: equal to one device, within JAX_RTOL of JAX, golden-accurate."""
    wire = make_noise_block(PCFG110, rms=2.0, seed=9)
    p = _run_port(PCFG110, pmesh, wire)
    assert np.array_equal(p, _single(PCFG110, pmesh, wire).numpy())
    assert relative_power_error(p, _run_jax(JCFG110, jmesh, wire)) \
        <= JAX_RTOL
    ref = beamform_block_ref(weights_numpy_golden(PCFG110), wire,
                             PCFG110.input_layout, PCFG110.navg_time,
                             PCFG110.navg_freq)
    assert_power_close(p, ref, rtol=2e-4, what="dsa110 structure")


@pytest.mark.parametrize("n_chan,navg_freq,match", [
    (12, 1, "not divisible by mesh size 8"),
    (16, 4, "multiple of navg_freq")])
def test_mesh_size_must_divide_channels(pmesh, jmesh, n_chan, navg_freq,
                                        match):
    pc = PCFG.replace(n_chan=n_chan, n_chan_total=n_chan,
                      navg_freq=navg_freq)
    jc = JCFG.replace(n_chan=n_chan, n_chan_total=n_chan,
                      navg_freq=navg_freq, chan_tile=1)
    with pytest.raises(ValueError, match="divisible|navg_freq"):
        jsh.sharded_beamformer(jc, jmesh)
    with pytest.raises(ValueError, match=match):
        psh.sharded_beamformer(pc, pmesh)


def test_step_refusals(pmesh):
    with pytest.raises(ValueError, match="band power"):
        psh.sharded_beamformer(PCFG, pmesh, fused_quant8=True,
                               with_band_power=True)
    with pytest.raises(ValueError, match="power\\|stokes"):
        psh.sharded_beamformer(PCFG, pmesh, products="voltages")
    step = psh.sharded_beamformer(PCFG, pmesh)
    qw = psh.shard_weights(PCFG, pmesh)
    wire = make_noise_block(PCFG, seed=0)
    with pytest.raises(ValueError, match="8 wire parts"):
        step(psh.sharded_wire_sharding(PCFG, pmesh).put(wire)[:4], qw)
    with pytest.raises(TypeError, match="takes 2 arguments"):
        step(wire, qw, np.ones(PCFG.n_beams, np.float32))


def test_sharded_stokes_matches_golden(pmesh, jmesh):
    wire = make_noise_block(PCFG, rms=2.0, seed=17)
    st, band = _run_port(PCFG, pmesh, wire, products="stokes",
                         with_band_power=True)
    jst, jband = _run_jax(JCFG, jmesh, wire, products="stokes",
                          with_band_power=True)
    ref = beamform_stokes_ref(weights_numpy_golden(PCFG), wire,
                              PCFG.input_layout, PCFG.navg_time,
                              PCFG.navg_freq)
    assert st.shape == ref.shape == jst.shape
    assert np.array_equal(st, _single(PCFG, pmesh, wire,
                                      beamform_stokes).numpy())
    scale = np.abs(ref[:, :, 0]).max()
    assert np.abs(st - ref).max() / scale < 3e-4
    assert np.abs(st - jst).max() / np.abs(jst[:, :, 0]).max() <= JAX_RTOL
    np.testing.assert_allclose(band, st[:, :, 0].sum(axis=(0, 2)),
                               rtol=BAND_RTOL)
    np.testing.assert_allclose(band, jband, rtol=JAX_RTOL)


@pytest.mark.parametrize("products", ["power", "stokes"])
def test_side_outputs_match_jax(pmesh, jmesh, products):
    """incoherent (antenna 2 flagged), SK and fused quant8 through the
    mesh: equal to one device, and to JAX (the integers exactly)."""
    wire = make_noise_block(PCFG, rms=2.0, seed=61)
    kw = dict(products=products, incoherent=True, flag_ants=(2,),
              sk_stats=True)
    out, inco, sk = _run_port(PCFG, pmesh, wire, **kw)
    jout, jinco, jsk = _run_jax(JCFG, jmesh, wire, **kw)
    detect = beamform_stokes if products == "stokes" else beamform_power
    s_out, s_inco, s_sk = _single(PCFG, pmesh, wire, detect,
                                  incoherent=True, flag_ants=(2,),
                                  sk_stats=True)
    assert np.array_equal(out, s_out.numpy())
    assert np.array_equal(inco, s_inco.numpy())
    assert np.array_equal(sk, s_sk.numpy())
    np.testing.assert_array_equal(inco, jinco)
    np.testing.assert_allclose(sk, jsk, rtol=1e-6)
    scales = np.full(PCFG.n_beams, 0.5, np.float32)
    step = psh.sharded_beamformer(PCFG, pmesh, products=products,
                                  fused_quant8=True)
    q8 = step(wire, psh.shard_weights(PCFG, pmesh), scales).numpy()
    assert q8.dtype == np.uint8
    assert np.array_equal(q8, detect(
        wire, _single_table(PCFG, pmesh), PCFG,
        quant8_scales=torch.from_numpy(scales)).numpy())


def test_package_exports_the_jax_names():
    import dsabeamformer_tpu.parallel as jpar

    assert sorted(ppar.__all__) == sorted(jpar.__all__)
    for name in jpar.__all__:
        assert callable(getattr(ppar, name))
