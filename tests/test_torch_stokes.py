"""The port's full-Stokes path on the CPU (the plain version of the detect
kernel's Stokes epilogue) against the JAX package's ``beamform_stokes`` in
interpret mode and the float64 golden model; the 8-bit Stokes quantizer; the
4-IF filterbank sink; and ``StreamingBeamformer(products="stokes")`` against
the JAX streaming loop, block for block."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ingest.sigproc as jsig
import dsabeamformer_tpu.ops.gemm as jgemm
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu.ops.reference as jref
import dsabeamformer_tpu.pipeline as jpipe
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ingest.sigproc as psig
import dsabeamformer_tpu_torch.ops.gemm as pgemm
import dsabeamformer_tpu_torch.ops.quantize as pq
import dsabeamformer_tpu_torch.pipeline as ppipe
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu_torch.ingest.dada import read_product_file
from dsabeamformer_tpu_torch.ingest.generator import (
    make_noise_block,
    make_point_source_block,
    make_random_bytes_block,
)
from dsabeamformer_tpu_torch.models.weights import (
    make_weights,
    weights_numpy_golden,
)
from dsabeamformer_tpu_torch.ops.packing import pack_4r4i, unpack_4r4i
from dsabeamformer_tpu_torch.ops.reference import (
    beamform_stokes_ref,
    stokes_ref,
)

#: Port vs JAX per plane, relative to the Stokes-I peak (identical integers;
#: the int8 mode's U/V planes differ in float32 summation order only).
JAX_RTOL = 1e-6

GEOMS = {
    "tiny": (jcfg.TINY, pcfg.TINY),
    "dsa10_small": (jcfg.DSA10.replace(n_chan=8, t_block=64, time_tile=64),
                    pcfg.DSA10.replace(n_chan=8, t_block=64)),
    "dsa10c_small": (jcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64,
                                                time_tile=64),
                     pcfg.DSA10_COMPACT.replace(n_chan=8, t_block=64)),
}


def _pair(geom="tiny", layout="tfpa", mode="int8x2", seed=5, **kw):
    """The two packages' configs and the same quantized weights in each."""
    jc, pc = (c.replace(input_layout=layout, weight_mode=mode, **kw)
              for c in GEOMS[geom])
    qj = jq.prepare_weights(jc, jmake_weights(jc, cal=JCal.random(jc,
                                                                  seed=seed)))
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    return jc, pc, qj, qp


def _plane_errors(got, want):
    """Max abs error of each Stokes plane over the I-plane peak."""
    scale = np.abs(want[:, :, 0]).max()
    return [float(np.abs(got[:, :, k] - want[:, :, k]).max() / scale)
            for k in range(4)]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("inco,sk", [(False, False), (True, False),
                                     (False, True), (True, True)],
                         ids=["plain", "inco", "sk", "inco+sk"])
@pytest.mark.parametrize("mode", ["int8x2", "int8"])
@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_stokes_matches_jax(geom, layout, mode, inco, sk):
    """Each plane within 1e-6 of the I peak of the JAX kernel's (to the bit
    in the int8x2 mode); the JAX return order; incoherent and SK equal."""
    jc, pc, qj, qp = _pair(geom, layout, mode)
    wire = make_random_bytes_block(pc, seed=19)
    kw = dict(incoherent=inco, sk_stats=sk, flag_ants=(1,) if inco else ())
    jo = _as_tuple(jgemm.beamform_stokes(jnp.asarray(wire), qj, jc, **kw))
    po = _as_tuple(pgemm.beamform_stokes(wire, qp, pc, **kw))
    assert len(po) == len(jo) == 1 + inco + sk
    sj, sp = np.asarray(jo[0]), po[0].numpy()
    assert sp.shape == sj.shape == (pc.n_chan, pc.t_block // pc.navg_time, 4,
                                    pc.n_beams)
    assert max(_plane_errors(sp, sj)) <= JAX_RTOL
    if mode == "int8x2":
        np.testing.assert_array_equal(sp, sj)
    for k in range(1, len(po)):
        np.testing.assert_array_equal(po[k].numpy(), np.asarray(jo[k]))


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_stokes_vs_golden(layout):
    """The float64 golden model, as tests/test_stokes.py gates the JAX
    kernel: int8x2 within 3e-4 of the I peak per plane."""
    _, pc, _, _ = _pair(layout=layout)
    wire = make_noise_block(pc, rms=2.5, seed=77)
    qw = pq.prepare_weights(pc, make_weights(pc, device="cpu"))
    st = pgemm.beamform_stokes(wire, qw, pc).numpy()
    ref = beamform_stokes_ref(weights_numpy_golden(pc), wire,
                              pc.input_layout, pc.navg_time, pc.navg_freq)
    assert st.shape == ref.shape
    assert max(_plane_errors(st, ref)) <= 3e-4
    jr = jref.beamform_stokes_ref(weights_numpy_golden(pc), wire,
                                  pc.input_layout, pc.navg_time)
    np.testing.assert_allclose(ref, jr, rtol=1e-12, atol=1e-9 * np.abs(
        jr).max())


def test_stokes_ref_matches_jax():
    rng = np.random.default_rng(3)
    bv = rng.standard_normal((2, 5, 2, 7)) + 1j * rng.standard_normal(
        (2, 5, 2, 7))
    np.testing.assert_array_equal(stokes_ref(bv), jref.stokes_ref(bv))


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_stokes_i_equals_power(geom):
    """The I plane is the power product to the bit, in float32 and in the
    uint8 epilogue (offset 0 for I)."""
    _, pc, _, qp = _pair(geom)
    wire = make_random_bytes_block(pc, seed=23)
    st = pgemm.beamform_stokes(wire, qp, pc)
    p = pgemm.beamform_power(wire, qp, pc)
    assert torch.equal(st[:, :, 0], p)
    scales = (64.0 / p.median()).expand(pc.n_beams).contiguous()
    assert torch.equal(
        pgemm.beamform_stokes(wire, qp, pc, quant8_scales=scales)[:, :, 0],
        pgemm.beamform_power(wire, qp, pc, quant8_scales=scales))


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_pure_x_polarization_exact(layout):
    """Y-pol bytes zeroed: with int8 weights By is exactly 0, so Q == I and
    U == V == 0 exactly."""
    _, pc, _, qp = _pair(layout=layout)
    wire = make_point_source_block(pc, pc.beam_angles_rad()[10],
                                   noise_rms=0.5, seed=2)
    re, im = unpack_4r4i(wire)
    re[:, :, 1] = 0  # the pol axis is dim 2 of both 4-D host forms
    im[:, :, 1] = 0
    wire = pack_4r4i(re, im)
    st = pgemm.beamform_stokes(wire, qp, pc)
    assert float(st[:, :, 0].max()) > 0
    assert torch.equal(st[:, :, 1], st[:, :, 0])
    assert not st[:, :, 2:].any()


def _auto_scales(st):
    """Auto-cal-style per-beam scales: the I-plane median to mid-rail 64."""
    med = np.median(np.asarray(st)[:, :, 0, :], axis=(0, 1))
    return (64.0 / med).astype(np.float32)


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_quant8_stokes_byte_equal_jax(geom, layout):
    """uint8 Stokes (``quant8_scales``) byte-equal to the JAX kernel's and
    to the port's two-pass quantizer (``quantize_u8`` of the float32
    product, as ``FilterbankSink.device_post`` runs it); Q/U/V sit at their
    128 midpoint."""
    jc, pc, qj, qp = _pair(geom, layout)
    wire = make_noise_block(pc, rms=2.5, seed=91)
    f32 = pgemm.beamform_stokes(wire, qp, pc)
    scales = _auto_scales(f32)
    uj = np.asarray(jgemm.beamform_stokes(jnp.asarray(wire), qj, jc,
                                          quant8_scales=jnp.asarray(scales)))
    up = pgemm.beamform_stokes(wire, qp, pc, quant8_scales=scales)
    assert up.dtype == torch.uint8 and uj.dtype == np.uint8
    np.testing.assert_array_equal(up.numpy(), uj)
    two_pass = pgemm.quantize_u8(f32, torch.from_numpy(scales),
                                 pgemm.stokes_offsets())
    assert torch.equal(up, two_pass)
    assert abs(float(up[:, :, 1:].float().mean()) - 128.0) < 8.0


def test_quant8_offset_rounds_once_as_xla():
    """``x * scale + 128`` is one rounding in the JAX kernel and its device
    quantizer (XLA contracts it to an FMA on the CPU), and in the port.
    Scales chosen so that two roundings would give another byte."""
    jc, pc, qj, qp = _pair()
    wire = make_random_bytes_block(pc, seed=17)
    st = pgemm.beamform_stokes(wire, qp, pc).numpy()
    scales = np.ones(pc.n_beams, np.float32)
    forced = []
    for b in range(pc.n_beams):
        x = np.float32(st[0, 0, 1, b])
        for k in range(60, 200):
            c = np.float32((k + 0.5 - 128) / x)
            for _ in range(2000):
                two = np.rint(np.float32(x * c) + np.float32(128))
                one = np.rint(np.float32(np.float64(x) * np.float64(c) + 128))
                if c > 0 and two != one:
                    break
                c = np.nextafter(c, np.float32(np.inf), dtype=np.float32)
            else:
                continue
            scales[b] = c
            forced.append((b, one))
            break
    assert len(forced) >= pc.n_beams // 2
    uj = np.asarray(jgemm.beamform_stokes(jnp.asarray(wire), qj, jc,
                                          quant8_scales=jnp.asarray(scales)))
    up = pgemm.beamform_stokes(wire, qp, pc, quant8_scales=scales).numpy()
    np.testing.assert_array_equal(up, uj)
    assert all(up[0, 0, 1, b] == one for b, one in forced)
    dev = np.asarray(jsig._get_quant8_stokes()(jnp.asarray(st),
                                               jnp.asarray(scales)))
    np.testing.assert_array_equal(dev, up)


@pytest.mark.parametrize("bad", ["navg_freq", "n_beams"])
def test_quant8_errors_match_jax(bad):
    jc, pc, qj, qp = _pair()
    wire = make_noise_block(pc, rms=2.0, seed=73)
    n = 3 if bad == "n_beams" else pc.n_beams
    if bad == "navg_freq":
        jc, pc = jc.replace(navg_freq=2), pc.replace(navg_freq=2)
    scales = np.ones(n, np.float32)
    with pytest.raises(ValueError, match=bad) as ej:
        jgemm.beamform_stokes(jnp.asarray(wire), qj, jc,
                              quant8_scales=jnp.asarray(scales))
    with pytest.raises(ValueError, match=bad) as ep:
        pgemm.beamform_stokes(wire, qp, pc, quant8_scales=scales)
    assert str(ep.value) == str(ej.value)


def test_stokes_freq_averaging_matches_jax():
    jc, pc, qj, qp = _pair(navg_freq=2)
    wire = make_random_bytes_block(pc, seed=9)
    sj, ij = jgemm.beamform_stokes(jnp.asarray(wire), qj, jc, incoherent=True)
    sp, ip = pgemm.beamform_stokes(wire, qp, pc, incoherent=True)
    assert tuple(sp.shape) == (pc.n_chan // 2, pc.t_block // pc.navg_time, 4,
                               pc.n_beams)
    assert max(_plane_errors(sp.numpy(), np.asarray(sj))) <= JAX_RTOL
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))


def test_plain_stokes_variants_and_chunking():
    """The launch-count keys of the Stokes variants, and the plain version
    independent of its channel chunk."""
    _, pc, _, qp = _pair("dsa10_small")
    wire = make_random_bytes_block(pc, seed=4)
    x, tm = pgemm._prepare_wire(wire, pc)
    whole = pgemm.detect_power_plain(x, qp.terms, qp.scales, pc, tm,
                                     stokes=True)[0]
    one = pgemm.detect_power_plain(x, qp.terms, qp.scales, pc, tm,
                                   chan_chunk=1, stokes=True)[0]
    assert torch.equal(whole, one)
    assert pgemm.variant_name(False, False, False, True) == "stokes"
    assert pgemm.variant_name(True, True, True, True) == "stokes+sk+q8+inco"
    assert pgemm.variant_name(True, False, True) == "sk+q8"
    assert not any(pgemm.fused_detect.launches.values())


# --------------------------------------------------------------------- #
# The 4-IF filterbank sink and the streaming loop
# --------------------------------------------------------------------- #

def _stokes_blocks(n, seed):
    """Float32 Stokes-shaped blocks: I positive, Q/U/V signed, |Q| <= I."""
    rng = np.random.default_rng(seed)
    f, t, b = pcfg.TINY.out_block_shape
    out = []
    for _ in range(n):
        i = rng.uniform(0.5, 3.0, (f, t, b)).astype(np.float32)
        quv = (rng.uniform(-0.5, 0.5, (f, t, 3, b)) * i[:, :, None]).astype(
            np.float32)
        out.append(np.concatenate([i[:, :, None], quv], axis=2))
    return out


def _read_all(d, beams):
    return {b: (d / f"beam{b:04d}.fil").read_bytes() for b in beams}


@pytest.mark.parametrize("kw", [
    dict(), dict(beams=[0, 5]), dict(nbits=8), dict(nbits=8, scale=20.0),
    dict(nbits=8, beams=[2])], ids=["f32", "beams", "u8auto", "u8scale",
                                    "u8beam"])
def test_stokes_sink_files_byte_equal_jax(kw, tmp_path):
    """The same float32 Stokes blocks (with a dropped block) through both
    sinks -> identical 4-IF files and scales.json; the device-side layout
    writes the same bytes; uint8 blocks from ``device_post`` too."""
    cfg, jc = pcfg.TINY, jcfg.TINY
    blocks = _stokes_blocks(3, seed=3)
    sinks = {"jax": jsig.FilterbankSink(tmp_path / "j", jc, products="stokes",
                                        **kw),
             "port": psig.FilterbankSink(tmp_path / "p", cfg,
                                         products="stokes", **kw),
             "layout": psig.FilterbankSink(tmp_path / "l", cfg,
                                           products="stokes", **kw)}
    for seq, blk in zip((0, 1, 3), blocks):
        sinks["jax"].write(seq, blk)
        sinks["port"].write(seq, blk)
        laid = sinks["layout"].device_layout(torch.from_numpy(blk))
        assert tuple(laid.shape) == sinks["layout"].layout_shape
        sinks["layout"].write_beams(seq, laid.numpy())
    for s in sinks.values():
        s.close()
    beams = sinks["port"].beams
    want = _read_all(tmp_path / "j", beams)
    assert _read_all(tmp_path / "p", beams) == want
    assert _read_all(tmp_path / "l", beams) == want
    assert sinks["port"].n_splices == 1
    if kw.get("nbits") == 8:
        side = (tmp_path / "j" / "scales.json").read_text()
        for d in ("p", "l"):
            assert (tmp_path / d / "scales.json").read_text() == side
        assert json.loads(side)["__quv_offset__"] == 128.0
    hdr, data = psig.read_filterbank(tmp_path / "p" / f"beam{beams[0]:04d}.fil")
    assert hdr["nifs"] == 4 and data.shape == (4 * cfg.out_block_shape[1], 4,
                                               cfg.n_chan)
    # Q/U/V midpoint and zero-filled gap.
    t_out = cfg.out_block_shape[1]
    assert not data[2 * t_out:3 * t_out].any()


def test_stokes_device_post_byte_equal_jax(tmp_path):
    """``device_post`` on a Stokes block: float32 while calibrating, then
    uint8 equal to the JAX package's device quantizer (one rounding of
    ``x * scale + offset``)."""
    cfg, jc = pcfg.TINY, jcfg.TINY
    b0, b1 = _stokes_blocks(2, seed=5)
    port = psig.FilterbankSink(tmp_path / "p", cfg, nbits=8,
                               products="stokes")
    jax_sink = jsig.FilterbankSink(tmp_path / "j", jc, nbits=8,
                                   products="stokes")
    assert port.device_post(torch.from_numpy(b0)).dtype == torch.float32
    port.write(0, b0)
    jax_sink.write(0, b0)
    assert port.scales == jax_sink.scales
    up = port.device_post(torch.from_numpy(b1))
    uj = np.asarray(jax_sink.device_post(jnp.asarray(b1)))
    assert up.dtype == torch.uint8
    np.testing.assert_array_equal(up.numpy(), uj)
    assert port.device_post(torch.from_numpy(b0), warmup=True).dtype == \
        torch.uint8
    port.close()
    jax_sink.close()


def _capture(cfg, tmp_path, seeds):
    wires = [make_noise_block(cfg, rms=2.0, seed=s) for s in seeds]
    raw = tmp_path / f"cap-{cfg.input_layout}.raw"
    raw.write_bytes(b"".join(w.tobytes() for w in wires))
    return raw, len(wires)


def _run(mod, cfg, qw, raw, sink, **kw):
    """One Stokes stream from a capture file; returns which blocks took
    the kernel's uint8 epilogue."""
    bf = mod.StreamingBeamformer(cfg, qw, mod.FileSource(cfg, raw), sink,
                                 products="stokes", **kw)
    engaged = []
    orig = bf._step
    bf._step = lambda w, q8=None, sk_stats=None: (
        engaged.append(q8 is not None), orig(w, q8, sk_stats=sk_stats))[1]
    if mod is ppipe:
        bf.warmup()
        engaged.clear()
    bf.run()
    sink.close()
    return engaged


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_stokes_stream_matches_jax(layout, tmp_path):
    """``StreamingBeamformer(products="stokes")`` in both packages, the same
    capture file and weights: the 8-bit 4-IF .fil files and scales.json
    byte-equal (block 0 float32 for the auto-calibration, later blocks from
    the kernels' uint8 epilogues), the incoherent .dada equal, and the
    float32 ``BEAM_STOKES_IQUV`` .dada equal."""
    jc, pc, qj, qp = _pair(layout=layout)
    raw, n = _capture(pc, tmp_path, (61, 62, 63))
    sinks = {}
    for name, mod, sig, cfg, qw in (("jax", jpipe, jsig, jc, qj),
                                    ("port", ppipe, psig, pc, qp)):
        fil = sig.FilterbankSink(tmp_path / name, cfg, nbits=8,
                                 products="stokes")
        inco = mod.FileSink(tmp_path / f"{name}-inco.dada", cfg,
                            products="incoherent")
        engaged = _run(mod, cfg, qw, raw, fil, incoherent_sink=inco,
                       flag_ants=(2,))
        inco.close()
        assert engaged == [False] + [True] * (n - 1)
        dada = mod.FileSink(tmp_path / f"{name}.dada", cfg, products="stokes")
        _run(mod, cfg, qw, raw, dada)
        sinks[name] = fil
    assert sinks["port"].scales == sinks["jax"].scales
    beams = sinks["port"].beams
    assert _read_all(tmp_path / "port", beams) == \
        _read_all(tmp_path / "jax", beams)
    assert (tmp_path / "port" / "scales.json").read_text() == \
        (tmp_path / "jax" / "scales.json").read_text()
    for what in ("inco", None):
        suffix = f"-{what}.dada" if what else ".dada"
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes()
    h, st = read_product_file(tmp_path / "port.dada")
    assert h["PAYLOAD"] == "BEAM_STOKES_IQUV" and h["OUT_NSTOKES"] == "4"
    assert st.shape == (n, *pc.out_block_shape[:2], 4, pc.n_beams)
    hdr, data = psig.read_filterbank(tmp_path / "port" / "beam0000.fil")
    assert hdr["nifs"] == 4 and data.dtype == np.uint8


def test_fused_quant8_stokes_pipeline_byte_equal(tmp_path, monkeypatch):
    """Stream level, as tests/test_stokes.py holds the JAX loop: an 8-bit
    Stokes run through the kernel's uint8 epilogue writes the same files as
    the two-pass path (float32 product, then ``device_post``)."""
    _, pc, _, qp = _pair()
    raw, n = _capture(pc, tmp_path, (71, 72, 73))
    sinks = {}
    for name, fused in (("fused", True), ("post", False)):
        if not fused:
            monkeypatch.setattr(ppipe.StreamingBeamformer, "_fused_quant8",
                                lambda self: None)
        sink = psig.FilterbankSink(tmp_path / name, pc, nbits=8,
                                   products="stokes")
        assert _run(ppipe, pc, qp, raw, sink) == [False] + [fused] * (n - 1)
        monkeypatch.undo()
        sinks[name] = sink
    assert sinks["fused"].scales == sinks["post"].scales
    assert _read_all(tmp_path / "fused", sinks["fused"].beams) == \
        _read_all(tmp_path / "post", sinks["post"].beams)


def test_stokes_stream_rejects_unknown_products():
    _, pc, _, qp = _pair()
    src = ppipe.SyntheticSource(pc, [make_noise_block(pc, seed=1)], 1)
    with pytest.raises(ValueError, match="power|stokes"):
        ppipe.StreamingBeamformer(pc, qp, src, products="voltages")
    bf = ppipe.StreamingBeamformer(pc, qp, src, products="stokes")
    f, t, b = pc.out_block_shape
    assert bf.out_block_shape == (f, t, 4, b)
