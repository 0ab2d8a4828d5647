"""The port's file outputs against the JAX package's: SIGPROC filterbank
headers and payloads (32-bit, 8-bit auto and explicit scale, gap
zero-fill, the device-side layout, splice), the 8-bit path through the
streaming loop (fused uint8 kernel epilogue vs the two-pass quantizer),
and the PSRDADA headers, files and product files."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ingest.dada as jdada
import dsabeamformer_tpu.ingest.sigproc as jsig
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu.pipeline as jpipe
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ingest.dada as pdada
import dsabeamformer_tpu_torch.ingest.sigproc as psig
import dsabeamformer_tpu_torch.ops.quantize as pq
import dsabeamformer_tpu_torch.pipeline as ppipe
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu_torch.ingest.generator import make_noise_block
from dsabeamformer_tpu_torch.models.weights import make_weights

CFG = pcfg.TINY
JCFG = jcfg.TINY


def _read_all(d, beams):
    return {b: (d / f"beam{b:04d}.fil").read_bytes() for b in beams}


@pytest.mark.parametrize("kw", [
    dict(beam=0), dict(beam=31, nbits=8), dict(beam=3, nifs=4),
    dict(beam=7, tstart_mjd=60000.25, source_name="FRB", telescope_id=4,
         machine_id=9)], ids=["default", "8bit", "nifs4", "fields"])
@pytest.mark.parametrize("navg_freq", [1, 2])
def test_filterbank_header_byte_equal_jax(kw, navg_freq):
    p = psig.encode_filterbank_header(CFG.replace(navg_freq=navg_freq), **kw)
    j = jsig.encode_filterbank_header(JCFG.replace(navg_freq=navg_freq), **kw)
    assert p == j


def _blocks(n, seed, dist=(0.5, 3.0)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(*dist, CFG.out_block_shape).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("kw", [
    dict(), dict(beams=[0, 5]), dict(nbits=8), dict(nbits=8, scale=20.0),
    dict(nbits=8, beams=[2])], ids=["f32", "beams", "u8auto", "u8scale",
                                    "u8beam"])
def test_sink_files_byte_equal_jax(kw, tmp_path):
    """The same float32 blocks through both sinks -> identical files and
    identical scales.json; the device-side layout writes the same bytes."""
    blocks = _blocks(3, seed=3)
    sinks = {"jax": jsig.FilterbankSink(tmp_path / "j", JCFG, **kw),
             "port": psig.FilterbankSink(tmp_path / "p", CFG, **kw),
             "layout": psig.FilterbankSink(tmp_path / "l", CFG, **kw)}
    for seq, blk in enumerate(blocks):
        sinks["jax"].write(seq, blk)
        sinks["port"].write(seq, blk)
        laid = sinks["layout"].device_layout(torch.from_numpy(blk))
        assert tuple(laid.shape) == sinks["layout"].layout_shape
        sinks["layout"].write_beams(seq, laid.numpy())
    for s in sinks.values():
        s.close()
    beams = sinks["port"].beams
    assert beams == sinks["jax"].beams
    want = _read_all(tmp_path / "j", beams)
    assert _read_all(tmp_path / "p", beams) == want
    assert _read_all(tmp_path / "l", beams) == want
    assert sinks["port"].scales == sinks["jax"].scales
    if kw.get("nbits") == 8:
        for d in ("p", "l"):
            assert (tmp_path / d / "scales.json").read_text() == \
                (tmp_path / "j" / "scales.json").read_text()
    hdr, data = psig.read_filterbank(tmp_path / "p" / f"beam{beams[0]:04d}.fil")
    jhdr, jdata = jsig.read_filterbank(tmp_path / "j" /
                                       f"beam{beams[0]:04d}.fil")
    assert hdr == jhdr
    np.testing.assert_array_equal(data, jdata)


def test_gap_zero_fill_keeps_time_axis_contiguous(tmp_path):
    _, t_out, _ = CFG.out_block_shape
    b0, b2 = _blocks(2, seed=11, dist=(1, 2))
    for nbits in (32, 8):
        sink = psig.FilterbankSink(tmp_path / f"f{nbits}", CFG, beams=[1],
                                   nbits=nbits, scale=10.0)
        sink.write(0, b0)
        sink.write(2, b2)  # seq 1 dropped
        assert sink.n_splices == 1 and sink.filled_samples == t_out
        sink.close()
        _, data = psig.read_filterbank(tmp_path / f"f{nbits}" / "beam0001.fil")
        assert data.shape[0] == 3 * t_out
        assert (data[t_out:2 * t_out] == 0).all()
        if nbits == 32:
            np.testing.assert_array_equal(data[:t_out, 0], b0[::-1, :, 1].T)
            np.testing.assert_array_equal(data[2 * t_out:, 0],
                                          b2[::-1, :, 1].T)


def test_8bit_auto_scale_frozen_and_sidecar(tmp_path):
    _, t_out, _ = CFG.out_block_shape
    quiet = _blocks(1, seed=11, dist=(0.5, 1.5))[0]
    sink = psig.FilterbankSink(tmp_path / "a", CFG, beams=[0, 2], nbits=8)
    assert sink.scales[0] is None
    sink.write(0, quiet)
    s0 = sink.scales[0]
    assert abs(s0 * np.median(quiet[:, :, 0]) - 64.0) < 1.0
    sink.write(1, 100.0 * quiet)  # a loud later block does not rescale
    assert sink.scales[0] == s0
    sink.close()
    _, data = psig.read_filterbank(tmp_path / "a" / "beam0000.fil")
    assert data[t_out:].max() == 255
    side = json.loads((tmp_path / "a" / "scales.json").read_text())
    assert side == {"beam0000.fil": sink.scales[0],
                    "beam0002.fil": sink.scales[2]}


def test_device_post_and_fused_scales(tmp_path):
    """device_post: block 0 passes through as float32 (auto-calibration),
    later blocks are quantized by torch ops, byte-equal to the host path;
    fused_quant8_scales offers the same scales for the kernel epilogue."""
    b0, b1 = _blocks(2, seed=17)
    host = psig.FilterbankSink(tmp_path / "h", CFG, nbits=8)
    dev = psig.FilterbankSink(tmp_path / "d", CFG, nbits=8)
    assert dev.fused_quant8_scales("cpu") is None
    for s, use_dev in ((host, False), (dev, True)):
        out0 = s.device_post(torch.from_numpy(b0)) if use_dev else b0
        assert np.asarray(out0).dtype == np.float32
        s.write(0, np.asarray(out0))
        out1 = s.device_post(torch.from_numpy(b1)) if use_dev else b1
        if use_dev:
            assert out1.dtype == torch.uint8
        s.write(1, np.asarray(out1))
        s.close()
    assert host.scales == dev.scales
    vec = dev.fused_quant8_scales("cpu")
    np.testing.assert_array_equal(
        vec.numpy(), np.array([dev.scales[b] for b in range(CFG.n_beams)],
                              np.float32))
    assert _read_all(tmp_path / "h", host.beams) == \
        _read_all(tmp_path / "d", dev.beams)
    warm = dev.device_post(torch.from_numpy(b0), warmup=True)
    assert warm.dtype == torch.uint8
    s32 = psig.FilterbankSink(tmp_path / "f32", CFG)
    blk = torch.from_numpy(b0)
    assert s32.device_post(blk) is blk and s32.fused_quant8_scales() is None


def test_sink_validation_and_stokes_not_ported(tmp_path):
    with pytest.raises(ValueError, match="out of range"):
        psig.FilterbankSink(tmp_path / "a", CFG, beams=[CFG.n_beams])
    with pytest.raises(ValueError, match="products"):
        psig.FilterbankSink(tmp_path / "b", CFG, products="voltages")
    with pytest.raises(ValueError, match="nbits"):
        psig.FilterbankSink(tmp_path / "c", CFG, nbits=16)
    with pytest.raises(ValueError, match="positive"):
        psig.FilterbankSink(tmp_path / "d", CFG, nbits=8, scale=-1.0)
    # Stokes sinks are ported now (tests/test_torch_stokes.py): 4 IFs.
    st = psig.FilterbankSink(tmp_path / "e", CFG, products="stokes")
    assert st.nifs == 4 and st.layout_shape[2] == 4
    st.close()
    assert psig.read_filterbank_header(tmp_path / "e" / "beam0000.fil")[0][
        "nifs"] == 4
    assert psig.STOKES_QUV_OFFSET == jsig.STOKES_QUV_OFFSET


def test_reader_errors(tmp_path):
    p = tmp_path / "x.fil"
    p.write_bytes(b"\x04\x00\x00\x00junk")
    with pytest.raises(ValueError):
        psig.read_filterbank(p)
    hdr = psig.encode_filterbank_header(CFG, beam=0)
    p.write_bytes(hdr[: len(hdr) // 2])
    with pytest.raises(ValueError, match="truncated"):
        psig.read_filterbank(p)


@pytest.mark.parametrize("nbits", [32, 8])
def test_splice_matches_jax(nbits, tmp_path):
    """Per-subband files -> one full-band file: the port's splice writes
    the JAX package's bytes, and equals the full-band sink's file."""
    blk = _blocks(1, seed=21)[0]
    f_out = CFG.out_block_shape[0]
    kw = dict(beams=[1], nbits=nbits, scale=5.0)
    full = psig.FilterbankSink(tmp_path / "full", CFG, **kw)
    full.write(0, blk)
    full.close()
    parts = []
    for i in range(2):
        sub = CFG.subband(i * 4, 4)
        sink = psig.FilterbankSink(tmp_path / f"sub{i}", sub, **kw)
        sink.write(0, blk[i * f_out // 2:(i + 1) * f_out // 2])
        sink.close()
        parts.append(tmp_path / f"sub{i}" / "beam0001.fil")
    hp = psig.splice_filterbanks(parts[::-1], tmp_path / "mp.fil")
    hj = jsig.splice_filterbanks(parts[::-1], tmp_path / "mj.fil")
    assert hp == hj and hp["_dropped_samples"] == 0
    assert (tmp_path / "mp.fil").read_bytes() == \
        (tmp_path / "mj.fil").read_bytes() == \
        (tmp_path / "full" / "beam0001.fil").read_bytes()
    with pytest.raises(ValueError, match="tile contiguously"):
        psig.splice_filterbanks([parts[0], parts[0]], tmp_path / "x.fil")


def _stream(mod, cfg, qw, sink, wires, **kw):
    src = mod.SyntheticSource(cfg, wires, len(wires))
    bf = mod.StreamingBeamformer(cfg, qw, src, sink, depth=2, **kw)
    engaged = []
    orig = bf._step
    bf._step = lambda w, q8=None, sk_stats=None: (
        engaged.append(q8 is not None), orig(w, q8, sk_stats=sk_stats))[1]
    bf.warmup()
    engaged.clear()
    bf.run()
    sink.close()
    return engaged


def test_fused_quant8_pipeline_byte_equal(tmp_path, monkeypatch):
    """Stream level: an 8-bit filterbank run through the kernel's uint8
    epilogue writes the same files as the two-pass path (float32 product,
    then ``device_post``).  Block 0 travels float32 either way."""
    wires = [make_noise_block(CFG, rms=2.0, seed=s) for s in (31, 32, 33)]
    qw = pq.prepare_weights(CFG, make_weights(CFG, device="cpu"))
    sinks = {}
    for name, fused in (("fused", True), ("post", False)):
        if not fused:
            monkeypatch.setattr(ppipe.StreamingBeamformer, "_fused_quant8",
                                lambda self: None)
        sink = psig.FilterbankSink(tmp_path / name, CFG, nbits=8)
        engaged = _stream(ppipe, CFG, qw, sink, wires)
        assert engaged == [False] + [fused] * (len(wires) - 1)
        monkeypatch.undo()
        sinks[name] = sink
    assert sinks["fused"].scales == sinks["post"].scales
    assert _read_all(tmp_path / "fused", sinks["fused"].beams) == \
        _read_all(tmp_path / "post", sinks["post"].beams)


def test_fused_quant8_hook_gated_to_8bit(tmp_path):
    qw = pq.prepare_weights(CFG, make_weights(CFG, device="cpu"))
    blocks = [make_noise_block(CFG, rms=2.0, seed=41)]
    for nbits, navg_freq, want in ((32, 1, False), (8, 1, True),
                                   (8, 2, False)):
        cfg = CFG.replace(navg_freq=navg_freq)
        sink = psig.FilterbankSink(tmp_path / f"f{nbits}{navg_freq}", cfg,
                                   nbits=nbits)
        bf = ppipe.StreamingBeamformer(cfg, qw, ppipe.SyntheticSource(
            cfg, blocks, 1), sink)
        assert (bf._fused_quant8() is not None) == want


def test_8bit_navg_freq_runs_device_post(tmp_path):
    """navg_freq > 1 cannot quantize in the kernel: the stream runs the
    sink's device_post on the averaged product instead; block 0 calibrates,
    later blocks come back uint8."""
    cfg = CFG.replace(navg_freq=2)
    qw = pq.prepare_weights(cfg, make_weights(cfg, device="cpu"))
    wires = [make_noise_block(cfg, rms=2.0, seed=s) for s in (5, 6, 7)]
    sink = psig.FilterbankSink(tmp_path / "f", cfg, nbits=8)
    engaged = _stream(ppipe, cfg, qw, sink, wires)
    assert engaged == [False, False, False]
    hdr, data = psig.read_filterbank(tmp_path / "f" / "beam0004.fil")
    assert hdr["nchans"] == cfg.n_chan // 2 and data.dtype == np.uint8
    assert data.shape[0] == 3 * cfg.out_block_shape[1]


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_fil_and_incoherent_vs_jax_stream(layout, tmp_path):
    """The deployed sinks on both streaming loops, same wire and weights: .fil
    payloads within 1 count (float32 order can move a rounding), the
    scales within 1e-6, the incoherent .dada files equal."""
    jc, pc = JCFG.replace(input_layout=layout), CFG.replace(input_layout=layout)
    qj = jq.prepare_weights(jc, jmake_weights(jc))
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    wires = [make_noise_block(pc, rms=2.0, seed=s) for s in (21, 22, 23)]
    sinks = {}
    for name, mod, sig, cfg, qw in (("jax", jpipe, jsig, jc, qj),
                                    ("port", ppipe, psig, pc, qp)):
        fil = sig.FilterbankSink(tmp_path / name, cfg, nbits=8)
        inco = mod.FileSink(tmp_path / f"{name}.dada", cfg,
                            products="incoherent")
        _stream(mod, cfg, qw, fil, wires, incoherent_sink=inco,
                flag_ants=(2,))
        inco.close()
        sinks[name] = fil
    for b in range(pc.n_beams):
        np.testing.assert_allclose(sinks["port"].scales[b],
                                   sinks["jax"].scales[b], rtol=1e-6)
        _, dp = psig.read_filterbank(tmp_path / "port" / f"beam{b:04d}.fil")
        _, dj = jsig.read_filterbank(tmp_path / "jax" / f"beam{b:04d}.fil")
        assert dp.shape == dj.shape
        assert np.abs(dp.astype(int) - dj.astype(int)).max() <= 1
    assert (tmp_path / "port.dada").read_bytes() == \
        (tmp_path / "jax.dada").read_bytes()
    h, inco = pdada.read_product_file(tmp_path / "port.dada")
    assert h["PAYLOAD"] == "INCOHERENT_POWER"
    assert inco.shape == (3, *pc.out_block_shape[:2])


# --------------------------------------------------------------------- #
# PSRDADA
# --------------------------------------------------------------------- #

def test_dada_header_and_file_roundtrip_equal_jax(tmp_path):
    blocks = [make_noise_block(CFG, seed=s) for s in range(2)]
    extra = dict(UTC_START="2026-08-16-00:00:00")
    assert pdada.encode_header(CFG, **extra) == \
        jdada.encode_header(JCFG, **extra)
    assert "INSTRUMENT dsabeamformer_tpu\n" in pdada.encode_header(CFG)
    pdada.write_dada_file(tmp_path / "p.dada", CFG, blocks, **extra)
    jdada.write_dada_file(tmp_path / "j.dada", JCFG, blocks, **extra)
    assert (tmp_path / "p.dada").read_bytes() == \
        (tmp_path / "j.dada").read_bytes()
    base = CFG.replace(n_chan=4, n_chan_total=4, t_block=32, f_start_hz=1e9)
    jbase = JCFG.replace(n_chan=4, n_chan_total=4, t_block=32, time_tile=32,
                         chan_tile=2, f_start_hz=1e9)
    for path in ("p.dada", "j.dada"):
        cfg, h, off = pdada.read_dada_file(tmp_path / path, base)
        jc, jh, joff = jdada.read_dada_file(tmp_path / path, jbase)
        assert (h, off) == (jh, joff) and off == pdada.DADA_HDR_SIZE
        for f in ("n_chan", "n_ant", "n_ant_active", "t_block",
                  "input_layout", "n_chan_total", "f_start_hz",
                  "bandwidth_hz", "n_beams", "navg_time", "navg_freq"):
            assert getattr(cfg, f) == getattr(jc, f) == getattr(CFG, f), f
        assert (tmp_path / path).read_bytes()[off:] == \
            b"".join(b.tobytes() for b in blocks)
        assert pdada.is_dada_file(tmp_path / path)
    assert not pdada.is_dada_file(tmp_path / "missing.dada")


def test_dada_standard_keys_and_errors(tmp_path):
    df = CFG.bandwidth_hz / CFG.n_chan_total
    text = "\n".join([
        "HDR_VERSION 1.0", f"HDR_SIZE {pdada.DADA_HDR_SIZE}", "NBIT 4",
        "NDIM 2", "NPOL 2", f"NCHAN {CFG.n_chan}", f"NANT {CFG.n_ant}",
        f"FREQ {(CFG.f_start_hz + CFG.n_chan * df / 2) / 1e6!r}",
        f"BW {CFG.n_chan * df / 1e6!r}",
        f"TSAMP {CFG.sample_period_s * 1e6!r}", "ORDER FTPA"]) + "\n"
    h = pdada.parse_header(text)
    assert h == jdada.parse_header(text)
    cfg = pdada.config_from_dada_header(h, CFG.replace(f_start_hz=0.9e9))
    jc = jdada.config_from_dada_header(h, JCFG.replace(f_start_hz=0.9e9))
    assert cfg.input_layout == jc.input_layout == "ftpa"
    np.testing.assert_allclose(cfg.freqs_hz(), jc.freqs_hz(), rtol=1e-12)
    for bad in ({"NBIT": "8"}, {"NDIM": "1"}, {"ORDER": "PFTA"}):
        with pytest.raises(ValueError) as ej:
            jdada.config_from_dada_header(dict(h, **bad), JCFG)
        with pytest.raises(ValueError) as ep:
            pdada.config_from_dada_header(dict(h, **bad), CFG)
        assert str(ep.value) == str(ej.value)
    good = pdada.encode_header(CFG)
    pdada.validate_header(CFG, good)
    for cfg_bad in (CFG.replace(n_beams=64), CFG.replace(input_layout="ftpa")):
        jbad = JCFG.replace(n_beams=cfg_bad.n_beams,
                            input_layout=cfg_bad.input_layout)
        with pytest.raises(ValueError) as ej:
            jdada.validate_header(jbad, good)
        with pytest.raises(ValueError) as ep:
            pdada.validate_header(cfg_bad, good)
        assert str(ep.value) == str(ej.value)
    with pytest.raises(ValueError, match="missing"):
        pdada.validate_header(CFG, "NANT 16\n")


def test_product_files_equal_jax(tmp_path):
    """FileSink(.dada) of both streaming loops: the same header block, the same
    float32 payload, read back by either package's read_product_file;
    a torn trailing block is dropped."""
    import os

    wires = [make_noise_block(CFG, rms=2.0, seed=s) for s in range(2)]
    qj = jq.prepare_weights(JCFG, jmake_weights(JCFG))
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    for name, mod, cfg, qw in (("j", jpipe, JCFG, qj), ("p", ppipe, CFG, qp)):
        sink = mod.FileSink(str(tmp_path / f"{name}.dada"), cfg)
        mod.run_stream(cfg, qw, mod.SyntheticSource(cfg, wires, 2), sink,
                       depth=1)
        sink.close()
    pb = (tmp_path / "p.dada").read_bytes()
    jb = (tmp_path / "j.dada").read_bytes()
    assert pb[:pdada.DADA_HDR_SIZE] == jb[:jdada.DADA_HDR_SIZE]
    hp, powers = pdada.read_product_file(tmp_path / "p.dada")
    hj, jpowers = jdada.read_product_file(tmp_path / "j.dada")
    assert hp == hj and hp["PAYLOAD"] == "BEAM_POWERS"
    assert powers.shape == jpowers.shape == (2, *CFG.out_block_shape)
    np.testing.assert_allclose(powers, jpowers, rtol=1e-6)
    full = os.path.getsize(tmp_path / "p.dada")
    os.truncate(tmp_path / "p.dada", full - 7)
    assert pdada.read_product_file(tmp_path / "p.dada")[1].shape[0] == 1
    pdada.write_dada_file(tmp_path / "v.dada", CFG, [wires[0]])
    with pytest.raises(ValueError, match="not a beam-product"):
        pdada.read_product_file(tmp_path / "v.dada")
    with pytest.raises(ValueError, match="unknown products"):
        ppipe.FileSink(tmp_path / "x.dada", CFG, products="voltages")


def test_jax_fil_reads_in_port(tmp_path):
    """A file the JAX package's sink wrote reads in the port, and the
    reverse, header dicts equal."""
    blk = _blocks(1, seed=2)[0]
    j = jsig.FilterbankSink(tmp_path / "j", JCFG, beams=[4], nbits=8,
                            scale=7.0)
    j.write(0, blk)
    j.close()
    hp, dp = psig.read_filterbank(tmp_path / "j" / "beam0004.fil")
    hj, dj = jsig.read_filterbank(tmp_path / "j" / "beam0004.fil")
    assert hp == hj
    np.testing.assert_array_equal(dp, dj)
    assert psig.read_filterbank_header(tmp_path / "j" / "beam0004.fil") == \
        jsig.read_filterbank_header(tmp_path / "j" / "beam0004.fil")
    assert jnp.asarray(dp).shape == (CFG.out_block_shape[1], 1,
                                     CFG.out_block_shape[0])
