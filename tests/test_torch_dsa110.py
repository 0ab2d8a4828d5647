"""The port at DSA-110 width on the CPU (its plain PyTorch paths), against
the JAX package in interpret mode: a_compute 128 (110 active antennas in 128
wire slots) and 512 beams, at a few channels and 64 samples.

Covers the detection products (power, Stokes, voltages), the incoherent sum
with antenna 77 flagged (a bit in the third word of the kernels' 128-bit
mask) and the SK accumulators, the weights at ``[F, 512, 128]``, a point
source against the float64 golden model, and the streaming loop at a
DSA-110 sub-band: plain and deployed (8-bit .fil for all 512 beams, the
incoherent .dada, the RFI monitor excising a carrier mid-stream), block for
block against the JAX driver.  Weights are carried across with
``quant_weights_from_numpy``, so both sides multiply the same integers.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ingest.sigproc as jsig
import dsabeamformer_tpu.ops.gemm as jgemm
import dsabeamformer_tpu.ops.incoherent as jinco
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu.pipeline as jpipe
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ingest.sigproc as psig
import dsabeamformer_tpu_torch.ops.gemm as pgemm
import dsabeamformer_tpu_torch.ops.quantize as pq
import dsabeamformer_tpu_torch.pipeline as ppipe
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu.models.weights import zap_weights as jzap_weights
from dsabeamformer_tpu.ops.rfi import RFIMonitor as JMonitor
from dsabeamformer_tpu_torch.ingest.generator import (
    make_point_source_block,
    make_random_bytes_block,
)
from dsabeamformer_tpu_torch.models.weights import (
    make_weights,
    weights_numpy_golden,
    zap_weights,
)
from dsabeamformer_tpu_torch.ops.incoherent import (
    incoherent_power,
    sk_block_stats,
)
from dsabeamformer_tpu_torch.ops.reference import (
    beamform_block_ref,
    beamform_stokes_ref,
)
from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor
from dsabeamformer_tpu_torch.utils.testing import relative_power_error

#: Port vs JAX (identical integers; float32 summation order only).
JAX_RTOL = 1e-6
#: Flagged out of the incoherent sum: 77 sits in the mask's third word.
FLAGS = (3, 77)
TARGET_BEAM = 300


def _cfgs(n_chan=4, layout="tfpa", mode="int8x2", subband=False, **kw):
    """The JAX and port configs at DSA-110 width, 64 samples (the JAX one
    with its Pallas tiles cut to the block)."""
    jc, pc = jcfg.DSA110, pcfg.DSA110
    if subband:
        jc, pc = jc.subband(0, n_chan), pc.subband(0, n_chan)
    jc = jc.replace(n_chan=n_chan, t_block=64, time_tile=64, chan_tile=4,
                    input_layout=layout, weight_mode=mode, **kw)
    pc = pc.replace(n_chan=n_chan, t_block=64, input_layout=layout,
                    weight_mode=mode, **kw)
    return jc, pc


def _carry(qj):
    return pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                       np.asarray(qj.scales), device="cpu")


def _pair(seed=5, **kw):
    """The two configs and the same quantized weights in each."""
    jc, pc = _cfgs(**kw)
    qj = jq.prepare_weights(jc, jmake_weights(jc, cal=JCal.random(jc,
                                                                  seed=seed)))
    return jc, pc, qj, _carry(qj)


def _plane_errors(got, want):
    """Max abs error of each Stokes plane over the I-plane peak."""
    scale = np.abs(want[:, :, 0]).max()
    return [float(np.abs(got[:, :, k] - want[:, :, k]).max() / scale)
            for k in range(4)]


# --------------------------------------------------------------------- #
# The detection products
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("layout,mode,navg_freq", [
    ("tfpa", "int8x2", 1), ("ftpa", "int8", 1), ("tfpa", "int8x2", 2)])
def test_power_matches_jax(layout, mode, navg_freq):
    jc, pc, qj, qp = _pair(layout=layout, mode=mode, navg_freq=navg_freq)
    assert pc.a_compute == jc.a_compute == 128
    wire = make_random_bytes_block(pc, seed=11)
    pj = np.asarray(jgemm.beamform_power(jnp.asarray(wire), qj, jc))
    pp = pgemm.beamform_power(wire, qp, pc).numpy()
    assert pp.shape == pj.shape == (4 // navg_freq, 4, 512)
    assert relative_power_error(pp, pj) <= JAX_RTOL


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("product", ["stokes", "voltages"])
def test_stokes_and_voltages_bit_equal_jax(product, layout):
    jc, pc, qj, qp = _pair(layout=layout)
    wire = make_random_bytes_block(pc, seed=13)
    fj = getattr(jgemm, f"beamform_{product}")
    fp = getattr(pgemm, f"beamform_{product}")
    got = fp(wire, qp, pc).numpy()
    want = np.asarray(fj(jnp.asarray(wire), qj, jc))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quant8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("product", ["power", "stokes"])
def test_incoherent_and_sk_match_jax(product, quant8):
    """Antennas 3 and 77 flagged: the incoherent sum and the SK
    accumulators equal the JAX kernel's, in the JAX return order; the uint8
    product byte-equal."""
    jc, pc, qj, qp = _pair()
    wire = make_random_bytes_block(pc, seed=17)
    kw = dict(incoherent=True, flag_ants=FLAGS, sk_stats=True)
    if quant8:
        f32 = getattr(pgemm, f"beamform_{product}")(wire, qp, pc).numpy()
        plane = f32[:, :, 0] if product == "stokes" else f32
        kw["quant8_scales"] = (64.0 / np.median(plane, axis=(0, 1))).astype(
            np.float32)
    jo = getattr(jgemm, f"beamform_{product}")(
        jnp.asarray(wire), qj, jc,
        **{k: jnp.asarray(v) if k == "quant8_scales" else v
           for k, v in kw.items()})
    po = getattr(pgemm, f"beamform_{product}")(wire, qp, pc, **kw)
    assert len(po) == len(jo) == 3
    if quant8:
        assert po[0].dtype == torch.uint8
        np.testing.assert_array_equal(po[0].numpy(), np.asarray(jo[0]))
    for k in (1, 2):
        np.testing.assert_array_equal(po[k].numpy(), np.asarray(jo[k]))
    # The standalone ops agree: the flagged antennas are out of the sum.
    assert torch.equal(po[1], incoherent_power(wire, pc, FLAGS))
    ref = sk_block_stats(wire, pc)
    assert torch.equal(po[2], torch.stack([ref["s1"], ref["s2"]], dim=1))
    assert not torch.equal(po[1], incoherent_power(wire, pc, (3,)))


def test_wide_incoherent_mask():
    """110 active antennas: bits 0..109 set, flagged ones cleared, in any
    of the four 32-bit words the kernels take at a_compute 128."""
    _, pc = _cfgs()
    full = pgemm.incoherent_mask(pc)
    assert full == (1 << 110) - 1 and full.bit_length() == 110
    m = pgemm.incoherent_mask(pc, (3, 40, 77, 109))
    assert [a for a in range(128) if not (m >> a) & 1] == \
        [3, 40, 77] + list(range(109, 128))
    words = list(pgemm._mask_words(m, pc.a_compute))
    assert len(words) == -(-pc.a_compute // 32) == 4
    assert words == [0xFFFFFFF7, 0xFFFFFEFF, 0xFFFFDFFF, 0x1FFF]
    assert sum(w << (32 * i) for i, w in enumerate(words)) == m
    # The plain version takes the mask as it comes: the flagged antennas,
    # whatever their word, leave the sum.
    wire = make_random_bytes_block(pc, seed=2)
    x, tm = pgemm._prepare_wire(wire, pc)
    qw = pq.prepare_weights(pc, make_weights(pc, device="cpu"))
    inco = pgemm.detect_power_plain(x, qw.terms, qw.scales, pc, tm,
                                    inco_mask=m)[1]
    assert torch.equal(inco, incoherent_power(wire, pc, (3, 40, 77, 109)))
    np.testing.assert_array_equal(
        inco.numpy(),
        np.asarray(jinco.incoherent_power(jnp.asarray(wire),
                                          _cfgs()[0], (3, 40, 77, 109))))


# --------------------------------------------------------------------- #
# Weights, and the physics against the golden model
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("what", ["make", "zap", "quantize"])
def test_weights_at_dsa110_width(what):
    """``make_weights`` at ``[F, 512, 128]`` within 1e-6 of JAX's,
    ``zap_weights`` zeroes whole rows, and ``prepare_weights`` of the JAX
    weights gives JAX's int8x2 terms ``[F, 256, 1024]`` byte for byte."""
    jc, pc = _cfgs(n_chan=8)
    cal_j = JCal.random(jc, seed=4)
    wj = jmake_weights(jc, cal=cal_j)
    if what == "make":
        from dsabeamformer_tpu_torch.models.calibration import CalTable
        wp = make_weights(pc, cal=CalTable(gains=cal_j.gains), device="cpu")
        assert tuple(wp.re.shape) == (8, 512, 128)
        for got, want in ((wp.re, wj.re), (wp.im, wj.im)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6)
    elif what == "zap":
        wp = make_weights(pc, device="cpu")
        z = zap_weights(wp, [1, 6], pc)
        zj = jzap_weights(jmake_weights(jc), [1, 6], jc)
        assert not z.re[[1, 6]].any() and not z.im[[1, 6]].any()
        assert torch.equal(z.re[0], wp.re[0])
        np.testing.assert_array_equal(np.asarray(zj.re)[[1, 6]], 0)
    else:
        from dsabeamformer_tpu_torch.ops.cplx import CVec
        qj = jq.prepare_weights(jc, wj)
        qp = pq.prepare_weights(pc, CVec(torch.from_numpy(np.array(wj.re)),
                                         torch.from_numpy(np.array(wj.im))))
        assert [tuple(t.shape) for t in qp.terms] == [(8, 256, 1024)] * 2
        for tp, tj in zip(qp.terms, qj.terms):
            np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(qp.scales.numpy(), np.asarray(qj.scales))


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_point_source_vs_golden(layout):
    """A source at beam 300 of 512: the argmax, and power and each Stokes
    plane within 1e-3 of the float64 golden model."""
    _, pc = _cfgs(n_chan=8, layout=layout)
    pc = pc.replace(t_block=128)
    wire = make_point_source_block(pc, pc.beam_angles_rad()[TARGET_BEAM],
                                   noise_rms=0.4, seed=7)
    qw = pq.prepare_weights(pc, make_weights(pc, device="cpu"))
    gold = weights_numpy_golden(pc)
    p = pgemm.beamform_power(wire, qw, pc).numpy()
    assert int(np.argmax(p.sum(axis=(0, 1)))) == TARGET_BEAM
    assert relative_power_error(
        p, beamform_block_ref(gold, wire, layout, pc.navg_time)) <= 1e-3
    st = pgemm.beamform_stokes(wire, qw, pc).numpy()
    ref = beamform_stokes_ref(gold, wire, layout, pc.navg_time)
    assert max(_plane_errors(st, ref)) <= 1e-3


# --------------------------------------------------------------------- #
# The streaming loop at a DSA-110 sub-band
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("products", ["power", "stokes"])
def test_stream_matches_jax(products):
    """``StreamingBeamformer`` on ``DSA110.subband(0, 4)``-sized blocks with a
    mid-stream weight update: the port's blocks equal the JAX driver's."""
    jc, pc = _cfgs(subband=True)
    assert pc.f_start_hz == pcfg.DSA110.subband(0, 4).f_start_hz
    (qj1, qj2) = (jq.prepare_weights(jc, jmake_weights(
        jc, cal=JCal.random(jc, seed=s))) for s in (1, 2))
    blocks = [make_random_bytes_block(pc, seed=30 + s) for s in range(3)]
    runs = {}
    for name, mod, cfg, w1, w2 in (("jax", jpipe, jc, qj1, qj2),
                                   ("port", ppipe, pc, _carry(qj1),
                                    _carry(qj2))):
        sink = mod.CollectSink()
        bf = mod.StreamingBeamformer(cfg, w1, mod.SyntheticSource(
            cfg, blocks, 4), sink, depth=2, products=products)
        assert bf.run(max_blocks=2).n_blocks == 2
        bf.update_weights(w2)
        assert bf.run().n_blocks == 2
        runs[name] = sink.outputs
    assert [s for s, _ in runs["port"]] == [s for s, _ in runs["jax"]] \
        == [0, 1, 2, 3]
    for (_, oj), (_, op) in zip(runs["jax"], runs["port"]):
        np.testing.assert_array_equal(op, np.asarray(oj))
    assert not np.array_equal(runs["port"][3][1], runs["port"][0][1])


CARRIER_CHAN = 5


def _with_carrier(blk, cfg):
    """Channel CARRIER_CHAN's active antennas set to a constant byte: a
    carrier whose spectral kurtosis is 0."""
    w = blk.reshape(cfg.wire_block_shape).copy()
    w[:, CARRIER_CHAN, :, :cfg.n_ant_active] = 0x77
    return w


def test_deployed_stream_matches_jax(tmp_path):
    """The deployed path at a DSA-110 sub-band: 8-bit .fil for all 512
    beams from the kernel's uint8 epilogue, the incoherent .dada with
    antennas 3 and 77 flagged, and ``RFIMonitor(interval=2, sample=2)``
    whose excision swaps in weights with the carrier channel zapped.  The
    events, every .fil, scales.json and the .dada equal the JAX driver's."""
    jc, pc = _cfgs(n_chan=8, subband=True)
    blocks = [_with_carrier(make_random_bytes_block(pc, seed=50 + s), pc)
              for s in range(2)]
    runs = {}
    for name, mod, sig, cfg, mon_cls in (("jax", jpipe, jsig, jc, JMonitor),
                                         ("port", ppipe, psig, pc,
                                          RFIMonitor)):
        def weights(zapped=(), name=name):
            qj = jq.prepare_weights(jc, jzap_weights(jmake_weights(jc),
                                                     list(zapped), jc))
            return qj if name == "jax" else _carry(qj)

        fil = sig.FilterbankSink(tmp_path / name, cfg, nbits=8)
        inco = mod.FileSink(tmp_path / f"{name}.dada", cfg,
                            products="incoherent")
        bf = mod.StreamingBeamformer(cfg, weights(), mod.SyntheticSource(
            cfg, blocks, 6), fil, depth=2, incoherent_sink=inco,
            flag_ants=FLAGS)
        events = []

        def excise(ev, bf=bf, events=events, weights=weights):
            events.append(ev)
            if ev["type"] == "excise" and not ev.get("final"):
                bf.update_weights(weights(ev["zapped"]))

        bf.rfi_monitor = mon_cls(cfg, interval=2, sample=2, on_event=excise)
        if mod is ppipe:
            bf.warmup()
        stats = bf.run()
        fil.close()
        inco.close()
        assert stats.n_blocks == 6 and stats.dropped == 0
        runs[name] = events, fil
    (ev_j, fil_j), (ev_p, fil_p) = runs["jax"], runs["port"]
    assert ev_p == ev_j
    assert [(e["type"], e["new"]) for e in ev_p] == [("excise",
                                                      [CARRIER_CHAN])]
    assert fil_p.scales == fil_j.scales and len(fil_p.beams) == 512
    for b in range(512):
        name = f"beam{b:04d}.fil"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    assert json.loads((tmp_path / "port" / "scales.json").read_text()) == \
        json.loads((tmp_path / "jax" / "scales.json").read_text())
    assert (tmp_path / "port.dada").read_bytes() == \
        (tmp_path / "jax.dada").read_bytes()
    # The carrier channel (file column F-1-c) is zero once the swap lands.
    _, data = psig.read_filterbank(tmp_path / "port" / "beam0300.fil")
    t_out = pc.out_block_shape[1]
    assert not data[-t_out:, 0, pc.n_chan - 1 - CARRIER_CHAN].any()
    assert data[:t_out, 0, pc.n_chan - 1 - CARRIER_CHAN].any()
