"""Streaming through the channel mesh: the port's ``MeshStreamingBeamformer``
on eight CPU slots against the JAX package's on its eight virtual CPU
devices, case for case (tests/test_mesh_stream.py: seeds, sizes, depths),
on the same wire and the same quantized table: every drained block within
JAX_RTOL of JAX's (side outputs equal), and the JAX tests' own checks
(golden bars, band sums, weight-update regimes, engaged uint8 kernel)."""

import dataclasses

import numpy as np
import pytest

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ops.dedisperse as jdd
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu.ops.rfi as jrfi
import dsabeamformer_tpu.parallel.sharding as jsh
import dsabeamformer_tpu.pipeline as jpipe
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ops.dedisperse as pdd
import dsabeamformer_tpu_torch.ops.quantize as pq
import dsabeamformer_tpu_torch.ops.rfi as prfi
import dsabeamformer_tpu_torch.parallel.sharding as psh
import dsabeamformer_tpu_torch.pipeline as ppipe
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu_torch.ingest import sigproc as psig
from dsabeamformer_tpu_torch.ingest.generator import (
    make_dispersed_pulse_block,
    make_noise_block,
)
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.tracking import FringeTracker
from dsabeamformer_tpu_torch.models.weights import weights_numpy_golden
from dsabeamformer_tpu_torch.ops.incoherent import incoherent_power_golden
from dsabeamformer_tpu_torch.ops.reference import (
    beamform_block_ref,
    beamform_stokes_ref,
)
from dsabeamformer_tpu_torch.utils.testing import (
    assert_power_close,
    relative_power_error,
)

#: Port against JAX per block on identical wire and weights.
JAX_RTOL = 1e-6
#: The band against the product's own channel sum (the JAX test's bar).
BAND_RTOL = 1e-5

#: TINY with the DSA-110 sharding structure: 16 channels over 8 slots.
PCFG = pcfg.TINY.replace(n_chan=16, n_chan_total=16)
JCFG = jcfg.TINY.replace(n_chan=16, n_chan_total=16, chan_tile=2)


@pytest.fixture(scope="module")
def pmesh():
    return psh.make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_mesh(8)


def _weights(jc=JCFG, cal_seed=None):
    """The JAX package's table and the port's copy of its bytes."""
    cal = None if cal_seed is None else JCal.random(jc, seed=cal_seed)
    qj = jq.quantize_weights(jmake_weights(jc, cal=cal), jc.weight_mode)
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    return qj, qp


def _golden(cfg, wire, cal=None):
    return beamform_block_ref(weights_numpy_golden(cfg, cal=cal), wire,
                              cfg.input_layout, cfg.navg_time, cfg.navg_freq)


def _pair(pmesh, jmesh, pc=PCFG, jc=JCFG):
    """``(name, pipeline module, config, mesh, weights)`` of both runs."""
    qj, qp = _weights(jc)
    return (("jax", jpipe, jc, jmesh, qj), ("port", ppipe, pc, pmesh, qp))


def _assert_outputs_match(port, jax_out, rtol=JAX_RTOL):
    assert [s for s, _ in port] == [s for s, _ in jax_out]
    for (seq, p), (_, j) in zip(port, jax_out):
        assert relative_power_error(p, np.asarray(j)) <= rtol, seq


def test_mesh_stream_16_blocks_golden(pmesh, jmesh):
    blocks = [make_noise_block(PCFG, rms=2.0, seed=s) for s in range(4)]
    runs = {}
    for name, mod, cfg, mesh, qw in _pair(pmesh, jmesh):
        sink = mod.CollectSink()
        bf = mod.MeshStreamingBeamformer(
            cfg, qw, mod.SyntheticSource(cfg, blocks, n_blocks=16), sink,
            mesh=mesh, depth=2)
        bf.warmup()
        stats = bf.run()
        assert stats.n_blocks == 16 and len(sink.outputs) == 16
        runs[name] = sink.outputs
    _assert_outputs_match(runs["port"], runs["jax"])
    refs = [_golden(PCFG, b) for b in blocks]
    for seq, p in runs["port"]:
        assert p.shape == PCFG.out_block_shape
        assert_power_close(p, refs[seq % 4], what=f"mesh stream block {seq}")


def test_mesh_stream_midstream_weight_update(pmesh, jmesh):
    wire = make_noise_block(PCFG, rms=2.0, seed=11)
    (qj0, qp0), (qj1, qp1) = _weights(), _weights(cal_seed=5)
    swapped_at = 4
    runs = {}
    for name, mod, cfg, mesh, w0, w1 in (
            ("jax", jpipe, JCFG, jmesh, qj0, qj1),
            ("port", ppipe, PCFG, pmesh, qp0, qp1)):
        sink = mod.CollectSink()
        bf = mod.MeshStreamingBeamformer(
            cfg, w0, mod.SyntheticSource(cfg, [wire], n_blocks=8), sink,
            mesh=mesh, depth=2)

        def on_block(bs, bf=bf, w1=w1):
            if bs.block_idx == swapped_at - 1:
                bf.update_weights(w1)

        bf.on_block = on_block
        bf.warmup()
        assert bf.run().n_blocks == 8
        runs[name] = sink.outputs
    _assert_outputs_match(runs["port"], runs["jax"])
    cal = CalTable(gains=JCal.random(JCFG, seed=5).gains)
    ref0, ref1 = _golden(PCFG, wire), _golden(PCFG, wire, cal=cal)
    first_new = None
    for seq, p in runs["port"]:
        regime = int(np.abs(p - ref1).max() < np.abs(p - ref0).max())
        if regime and first_new is None:
            first_new = seq
        assert regime or first_new is None, f"block {seq} reverted"
        assert_power_close(p, ref1 if regime else ref0, what=f"block {seq}")
    assert first_new is not None and swapped_at <= first_new <= swapped_at + 2


def test_mesh_stream_band_power_collective(pmesh, jmesh):
    wire = make_noise_block(PCFG, rms=2.0, seed=21)
    bands, outs = {}, {}
    for name, mod, cfg, mesh, qw in _pair(pmesh, jmesh):
        sink, got = mod.CollectSink(), {}
        bf = mod.MeshStreamingBeamformer(
            cfg, qw, mod.SyntheticSource(cfg, [wire], n_blocks=5), sink,
            mesh=mesh, depth=2, with_band_power=True,
            on_band_power=lambda seq, band, got=got: got.__setitem__(
                seq, band))
        bf.warmup()
        bf.run()
        assert sorted(got) == list(range(5))
        bands[name], outs[name] = got, sink.outputs
    _assert_outputs_match(outs["port"], outs["jax"])
    for seq, p in outs["port"]:
        np.testing.assert_allclose(bands["port"][seq], p.sum(axis=(0, 2)),
                                   rtol=BAND_RTOL)
        np.testing.assert_allclose(bands["port"][seq], bands["jax"][seq],
                                   rtol=JAX_RTOL)


def test_mesh_stream_stokes(pmesh, jmesh):
    wire = make_noise_block(PCFG, rms=2.0, seed=31)
    runs = {}
    for name, mod, cfg, mesh, qw in _pair(pmesh, jmesh):
        sink = mod.CollectSink()
        bf = mod.MeshStreamingBeamformer(
            cfg, qw, mod.SyntheticSource(cfg, [wire], n_blocks=3), sink,
            mesh=mesh, depth=2, products="stokes")
        bf.warmup()
        assert bf.run().n_blocks == 3
        runs[name] = sink.outputs
    ref = beamform_stokes_ref(weights_numpy_golden(PCFG), wire,
                              PCFG.input_layout, PCFG.navg_time,
                              PCFG.navg_freq)
    scale = np.abs(ref[:, :, 0]).max()
    for (_, st), (_, sj) in zip(runs["port"], runs["jax"]):
        assert st.shape == ref.shape
        assert np.abs(st - ref).max() / scale < 3e-4
        sj = np.asarray(sj)
        assert np.abs(st - sj).max() / np.abs(sj[:, :, 0]).max() <= JAX_RTOL


def test_mesh_stream_fused_incoherent(pmesh, jmesh):
    wire = make_noise_block(PCFG, rms=2.0, seed=61)
    runs = {}
    for name, mod, cfg, mesh, qw in _pair(pmesh, jmesh):
        sink, inco = mod.CollectSink(), mod.CollectSink()
        bf = mod.MeshStreamingBeamformer(
            cfg, qw, mod.SyntheticSource(cfg, [wire], n_blocks=4), sink,
            mesh=mesh, depth=2, incoherent_sink=inco, flag_ants=(2,))
        bf.warmup()
        assert bf.run().n_blocks == 4 and len(inco.outputs) == 4
        runs[name] = sink.outputs, inco.outputs
    _assert_outputs_match(runs["port"][0], runs["jax"][0])
    ref_i = incoherent_power_golden(wire, PCFG, flag_ants=(2,))
    for (_, ip), (_, ij) in zip(runs["port"][1], runs["jax"][1]):
        np.testing.assert_array_equal(ip, np.asarray(ij))
        np.testing.assert_allclose(ip, ref_i, rtol=1e-6)


def test_mesh_stream_fused_sk_monitor(pmesh, jmesh):
    """The SK accumulators from the mesh step equal JAX's; the live
    monitor on both mesh streams sees every block and raises the same
    events (none on noise)."""
    wire = make_noise_block(PCFG, rms=2.0, seed=71)
    _, sk = psh.sharded_beamformer(PCFG, pmesh, sk_stats=True)(
        wire, psh.shard_weights(PCFG, pmesh))
    import jax

    from dsabeamformer_tpu.ops.gemm import device_wire_view

    _, jsk = jsh.sharded_beamformer(JCFG, jmesh, sk_stats=True)(
        jax.device_put(device_wire_view(wire, JCFG),
                       jsh.sharded_wire_sharding(JCFG, jmesh)),
        jsh.shard_weights(JCFG, jmesh))
    assert sk.shape == (PCFG.n_chan, 2)
    np.testing.assert_allclose(sk.numpy(), np.asarray(jsk), rtol=1e-6)
    events = {}
    for (name, mod, cfg, mesh, qw), mon_cls in zip(
            _pair(pmesh, jmesh), (jrfi.RFIMonitor, prfi.RFIMonitor)):
        bf = mod.MeshStreamingBeamformer(
            cfg, qw, mod.SyntheticSource(cfg, [wire], n_blocks=4),
            mod.CollectSink(), mesh=mesh, depth=2)
        got = events[name] = []
        bf.rfi_monitor = mon_cls(cfg, interval=2, sample=1,
                                 on_event=got.append)
        bf.warmup()
        assert bf.run().n_blocks == 4
        assert not bf.rfi_monitor._pending
    assert events["port"] == events["jax"]
    assert not [e for e in events["port"]
                if e["type"] == "excise" and e.get("new")]


def test_mesh_stream_fused_quant8(pmesh, jmesh):
    """The fused uint8 quantization through the mesh step: byte-equal to
    quantizing the gathered float32 product, and to JAX's uint8."""
    import jax

    from dsabeamformer_tpu.ops.gemm import device_wire_view

    wire = make_noise_block(PCFG, rms=2.0, seed=91)
    qw_sh = psh.shard_weights(PCFG, pmesh)
    p32 = psh.sharded_beamformer(PCFG, pmesh)(wire, qw_sh).numpy()
    scales = np.full(PCFG.n_beams, 0.5, np.float32)
    pq8 = psh.sharded_beamformer(PCFG, pmesh, fused_quant8=True)(
        wire, qw_sh, scales).numpy()
    assert pq8.dtype == np.uint8
    np.testing.assert_array_equal(
        pq8, np.clip(np.rint(p32 * scales), 0, 255).astype(np.uint8))
    jq8 = jsh.sharded_beamformer(JCFG, jmesh, fused_quant8=True)(
        jax.device_put(device_wire_view(wire, JCFG),
                       jsh.sharded_wire_sharding(JCFG, jmesh)),
        jsh.shard_weights(JCFG, jmesh), jax.device_put(scales))
    np.testing.assert_array_equal(pq8, np.asarray(jq8))


def test_mesh_stream_with_search_monitor(pmesh, jmesh):
    """The live single-pulse search on the gathered product: a dispersed
    pulse in the wire, the same candidates as the JAX package's mesh
    stream, and the pulse found."""
    pc, jc = PCFG.replace(navg_time=2), JCFG.replace(navg_time=2)
    tsamp = pc.sample_period_s * pc.navg_time
    f = pc.freqs_hz() / 1e6
    dm = 16 * tsamp / (pcfg.DM_CONST_S * (f.min() ** -2 - f.max() ** -2))
    target = pc.n_beams // 2
    blocks = [make_dispersed_pulse_block(
        pc, dm, angle_rad=pc.beam_angles_rad()[target], t0_sample=8,
        width_samples=6, amplitude=5.0, seed=s) for s in range(2)]
    dms = pdd.dm_trial_grid(float(f.min()), float(f.max()), tsamp,
                            dm_max=3 * dm)
    found = {}
    for (name, mod, cfg, mesh, qw), dd, extra in zip(
            _pair(pmesh, jmesh, pc, jc), (jdd, pdd), ({}, {"device": "cpu"})):
        bf = mod.MeshStreamingBeamformer(
            cfg, qw, mod.SyntheticSource(cfg, blocks, 4), mod.CollectSink(),
            mesh=mesh, depth=2)
        mon = bf.search_monitor = dd.SearchMonitor(
            f, tsamp, dms, beam=target, threshold=6.0, chunk_t=64, **extra)
        bf.warmup()
        assert bf.run().n_blocks == 4
        found[name] = mon.candidates
    port, ref = found["port"], found["jax"]
    assert port and len(port) == len(ref)
    for cp, cr in zip(port, ref):
        assert cp.snr == pytest.approx(cr.snr, rel=1e-5)
        assert dataclasses.asdict(dataclasses.replace(cp, snr=cr.snr)) \
            == dataclasses.asdict(cr)
    best = max(port, key=lambda c: c.snr)
    assert best.beam == target and abs(best.dm - dm) <= 2 * (dms[1] - dms[0])


def test_mesh_rejects_quant8_with_band_power(pmesh):
    with pytest.raises(ValueError, match="band power"):
        psh.sharded_beamformer(PCFG, pmesh, fused_quant8=True,
                               with_band_power=True)
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        _, qp = _weights(JCFG.replace(n_chan=12, n_chan_total=12))
        ppipe.MeshStreamingBeamformer(
            PCFG.replace(n_chan=12, n_chan_total=12), qp, None, mesh=pmesh)


def test_mesh_stream_fused_quant8_files_byte_equal(pmesh, jmesh, tmp_path):
    """An 8-bit filterbank mesh run engages the fused uint8 kernel after
    block 0 and writes the single-device run's files byte for byte; JAX's
    mesh run's within one count (float32 order can move a rounding)."""
    from dsabeamformer_tpu.ingest import sigproc as jsig

    wires = [make_noise_block(PCFG, rms=2.0, seed=s) for s in (51, 52, 53)]
    raw = tmp_path / "cap.raw"
    raw.write_bytes(b"".join(w.tobytes() for w in wires))
    qj, qp = _weights()
    sinks = {}
    for name, mod, sig, cfg, qw, kw in (
            ("mesh", ppipe, psig, PCFG, qp, {"mesh": pmesh}),
            ("single", ppipe, psig, PCFG, qp, {}),
            ("jax", jpipe, jsig, JCFG, qj, {"mesh": jmesh})):
        sink = sig.FilterbankSink(tmp_path / name, cfg, nbits=8,
                                  beams=[0, 3])
        klass = mod.StreamingBeamformer if name == "single" \
            else mod.MeshStreamingBeamformer
        bf = klass(cfg, qw, mod.FileSource(cfg, raw), sink, **kw)
        engaged, step = [], bf._step
        bf._step = lambda w, q8=None, sk_stats=None, step=step, \
            engaged=engaged: (engaged.append(q8 is not None),
                              step(w, q8, sk_stats=sk_stats))[1]
        assert bf._fused_quant8() is not None
        bf.run()
        assert engaged == [False, True, True], (name, engaged)
        sink.close()
        sinks[name] = sink
    assert sinks["mesh"].scales == sinks["single"].scales
    for b in (0, 3):
        np.testing.assert_allclose(sinks["mesh"].scales[b],
                                   sinks["jax"].scales[b], rtol=1e-6)
        name = f"beam{b:04d}.fil"
        assert (tmp_path / "mesh" / name).read_bytes() \
            == (tmp_path / "single" / name).read_bytes()
        _, dp = psig.read_filterbank(tmp_path / "mesh" / name)
        _, dj = jsig.read_filterbank(tmp_path / "jax" / name)
        assert np.abs(dp.astype(int) - dj.astype(int)).max() <= 1


def test_mesh_stream_drop_accounting(pmesh):
    wire = make_noise_block(PCFG, rms=2.0, seed=41)
    _, qp = _weights()

    class DroppySource(ppipe.SyntheticSource):
        def read_block(self):
            item = super().read_block()
            self.dropped, self.skipped = 3, 1
            return item

    bf = ppipe.MeshStreamingBeamformer(
        PCFG, qp, DroppySource(PCFG, [wire], n_blocks=4), ppipe.CollectSink(),
        mesh=pmesh)
    bf.warmup()
    stats = bf.run()
    assert (stats.n_blocks, stats.dropped, stats.skipped) == (4, 3, 1)


def test_mesh_stream_tracker_resharding(pmesh):
    """A fringe tracker's updates are re-split by ``update_weights``: the
    mesh stream equals the single-device tracked stream byte for byte, and
    each block matches the golden model at some tracked pointing."""
    wire = make_noise_block(PCFG, rms=2.0, seed=51)
    _, qp = _weights()
    outs, trackers = {}, {}
    for name, klass, kw in (
            ("mesh", ppipe.MeshStreamingBeamformer, {"mesh": pmesh}),
            ("single", ppipe.StreamingBeamformer, {})):
        sink = ppipe.CollectSink()
        tr = trackers[name] = FringeTracker(PCFG, pointing0_rad=0.0,
                                            device="cpu")
        bf = klass(PCFG, qp, ppipe.SyntheticSource(PCFG, [wire], 4), sink,
                   depth=1, tracker=tr, **kw)
        bf.warmup()
        assert bf.run().n_blocks == 4
        outs[name] = sink.outputs
    for (_, a), (_, b) in zip(outs["mesh"], outs["single"]):
        assert np.array_equal(a, b)
    tracker = trackers["mesh"]
    refs = [beamform_block_ref(
        weights_numpy_golden(PCFG, pointing_rad=tracker.pointing_at(
            t * PCFG.block_duration_s)), wire, PCFG.input_layout,
        PCFG.navg_time, PCFG.navg_freq) for t in range(5)]
    for seq, p in outs["mesh"]:
        errs = [relative_power_error(p, r) for r in refs[:seq + 1]]
        assert min(errs) < 1e-3, (seq, errs)
