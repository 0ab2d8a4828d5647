"""The slice as a whole: the port's StreamingBeamformer on the CPU against
the JAX package's, block for block, with a mid-stream weight update; plus
the port's sources, sinks and stats."""

import time

import numpy as np
import pytest

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu.pipeline as jpipe
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ops.quantize as pq
import dsabeamformer_tpu_torch.pipeline as ppipe
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu_torch.ingest.generator import make_noise_block
from dsabeamformer_tpu_torch.models.weights import make_weights, weights_numpy_golden
from dsabeamformer_tpu_torch.ops.reference import beamform_block_ref
from dsabeamformer_tpu_torch.utils.testing import assert_power_close, relative_power_error

#: Port vs JAX per block on identical wire and weights (f32 order only).
JAX_RTOL = 1e-6


def _weights_pair(cal_seed):
    jc = jcfg.TINY
    qj = jq.prepare_weights(jc, jmake_weights(
        jc, cal=JCal.random(jc, seed=cal_seed, amp_sigma=0.5)))
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    return qj, qp


@pytest.mark.parametrize("depth", [0, 2])
def test_stream_matches_jax_with_weight_update(depth):
    blocks = [make_noise_block(pcfg.TINY, rms=2.0, seed=s) for s in range(3)]
    (qj1, qp1), (qj2, qp2) = _weights_pair(1), _weights_pair(2)
    runs = {}
    for name, mod, cfg, w1, w2 in (
            ("jax", jpipe, jcfg.TINY, qj1, qj2),
            ("port", ppipe, pcfg.TINY, qp1, qp2)):
        sink = mod.CollectSink()
        src = mod.SyntheticSource(cfg, blocks, n_blocks=4)
        bf = mod.StreamingBeamformer(cfg, w1, src, sink, depth=depth)
        first = bf.run(max_blocks=2)
        bf.update_weights(w2)
        rest = bf.run()
        assert (first.n_blocks, rest.n_blocks) == (2, 2)
        runs[name] = sink.outputs
    assert [s for s, _ in runs["port"]] == [s for s, _ in runs["jax"]] \
        == [0, 1, 2, 3]
    for (_, pj), (_, pp) in zip(runs["jax"], runs["port"]):
        assert pp.shape == pcfg.TINY.out_block_shape
        assert relative_power_error(pp, np.asarray(pj)) <= JAX_RTOL
    # The update took effect: block 0 (seq 3, new weights) differs from seq 0.
    assert relative_power_error(runs["port"][3][1], runs["port"][0][1]) > 1e-3


def test_stream_outputs_match_golden_and_stats():
    cfg = pcfg.TINY
    blocks = [make_noise_block(cfg, rms=2.0, seed=s) for s in range(3)]
    qw = pq.prepare_weights(cfg, make_weights(cfg, device="cpu"))
    sink, seen = ppipe.CollectSink(), []
    stats = ppipe.run_stream(cfg, qw, ppipe.SyntheticSource(cfg, blocks, 5),
                             sink, depth=3, on_block=seen.append)
    assert stats.n_blocks == 5 and len(sink.outputs) == 5
    assert stats.bytes_in == 5 * cfg.wire_block_bytes
    assert stats.macs == 5 * cfg.macs_per_block * 2
    rec = stats.record(cfg)
    assert rec["blocks"] == 5 and rec["dropped"] == 0
    assert rec["device"] == "cpu" and rec["tc_utilization_issued"] is None
    assert rec["realtime_factor"] > 0
    assert [b.seq for b in seen] == list(range(5))
    assert "x RT" in seen[0].line(cfg)
    w_ref = weights_numpy_golden(cfg)
    for seq, powers in sink.outputs:
        ref = beamform_block_ref(w_ref, blocks[seq % 3], cfg.input_layout,
                                 cfg.navg_time)
        assert_power_close(powers, ref, rtol=2e-4, what=f"block {seq}")


def test_file_source_and_sink_roundtrip(tmp_path):
    cfg = pcfg.TINY.replace(input_layout="ftpa")
    blocks = [make_noise_block(cfg, rms=2.0, seed=s) for s in range(2)]
    raw = tmp_path / "blocks.raw"
    raw.write_bytes(b"H" * 16 + b"".join(b.tobytes() for b in blocks))
    qw = pq.prepare_weights(cfg, make_weights(cfg, device="cpu"))
    out = tmp_path / "powers.f32"
    sink = ppipe.FileSink(out)
    stats = ppipe.run_stream(cfg, qw, ppipe.FileSource(cfg, raw, offset=16),
                             sink)
    sink.close()
    assert stats.n_blocks == 2
    got = np.fromfile(out, np.float32).reshape(2, *cfg.out_block_shape)
    collect = ppipe.CollectSink()
    ppipe.run_stream(cfg, qw, ppipe.SyntheticSource(cfg, blocks, 2), collect)
    np.testing.assert_array_equal(got[1], collect.outputs[1][1])


def test_stream_rejects_bad_blocks_and_depth():
    cfg = pcfg.TINY
    qw = pq.prepare_weights(cfg, make_weights(cfg, device="cpu"))
    bad = ppipe.SyntheticSource(cfg, [np.zeros((3, 4), np.uint8)], 1)
    with pytest.raises(ValueError, match="source block shaped"):
        ppipe.run_stream(cfg, qw, bad)
    with pytest.raises(ValueError, match="depth"):
        ppipe.StreamingBeamformer(cfg, qw, bad, depth=-1)
    bf = ppipe.StreamingBeamformer(cfg, qw, bad, depth=1)
    assert bf.n_slots == 3
    bf.warmup()
    assert bf.current_stats().n_blocks == 0


def test_rate_paced_source_as_jax():
    """``SyntheticSource(rate_factor=)`` paces block i to ``i *
    block_duration_s / rate_factor`` after the first read, in both packages:
    the counts, and a lower bound on the elapsed time only."""
    blocks = [make_noise_block(pcfg.TINY, seed=0)]
    qj, qp = _weights_pair(1)
    for mod, cfg, qw in ((jpipe, jcfg.TINY, qj), (ppipe, pcfg.TINY, qp)):
        # 0.5x realtime over 4 blocks: the last is due 6 block durations in.
        src = mod.SyntheticSource(cfg, blocks, n_blocks=4, rate_factor=0.5)
        assert src.rate_factor == 0.5
        t0 = time.perf_counter()
        stats = mod.run_stream(cfg, qw, src)
        elapsed = time.perf_counter() - t0
        assert stats.n_blocks == 4 and stats.dropped == 0
        assert elapsed >= 3 * cfg.block_duration_s / 0.5
    unpaced = ppipe.SyntheticSource(pcfg.TINY, blocks, n_blocks=2)
    assert unpaced.rate_factor is None
    assert [unpaced.read_block()[0] for _ in range(2)] == [0, 1]
    assert unpaced.read_block() is None


def test_stream_without_a_sink_as_jax():
    """No sink: the product stays on the device side (nothing is fetched),
    the incoherent product still reaches its sink, and the stats are those
    of the JAX package's loop and of the same stream with a sink."""
    blocks = [make_noise_block(pcfg.TINY, rms=2.0, seed=s) for s in range(2)]
    qj, qp = _weights_pair(1)
    stats, inco = {}, {}
    for name, mod, cfg, qw, sink in (
            ("jax", jpipe, jcfg.TINY, qj, None),
            ("port", ppipe, pcfg.TINY, qp, None),
            ("port+sink", ppipe, pcfg.TINY, qp, ppipe.CollectSink())):
        inco[name] = mod.CollectSink()
        bf = mod.StreamingBeamformer(
            cfg, qw, mod.SyntheticSource(cfg, blocks, n_blocks=3), sink,
            depth=2, incoherent_sink=inco[name])
        stats[name] = bf.run()
        if name == "port":
            assert not bf._wants_product
            pending = bf._enqueue(blocks[0])
            assert bf._fetch(pending)[0] is None      # no product fetched
            assert bf._fetch(pending)[1] is not None  # the incoherent one is
    for name in ("port", "port+sink"):
        for key in ("n_blocks", "bytes_in", "macs", "dropped", "skipped"):
            assert getattr(stats[name], key) == getattr(stats["jax"], key)
        assert [s for s, _ in inco[name].outputs] == [0, 1, 2]
        for (_, a), (_, b) in zip(inco[name].outputs, inco["jax"].outputs):
            np.testing.assert_array_equal(a, np.asarray(b))
