"""The slice as a whole: the port's StreamingBeamformer on the CPU against
the JAX package's, block for block, with a mid-stream weight update; plus
the port's sources, sinks and stats."""

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
