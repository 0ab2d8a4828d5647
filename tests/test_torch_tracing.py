"""The streaming loop's spans and counters on the CPU: under a
``utils.profiling`` trace its ``dsabf.*`` spans, their nesting and their
per-block ``dsabf.block.<seq>`` marks reach the exported trace (the single
stream's and the mesh stream's); with no trace recording no
``record_function`` is entered; the counters of ``StreamStats`` count the
tracker's and the RFI monitor's weight swaps, the RFI events, the SK and
float32 blocks; the stage seconds of each block lie inside its wall time;
``run --stats-file`` writes them and ``run --trace-blocks`` traces a
stream's steady-state blocks."""

import json
import re

import pytest
import torch

import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ops.quantize as pq
import dsabeamformer_tpu_torch.pipeline as ppipe
from dsabeamformer_tpu_torch import cli as pcli
from dsabeamformer_tpu_torch.ingest.generator import (make_noise_block,
                                                       make_tone_block)
from dsabeamformer_tpu_torch.ingest.sigproc import FilterbankSink
from dsabeamformer_tpu_torch.models.weights import make_weights, zap_weights
from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor
from dsabeamformer_tpu_torch.parallel.sharding import make_mesh
from dsabeamformer_tpu_torch.utils import profiling
from dsabeamformer_tpu_torch.utils.metrics import STAGES

CFG = pcfg.TINY
MARK = re.compile(r"^dsabf\.block\.(\d+)$")
#: Spans of the CPU route (no ring slot, so no H2D wait or release).
CPU_SPANS = {"dsabf.source.read", "dsabf.loop.weights", "dsabf.loop.enqueue",
             "dsabf.loop.detect", "dsabf.loop.drain",
             "dsabf.loop.drain_wait", "dsabf.sink.write",
             "dsabf.loop.on_block"}


def _weights():
    return pq.prepare_weights(CFG, make_weights(CFG, device="cpu"))


def _blocks(n=3):
    return [make_noise_block(CFG, rms=2.0, seed=s) for s in range(n)]


def _tone(seed, chan=6):
    """Noise with a CW carrier in ``chan``: an RFI monitor excises it."""
    w = make_noise_block(CFG, rms=2.0, seed=seed).reshape(
        CFG.t_block, CFG.n_chan, CFG.n_pol, CFG.n_ant).copy()
    tone = make_tone_block(CFG, chan=chan, amplitude=6.0).reshape(w.shape)
    w[:, chan] = tone[:, chan]
    return w.reshape(CFG.wire_block_shape)


def _inside(inner, outer):
    return outer["tid"] == inner["tid"] and outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _by_block(events, name):
    """seq -> the ``name`` spans holding a ``dsabf.block.<seq>`` mark."""
    marks = [(int(MARK.match(e["name"]).group(1)), e) for e in events
             if MARK.match(e["name"])]
    out: dict = {}
    for s in (e for e in events if e["name"] == name):
        for seq, m in marks:
            if _inside(m, s):
                out.setdefault(seq, []).append(s)
    return out


def _traced_stream(tmp_path, make_bf):
    with profiling.trace(tmp_path, "cpu"):
        stats = make_bf().run()
    events = [e for e in profiling.trace_events(tmp_path)
              if e.get("cat") == "user_annotation"]
    return stats, events


@pytest.mark.parametrize("mesh", [False, True], ids=["single", "mesh"])
def test_spans_nest_and_name_their_blocks(tmp_path, mesh):
    n, depth = 6, 2
    seen = []

    def make_bf():
        source = ppipe.SyntheticSource(CFG, _blocks(), n)
        sink = ppipe.CollectSink()
        if mesh:
            return ppipe.MeshStreamingBeamformer(
                CFG, _weights(), source, sink, depth=depth,
                mesh=make_mesh(2, devices=["cpu"] * 2), on_block=seen.append)
        return ppipe.StreamingBeamformer(CFG, _weights(), source, sink,
                                         depth=depth, on_block=seen.append)

    stats, events = _traced_stream(tmp_path, make_bf)
    assert stats.n_blocks == n and [b.seq for b in seen] == list(range(n))
    names = {e["name"] for e in events}
    assert CPU_SPANS <= names
    assert {m for m in names if MARK.match(m)} == {
        f"dsabf.block.{s}" for s in range(n)}
    spans = {name: [e for e in events if e["name"] == name]
             for name in CPU_SPANS}
    for child, parent in (("dsabf.loop.detect", "dsabf.loop.enqueue"),
                          ("dsabf.loop.drain_wait", "dsabf.loop.drain"),
                          ("dsabf.sink.write", "dsabf.loop.drain"),
                          ("dsabf.loop.on_block", "dsabf.loop.drain")):
        assert len(spans[child]) == n
        assert all(any(_inside(c, p) for p in spans[parent])
                   for c in spans[child]), child
    enq = _by_block(events, "dsabf.loop.enqueue")
    drain = _by_block(events, "dsabf.loop.drain")
    read = _by_block(events, "dsabf.source.read")
    assert sorted(enq) == sorted(drain) == sorted(read) == list(range(n))
    for seq in range(n):
        (e,), (d,), (r,) = enq[seq], drain[seq], read[seq]
        assert r["ts"] + r["dur"] <= e["ts"]
        assert e["ts"] + e["dur"] <= d["ts"]
        # depth 2: a block drains once two later ones are enqueued
        later = [s for s in range(seq + 1, n)
                 if enq[s][0]["ts"] < d["ts"]]
        assert len(later) == min(depth, n - 1 - seq)


def test_no_record_function_without_a_trace(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no trace")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    sink = ppipe.CollectSink()
    bf = ppipe.StreamingBeamformer(
        CFG, _weights(), ppipe.SyntheticSource(CFG, _blocks(), 4), sink)
    bf.rfi_monitor = RFIMonitor(CFG, interval=1)
    assert bf.run().n_blocks == 4 and len(sink.outputs) == 4
    assert profiling.annotate("x") is profiling.annotate("y")
    profiling.mark_block(3)


class _Tracker:
    """Swaps fresh weights in at the stream times of ``at``."""

    def __init__(self, at):
        self.at = set(at)
        self.calls = 0

    def maybe_update(self, t):
        self.calls += 1
        seq = round(t / CFG.block_duration_s)
        return _weights() if seq in self.at else None


def test_tracker_swaps_are_counted():
    tracker = _Tracker(at=(2, 4))
    bf = ppipe.StreamingBeamformer(
        CFG, _weights(), ppipe.SyntheticSource(CFG, _blocks(), 6),
        ppipe.CollectSink(), tracker=tracker)
    stats = bf.run()
    assert tracker.calls == 6
    assert stats.weight_swaps == 2
    rec = stats.record(CFG)
    assert rec["weight_swaps"] == 2 and rec["rfi_events"] == 0
    assert rec["sk_blocks"] == rec["float_blocks"] == 0


@pytest.mark.parametrize("depth", [0, 2])
def test_rfi_sk_and_float_counters(tmp_path, depth):
    """An 8-bit filterbank sink and an RFI monitor sampling every second
    block, which excises a carrier and swaps weights in: one float32 block
    (the sink's calibration), three SK blocks of six, one event, one swap."""
    blocks = [_tone(40 + s) for s in range(6)]
    sink = FilterbankSink(tmp_path, CFG, nbits=8)
    bf = ppipe.StreamingBeamformer(
        CFG, _weights(), ppipe.SyntheticSource(CFG, blocks, 6), sink,
        depth=depth)

    def excise(ev):
        if ev["type"] == "excise" and not ev.get("final"):
            bf.update_weights(pq.prepare_weights(
                CFG, zap_weights(make_weights(CFG, device="cpu"),
                                 ev["zapped"], CFG)))

    bf.rfi_monitor = mon = RFIMonitor(CFG, interval=1, sample=2,
                                      on_event=excise)
    stats = bf.run()
    sink.close()
    assert [e["type"] for e in mon.events] == ["excise"]
    assert stats.rfi_events == 1 and stats.weight_swaps == 1
    assert stats.sk_blocks == 3 and stats.float_blocks == 1
    assert stats.drains_waited == 0  # the CPU route never waits
    assert stats.early_drains == 0   # nor delivers before retiring
    rec = stats.record(CFG)
    for k in ("rfi_events", "sk_blocks", "float_blocks", "drains_waited",
              "early_drains", "weight_swaps"):
        assert rec[k] == getattr(stats, k)


def test_stage_seconds_lie_in_the_wall_time():
    seen = []
    bf = ppipe.StreamingBeamformer(
        CFG, _weights(), ppipe.SyntheticSource(CFG, _blocks(), 8),
        ppipe.CollectSink(), depth=2, on_block=seen.append)
    bf.rfi_monitor = RFIMonitor(CFG, interval=2)
    stats = bf.run()
    assert len(seen) == 8
    for b in seen:
        stages = (b.read_s, b.enqueue_s, b.h2d_wait_s, b.inflight_s,
                  b.drain_wait_s, b.sinks_s, b.rfi_s)
        assert all(s >= 0 for s in stages)
        assert b.h2d_wait_s <= b.inflight_s
        assert b.enqueue_s + b.inflight_s + b.drain_wait_s + b.sinks_s \
            <= b.wall_s + 1e-9
    rec = stats.record(CFG)
    total = sum(rec[f"{k}_s"] for k in STAGES)
    assert all(rec[f"{k}_s"] >= 0 for k in STAGES)
    assert 0 < total <= stats.wall_s
    assert rec["enqueue_s"] == pytest.approx(sum(b.enqueue_s for b in seen))
    assert rec["drain_wait_s"] == pytest.approx(
        sum(b.drain_wait_s for b in seen))


def _capture(path, n):
    with open(path, "wb") as f:
        for s in range(n):
            f.write(make_noise_block(CFG, rms=2.0, seed=s).tobytes())
    return str(path)


def test_cli_stats_file_has_the_stage_keys(tmp_path, capsys):
    st = tmp_path / "stats.jsonl"
    rc = pcli.main(["run", "--config", "tiny", "--input-file",
                    _capture(tmp_path / "in.raw", 3), "--stats-file",
                    str(st), "--device", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("weight_swaps", "rfi_events", "sk_blocks", "float_blocks",
              "drains_waited", "early_drains", *(f"{s}_s" for s in STAGES)):
        assert k in rec
    lines = [json.loads(line) for line in open(st)]
    assert [r["seq"] for r in lines] == [0, 1, 2]
    for r in lines:
        for k in ("read_s", "enqueue_s", "h2d_wait_s", "inflight_s",
                  "drain_wait_s", "sinks_s", "rfi_s"):
            assert r[k] >= 0


def test_cli_trace_blocks(tmp_path, capsys, monkeypatch):
    """``run --trace-blocks 2`` at depth 2: the trace starts at the 4th
    drain and holds the next two blocks' enqueue and drain spans."""
    monkeypatch.setattr(profiling, "DEFAULT_LOG_DIR", str(tmp_path / "tr"))
    rc = pcli.main(["run", "--config", "tiny", "--input-file",
                    _capture(tmp_path / "in.raw", 10), "--trace-blocks", "2",
                    "--device", "cpu"])
    assert rc == 0
    err = capsys.readouterr().err
    found = re.findall(r"trace of 2 block\(s\): (\S+)", err)
    assert len(found) == 1 and found[0].startswith(str(tmp_path / "tr"))
    events = profiling.trace_events(tmp_path / "tr")
    names = [e["name"] for e in events]
    assert "dsabf.loop.enqueue" in names and "dsabf.loop.drain" in names
    drained = {int(MARK.match(m).group(1)) for m in names if MARK.match(m)}
    assert {4, 5} <= drained and 0 not in drained


def test_block_trace_stops_once(tmp_path):
    with pytest.raises(ValueError):
        profiling.BlockTrace(0, skip=1)
    bt = profiling.BlockTrace(1, skip=2, log_dir=tmp_path)
    assert bt.stop() is None                  # nothing recorded yet
    assert bt.drained() is None               # 1st drain: not yet
    assert bt.drained() is None               # 2nd: recording starts
    path = bt.drained()                       # 3rd: one block recorded
    assert path and path.startswith(str(tmp_path))
    assert bt.stop() is None and bt.drained() is None
