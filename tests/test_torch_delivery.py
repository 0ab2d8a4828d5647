"""The streaming loop's early delivery, driven on the CPU by a source that
answers "nothing yet" to some polls and blocks that finish on cue
(``torch_early_delivery``): the oldest finished block is delivered before
the next block is read, delivery keeps dispatch order when a later block
finishes first, the end of data during a poll ends the stream only once the
rest is delivered, ``early_drains`` counts the blocks delivered in a wait,
the products are the unpaced stream's, and each delivery in a wait splits
the read's span, whose last piece alone names the block."""

import re

import numpy as np
import pytest

import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ops.quantize as pq
import dsabeamformer_tpu_torch.pipeline as ppipe
from dsabeamformer_tpu_torch.ingest.generator import make_noise_block
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.utils import profiling
from torch_early_delivery import OnCue, PacedSource

CFG = pcfg.TINY
N = 6


def _weights():
    return pq.prepare_weights(CFG, make_weights(CFG, device="cpu"))


def _blocks():
    return [make_noise_block(CFG, rms=2.0, seed=s) for s in range(3)]


def _unpaced(depth):
    sink = ppipe.CollectSink()
    ppipe.StreamingBeamformer(CFG, _weights(),
                              ppipe.SyntheticSource(CFG, _blocks(), N), sink,
                              depth=depth).run()
    return sink.outputs


def _run(depth, finish, waits=lambda seq: 3, n=N):
    src = PacedSource(_blocks(), n, waits)
    sink = ppipe.CollectSink()
    bf = OnCue(CFG, _weights(), src, sink, depth=depth, finish=finish)
    stats = bf.run()
    return stats, src.log, sink.outputs


def _events(log, kind):
    return [e[1] for e in log if e[0] == kind]


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("finish,early", [(lambda seq: 1, N),
                                          (lambda seq: None, 0)],
                         ids=["on_cue", "cannot_tell"])
def test_finished_block_is_delivered_before_the_next_read(depth, finish,
                                                          early):
    stats, log, outputs = _run(depth, finish)
    assert stats.n_blocks == N and stats.early_drains == early
    assert _events(log, "deliver") == _events(log, "read") == list(range(N))
    for seq in range(N - 1):
        delivered = log.index(("deliver", seq)) < log.index(("read", seq + 1))
        # Where the loop cannot tell, a block waits for its retire point:
        # ``depth`` later blocks read.
        assert delivered == bool(early)
    assert log.count(("end",)) == 1
    if early:   # the end is read once every block is delivered
        assert log[-1] == ("end",)
    for (sa, a), (sb, b) in zip(outputs, _unpaced(depth)):
        assert sa == sb and np.array_equal(a, b)


def test_delivery_keeps_order_when_a_later_block_finishes_first():
    """Block 1 finishes 6 polls after its read, block 2 one poll after its
    own, which comes 4 polls after block 1's: block 2 waits for block 1,
    and both are delivered in the wait before block 3."""
    src = PacedSource(_blocks(), N)
    bf = OnCue(CFG, _weights(), src, ppipe.CollectSink(), depth=2,
               finish=lambda seq: 6 if seq == 1 else 1)
    stats = bf.run()
    log = src.log
    assert bf._read_at[2] + 1 < bf._read_at[1] + 6    # 2 finished first
    assert _events(log, "deliver") == list(range(N))
    assert log.index(("read", 2)) < log.index(("deliver", 1))
    assert log.index(("deliver", 1)) + 1 == log.index(("deliver", 2)) \
        < log.index(("read", 3))
    assert stats.early_drains == N


def test_end_of_data_during_a_poll_ends_the_stream_after_the_rest():
    """A source that never makes the loop wait (each block is ready at the
    first poll) ends while three blocks are in flight and unfinished: the
    first three are delivered at their retire points, and the end's polls
    answer None, which ends nothing: the last three are delivered in them,
    and the stream ends in one blocking read after."""
    stats, log, outputs = _run(depth=3, finish=lambda seq: 5 + seq,
                               waits=lambda seq: 0)
    assert [s for s, _ in outputs] == list(range(N))
    assert stats.n_blocks == N and stats.early_drains == 3
    reads, end = log.index(("read", N - 1)), log.index(("end",))
    assert _events(log[reads:end], "deliver") == [2, 3, 4, 5]
    assert end == len(log) - 1


def test_a_block_delivered_early_is_retired_at_its_retire_point():
    """The RFI monitor's poll (the retire) sees each block once ``depth``
    later blocks are read, whenever the block was delivered."""
    from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor

    polled = []

    class Monitor(RFIMonitor):
        def poll(self, n_drained=None):
            polled.append((n_drained, list(_events(src.log, "read"))))
            super().poll(n_drained)

    src = PacedSource(_blocks(), N)
    bf = OnCue(CFG, _weights(), src, ppipe.CollectSink(), depth=2)
    bf.rfi_monitor = Monitor(CFG, interval=1)
    stats = bf.run()
    assert stats.early_drains == N
    in_loop = [(n, reads) for n, reads in polled if n is not None]
    assert [n for n, _ in in_loop] == list(range(1, N + 1))
    for n, reads in in_loop[:N - 2]:
        assert reads[-1] == n + 1    # retired once block n + 1 is read


MARK = re.compile(r"^dsabf\.block\.(\d+)$")


def test_a_delivery_in_a_wait_splits_the_read_span(tmp_path):
    """Each read span holds at most one block mark, the one that returned
    the block; no drain lies inside a read; every drain holds its mark."""
    with profiling.trace(tmp_path, "cpu"):
        _run(depth=2, finish=lambda seq: 1)
    ev = [e for e in profiling.trace_events(tmp_path)
          if e.get("cat") == "user_annotation"]

    def inside(inner, outer):
        return outer["ts"] <= inner["ts"] and \
            inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]

    marks = [e for e in ev if MARK.match(e["name"])]
    reads = [e for e in ev if e["name"] == "dsabf.source.read"]
    drains = [e for e in ev if e["name"] == "dsabf.loop.drain"]
    held = [[int(MARK.match(m["name"]).group(1)) for m in marks
             if inside(m, r)] for r in reads]
    assert sorted(s for h in held for s in h) == list(range(N))
    assert all(len(h) <= 1 for h in held)
    assert len(reads) > N             # split by the deliveries
    assert not any(inside(d, r) for d in drains for r in reads)
    assert sorted(int(MARK.match(m["name"]).group(1)) for m in marks
                  for d in drains if inside(m, d)) == list(range(N))
