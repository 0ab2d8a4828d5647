"""The port's streaming RFI monitor (``ops/rfi.py``) against the JAX
package's on the same blocks: window pooling, sticky excision, the cap,
the sampling grid, the drained-count gate, and the streaming loop's
sampled SK variant and mid-stream excision."""

import numpy as np
import pytest

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu.pipeline as jpipe
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ops.quantize as pq
import dsabeamformer_tpu_torch.pipeline as ppipe
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu.models.weights import zap_weights as jzap_weights
from dsabeamformer_tpu.ops.rfi import RFIMonitor as JMonitor
from dsabeamformer_tpu_torch.ingest.generator import make_noise_block, make_tone_block
from dsabeamformer_tpu_torch.models.weights import make_weights, zap_weights
from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor
from dsabeamformer_tpu_torch.utils.testing import relative_power_error
from torch_early_delivery import OnCue, PacedSource

CFG = pcfg.TINY
JCFG = jcfg.TINY


def _tone_infected(seed, chan=2, amp=6.0, extra=None):
    """Noise with a CW carrier in ``chan`` (and ``extra``): the JAX
    package's test blocks, from the port's generators (byte-identical)."""
    c = CFG
    w = make_noise_block(c, rms=2.0, seed=seed).reshape(
        c.t_block, c.n_chan, c.n_pol, c.n_ant).copy()
    for ch in (chan,) + ((extra,) if extra is not None else ()):
        tone = make_tone_block(c, chan=ch, amplitude=amp).reshape(
            c.t_block, c.n_chan, c.n_pol, c.n_ant)
        w[:, ch] = tone[:, ch]
    return w.reshape(c.wire_block_shape)


def _both(blocks, poll=(lambda m, i: m.poll()), flush=False, **kw):
    """Feed the same blocks to both monitors; returns both event lists and
    the port's monitor."""
    out = []
    for cls, cfg in ((JMonitor, JCFG), (RFIMonitor, CFG)):
        events = []
        mon = cls(cfg, on_event=events.append, **kw)
        for i, blk in enumerate(blocks):
            mon.observe(blk)
            poll(mon, i)
        if flush:
            mon.flush()
        out.append(events)
    assert out[1] == out[0]
    return out[1], mon


def test_excises_once_and_stays_sticky():
    events, mon = _both([_tone_infected(s) for s in range(6)], interval=2)
    assert [e["type"] for e in events] == ["excise"]
    assert events[0]["new"] == [2] and events[0]["blocks"] == 2
    assert mon.zapped == {2}


def test_sampling_and_flush():
    events, _ = _both([_tone_infected(10 + s) for s in range(6)],
                      interval=4, sample=2, flush=True)
    assert [e["type"] for e in events] == ["excise"]
    assert events[0]["blocks"] == 3 and events[0]["final"] is True


def test_wants_stats_peeks_sampling_grid():
    mon = RFIMonitor(CFG, sample=3)
    decisions = []
    for _ in range(7):
        want = mon.wants_stats()
        assert mon.wants_stats() == want  # peek, no advance
        mon.observe_stats(np.ones((CFG.n_chan, 2), np.float32) if want
                          else None)
        decisions.append(want)
    assert decisions == [True, False, False] * 2 + [True]
    mon2 = RFIMonitor(CFG, sample=2)
    assert mon2.wants_stats()
    with pytest.raises(ValueError, match="grid skew"):
        mon2.observe_stats(None)


def test_cap_refuses_wholesale_zap_and_is_not_respammed():
    blocks = [_tone_infected(60 + s, extra=5) for s in range(4)]
    events, mon = _both(blocks, interval=1, max_fraction=0.01,
                        poll=lambda m, i: m.poll(None))
    assert [e["type"] for e in events] == ["cap"]
    assert events[0]["flagged"] == [2, 5] and events[0]["max_channels"] == 1
    assert mon.zapped == set()


def test_seed_not_rereported():
    events, _ = _both([_tone_infected(30 + s) for s in range(4)],
                      interval=2, seed_zapped=[2])
    assert events == []


def test_validation():
    for kw in (dict(interval=0), dict(sample=0), dict(max_fraction=0.0),
               dict(max_fraction=1.5)):
        with pytest.raises(ValueError):
            RFIMonitor(CFG, **kw)


def test_poll_gated_by_drained_count():
    mon = RFIMonitor(CFG, interval=100)  # never decides
    for s in range(3):
        mon.observe(_tone_infected(50 + s))
    mon.poll(0)
    assert mon._n == 0 and len(mon._pending) == 3
    mon.poll(1)
    assert mon._n == 1 and len(mon._pending) == 2
    mon.poll(3)
    assert mon._n == 3 and not mon._pending
    mon.observe(_tone_infected(53))
    mon.poll(None)
    assert mon._n == 4


def test_flush_event_is_final_and_warmup_keeps_no_state():
    events, _ = _both([_tone_infected(70 + s) for s in range(2)],
                      interval=100, flush=True)
    assert len(events) == 1 and events[0].get("final") is True
    mon = RFIMonitor(CFG, interval=1)
    mon.warmup(_tone_infected(80))
    assert mon._n == 0 and not mon._pending and mon.zapped == set()


def test_observe_stats_matches_observe():
    """The fused path (the kernel's [n_chan, 2] accumulators) and the
    standalone pass give the same events, block for block."""
    import dsabeamformer_tpu_torch.ops.gemm as pgemm

    qw = pq.prepare_weights(CFG, make_weights(CFG, device="cpu"))
    ev_a, ev_b = [], []
    a = RFIMonitor(CFG, interval=2, on_event=ev_a.append)
    b = RFIMonitor(CFG, interval=2, on_event=ev_b.append)
    for s in range(4):
        blk = _tone_infected(90 + s)
        a.observe(blk)
        b.observe_stats(pgemm.beamform_power(blk, qw, CFG, sk_stats=True)[1]
                        .numpy())
        a.poll()
        b.poll()
    assert ev_a == ev_b and [e["new"] for e in ev_a] == [[2]]


def test_sampled_sk_gates_kernel_variant(monkeypatch):
    """With ``sample=2`` the stream asks for the SK output only on sampled
    blocks, in the JAX package's pattern, warmup runs both variants, and
    the monitor excises the carrier from the sampled subset."""
    blocks = [_tone_infected(50 + s) for s in range(6)]
    runs = {}
    for name, mod, cfg, qw in (
            ("jax", jpipe, JCFG,
             jq.prepare_weights(JCFG, jmake_weights(JCFG))),
            ("port", ppipe, CFG,
             pq.prepare_weights(CFG, make_weights(CFG, device="cpu")))):
        events, calls = [], []
        mon = (JMonitor if name == "jax" else RFIMonitor)(
            cfg, interval=2, sample=2, on_event=events.append)
        bf = mod.StreamingBeamformer(cfg, qw, mod.SyntheticSource(
            cfg, blocks, n_blocks=6), mod.CollectSink(), depth=1)
        bf.rfi_monitor = mon
        inner = bf._step

        def spy(w, q8=None, sk_stats=None, inner=inner, calls=calls):
            calls.append(bool(bf.rfi_monitor is not None
                              if sk_stats is None else sk_stats))
            return inner(w, q8, sk_stats=sk_stats)

        bf._step = spy
        bf.warmup()
        assert calls == [True, False]  # both variants before the stream
        calls.clear()
        bf.run(max_blocks=6)
        runs[name] = calls, events
    assert runs["port"] == runs["jax"]
    calls, events = runs["port"]
    assert calls == [True, False] * 3
    assert [e["type"] for e in events] == ["excise"] and \
        events[0]["new"] == [2]


@pytest.mark.parametrize("early", [False, True], ids=["unpaced", "paced"])
@pytest.mark.parametrize("depth", [0, 2])
def test_midstream_excision_zeroes_channel_like_jax(depth, early, tmp_path):
    """The excise glue (regenerate the weights with the grown zap set,
    swap them in mid-stream) on both streaming loops: the same events,
    the same products within float32 order, and channel 6 exactly zero
    once the new weights run.  Paced: the port's source makes the loop
    wait before each block and every block finishes in that wait, so it is
    delivered before the next read (``torch_early_delivery``); the swap
    engages at the same block as the JAX package's."""
    blocks = [_tone_infected(40 + s, chan=6) for s in range(6)]
    runs = {}
    for name, mod, cfg, mk, zap, prep, mon_cls in (
            ("jax", jpipe, JCFG, jmake_weights, jzap_weights,
             jq.prepare_weights, JMonitor),
            ("port", ppipe, CFG, lambda c: make_weights(c, device="cpu"),
             zap_weights, pq.prepare_weights, RFIMonitor)):
        sink, events = mod.CollectSink(), []
        if name == "port" and early:
            bf = OnCue(cfg, prep(cfg, mk(cfg)), PacedSource(blocks, 6), sink,
                       depth=depth)
        else:
            bf = mod.StreamingBeamformer(cfg, prep(cfg, mk(cfg)),
                                         mod.SyntheticSource(cfg, blocks, 6),
                                         sink, depth=depth)

        def excise(ev, bf=bf, cfg=cfg, mk=mk, zap=zap, prep=prep,
                   events=events):
            events.append(ev)
            if ev["type"] == "excise" and not ev.get("final"):
                bf.update_weights(prep(cfg, zap(mk(cfg), ev["zapped"], cfg)))

        bf.rfi_monitor = mon_cls(cfg, interval=1, on_event=excise)
        stats = bf.run()
        runs[name] = events, sink.outputs
    # Depth 0 retires each block as it is enqueued: no wait comes first.
    assert stats.early_drains == (6 if early and depth else 0)
    (ev_j, out_j), (ev_p, out_p) = runs["jax"], runs["port"]
    assert ev_p == ev_j and 6 in ev_p[0]["new"]
    assert [s for s, _ in out_p] == list(range(6))
    for (_, a), (_, b) in zip(out_j, out_p):
        assert relative_power_error(b, np.asarray(a)) <= 1e-6
    assert out_p[0][1][6].max() > 0      # before the excision
    assert out_p[-1][1][6].max() == 0    # after it: exactly zero
    assert out_p[-1][1][3].max() > 0     # other channels untouched
