"""Streams from the benchmark's capture ring through the deployed loop.

The port's ``pipeline.StreamingBeamformer`` reads the ring through its
``pipeline.RingSource`` (on a card the pinned-ring route: each slot
registered with ``cudaHostRegister``, H2D straight from the slot, released
after ``h2d_done``), with the deployed products: the kernel's uint8
epilogue at the 8-bit sink's scales and the ``.fil`` layout on the device,
the incoherent sum, and the RFI monitor on the kernel's SK accumulators.

The mix sets ``pace``:

- ``saturated``: every free slot is kept published: the slot the loop
  hands back is published again at once, in the release itself, as a
  capture process that is never the bottleneck would.  The window opens at
  the drain of the pre-roll's last block (every slot registered, the loop
  in its steady state) and lasts ``--seconds``;
- ``realtime``: once the loop has handed back the pre-roll's last slot
  (every slot read and registered once, the last copy done), block ``i``
  of the window is due ``i * block / rate`` after it opens and is
  published then, or dropped and counted when its slot is still unread.
  The clock never slows for the consumer, and runs in the ring's own calls
  (``CaptureRing.advance``): no producer thread and no late timer stands
  between a block's due time and the loop's read of it.

The producer publishes slots filled once at set-up (blocks made on the
device from the seed and copied in): in a deployment the NIC writes the
ring, so the host copies nothing per block.  Blocks drain in order; the
sinks keep those the check samples, drawn from the seed among the window's
first ``--seconds`` of sky.

Any product the mix names beyond those three is attached by its own module
(``products/<name>.py``, ``attach``) to the built loop before its warm-up,
and keeps its data of the sampled blocks the same way.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from beambench import inputs, products, program
from beambench.capture_ring import CaptureRing
from beambench.core import Kept, Outcome, Run
from beambench.trace import Tracer
from dsabeamformer_tpu_torch.ops import gemm
from dsabeamformer_tpu_torch.pipeline import RingSource, StreamingBeamformer

#: The deployed products this kind builds itself (``products/<name>.py``).
OWN = ("uint8_fil", "incoherent", "sk")


class _Clock:
    """The window's state, kept at each drain (the loop's ``on_block``)
    and, paced, at each slot's release (the ring's ``on_release``)."""

    def __init__(self, r: Run, n_pre: int, saturated: bool, tracer: Tracer,
                 monitor, keep: set):
        self.r = r
        self.n_pre = n_pre
        self.released = 0
        self.saturated = saturated
        self.tracer = tracer
        self.monitor = monitor
        self.keep = keep
        self.t0 = None
        self.t_end = math.inf
        self.drains: list = []
        self.sk: dict = {}

    def open(self, t: float) -> float:
        self.t0, self.t_end = t, t + self.r.seconds
        return t

    def on_release(self) -> None:  # called with the ring's lock held
        """The paced window opens as the loop hands back the pre-roll's last
        slot: no slot is registered inside the window, and no block of the
        pre-roll waits for the copy engine there, on any route."""
        self.released += 1
        if self.released == self.n_pre:
            self.open(time.perf_counter())

    def on_block(self, bs) -> None:
        t = time.perf_counter()
        with self.tracer.span("on_block"):
            self.drains.append((bs.seq, t))
            sk = self.monitor.drained()
            if bs.seq in self.keep and sk is not None:
                self.sk[bs.seq] = np.array(sk)
            if len(self.drains) == self.n_pre and self.saturated:
                self.open(t)
        tr = self.tracer
        if tr.enabled and self.t0 is not None:
            lead, length = self.r.trace_window
            if tr.t_open is None and t >= self.t0 + lead:
                tr.open()
            elif tr.active and t >= tr.t_open + length:
                tr.close()


class _Refill:
    """The saturated producer: every slot published at start, and each
    slot the loop releases published again at once until the window's
    end, when the ring is marked ended instead (``ring.on_release``)."""

    def __init__(self, ring: CaptureRing, clock: _Clock):
        self.ring = ring
        self.clock = clock
        self.seq = 0
        self.due: dict = {}
        ring.on_release = self.refill

    def start(self) -> None:
        for _ in range(self.ring.nbufs):
            self.ring.publish(self.seq)
            self.seq += 1

    def refill(self) -> None:  # called with the ring's lock held
        if time.perf_counter() >= self.clock.t_end:
            self.ring._set_eod()
        else:
            self.ring._publish(self.seq)
            self.seq += 1

    def halt(self) -> None:
        self.ring.on_release = None
        self.ring.set_eod()


class _Paced:
    """The real-time producer, a clock the ring reads (``ring.advance``):
    the pre-roll's blocks published at once; then, from the release of the
    pre-roll's last slot (``clock.t0``), block ``i`` of the window published
    at ``t0 + i * period_s`` whether or not the loop is ready for it
    (dropped and counted when no slot is free), and the data ended after
    the last.  No thread: the ring works out each block's fate at its due
    time when the loop next calls it, so the harness adds no lateness."""

    def __init__(self, ring: CaptureRing, clock: _Clock, period_s: float,
                 n_due: int):
        self.ring = ring
        self.clock = clock
        self.period_s = period_s
        self.n_due = n_due
        self.seq = 0
        self.i = 0
        self.due: dict = {}

    def start(self) -> None:
        for _ in range(min(self.clock.n_pre, self.ring.nbufs)):
            self.ring.publish(self.seq)
            self.seq += 1
        self.ring.advance = self.advance

    def advance(self, now: float):  # called with the ring's lock held
        t0 = self.clock.t0
        if t0 is None:
            return None
        while self.i < self.n_due:
            due = t0 + self.i * self.period_s
            if due > now:
                return due
            self.due[self.seq] = due
            self.ring._publish(self.seq, due)
            self.seq += 1
            self.i += 1
        self.ring._set_eod()
        return None

    def halt(self) -> None:
        self.ring.advance = None
        self.ring.set_eod()


def run(r: Run) -> Outcome:
    mix, dev = r.mix, r.device
    extra = program.require_products(mix, OWN)
    cfg = program.obs_config(r.config, r.control)
    block_s = cfg.block_duration_s
    depth = int(mix["depth"])
    saturated = mix["pace"] == "saturated"
    if not saturated and mix["pace"] != "realtime":
        raise ValueError(f"unknown pace {mix['pace']!r}")
    n_slots = max(depth + 2, round(float(mix["ring_sky_s"]) / block_s))
    n_pre = n_slots + 2 if saturated else n_slots
    n_1x = max(1, int(r.seconds / block_s))
    keep = {n_pre + int(o) for o in r.rng(1).choice(
        n_1x, min(int(mix["check_blocks"]), n_1x), replace=False)}
    tracer = Tracer(r.trace, dev)

    ring = CaptureRing(f"beambench-{r.cell}", n_slots, cfg.wire_block_bytes,
                       tracer.span)
    qw = program.port_weights(cfg, inputs.steering_weights(r.config, r.seed,
                                                           dev))
    for k in range(n_slots):
        blk = inputs.wire_block(r.config, r.seed, k, dev)
        torch.from_numpy(ring.slot(k)).copy_(blk.reshape(-1))
        del blk
    # The sink calibrates its scales on the stream's first block (seq 0,
    # slot 0), in the pre-roll, as the deployed sink does.
    sink = program.KeepSink(cfg, keep, tracer.span)
    inco = program.KeepIncoherent(cfg, keep, tracer.span)
    monitor = program.KeepRFIMonitor(cfg, **mix["rfi"])
    clock = _Clock(r, n_pre, saturated, tracer, monitor, keep)
    source = RingSource(cfg, ring, validate=False, timeout_s=60.0, device=dev)
    bf = StreamingBeamformer(cfg, qw, source, sink, depth=depth,
                             incoherent_sink=inco, on_block=clock.on_block)
    bf.rfi_monitor = monitor
    attached = {name: products.module(name).attach(r, cfg, bf, keep, tracer)
                for name in extra}
    bf.warmup()
    tracer.prepare()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches0 = sum(gemm.fused_detect.launches.values())
    if saturated:
        producer = _Refill(ring, clock)
    else:
        period_s = block_s / float(mix["rate"])
        producer = _Paced(ring, clock, period_s,
                          n_due=math.ceil(r.seconds / period_s))
        ring.on_release = clock.on_release
    producer.start()
    try:
        bf.run()
    finally:
        producer.halt()
        tracer.finish()
    if clock.t0 is None:
        raise RuntimeError("the stream ended before its window opened")
    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    launches = sum(gemm.fused_detect.launches.values()) - launches0
    source.close()
    del bf, source, qw
    ring_slot = {seq: slot for seq, slot, _t in ring.log}
    ring.close()

    seqs = [s for s, _ in clock.drains]
    published = set(ring_slot)
    order_faults = (sum(1 for a, b in zip(seqs, seqs[1:]) if b <= a)
                    + len(published - set(seqs)) + len(set(seqs) - published))
    kept = [Kept(content=ring_slot[s], products={
                "uint8_fil": sink.kept[s], "incoherent": inco.kept.get(s),
                "sk": clock.sk.get(s),
                **{name: a.kept.get(s) for name, a in attached.items()}})
            for s in sorted(keep) if s in sink.kept]
    del attached
    out = Outcome(
        t0=clock.t0, t1=clock.t_end if saturated else clock.t0 + r.seconds,
        setup_s=clock.t0 - r.t_process, attempted=0, failed=0, kept=kept,
        memory_peak_bytes=int(memory_peak), drains=clock.drains,
        due=producer.due, order_faults=order_faults,
        lost=len((keep & published) - set(sink.kept)),
        scales=sink.scale_vector())
    if saturated:
        out.attempted = out.drained_in_window()
    else:
        drained = set(seqs)
        out.attempted = len(producer.due)
        out.failed = sum(1 for s in producer.due if s not in drained)
    if r.trace:
        out.trace = tracer.view()
        out.trace_blocks = sum(1 for _, t in clock.drains
                               if tracer.t_open < t <= tracer.t_close)
    out.notes = {"ring_slots": n_slots, "depth": depth,
                 "dropped": ring.dropped, "kernel_launches": launches,
                 "rfi_events": len(monitor.events),
                 "blocks_drained": len(seqs)}
    if not saturated:
        lat = np.array(out.latencies_ms())
        pickup = np.array([(ring.opened[s] - t) * 1e3
                           for s, t in producer.due.items()
                           if s in ring.opened])
        out.notes["latency_ms_p50_p95_max"] = np.percentile(
            lat, [50, 95, 100]).tolist()
        # Due -> the loop's open_read of the block: the loop's own delay.
        out.notes["pickup_ms_p50_p95_max"] = np.percentile(
            pickup, [50, 95, 100]).tolist() if pickup.size else None
    if r.trace:
        out.notes["trace_open_ms"] = tracer.open_ms
    return out
