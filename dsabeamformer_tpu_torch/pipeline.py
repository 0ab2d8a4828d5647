"""Streaming driver: the per-block hot loop.

Blocks come from a source, go to the device, through ``beamform_power``, and
their averaged powers come back to a sink, with up to ``depth`` blocks in
flight so that one block's transfers overlap another's kernel.

On a CUDA device each block takes one of ``depth + 2`` slots.  A slot owns a
pinned host staging buffer, a device wire buffer, a pinned host output
buffer and three events:

    host:   wait h2d_done(slot)  -> copy the source block into pinned staging
    copy:   wait kernel_done(slot) -> H2D staging -> device wire; record h2d_done
    compute: wait h2d_done         -> beamform_power kernel;     record kernel_done
    d2h:    wait kernel_done       -> D2H powers -> pinned output; record d2h_done
    drain:  sync d2h_done          -> sink.write(seq, powers)

so a staging buffer is never overwritten before the H2D copy out of it has
completed, and a device wire buffer never before the kernel reading it has
finished.  The host waits only to drain the oldest block and on h2d_done
before refilling a staging buffer; with depth + 2 slots that event has
already passed in steady state.

On the CPU the same loop runs synchronously on plain tensors (the tests'
path).  The sink receives a NumPy view of a buffer the driver reuses: it
must consume or copy it before ``write`` returns.
"""

from __future__ import annotations

import collections
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.ops.gemm import beamform_power
from dsabeamformer_tpu_torch.ops.quantize import QuantWeights
from dsabeamformer_tpu_torch.utils.metrics import BlockStats, StreamStats

Block = Tuple[int, np.ndarray]


# --------------------------------------------------------------------- #
# Sources
# --------------------------------------------------------------------- #

class SyntheticSource:
    """Cycles pre-generated wire blocks (test / benchmark mode), as fast as
    the driver reads them."""

    def __init__(self, cfg: ObsConfig, blocks: List[np.ndarray],
                 n_blocks: int):
        self.cfg = cfg
        self.blocks = blocks
        self.n_blocks = n_blocks
        self._i = 0
        self.dropped = 0
        self.skipped = 0

    def read_block(self) -> Optional[Block]:
        if self._i >= self.n_blocks:
            return None
        blk = self.blocks[self._i % len(self.blocks)]
        seq = self._i
        self._i += 1
        return seq, blk


class FileSource:
    """Raw concatenated wire blocks from a file; ``offset`` skips a leading
    header (e.g. a PSRDADA file's HDR_SIZE bytes)."""

    def __init__(self, cfg: ObsConfig, path: str | Path, offset: int = 0):
        self.cfg = cfg
        self._f = open(path, "rb")
        if offset:
            self._f.seek(offset)
        self._seq = 0
        self.dropped = 0
        self.skipped = 0

    def read_block(self) -> Optional[Block]:
        blk = np.empty(self.cfg.wire_block_shape, dtype=np.uint8)
        if self._f.readinto(memoryview(blk).cast("B")) < blk.nbytes:
            self._f.close()
            return None
        seq = self._seq
        self._seq += 1
        return seq, blk


# --------------------------------------------------------------------- #
# Sinks
# --------------------------------------------------------------------- #

class CollectSink:
    """Keeps copies of the power blocks in memory (tests / small runs)."""

    def __init__(self):
        self.outputs: List[Tuple[int, np.ndarray]] = []

    def write(self, seq: int, powers: np.ndarray) -> None:
        self.outputs.append((seq, np.array(powers)))

    def close(self) -> None:
        pass


class FileSink:
    """Appends float32 power blocks to a raw file (the DADA-header variant
    of the JAX package waits for the ``ingest/dada.py`` port)."""

    def __init__(self, path: str | Path):
        self._f = open(path, "wb")

    def write(self, seq: int, powers: np.ndarray) -> None:
        self._f.write(np.ascontiguousarray(powers, dtype=np.float32).tobytes())

    def close(self):
        self._f.close()


# --------------------------------------------------------------------- #
# Driver
# --------------------------------------------------------------------- #

class _Slot:
    """One in-flight block's buffers and events on a CUDA device."""

    def __init__(self, cfg: ObsConfig, device: torch.device):
        self.host_wire = torch.empty(cfg.device_wire_shape, dtype=torch.uint8,
                                     pin_memory=True)
        self.dev_wire = torch.empty(cfg.device_wire_shape, dtype=torch.uint8,
                                    device=device)
        self.host_out = torch.empty(cfg.out_block_shape, dtype=torch.float32,
                                    pin_memory=True)
        self.h2d_done = torch.cuda.Event()
        self.kernel_done = torch.cuda.Event()
        self.d2h_done = torch.cuda.Event()


class StreamingBeamformer:
    """The per-block streaming loop (power product).

    ``depth`` is the number of blocks allowed in flight; the device follows
    the weights (``qw.scales.device``).  ``update_weights`` swaps in new
    weights for subsequent blocks without draining the stream.
    """

    def __init__(
        self,
        cfg: ObsConfig,
        weights: QuantWeights,
        source,
        sink=None,
        *,
        depth: int = 2,
        on_block: Optional[Callable[[BlockStats], None]] = None,
    ):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self.cfg = cfg
        self.source = source
        self.sink = sink
        self.depth = depth
        self.on_block = on_block
        self.device = weights.device
        self._cuda = self.device.type == "cuda"
        self._slots: list = []
        self._n_enq = 0
        if self._cuda:
            self.device_kind = torch.cuda.get_device_name(self.device)
            self._copy = torch.cuda.Stream(self.device)
            self._compute = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        else:
            self.device_kind = "cpu"
        self.update_weights(weights)
        self._inflight: collections.deque = collections.deque()
        self._block_idx = 0
        self._stats: Optional[StreamStats] = None

    @property
    def n_slots(self) -> int:
        """Host staging buffers (and device buffers) on a CUDA device:
        every in-flight block, the one being enqueued and one spare."""
        return self.depth + 2

    def update_weights(self, weights: QuantWeights) -> None:
        """Swap in new (already-quantized) weights for subsequent blocks."""
        if weights.device != self.device:
            raise ValueError(
                f"weights are on {weights.device}, the stream on {self.device}")
        if self._cuda:
            # Order the weights' creation before the compute stream reads
            # them, and keep their memory from reuse until the kernels
            # queued on it have run (they may outlive this reference).
            self._compute.wait_stream(torch.cuda.current_stream(self.device))
            for t in (*weights.terms, weights.scales):
                t.record_stream(self._compute)
        self.weights = weights

    def current_stats(self) -> StreamStats:
        """Stats for the in-progress (or completed) run, wall-clocked from
        the loop start."""
        if self._stats is None:
            self._stats = StreamStats(cfg_name=self.cfg.name,
                                      device_kind=self.device_kind)
        self._stats.dropped = getattr(self.source, "dropped", 0)
        self._stats.skipped = getattr(self.source, "skipped", 0)
        return self._stats.finish()

    def _enqueue(self, wire_np: np.ndarray):
        """Start one block; returns what ``_drain_one`` needs to finish it."""
        cfg = self.cfg
        if tuple(wire_np.shape) not in (cfg.wire_block_shape,
                                        cfg.device_wire_shape):
            raise ValueError(
                f"source block shaped {tuple(wire_np.shape)} is neither "
                f"{cfg.wire_block_shape} nor {cfg.device_wire_shape}")
        wire = torch.as_tensor(wire_np).reshape(cfg.device_wire_shape)
        if not self._cuda:
            return beamform_power(wire, self.weights, cfg).numpy()
        if not self._slots:
            self._slots = [_Slot(cfg, self.device)
                           for _ in range(self.n_slots)]
        slot = self._slots[self._n_enq % len(self._slots)]
        self._n_enq += 1
        slot.h2d_done.synchronize()  # staging buffer's last H2D has completed
        slot.host_wire.copy_(wire)                   # host -> pinned staging
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(slot.kernel_done)  # device buffer is free
            slot.dev_wire.copy_(slot.host_wire, non_blocking=True)
            slot.h2d_done.record(self._copy)
        with torch.cuda.stream(self._compute):
            self._compute.wait_event(slot.h2d_done)
            out = beamform_power(slot.dev_wire, self.weights, cfg)
            slot.kernel_done.record(self._compute)
        with torch.cuda.stream(self._d2h):
            self._d2h.wait_event(slot.kernel_done)
            slot.host_out.copy_(out, non_blocking=True)
            slot.d2h_done.record(self._d2h)
        # `out` stays referenced until the drain has synchronized d2h_done,
        # so its memory is not reused while the D2H copy may still read it.
        return slot, out

    def _fetch(self, pending) -> np.ndarray:
        if not self._cuda:
            return pending
        slot, _out = pending
        slot.d2h_done.synchronize()
        return slot.host_out.numpy()

    def warmup(self) -> None:
        """Run one zero block through the full round trip (builds the
        kernel and allocates the slots before a live stream attaches)."""
        zero = np.zeros(self.cfg.device_wire_shape, dtype=np.uint8)
        self._fetch(self._enqueue(zero))

    def _drain_one(self) -> None:
        seq, pending, t_enq = self._inflight.popleft()
        arr = self._fetch(pending)  # D2H complete
        if self.sink is not None:
            self.sink.write(seq, arr)
        bs = BlockStats(
            block_idx=self._block_idx,
            seq=seq,
            wall_s=time.perf_counter() - t_enq,
            bytes_in=self.cfg.wire_block_bytes,
            dropped=getattr(self.source, "dropped", 0),
            skipped=getattr(self.source, "skipped", 0),
        )
        self._block_idx += 1
        if self.on_block is not None:
            self.on_block(bs)

    def run(self, max_blocks: Optional[int] = None) -> StreamStats:
        cfg = self.cfg
        self._stats = stats = StreamStats(cfg_name=cfg.name,
                                          device_kind=self.device_kind)
        n = 0
        while max_blocks is None or n < max_blocks:
            item = self.source.read_block()
            if item is None:
                break
            seq, wire_np = item
            t_enq = time.perf_counter()
            self._inflight.append((seq, self._enqueue(wire_np), t_enq))
            stats.n_blocks += 1
            stats.bytes_in += cfg.wire_block_bytes
            stats.macs += cfg.macs_per_block * cfg.n_weight_terms
            n += 1
            while len(self._inflight) > self.depth:
                self._drain_one()
        while self._inflight:
            self._drain_one()
        stats.dropped = getattr(self.source, "dropped", 0)
        stats.skipped = getattr(self.source, "skipped", 0)
        return stats.finish()


def run_stream(
    cfg: ObsConfig,
    weights: QuantWeights,
    source,
    sink=None,
    *,
    depth: int = 2,
    max_blocks: Optional[int] = None,
    on_block: Optional[Callable[[BlockStats], None]] = None,
) -> StreamStats:
    return StreamingBeamformer(
        cfg, weights, source, sink, depth=depth, on_block=on_block
    ).run(max_blocks)
