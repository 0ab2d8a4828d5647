"""Streaming driver: the per-block hot loop.

Blocks come from a source (a shared-memory ring written by the capture
process, ``RingSource``; a file; or pre-made blocks), go to the device,
through ``beamform_power`` (or ``beamform_stokes``: ``products="stokes"``),
and their products come back to the sinks, with up to ``depth`` blocks in
flight so that one block's transfers overlap another's kernel.  The deployed
path adds, from the same kernel call: the 8-bit filterbank quantization
(``FilterbankSink`` with ``nbits=8``), the incoherent sum
(``incoherent_sink``) and the spectral-kurtosis accumulators of the RFI
monitor (``rfi_monitor``), whose excisions swap in new weights mid-stream
through ``update_weights``.  A fringe tracker (``tracker``) swaps in new
weights as the sky turns, and the live single-pulse search
(``search_monitor``) takes each drained block's searched beams.

On a CUDA device each block takes one of ``depth + 2`` slots.  A slot owns a
pinned host staging buffer, a device wire buffer, pinned host buffers for
each product it brings back, and three events:

    host:   wait h2d_done(slot)  -> copy the source block into pinned staging
    copy:   wait kernel_done(slot) -> H2D staging -> device wire; record h2d_done
    compute: wait h2d_done         -> detect kernel;             record kernel_done
    d2h:    wait kernel_done       -> D2H products -> pinned;   record d2h_done
    drain:  sync d2h_done          -> sinks, RFI monitor

so a staging buffer is never overwritten before the H2D copy out of it has
completed, and a device wire buffer never before the kernel reading it has
finished.  The host waits only to drain the oldest block and on h2d_done
before refilling a staging buffer; with depth + 2 slots that event has
already passed in steady state.

A ``RingSource`` on a CUDA device takes the pinned-ring route instead: each
ring slot is registered with the CUDA runtime (``cudaHostRegister``) the
first time it is seen, the source hands the loop a tensor view of the open
slot, and the H2D copy reads the slot itself, with no staging copy.  The
ring has one open read per consumer, so the loop hands block n's slot back
(after its h2d_done) before it opens block n + 1: the H2D copies are
serialized with the reads, the kernels and D2H copies keep overlapping.

On the CPU the same loop runs synchronously on plain tensors (the tests'
path).  A sink receives a NumPy view of a buffer the loop reuses: it must
consume or copy it before ``write`` returns.
"""

from __future__ import annotations

import collections
import ctypes
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.ingest import dada
from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
from dsabeamformer_tpu_torch.ops.gemm import beamform_power, beamform_stokes
from dsabeamformer_tpu_torch.ops.quantize import QuantWeights
from dsabeamformer_tpu_torch.utils.device import resolve_device
from dsabeamformer_tpu_torch.utils.metrics import BlockStats, StreamStats

Block = Tuple[int, np.ndarray]


# --------------------------------------------------------------------- #
# Sources
# --------------------------------------------------------------------- #

def staging_pool_size(wire_block_bytes: int, depth: int) -> int:
    """Host staging-buffer count for a copying ``RingSource`` at pipeline
    depth ``depth``: the loop needs depth + 2 (in flight, being enqueued,
    one spare); blocks under 512 MiB keep a floor of 8 buffers, which
    absorbs consumer stalls of several block periods."""
    if wire_block_bytes >= 512 * 2**20:
        return depth + 2
    return max(depth + 2, 8)


class RingSource:
    """Blocks from a dsaring shared-memory ring (the PSRDADA client).

    The stream header is validated against the config on attach
    (``dada.validate_header``); ``latest=True`` applies the skip-ahead
    overrun policy, and ``dropped`` / ``skipped`` are the ring's counters.

    On a CUDA ``device`` (the default) the source is *pinned*: it registers
    each ring slot with ``cudaHostRegister`` the first time it sees it (as
    PSRDADA's ``dada_cuda_dbregister`` registers its shared-memory ring with
    the CUDA runtime, so that transfers from it are DMA at full rate) and
    ``read_block`` returns a uint8 tensor view of the open slot; the
    streaming loop copies it to the card from there and calls ``release``
    once that copy has completed.  A failed registration raises with the
    CUDA error.  ``close`` unregisters the slots; call it before closing
    the ring.

    On the CPU each block is copied out of the ring into a round-robin pool
    of ``n_host_buffers`` host arrays (the JAX package's route) and the slot
    is released at once.
    """

    def __init__(self, cfg: ObsConfig, ring: RingBuffer, *,
                 latest: bool = False, timeout_s: float = 5.0,
                 validate: bool = True, n_host_buffers: int = 8,
                 device="cuda"):
        self.cfg = cfg
        self.ring = ring
        self.latest = latest
        self.timeout_s = timeout_s
        self.device = resolve_device(device)
        #: True: blocks are views of registered ring slots (the pinned-ring
        #: route); False: copies in a host pool.
        self.pinned = self.device.type == "cuda"
        if validate:
            dada.validate_header(cfg, ring.read_header(timeout_s=timeout_s))
        if ring.bufsz != cfg.wire_block_bytes:
            raise ValueError(f"ring slots hold {ring.bufsz} B, a "
                             f"{cfg.name} block {cfg.wire_block_bytes} B")
        self._pool = [] if self.pinned else [
            np.empty(cfg.wire_block_bytes, dtype=np.uint8)
            for _ in range(n_host_buffers)]
        self._pool_i = 0
        self._registered: set = set()  # slot addresses
        self._open = False

    @property
    def n_host_buffers(self) -> Optional[int]:
        """Size of the copying route's staging pool (None when pinned: the
        ring's own slots are the buffers, one open at a time)."""
        return None if self.pinned else len(self._pool)

    def read_block(self):
        if not self.pinned:
            buf = self._pool[self._pool_i]
            self._pool_i = (self._pool_i + 1) % len(self._pool)
            got = self.ring.read_block(buf, timeout_s=self.timeout_s,
                                       latest=self.latest)
            if got is None:
                return None
            seq, flat = got
            return seq, flat.reshape(self.cfg.wire_block_shape)
        if self._open:
            raise RuntimeError("release() the open ring slot before reading "
                               "the next block")
        got = self.ring.open_read(self.timeout_s, self.latest)
        if got is None:
            return None
        seq, addr = got
        self._open = True
        self._register(addr)
        n = self.cfg.wire_block_bytes
        view = np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(addr))
        return seq, torch.from_numpy(view).view(self.cfg.wire_block_shape)

    def release(self) -> None:
        """Hand the open slot back to the producer (pinned route)."""
        if self._open:
            self._open = False
            self.ring.release_read()

    def _register(self, addr: int) -> None:
        if addr in self._registered:
            return
        n = self.cfg.wire_block_bytes
        with torch.cuda.device(self.device):
            rc = int(torch.cuda.cudart().cudaHostRegister(addr, n, 0))
        if rc:
            raise RuntimeError(
                f"cudaHostRegister of ring {self.ring.name!r} slot "
                f"{addr:#x} ({n} B) failed: {torch.cuda.CudaError(rc)}")
        self._registered.add(addr)

    def close(self) -> None:
        """Release the open slot and unregister every registered one."""
        self.release()
        while self._registered:
            addr = self._registered.pop()
            rc = int(torch.cuda.cudart().cudaHostUnregister(addr))
            if rc:
                raise RuntimeError(
                    f"cudaHostUnregister of ring {self.ring.name!r} slot "
                    f"{addr:#x} failed: {torch.cuda.CudaError(rc)}")

    @property
    def dropped(self) -> int:
        return self.ring.dropped

    @property
    def skipped(self) -> int:
        return self.ring.skipped


class SyntheticSource:
    """Cycles pre-generated wire blocks (test / benchmark mode): as fast as
    the streaming loop reads them, or paced to ``rate_factor`` times real time
    (block ``i`` is due ``i * cfg.block_duration_s / rate_factor`` after the
    first read)."""

    def __init__(self, cfg: ObsConfig, blocks: List[np.ndarray],
                 n_blocks: int, rate_factor: Optional[float] = None):
        self.cfg = cfg
        self.blocks = blocks
        self.n_blocks = n_blocks
        self.rate_factor = rate_factor
        self._i = 0
        self._t0 = None
        self.dropped = 0
        self.skipped = 0

    def read_block(self) -> Optional[Block]:
        if self._i >= self.n_blocks:
            return None
        if self.rate_factor:
            if self._t0 is None:
                self._t0 = time.perf_counter()
            due = self._i * self.cfg.block_duration_s / self.rate_factor
            now = time.perf_counter() - self._t0
            if now < due:
                time.sleep(due - now)
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
    """Keeps copies of the product blocks in memory (tests / small runs)."""

    def __init__(self):
        self.outputs: List[Tuple[int, np.ndarray]] = []

    def write(self, seq: int, powers: np.ndarray) -> None:
        self.outputs.append((seq, np.array(powers)))

    def close(self) -> None:
        pass


class FileSink:
    """Appends float32 product blocks to a raw file.

    With a config and a ``.dada`` path, a DADA header block is written first
    (``PAYLOAD=BEAM_POWERS``, or ``INCOHERENT_POWER`` for the incoherent
    product, plus the output geometry), as the JAX package's ``FileSink``
    writes it, so ``ingest.dada.read_product_file`` of either package reads
    the file."""

    def __init__(self, path: str | Path, cfg: Optional[ObsConfig] = None,
                 products: str = "power", extra_header=None):
        payload = {"power": "BEAM_POWERS", "incoherent": "INCOHERENT_POWER",
                   "stokes": "BEAM_STOKES_IQUV"}.get(products)
        if payload is None:
            raise ValueError(f"unknown products {products!r}")
        self._f = open(path, "wb")
        if cfg is not None and str(path).endswith(".dada"):
            f_out, t_out, b_out = cfg.out_block_shape
            extra = {"OUT_NSTOKES": 4} if products == "stokes" else {}
            if products != "incoherent":
                # The incoherent product has no beam axis ([F', T']).
                extra["OUT_NBEAM"] = b_out
            extra.update(extra_header or {})
            text = dada.encode_header(
                cfg,
                HDR_SIZE=dada.DADA_HDR_SIZE,
                PAYLOAD=payload,
                OUT_DTYPE="float32",
                OUT_NCHAN=f_out,
                OUT_NTIME=t_out,
                **extra,
            ).encode("ascii")
            self._f.write(text.ljust(dada.DADA_HDR_SIZE, b"\0"))

    def write(self, seq: int, powers: np.ndarray) -> None:
        self._f.write(np.ascontiguousarray(powers, dtype=np.float32))

    def close(self):
        self._f.close()


class RingSink:
    """Writes float32 product blocks into an output dsaring for the
    downstream consumer.  With a config it commits the stream header
    first (``PAYLOAD=BEAM_POWERS`` or ``BEAM_STOKES_IQUV`` and the output
    geometry ``OUT_*``), as the JAX package's ``RingSink`` does."""

    def __init__(self, ring: RingBuffer, cfg: Optional[ObsConfig] = None,
                 products: str = "power", extra_header=None):
        if products not in ("power", "stokes"):
            raise ValueError(f"unknown products {products!r}")
        self.ring = ring
        if cfg is not None:
            f, t, b = cfg.out_block_shape
            extra = {"OUT_NSTOKES": 4} if products == "stokes" else {}
            extra.update(extra_header or {})
            self.ring.write_header(dada.encode_header(
                cfg,
                PAYLOAD=("BEAM_STOKES_IQUV" if products == "stokes"
                         else "BEAM_POWERS"),
                OUT_DTYPE="float32",
                OUT_NCHAN=f,
                OUT_NTIME=t,
                OUT_NBEAM=b,
                **extra,
            ))

    def write(self, seq: int, powers: np.ndarray) -> None:
        self.ring.write_block(np.ascontiguousarray(powers, dtype=np.float32))

    @property
    def dropped(self) -> int:
        """Product blocks the ring discarded because the downstream
        consumer was absent or too slow (the writer never blocks)."""
        return self.ring.dropped

    def close(self) -> None:
        """Mark end of data for the downstream consumer, then detach."""
        self.ring.set_eod()
        self.ring.close()


# --------------------------------------------------------------------- #
# Driver
# --------------------------------------------------------------------- #

class _Slot:
    """One in-flight block's buffers and events on a CUDA device.  The
    pinned staging buffer (never made on the pinned-ring route) and the
    pinned product buffers (one per (name, dtype)) are made at first use;
    ``StreamingBeamformer._make_slots`` makes them ahead of a run."""

    def __init__(self, cfg: ObsConfig, device: torch.device):
        self._wire_shape = cfg.device_wire_shape
        self._host_wire = None
        self.dev_wire = torch.empty(cfg.device_wire_shape, dtype=torch.uint8,
                                    device=device)
        self.host: dict = {}
        self.h2d_done = torch.cuda.Event()
        self.kernel_done = torch.cuda.Event()
        self.d2h_done = torch.cuda.Event()

    @property
    def host_wire(self) -> torch.Tensor:
        if self._host_wire is None:
            self._host_wire = torch.empty(self._wire_shape, dtype=torch.uint8,
                                          pin_memory=True)
        return self._host_wire

    def host_buffer(self, name: str, shape, dtype) -> torch.Tensor:
        key = (name, dtype)
        buf = self.host.get(key)
        if buf is None or tuple(buf.shape) != tuple(shape):
            buf = self.host[key] = torch.empty(shape, dtype=dtype,
                                               pin_memory=True)
        return buf


class StreamingBeamformer:
    """The per-block streaming loop.

    ``products`` is the detection product: ``"power"`` (``[F', T', B]``
    blocks) or ``"stokes"`` (full Stokes, ``[F', T', 4, B]`` blocks, I, Q,
    U, V).  ``depth`` is the number of blocks allowed in flight; the device
    follows the weights (``qw.scales.device``).  ``update_weights`` swaps
    in new weights for subsequent blocks without draining the stream.

    Optional, as in the JAX package's ``StreamingBeamformer``:

    - ``incoherent_sink`` receives the incoherent sum ``[F', T']`` of every
      block (without the antennas in ``flag_ants``);
    - ``rfi_monitor`` (``ops.rfi.RFIMonitor``, attached after construction)
      gets the kernel's SK accumulators on its sampling grid;
    - a sink with ``nbits == 8`` and ``fused_quant8_scales``
      (``FilterbankSink``) gets uint8 blocks from the kernel's epilogue once
      its scales exist (Stokes Q/U/V at their midpoint offset); its
      ``device_post`` runs on the device when that does not apply;
    - a sink's ``device_layout`` (the .fil file layout) runs on the device
      before the D2H copy;
    - ``tracker`` (``models.tracking.FringeTracker``) is polled once per
      block with the stream time; fresh weights swap in for that block;
    - ``search_monitor`` (``ops.dedisperse.SearchMonitor``, attached after
      construction) receives each drained block: its beams are selected
      from the product on the device (``select_beams``, before the sink's
      layout, so it sees the product whatever sink is attached) and only
      they come back; it is flushed at the end of the run.
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
        products: str = "power",
        incoherent_sink=None,
        flag_ants: tuple = (),
        tracker=None,
    ):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        if products not in ("power", "stokes"):
            raise ValueError(f"products must be power|stokes, got {products!r}")
        self.cfg = cfg
        self.products = products
        self._detect = beamform_stokes if products == "stokes" \
            else beamform_power
        self.source = source
        self.sink = sink
        self.depth = depth
        self.on_block = on_block
        self.incoherent_sink = incoherent_sink
        # A sink that lays its blocks out on the device (FilterbankSink:
        # beam-major, channels descending) gets them that way.
        self._layout = getattr(sink, "device_layout", None)
        # Bad antennas left out of the incoherent sum (the coherent product
        # flags them on the weight side, models.weights.flag_antennas).
        self.flag_ants = tuple(sorted(flag_ants))
        # Optional streaming RFI monitor (ops/rfi.py): observed at dispatch,
        # polled at drain; its on_event callback typically regenerates the
        # weights and calls update_weights.
        self.rfi_monitor = None
        # Optional fringe tracker: polled once per block with the stream
        # time; a non-None return swaps in new weights for that block.
        self.tracker = tracker
        # Optional live single-pulse search: fed each drained block, flushed
        # at the end of the stream.
        self.search_monitor = None
        self.device = weights.device
        self._cuda = self.device.type == "cuda"
        self._slots: list = []
        self._n_enq = 0
        self._held = None  # h2d_done of the ring slot the loop holds open
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
    def out_block_shape(self) -> tuple:
        """Shape of one product block: ``[F', T', B]``, or ``[F', T', 4, B]``
        for Stokes."""
        f_out, t_out, b = self.cfg.out_block_shape
        return (f_out, t_out, 4, b) if self.products == "stokes" \
            else (f_out, t_out, b)

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

    def _step(self, wire, quant8_scales=None, sk_stats=None):
        """One block's kernel call -> ``(out, inco_or_None, sk_or_None)``.

        ``sk_stats`` None means "whenever a monitor is attached"; the run
        loop passes the monitor's sampling-grid answer instead."""
        sk_on = (self.rfi_monitor is not None) if sk_stats is None \
            else sk_stats
        inco_on = self.incoherent_sink is not None
        res = self._detect(wire, self.weights, self.cfg, incoherent=inco_on,
                           flag_ants=self.flag_ants if inco_on else (),
                           quant8_scales=quant8_scales, sk_stats=sk_on)
        res = list(res) if isinstance(res, tuple) else [res]
        out = res.pop(0)
        inco = res.pop(0) if inco_on else None
        sk = res.pop(0) if sk_on else None
        return out, inco, sk

    def _fused_quant8(self):
        """The sink's in-kernel quantization hook, when usable: navg_freq=1
        (quantization must follow every average) and a sink with
        ``nbits == 8`` that offers per-beam scales.  Returns a callable
        giving the current scale vector on this device (None until the
        sink's auto-calibration has seen a float32 block), or None when the
        fused path does not apply (``device_post`` then covers it).  The
        vector is made on the compute stream, ahead of the kernels that
        read it."""
        if self.cfg.navg_freq != 1:
            return None
        if getattr(self.sink, "nbits", None) != 8:
            return None
        hook = getattr(self.sink, "fused_quant8_scales", None)
        if hook is None:
            return None
        return lambda: self._on_compute(hook, self.device)

    def _on_compute(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` with the compute stream current (so what
        it makes on the device is ordered before the kernels that read
        it)."""
        if not self._cuda:
            return fn(*args, **kwargs)
        with torch.cuda.stream(self._compute):
            return fn(*args, **kwargs)

    @property
    def _wants_product(self) -> bool:
        """Whether anything on the host reads the detection product: the
        sink (the whole block, laid out as it asks) or the search monitor
        (its beams, selected on the device).  Without either the product
        stays on the device (no pinned buffer, no D2H copy; the drain waits
        for the kernel alone)."""
        sm = self.search_monitor
        return self.sink is not None or (sm is not None and sm.wants_beams)

    def _products(self, wire, q8, sk_want, post) -> list:
        """One block's ``[out, inco, sk, mon]`` on the device: the kernel's
        outputs, the sink's ``device_post`` and ``device_layout`` applied to
        ``out`` and the search monitor's beams selected before the layout.
        ``out`` is None when no sink reads it; a product never made is None.
        """
        out, inco, sk = self._step(wire, q8, sk_stats=sk_want)
        mon = None
        if self._wants_product:
            if q8 is None and post is not None:
                out = post(out)
            sm = self.search_monitor
            if sm is not None and sm.wants_beams:
                mon = sm.select_beams(out)
            if self._layout is not None:
                out = self._layout(out)
        if self.sink is None:
            out = None
        return [out, inco, sk, mon]

    def _enqueue(self, wire, q8=None, sk_want=None, post=None,
                 pinned: bool = False):
        """Start one block; returns what ``_fetch`` needs to finish it.

        ``wire`` is a host array (staged through the slot's pinned buffer),
        a tensor view of a registered ring slot (``pinned``: copied to the
        card from there) or a tensor already on the device."""
        cfg = self.cfg
        if tuple(wire.shape) not in (cfg.wire_block_shape,
                                     cfg.device_wire_shape):
            raise ValueError(
                f"source block shaped {tuple(wire.shape)} is neither "
                f"{cfg.wire_block_shape} nor {cfg.device_wire_shape}")
        wire = torch.as_tensor(wire).reshape(cfg.device_wire_shape)
        if not self._cuda:
            return tuple(None if t is None else t.numpy()
                         for t in self._products(wire, q8, sk_want, post))
        self._make_slots()
        slot = self._slots[self._n_enq % len(self._slots)]
        self._n_enq += 1
        if pinned:
            if not wire.is_pinned():
                raise RuntimeError("the pinned-ring route got a block that "
                                   "is not in registered host memory")
            src = wire
        elif wire.is_cuda:
            src = wire
            self._copy.wait_stream(torch.cuda.current_stream(self.device))
        else:
            slot.h2d_done.synchronize()  # the staging buffer's last H2D is done
            slot.host_wire.copy_(wire)                # host -> pinned staging
            src = slot.host_wire
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(slot.kernel_done)  # device buffer is free
            slot.dev_wire.copy_(src, non_blocking=True)
            slot.h2d_done.record(self._copy)
        with torch.cuda.stream(self._compute):
            self._compute.wait_event(slot.h2d_done)
            dev = self._products(slot.dev_wire, q8, sk_want, post)
            slot.kernel_done.record(self._compute)
        host = [None] * len(dev)
        with torch.cuda.stream(self._d2h):
            # With nothing to copy, d2h_done is the kernel's completion.
            self._d2h.wait_event(slot.kernel_done)
            for i, (name, t) in enumerate(zip(("out", "inco", "sk", "mon"),
                                              dev)):
                if t is not None:
                    host[i] = slot.host_buffer(name, t.shape, t.dtype)
                    host[i].copy_(t, non_blocking=True)
            slot.d2h_done.record(self._d2h)
        # The device products stay referenced until the drain has
        # synchronized d2h_done, so their memory is not reused while the
        # D2H copies may still read them.
        return slot, dev, host

    def _fetch(self, pending) -> tuple:
        """``(out, inco, sk, mon)`` NumPy arrays of a started block, None
        where the block has no such product."""
        if not self._cuda:
            return pending
        slot, _dev, host = pending
        slot.d2h_done.synchronize()
        return tuple(None if h is None else h.numpy() for h in host)

    def _release_source(self) -> None:
        """Hand the ring slot of the last enqueued block back to the
        producer once its H2D copy has completed (pinned-ring route)."""
        if self._held is not None:
            self._held.synchronize()
            self._held = None
            self.source.release()

    def _make_slots(self) -> None:
        """The slots, each with the pinned buffers of every product this
        stream's sinks and monitor will bring back."""
        cfg = self.cfg
        if not self._slots:
            self._slots = [_Slot(cfg, self.device)
                           for _ in range(self.n_slots)]
            if not getattr(self.source, "pinned", False):
                for slot in self._slots:
                    slot.host_wire  # the staging buffers, made before a run
        shape = self.sink.layout_shape if self._layout is not None \
            else self.out_block_shape
        need = []
        if self.sink is not None:
            need.append(("out", shape, torch.float32))
        if getattr(self.sink, "nbits", None) == 8:
            need.append(("out", shape, torch.uint8))
        if self.incoherent_sink is not None:
            need.append(("inco", cfg.out_block_shape[:2], torch.float32))
        if self.rfi_monitor is not None:
            need.append(("sk", (cfg.n_chan, 2), torch.float32))
        for slot in self._slots:
            for name, shape, dtype in need:
                slot.host_buffer(name, shape, dtype)

    def warmup(self) -> None:
        """Run a zero block once through every kernel variant the steady
        state will launch (builds the kernel, allocates the slots and their
        pinned buffers before a live stream attaches)."""
        if self._cuda:
            self._make_slots()
            zero = torch.zeros(self.cfg.device_wire_shape, dtype=torch.uint8,
                               device=self.device)
        else:
            zero = np.zeros(self.cfg.device_wire_shape, dtype=np.uint8)
        mon = self.rfi_monitor
        sk_variants = [mon is not None]
        if mon is not None and mon.sample > 1:
            sk_variants.append(False)  # unsampled blocks skip the SK output
        for sk in sk_variants:
            self._fetch(self._enqueue(zero, sk_want=sk))
        if self._fused_quant8() is not None:
            # The steady state's uint8 variants, with unit scales (the
            # sink's own exist only after the first live block).
            ones = self._on_compute(torch.ones, self.cfg.n_beams,
                                    dtype=torch.float32, device=self.device)
            for sk in sk_variants:
                self._fetch(self._enqueue(zero, ones, sk_want=sk))
        elif getattr(self.sink, "device_post", None) is not None:
            warm = self.sink.device_post
            self._fetch(self._enqueue(zero, sk_want=sk_variants[0],
                                      post=lambda o: warm(o, warmup=True)))

    def _check_staging_pool(self) -> None:
        """A copying source's staging buffer must not be recycled while a
        block in flight may still read it: its pool has to hold every
        in-flight block (depth), the one being enqueued and one spare."""
        pool_n = getattr(self.source, "n_host_buffers", None)
        if pool_n is not None and self.depth + 2 > pool_n:
            raise ValueError(
                f"depth={self.depth} requires at least depth+2="
                f"{self.depth + 2} host staging buffers, but the source "
                f"has only {pool_n}; raise RingSource(n_host_buffers=...) "
                f"or lower the depth")

    def _drain_one(self) -> None:
        seq, pending, sk_host, t_enq = self._inflight.popleft()
        out, inco, sk, mon = self._fetch(pending)  # D2H complete
        if inco is not None:
            self.incoherent_sink.write(seq, inco)
        if self._layout is not None:
            self.sink.write_beams(seq, out)
        elif self.sink is not None:
            self.sink.write(seq, out)
        if self.search_monitor is not None:
            self.search_monitor.observe_selected(seq, mon, inco)
        if sk_host is not None:
            # The monitor holds this array since dispatch; it reads it only
            # after this block has drained (poll below).
            sk_host[...] = sk
        bs = BlockStats(
            block_idx=self._block_idx,
            seq=seq,
            wall_s=time.perf_counter() - t_enq,
            bytes_in=self.cfg.wire_block_bytes,
            dropped=getattr(self.source, "dropped", 0),
            skipped=getattr(self.source, "skipped", 0),
        )
        self._block_idx += 1
        if self.rfi_monitor is not None:
            # Only stats of drained blocks: touching a block still in
            # flight would serialize the stream.
            self.rfi_monitor.poll(self._block_idx)
        if self.on_block is not None:
            self.on_block(bs)

    def run(self, max_blocks: Optional[int] = None) -> StreamStats:
        cfg = self.cfg
        self._check_staging_pool()
        pinned = getattr(self.source, "pinned", False)
        if pinned and not self._cuda:
            raise ValueError(f"the source hands over registered ring slots "
                             f"for a CUDA stream; this stream runs on "
                             f"{self.device}")
        self._stats = stats = StreamStats(cfg_name=cfg.name,
                                          device_kind=self.device_kind)
        # Device-side product transform offered by the sink (8-bit
        # quantization, so the D2H copy moves 1 byte per sample).
        post = getattr(self.sink, "device_post", None)
        # In-kernel variant of the same: once the sink's per-beam scales
        # exist, the kernel quantizes and device_post is bypassed.
        fused_q8 = self._fused_quant8()
        try:
            self._loop(stats, max_blocks, post, fused_q8, pinned)
        finally:
            self._release_source()
            if pinned:  # a slot opened by a block that failed to enqueue
                self.source.release()
        while self._inflight:
            self._drain_one()
        if self.rfi_monitor is not None:
            self.rfi_monitor.flush()
        if self.search_monitor is not None:
            self.search_monitor.flush()
        stats.dropped = getattr(self.source, "dropped", 0)
        stats.skipped = getattr(self.source, "skipped", 0)
        return stats.finish()

    def _loop(self, stats, max_blocks, post, fused_q8, pinned) -> None:
        cfg = self.cfg
        n = 0
        while max_blocks is None or n < max_blocks:
            self._release_source()  # one open ring slot at a time
            item = self.source.read_block()
            if item is None:
                break
            seq, wire = item
            t_enq = time.perf_counter()
            if self.tracker is not None:
                new_qw = self.tracker.maybe_update(seq * cfg.block_duration_s)
                if new_qw is not None:
                    self.update_weights(new_qw)
            q8 = None if fused_q8 is None else fused_q8()
            mon = self.rfi_monitor
            # The SK output only on the monitor's sampling grid.
            sk_want = mon is not None and mon.wants_stats()
            pending = self._enqueue(wire, q8, sk_want, post, pinned=pinned)
            if pinned:
                self._held = pending[0].h2d_done
            sk_host = None
            if mon is not None:
                if sk_want:
                    sk_host = np.empty((cfg.n_chan, 2), np.float32)
                mon.observe_stats(sk_host)
            self._inflight.append((seq, pending, sk_host, t_enq))
            stats.n_blocks += 1
            stats.bytes_in += cfg.wire_block_bytes
            stats.macs += cfg.macs_per_block * cfg.n_weight_terms
            n += 1
            while len(self._inflight) > self.depth:
                self._drain_one()
            if fused_q8 is not None and q8 is None:
                # Auto-cal scales are learned when the sink sees the float32
                # block.  Drain until they exist, so the uint8 kernel engages
                # at block 1: a one-time startup stall.
                while self._inflight and fused_q8() is None:
                    self._drain_one()


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
