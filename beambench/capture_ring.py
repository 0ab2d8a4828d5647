"""The benchmark's capture ring: slots in this process's memory.

A PSRDADA-style ring of ``nbufs`` fixed-size slots, each an anonymous
private mapping (page-aligned, no file in ``/dev/shm``, no path at all).
The benchmark fills the slots once at set-up; a producer then *publishes*
them (``publish``), as a NIC writing the ring would, and the port reads them
through ``pipeline.RingSource``, which needs only the reader's surface of
``ingest.ring.RingBuffer``: ``bufsz``, ``name``, ``open_read``,
``release_read``, ``read_block`` (the copying route ``RingSource`` takes
on a device other than a card), ``dropped`` and ``skipped``.

Block ``seq`` lands in the next free slot in ring order.  ``publish``
never waits: with no free slot the block is counted dropped, as a PSRDADA
writer drops when the reader lags.  ``log`` records every published block
as ``(seq, slot, t_published)``, ``opened`` the time the reader took each.

A producer on a clock needs no thread of its own: ``advance(now)``, when
set, is called with the lock held at the start of every reader call, and
publishes (or drops) each block due by ``now`` at its due time.  The ring
changes only in the reader's calls, so a block due between two of them
finds the ring as the first left it, and its fate is exact; no thread
competes with the reader for the interpreter, and the reader's own delays
are all that lies between a block's due time and its read.
"""

from __future__ import annotations

import collections
import contextlib
import math
import mmap
import threading
import time
from typing import Optional, Tuple

import numpy as np

#: A timed wait wakes up to milliseconds late: the reader spins through the
#: last stretch before a block falls due, so it takes the block on time.
SPIN_S = 0.002


class CaptureRing:
    def __init__(self, name: str, nbufs: int, bufsz: int, span=None):
        if nbufs < 1 or bufsz < 1:
            raise ValueError(f"nbufs and bufsz must be >= 1, got "
                             f"{nbufs}, {bufsz}")
        self.name = name
        self.nbufs = nbufs
        self.bufsz = bufsz
        # ``span(name)``: a context manager around each reader call (the
        # benchmark's trace spans); none by default.
        self._span = span or (lambda _name: contextlib.nullcontext())
        flags = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
        self._maps = [mmap.mmap(-1, bufsz, flags=flags) for _ in range(nbufs)]
        self._arrays = [np.frombuffer(m, dtype=np.uint8) for m in self._maps]
        self._cv = threading.Condition()
        self._free = collections.deque(range(nbufs))
        self._ready: collections.deque = collections.deque()  # (seq, slot)
        self._open: Optional[int] = None
        self._eod = False
        self.dropped = 0
        self.skipped = 0
        self.log: list = []
        self.opened: dict = {}  # seq -> perf_counter() of open_read
        #: Called with the lock held once the reader hands a slot back: the
        #: saturated producer, which publishes into the slot at once.
        self.on_release = None
        #: ``advance(now) -> next due time or None``, called with the lock
        #: held at the start of every reader call: a producer on a clock.
        self.advance = None

    # -- set-up -------------------------------------------------------
    def slot(self, k: int) -> np.ndarray:
        """Slot ``k``'s bytes, writable in place."""
        return self._arrays[k]

    def address(self, k: int) -> int:
        return self._arrays[k].ctypes.data

    # -- producer -----------------------------------------------------
    def wait_free(self, timeout_s: Optional[float]) -> bool:
        """Wait until a slot is free or the timeout passes."""
        with self._cv:
            return self._cv.wait_for(lambda: bool(self._free), timeout_s)

    def publish(self, seq: int) -> bool:
        """Publish block ``seq`` in the next free slot; with none free the
        block is dropped and counted."""
        with self._cv:
            return self._publish(seq)

    def _publish(self, seq: int, t: Optional[float] = None) -> bool:
        """Publish with the lock held; ``t`` is the time the block counts
        as published (now by default)."""
        if not self._free:
            self.dropped += 1
            return False
        slot = self._free.popleft()
        self._ready.append((seq, slot))
        self.log.append((seq, slot, time.perf_counter() if t is None else t))
        self._cv.notify_all()
        return True

    def set_eod(self) -> None:
        with self._cv:
            self._set_eod()

    def _set_eod(self) -> None:
        self._eod = True
        self._cv.notify_all()

    # -- consumer (RingSource's surface) -------------------------------
    def open_read(self, timeout_s: Optional[float] = 1.0,
                  latest: bool = False) -> Optional[Tuple[int, int]]:
        """``(seq, address)`` of the next published block, or None at end of
        data or on timeout."""
        if latest:
            raise ValueError("the capture ring reads in order (latest=False)")
        with self._span("ring.open_read"), self._cv:
            if self._open is not None:
                raise RuntimeError("release_read() the open slot first")
            now = time.perf_counter()
            end = math.inf if timeout_s is None else now + timeout_s
            while True:
                due = self.advance(now) if self.advance else None
                if self._ready or self._eod:
                    break
                if now >= end:
                    return None
                if due is not None and due - now <= SPIN_S:
                    while time.perf_counter() < due:
                        pass
                else:
                    until = min(end, math.inf if due is None
                                else due - SPIN_S)
                    self._cv.wait(None if until == math.inf
                                  else max(until - now, 0.0))
                now = time.perf_counter()
            if not self._ready:
                return None
            seq, slot = self._ready.popleft()
            self._open = slot
            self.opened[seq] = time.perf_counter()
            return seq, self.address(slot)

    def release_read(self) -> None:
        with self._span("ring.release_read"), self._cv:
            if self._open is None:
                raise RuntimeError(f"ring {self.name!r}: no slot open")
            if self.advance is not None:
                self.advance(time.perf_counter())
            self._free.append(self._open)
            self._open = None
            self._cv.notify_all()
            if self.on_release is not None:
                self.on_release()

    def read_block(self, out: Optional[np.ndarray] = None, *,
                   timeout_s: Optional[float] = 1.0, latest: bool = False):
        """The copying reader: ``(seq, out)`` or None."""
        got = self.open_read(timeout_s, latest)
        if got is None:
            return None
        seq, _addr = got
        if out is None:
            out = np.empty(self.bufsz, dtype=np.uint8)
        out.reshape(-1)[...] = self._arrays[self._open]
        self.release_read()
        return seq, out

    def close(self) -> None:
        """Unmap the slots (after the reader has unregistered them)."""
        self._arrays = []
        for m in self._maps:
            try:
                m.close()
            except BufferError:  # a caller still holds a slot's array
                pass
        self._maps = []
