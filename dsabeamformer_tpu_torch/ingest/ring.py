"""Python binding for the dsaring shared-memory ring buffer.

The same ring as ``dsabeamformer_tpu/ingest/ring.py``: a capture process
writes fixed-size 4R4I voltage blocks into POSIX shared memory; the
beamformer connects, reads the text header once (the DADA-header analog),
then streams blocks in order or skipping to the newest, with the dropped and
skipped counters the streaming loop reports.  ``native/ring_buffer.cpp`` is a
byte-for-byte copy of the JAX package's source, so the segment layout (the
control page, ``kMagic``) is the same and a ring written by either package
reads in the other.

The library is compiled with ``g++`` at first use into the port's
git-ignored ``build/`` directory, under a name that carries a hash of the
source, behind an ``fcntl`` lock (a producer and a consumer often start
together in two processes).

Besides the copying ``read_block`` and ``write_block``, either side can
work on a slot in place: a consumer opens the next block (``open_read``: its
address, no copy) and hands it back later (``release_read``), as the
streaming loop's pinned-ring route does to copy a block to the card straight
from the slot; a producer fills the next free slot (``open_write``) and
publishes it (``commit_write``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "ring_buffer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
_CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_BUILD_LOCK = threading.Lock()

_lib = None


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libdsaring-{h.hexdigest()[:16]}.so"


def _build_library() -> Path:
    """Compile the ring on first use.  An ``fcntl`` lock file serializes
    builds between processes (the threading lock covers threads of one
    process); the compiler writes a per-pid temporary that is published with
    an atomic ``os.replace``."""
    so = _so_path()
    with _BUILD_LOCK:
        if so.exists():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(so.with_suffix(".lock"), "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            try:
                if so.exists():  # built by another process while we waited
                    return so
                tmp = so.with_suffix(f".so.tmp.{os.getpid()}")
                cmd = [os.environ.get("CXX", "g++"), *_CXX_FLAGS, str(_SRC),
                       "-o", str(tmp), "-lrt", "-pthread"]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"building {so.name} failed ({proc.returncode}):\n"
                        f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)
            finally:
                fcntl.flock(lock_f, fcntl.LOCK_UN)
        return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build_library()))
    u64, i64, vp, cp = (ctypes.c_uint64, ctypes.c_int64, ctypes.c_void_p,
                        ctypes.c_char_p)
    lib.dsaring_create.restype = vp
    lib.dsaring_create.argtypes = [cp, u64, u64, u64]
    lib.dsaring_connect.restype = vp
    lib.dsaring_connect.argtypes = [cp]
    lib.dsaring_close.argtypes = [vp]
    lib.dsaring_destroy.argtypes = [cp]
    lib.dsaring_destroy.restype = ctypes.c_int
    for fn in ("nbufs", "bufsz", "hdrsz", "dropped", "skipped", "w_head",
               "r_tail", "readers"):
        f = getattr(lib, f"dsaring_{fn}")
        f.restype = u64
        f.argtypes = [vp]
    lib.dsaring_write_header.restype = ctypes.c_int
    lib.dsaring_write_header.argtypes = [vp, cp, u64]
    lib.dsaring_read_header.restype = cp
    lib.dsaring_read_header.argtypes = [vp]
    lib.dsaring_open_write.restype = vp
    lib.dsaring_open_write.argtypes = [vp]
    lib.dsaring_commit_write.restype = ctypes.c_int
    lib.dsaring_commit_write.argtypes = [vp]
    lib.dsaring_drop_write.argtypes = [vp]
    lib.dsaring_set_eod.argtypes = [vp]
    lib.dsaring_eod.restype = ctypes.c_int
    lib.dsaring_eod.argtypes = [vp]
    lib.dsaring_open_read.restype = vp
    lib.dsaring_open_read.argtypes = [vp, i64, ctypes.c_int,
                                      ctypes.POINTER(u64)]
    lib.dsaring_release_read.restype = ctypes.c_int
    lib.dsaring_release_read.argtypes = [vp]
    _lib = lib
    return lib


class RingBuffer:
    """Handle on a dsaring shared-memory segment.

    One process creates it (the producer), others connect.  Single producer,
    single consumer.
    """

    def __init__(self, name: str, *, create: bool = False, nbufs: int = 8,
                 bufsz: int = 0, hdrsz: int = 4096,
                 connect_timeout_s: float = 0.0):
        self._lib = _load()
        self.name = name
        self._owner = create
        if create:
            if bufsz <= 0:
                raise ValueError("bufsz required when creating a ring")
            self._h = self._lib.dsaring_create(name.encode(), nbufs, bufsz,
                                               hdrsz)
        else:
            # The producer may not have created the segment yet: poll up to
            # the timeout.
            deadline = time.monotonic() + connect_timeout_s
            while True:
                self._h = self._lib.dsaring_connect(name.encode())
                if self._h or time.monotonic() >= deadline:
                    break
                time.sleep(0.05)
        if not self._h:
            raise OSError(
                f"dsaring: could not {'create' if create else 'connect to'} "
                f"ring {name!r}")

    # -- properties ---------------------------------------------------
    @property
    def nbufs(self) -> int:
        return self._lib.dsaring_nbufs(self._h)

    @property
    def bufsz(self) -> int:
        return self._lib.dsaring_bufsz(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.dsaring_dropped(self._h)

    @property
    def skipped(self) -> int:
        return self._lib.dsaring_skipped(self._h)

    @property
    def n_written(self) -> int:
        return self._lib.dsaring_w_head(self._h)

    @property
    def n_read(self) -> int:
        return self._lib.dsaring_r_tail(self._h)

    @property
    def readers(self) -> int:
        """Best-effort count of open handles that have read from this ring
        (advisory: a crashed reader leaks it)."""
        return self._lib.dsaring_readers(self._h)

    # -- header -------------------------------------------------------
    def write_header(self, text: str) -> None:
        data = text.encode()
        if self._lib.dsaring_write_header(self._h, data, len(data)) != 0:
            raise ValueError("header larger than ring header area")

    def read_header(self, timeout_s: float = 5.0) -> str:
        deadline = time.monotonic() + timeout_s
        while True:
            p = self._lib.dsaring_read_header(self._h)
            if p is not None:
                return p.decode()
            if time.monotonic() >= deadline:
                raise TimeoutError("no header committed on ring")
            time.sleep(0.01)

    # -- producer -----------------------------------------------------
    def write_block(self, block: np.ndarray) -> bool:
        """Copy one block into the ring.  Returns False (and counts a drop)
        if the consumer has fallen nbufs behind."""
        flat = np.ascontiguousarray(block).reshape(-1).view(np.uint8)
        if flat.nbytes != self.bufsz:
            raise ValueError(f"block is {flat.nbytes} B, ring bufsz {self.bufsz}")
        slot = self._lib.dsaring_open_write(self._h)
        if not slot:
            self._lib.dsaring_drop_write(self._h)
            return False
        ctypes.memmove(slot, flat.ctypes.data, flat.nbytes)
        self._lib.dsaring_commit_write(self._h)
        return True

    def open_write(self) -> Optional[int]:
        """The address of the next free slot to fill in place, or None
        while the ring is full (nothing is counted dropped: a producer that
        can wait polls again).  ``commit_write`` publishes it."""
        slot = self._lib.dsaring_open_write(self._h)
        return int(slot) if slot else None

    def commit_write(self) -> None:
        """Publish the slot ``open_write`` returned to the consumer."""
        if self._lib.dsaring_commit_write(self._h) != 0:
            raise RuntimeError(f"ring {self.name!r}: no slot open to commit")

    def set_eod(self) -> None:
        self._lib.dsaring_set_eod(self._h)

    # -- consumer -----------------------------------------------------
    def open_read(self, timeout_s: Optional[float] = 1.0,
                  latest: bool = False) -> Optional[Tuple[int, int]]:
        """Open the next block in place: ``(seq, address)`` of its slot, or
        None on timeout or end of data.  The slot stays the consumer's (the
        producer cannot overwrite it) until ``release_read``; one slot is
        open per handle at a time.  ``latest=True`` applies the skip-ahead
        overrun policy."""
        seq = ctypes.c_uint64()
        timeout_us = -1 if timeout_s is None else int(timeout_s * 1e6)
        p = self._lib.dsaring_open_read(self._h, timeout_us,
                                        1 if latest else 0,
                                        ctypes.byref(seq))
        if not p:
            return None
        return int(seq.value), int(p)

    def release_read(self) -> None:
        """Hand the slot ``open_read`` opened back to the producer."""
        if self._lib.dsaring_release_read(self._h) != 0:
            raise RuntimeError(f"ring {self.name!r}: no slot open to release")

    def read_block(
        self,
        out: Optional[np.ndarray] = None,
        *,
        timeout_s: Optional[float] = 1.0,
        latest: bool = False,
    ) -> Optional[Tuple[int, np.ndarray]]:
        """Read one block, copied into ``out`` or a fresh array.

        Returns (seq, array) or None on timeout or end of data.
        """
        if out is not None and out.nbytes != self.bufsz:
            raise ValueError(f"out is {out.nbytes} B, ring bufsz {self.bufsz}")
        got = self.open_read(timeout_s, latest)
        if got is None:
            return None
        seq, p = got
        if out is None:
            out = np.empty(self.bufsz, dtype=np.uint8)
        ctypes.memmove(out.reshape(-1).view(np.uint8).ctypes.data, p,
                       self.bufsz)
        self.release_read()
        return seq, out

    def eod(self) -> bool:
        return bool(self._lib.dsaring_eod(self._h))

    # -- lifecycle ----------------------------------------------------
    def close(self) -> None:
        if self._h:
            self._lib.dsaring_close(self._h)
            self._h = None

    def destroy(self) -> None:
        self.close()
        self._lib.dsaring_destroy(self.name.encode())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._owner:
            self.destroy()
        else:
            self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
