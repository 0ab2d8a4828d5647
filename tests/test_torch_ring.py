"""The port's shared-memory ring (``ingest/ring.py``, ``ingest/native/
ring_buffer.cpp``) and its pipeline pieces (``RingSource``, ``RingSink``,
``staging_pool_size``, the staging-pool check), on the CPU: the JAX
package's ring tests and restart drills run on the port, rings written by
either package read in the other, and a stream from a ring equals the same
blocks streamed from memory.  Assertions are on counts, never on wall
time; every ring has a name of its own (the tests run in parallel)."""

import threading
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ingest.ring as jring
import dsabeamformer_tpu.pipeline as jpipe
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.pipeline as ppipe
from dsabeamformer_tpu_torch.ingest import dada
from dsabeamformer_tpu_torch.ingest.generator import make_noise_block
from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
from dsabeamformer_tpu_torch.pipeline import (
    CollectSink,
    RingSink,
    RingSource,
    StreamingBeamformer,
    SyntheticSource,
    run_stream,
    staging_pool_size,
)

REPO = Path(__file__).resolve().parent.parent
CFG = pcfg.TINY


@pytest.fixture()
def ring_name():
    return f"ptest-{uuid.uuid4().hex[:10]}"


@pytest.fixture(scope="module")
def qw():
    return prepare_weights(CFG, make_weights(CFG, device="cpu"))


def test_ring_source_is_byte_identical_to_the_jax_package():
    """Same source text, so the same segment layout and magic."""
    port = REPO / "dsabeamformer_tpu_torch/ingest/native/ring_buffer.cpp"
    ref = REPO / "dsabeamformer_tpu/ingest/native/ring_buffer.cpp"
    assert port.read_bytes() == ref.read_bytes()


def test_create_connect_roundtrip(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=4, bufsz=1024) as prod:
        cons = RingBuffer(ring_name)
        assert cons.nbufs == 4 and cons.bufsz == 1024
        blk = np.arange(1024, dtype=np.uint8)
        assert prod.write_block(blk)
        got = cons.read_block(timeout_s=1.0)
        assert got is not None
        seq, data = got
        assert seq == 0
        np.testing.assert_array_equal(data, blk)
        cons.close()


def test_header_handshake(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=64) as prod:
        prod.write_header("NCHAN 8\nNBEAM 32\n")
        cons = RingBuffer(ring_name)
        assert "NCHAN 8" in cons.read_header()
        cons.close()


def test_writer_drops_when_full(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=16) as prod:
        blk = np.zeros(16, dtype=np.uint8)
        assert prod.write_block(blk)
        assert prod.write_block(blk)
        assert not prod.write_block(blk)  # full -> dropped
        assert prod.dropped == 1


def test_reader_skip_ahead_latest(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=8, bufsz=16) as prod:
        for i in range(5):
            prod.write_block(np.full(16, i, dtype=np.uint8))
        cons = RingBuffer(ring_name)
        seq, data = cons.read_block(timeout_s=1.0, latest=True)
        assert seq == 4
        assert data[0] == 4
        assert cons.skipped == 4
        cons.close()


def test_eod_ends_stream(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=16) as prod:
        prod.write_block(np.zeros(16, dtype=np.uint8))
        prod.set_eod()
        cons = RingBuffer(ring_name)
        assert cons.read_block(timeout_s=1.0) is not None
        assert cons.read_block(timeout_s=1.0) is None  # EOD, no more data
        assert cons.eod()
        cons.close()


def test_read_timeout_returns_none(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=16):
        cons = RingBuffer(ring_name)
        assert cons.read_block(timeout_s=0.05) is None
        cons.close()


def test_wrong_block_size_rejected(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=16) as prod:
        with pytest.raises(ValueError):
            prod.write_block(np.zeros(17, dtype=np.uint8))
        cons = RingBuffer(ring_name)
        with pytest.raises(ValueError):
            cons.read_block(np.zeros(15, dtype=np.uint8), timeout_s=0.01)
        cons.close()


def test_connect_missing_ring_fails(ring_name):
    with pytest.raises(OSError):
        RingBuffer(ring_name)


def test_threaded_stress_in_order(ring_name):
    """A producer thread writes 200 sequenced blocks; the consumer reads
    them all in order with no corruption."""
    n, bufsz = 200, 4096
    received = []

    with RingBuffer(ring_name, create=True, nbufs=8, bufsz=bufsz) as prod:
        def produce():
            i = 0
            while i < n:
                blk = np.full(bufsz, i % 251, dtype=np.uint8)
                blk[:8] = np.frombuffer(np.int64(i).tobytes(), dtype=np.uint8)
                if prod.write_block(blk):
                    i += 1
            prod.set_eod()

        t = threading.Thread(target=produce)
        t.start()
        cons = RingBuffer(ring_name)
        while True:
            got = cons.read_block(timeout_s=5.0)
            if got is None:
                break
            seq, data = got
            idx = int(np.frombuffer(data[:8].tobytes(), dtype=np.int64)[0])
            assert (data[8:] == idx % 251).all()
            received.append((seq, idx))
        t.join(timeout=60)
        assert not t.is_alive()
        cons.close()

    assert [s for s, _ in received] == list(range(n))
    assert [i for _, i in received] == list(range(n))


def test_reader_counter_advisory(ring_name):
    """0 until a handle reads, +1 per reading handle, -1 on close."""
    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=64) as ring:
        assert ring.readers == 0
        ring.write_block(np.zeros(64, np.uint8))
        r1 = RingBuffer(ring_name)
        assert r1.readers == 0  # attached, not yet reading
        assert r1.read_block(timeout_s=1.0) is not None
        assert ring.readers == 1
        r2 = RingBuffer(ring_name)
        ring.write_block(np.zeros(64, np.uint8))
        assert r2.read_block(timeout_s=1.0) is not None
        assert ring.readers == 2
        r1.close()
        assert ring.readers == 1
        r2.close()
        assert ring.readers == 0


def test_open_read_holds_the_slot_until_release(ring_name):
    """The in-place read (the pinned-ring route's): the slot's bytes are
    readable at the returned address, the producer cannot reuse the slot
    while it is open, and a release with nothing open raises."""
    import ctypes

    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=32) as prod:
        for i in range(2):
            assert prod.write_block(np.full(32, 10 + i, np.uint8))
        cons = RingBuffer(ring_name)
        seq, addr = cons.open_read(timeout_s=1.0)
        assert seq == 0
        assert bytes((ctypes.c_uint8 * 32).from_address(addr)) \
            == bytes([10]) * 32
        assert not prod.write_block(np.zeros(32, np.uint8))  # still full
        cons.release_read()
        assert prod.write_block(np.full(32, 12, np.uint8))
        with pytest.raises(RuntimeError, match="no slot open"):
            cons.release_read()
        assert cons.read_block(timeout_s=1.0)[0] == 1
        cons.close()


def test_open_write_fills_a_slot_in_place(ring_name):
    """The in-place write: None while full (no drop counted), the bytes
    written at the address arrive, a commit with nothing open raises."""
    import ctypes

    with RingBuffer(ring_name, create=True, nbufs=1, bufsz=16) as prod:
        addr = prod.open_write()
        ctypes.memmove(addr, bytes(range(16)), 16)
        prod.commit_write()
        assert prod.open_write() is None and prod.dropped == 0
        with pytest.raises(RuntimeError, match="no slot open"):
            prod.commit_write()
        cons = RingBuffer(ring_name)
        seq, data = cons.read_block(timeout_s=1.0)
        assert seq == 0 and bytes(data) == bytes(range(16))
        cons.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ring_written_by_one_package_reads_in_the_other(ring_name, writer):
    """A ring created and filled by one package's RingBuffer (header from
    that package's dada.encode_header) streams through the other package's
    RingSource, header validated, blocks intact."""
    from dsabeamformer_tpu.ingest import dada as jdada

    if writer == "jax":   # JAX ring and header, the port's RingSource
        w_ring, w_hdr = jring.RingBuffer, jdada.encode_header(jcfg.TINY)
        r_ring = RingBuffer
        make_src = lambda r: ppipe.RingSource(CFG, r, timeout_s=1.0,
                                             device="cpu")
    else:                 # the port's ring and header, JAX's RingSource
        w_ring, w_hdr = RingBuffer, dada.encode_header(CFG)
        r_ring = jring.RingBuffer
        make_src = lambda r: jpipe.RingSource(jcfg.TINY, r, timeout_s=1.0)
    blocks = [make_noise_block(CFG, rms=2.0, seed=s) for s in range(3)]
    with w_ring(ring_name, create=True, nbufs=4,
                bufsz=CFG.wire_block_bytes) as prod:
        prod.write_header(w_hdr)
        for b in blocks:
            assert prod.write_block(b)
        prod.set_eod()
        cons = r_ring(ring_name)
        src = make_src(cons)
        got = []
        while (item := src.read_block()) is not None:
            got.append((item[0], np.array(item[1])))
        cons.close()
    assert [s for s, _ in got] == [0, 1, 2]
    for (_, g), b in zip(got, blocks):
        assert np.array_equal(g, b)


def test_ring_source_rejects_a_mismatched_header(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=2,
                    bufsz=CFG.wire_block_bytes) as prod:
        prod.write_header(dada.encode_header(CFG.replace(n_beams=16)))
        cons = RingBuffer(ring_name)
        with pytest.raises(ValueError):
            RingSource(CFG, cons, timeout_s=1.0, device="cpu")
        cons.close()


def test_ring_stream_equals_synthetic_stream(ring_name, qw):
    """The same blocks through a ring and from memory give byte-equal
    products, with 0 dropped and 0 skipped."""
    blocks = [make_noise_block(CFG, rms=2.0, seed=s) for s in range(2)]
    n = 6
    ref = CollectSink()
    run_stream(CFG, qw, SyntheticSource(CFG, blocks, n), ref, depth=2)
    with RingBuffer(ring_name, create=True, nbufs=n,
                    bufsz=CFG.wire_block_bytes) as prod:
        prod.write_header(dada.encode_header(CFG))
        for i in range(n):
            assert prod.write_block(blocks[i % 2])
        prod.set_eod()
        cons = RingBuffer(ring_name)
        src = RingSource(CFG, cons, timeout_s=1.0, device="cpu")
        assert not src.pinned and src.n_host_buffers == 8
        sink = CollectSink()
        stats = run_stream(CFG, qw, src, sink, depth=2)
        src.close()
        cons.close()
    assert stats.n_blocks == n and stats.dropped == 0 and stats.skipped == 0
    assert [s for s, _ in sink.outputs] == list(range(n))
    for (_, a), (_, b) in zip(sink.outputs, ref.outputs):
        assert np.array_equal(a, b)


def test_ring_source_poll_block_is_not_the_end(ring_name):
    """``poll_block`` answers None on an empty ring and at end of data
    alike, and ends nothing: a block written after an empty poll is read,
    into the next staging buffer (an empty poll takes none), and only
    ``read_block`` ends the stream."""
    blocks = [make_noise_block(CFG, rms=2.0, seed=s) for s in range(2)]
    with RingBuffer(ring_name, create=True, nbufs=2,
                    bufsz=CFG.wire_block_bytes) as prod:
        prod.write_header(dada.encode_header(CFG))
        cons = RingBuffer(ring_name)
        src = RingSource(CFG, cons, timeout_s=0.05, device="cpu")
        for seq, blk in enumerate(blocks):
            assert src.poll_block(1e-4) is None
            assert src._pool_i == seq
            assert prod.write_block(blk)
            if seq == len(blocks) - 1:
                prod.set_eod()
            got, data = src.poll_block(0.5)
            assert got == seq and np.array_equal(data, blk)
        assert src._pool_i == len(blocks)
        assert src.poll_block(1e-4) is None
        assert src.read_block() is None
        cons.close()


def test_ring_sink_writes_header_and_blocks(ring_name, qw):
    """RingSink commits the output header (PAYLOAD, OUT_*) and the float32
    blocks; close() sets end of data.  The JAX package's ring reads it."""
    blocks = [make_noise_block(CFG, rms=2.0, seed=s) for s in range(2)]
    nbytes = int(np.prod(CFG.out_block_shape)) * 4
    with RingBuffer(ring_name, create=True, nbufs=4, bufsz=nbytes) as out:
        sink = RingSink(RingBuffer(ring_name), CFG)
        ref = CollectSink()
        run_stream(CFG, qw, SyntheticSource(CFG, blocks, 3), ref)
        run_stream(CFG, qw, SyntheticSource(CFG, blocks, 3), sink)
        assert sink.dropped == 0
        sink.close()
        cons = jring.RingBuffer(ring_name)
        hdr = dada.parse_header(cons.read_header())
        assert hdr["PAYLOAD"] == "BEAM_POWERS"
        f, t, b = CFG.out_block_shape
        assert (int(hdr["OUT_NCHAN"]), int(hdr["OUT_NTIME"]),
                int(hdr["OUT_NBEAM"])) == (f, t, b)
        for k in range(3):
            seq, data = cons.read_block(timeout_s=1.0)
            assert seq == k
            assert np.array_equal(data.view(np.float32).reshape(f, t, b),
                                  ref.outputs[k][1])
        assert cons.read_block(timeout_s=0.05) is None and cons.eod()
        cons.close()
        assert out.n_written == 3
    with pytest.raises(ValueError, match="products"):
        RingSink(None, products="voltages")


def test_pinned_ring_source_needs_a_card(monkeypatch, ring_name):
    """Named no device, RingSource takes the pinned route on the card; with
    no card that raises instead of copying on the CPU; a CPU stream refuses
    a pinned source."""
    with RingBuffer(ring_name, create=True, nbufs=2,
                    bufsz=CFG.wire_block_bytes) as prod:
        prod.write_header(dada.encode_header(CFG))
        cons = RingBuffer(ring_name)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            RingSource(CFG, cons, timeout_s=1.0)
        cons.close()

    class _Pinned:
        pinned = True

    bf = StreamingBeamformer(CFG, prepare_weights(
        CFG, make_weights(CFG, device="cpu")), _Pinned())
    with pytest.raises(ValueError, match="registered ring slots"):
        bf.run()


def test_consumer_restart_reattaches(ring_name, qw):
    """Kill the consumer mid-stream, start a fresh one: it re-attaches,
    re-validates the header, skips to the newest data and continues."""
    blocks = [make_noise_block(CFG, rms=2.0, seed=s) for s in range(2)]
    n_total = 40
    stop = threading.Event()

    with RingBuffer(ring_name, create=True, nbufs=4,
                    bufsz=CFG.wire_block_bytes) as prod:
        prod.write_header(dada.encode_header(CFG))

        def produce():
            for i in range(n_total):
                while not prod.write_block(blocks[i % 2]):
                    if stop.is_set():
                        return
                    time.sleep(0.001)
            prod.set_eod()

        t = threading.Thread(target=produce)
        t.start()
        try:
            ring1 = RingBuffer(ring_name)
            src1 = RingSource(CFG, ring1, timeout_s=10.0, device="cpu")
            stats1 = run_stream(CFG, qw, src1, CollectSink(), depth=1,
                                max_blocks=3)
            assert stats1.n_blocks == 3
            ring1.close()  # abrupt exit: no handshake with the producer

            ring2 = RingBuffer(ring_name)
            src2 = RingSource(CFG, ring2, latest=True, timeout_s=10.0,
                              device="cpu")
            sink2 = CollectSink()
            stats2 = run_stream(CFG, qw, src2, sink2, depth=1)
            ring2.close()
        finally:
            stop.set()
            t.join(timeout=60)
        assert not t.is_alive()

    assert stats2.n_blocks >= 1
    seqs = [s for s, _ in sink2.outputs]
    assert seqs[-1] == n_total - 1
    assert seqs == sorted(seqs)
    processed = stats1.n_blocks + stats2.n_blocks
    assert processed + stats2.skipped + stats2.dropped >= n_total - 4


def test_producer_restart_new_ring(ring_name):
    """A producer restart makes a fresh segment; a consumer attaching
    afterwards sees only the new stream."""
    with RingBuffer(ring_name, create=True, nbufs=2,
                    bufsz=CFG.wire_block_bytes) as prod1:
        prod1.write_header(dada.encode_header(CFG))
        prod1.write_block(make_noise_block(CFG, seed=1))
    with RingBuffer(ring_name, create=True, nbufs=2,
                    bufsz=CFG.wire_block_bytes) as prod2:
        prod2.write_header(dada.encode_header(CFG))
        cons = RingBuffer(ring_name)
        assert cons.n_written == 0  # old data gone with the old segment
        cons.close()


class _PooledNullSource:
    n_host_buffers = 8
    dropped = 0
    skipped = 0

    def read_block(self):
        return None


@pytest.mark.parametrize("depth,ok", [(8, False), (6, True)])
def test_depth_against_staging_pool(qw, depth, ok):
    """depth + 2 staging buffers are required; the JAX package's rule."""
    bf = StreamingBeamformer(CFG, qw, _PooledNullSource(), depth=depth)
    jbf = jpipe.StreamingBeamformer(jcfg.TINY, None, _PooledNullSource(),
                                    depth=depth)
    if ok:
        assert bf.run(max_blocks=1).n_blocks == 0
        return
    with pytest.raises(ValueError, match="staging buffers"):
        bf.run(max_blocks=1)
    with pytest.raises(ValueError, match="staging buffers"):
        jbf.run(max_blocks=1)


@pytest.mark.parametrize("nbytes", [2**20, 512 * 2**20 - 1, 512 * 2**20,
                                    CFG.wire_block_bytes,
                                    pcfg.DSA10.wire_block_bytes])
@pytest.mark.parametrize("depth", [0, 2, 7])
def test_staging_pool_size_matches_jax(nbytes, depth):
    assert staging_pool_size(nbytes, depth) \
        == jpipe.staging_pool_size(nbytes, depth)
