"""The in-process capture ring, and the producer's drops under a consumer
slower than its clock."""

import time

import pytest

from beambench.capture_ring import CaptureRing
from beambench.kinds.ring import _Paced, _Refill


def test_publish_open_release_in_order():
    ring = CaptureRing("t", 3, 16)
    for k in range(3):
        ring.slot(k)[:] = k
    assert [ring.publish(s) for s in range(4)] == [True, True, True, False]
    assert ring.dropped == 1
    seq, addr = ring.open_read(0.1)
    assert seq == 0 and addr == ring.address(0)
    with pytest.raises(RuntimeError):
        ring.open_read(0.1)
    ring.release_read()
    seq, addr = ring.open_read(0.1)
    assert seq == 1 and addr == ring.address(1) and (ring.slot(1) == 1).all()
    ring.release_read()
    assert ring.publish(4)  # into the slot freed first
    ring.set_eod()
    got = []
    while (item := ring.open_read(0.1)) is not None:
        got.append((item[0], item[1]))
        ring.release_read()
    assert got == [(2, ring.address(2)), (4, ring.address(0))]
    assert [(s, k) for s, k, _t in ring.log] == [(0, 0), (1, 1), (2, 2),
                                                (4, 0)]
    assert sorted(ring.opened) == [0, 1, 2, 4]
    ring.close()


class _StubClock:
    n_pre = 0
    t0 = None
    t_end = float("inf")


def _paced(slots: int, period: float, n_due: int) -> tuple:
    ring = CaptureRing("t", slots, 8)
    clock = _StubClock()
    producer = _Paced(ring, clock, period, n_due)
    producer.start()
    clock.t0 = time.perf_counter()
    return ring, producer


def test_realtime_producer_drops_what_a_slow_consumer_leaves():
    period, n_due, slots, read_s = 0.01, 40, 2, 0.025
    ring, producer = _paced(slots, period, n_due)
    seen = []
    while (got := ring.open_read(1.0)) is not None:
        seen.append(got[0])
        time.sleep(read_s)
        ring.release_read()
    assert len(producer.due) == n_due
    assert ring.dropped == n_due - len(seen) > n_due // 3
    assert seen == sorted(seen)
    # Each block counts as published at its due time, not when read.
    assert all(t == producer.due[s] for s, _k, t in ring.log)
    # A consumer that keeps up loses nothing, and takes each block when due.
    ring, producer = _paced(slots, period, n_due)
    n = 0
    while (got := ring.open_read(1.0)) is not None:
        assert ring.opened[got[0]] >= producer.due[got[0]]
        n += 1
        ring.release_read()
    assert (n, ring.dropped) == (n_due, 0)
    pickup = sorted(ring.opened[s] - t for s, t in producer.due.items())
    assert pickup[len(pickup) // 2] < 0.1 * period  # the median


def test_realtime_producer_waits_for_the_window():
    ring = CaptureRing("t", 2, 8)
    clock = _StubClock()
    clock.n_pre = 1
    producer = _Paced(ring, clock, 0.01, 3)
    producer.start()
    assert ring.open_read(0.1)[0] == 0  # the pre-roll, published at once
    ring.release_read()
    assert ring.open_read(0.05) is None  # the clock has not started
    clock.t0 = time.perf_counter()
    seqs = []
    while (got := ring.open_read(1.0)) is not None:
        seqs.append(got[0])
        ring.release_read()
    assert seqs == [1, 2, 3] and sorted(producer.due) == [1, 2, 3]


def test_saturated_refill_keeps_every_slot_published_until_the_end():
    clock = _StubClock()
    ring = CaptureRing("t", 3, 8)
    refill = _Refill(ring, clock)
    refill.start()
    seen = []
    for _ in range(7):
        seq, _addr = ring.open_read(0.1)
        seen.append(seq)
        assert len(ring._ready) == 2  # the other slots stay published
        ring.release_read()
    clock.t_end = 0.0  # the window is over: the next release ends the data
    while (got := ring.open_read(0.1)) is not None:
        seen.append(got[0])
        ring.release_read()
    assert seen == list(range(10)) and ring.dropped == 0
