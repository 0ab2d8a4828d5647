"""Streaming RFI monitor: in-band spectral kurtosis with automatic channel
excision.

The same monitor as ``dsabeamformer_tpu/ops/rfi.py``.  It folds each sampled
block's per-channel SK accumulators into a rolling window and, when a
channel's SK walks out of the robust cross-channel null, reports it for
excision; the caller regenerates the weights with the grown zap set and
swaps them in through the stream's ``update_weights``.

The streaming path takes the accumulators from the detection kernel
(``beamform_power(sk_stats=True)``): the pipeline hands :meth:`observe_stats`
a host array that it fills when the block drains, so :meth:`poll` never
touches a block still in flight.  :meth:`observe` is the standalone path, a
second pass over the wire (``ops.incoherent.sk_block_stats``).  Decisions
are made every ``interval`` observed blocks on pooled accumulators, so a
sparser ``sample`` widens the cadence rather than weakening the statistic.

Excision is sticky (a zapped channel stays zapped for the run) and capped:
if the flagged set would exceed ``max_fraction`` of the band the monitor
reports a ``cap`` event instead, because most of the band looking like RFI
means the null is broken (wrong levels, dead feed), not that the band
should be deleted.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.ops.incoherent import (
    sk_block_stats,
    sk_estimate,
    sk_flags,
    sk_samples_per_block,
)

__all__ = ["RFIMonitor"]


def _host(x) -> np.ndarray:
    """float64 NumPy copy of a tensor (any device) or an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


class RFIMonitor:
    """Rolling spectral-kurtosis monitor over the streaming wire blocks.

    ``on_event`` receives dicts::

        {"type": "excise", "new": [...], "zapped": [...],
         "sk_median": ..., "sk_sigma": ..., "blocks": N}
        {"type": "cap",    "flagged": [...], "zapped": [...],
         "max_channels": ...}

    with channel indices in the config's local frame.  ``seed_zapped``
    pre-loads channels already excised at startup so they are not
    re-reported.
    """

    def __init__(
        self,
        cfg: ObsConfig,
        *,
        interval: int = 8,
        sample: int = 1,
        threshold: float = 5.0,
        max_fraction: float = 0.25,
        on_event: Optional[Callable[[dict], None]] = None,
        seed_zapped: Iterable[int] = (),
    ):
        if interval < 1 or sample < 1:
            raise ValueError(
                f"interval/sample must be >= 1, got {interval}/{sample}")
        if not 0.0 < max_fraction <= 1.0:
            raise ValueError(f"max_fraction must be in (0, 1], "
                             f"got {max_fraction}")
        self.cfg = cfg
        self.interval = interval
        self.sample = sample
        self.threshold = threshold
        self.max_channels = max(1, int(max_fraction * cfg.n_chan))
        self.on_event = on_event
        self.zapped: set = set(int(c) for c in seed_zapped)
        # Emitted events for post-run stats, bounded (a broken null could
        # otherwise emit one event per window for hours).
        self.events: list = []
        self.events_dropped = 0
        self._max_events = 256
        self._seen = 0
        self._pending: deque = deque()  # (dispatch_index, stats)
        self._s1 = np.zeros(cfg.n_chan, np.float64)
        self._s2 = np.zeros(cfg.n_chan, np.float64)
        self._n = 0
        self._final = False
        self._last_cap: Optional[frozenset] = None

    def warmup(self, wire_dev) -> None:
        """Run the standalone SK reduction once on ``wire_dev`` and discard
        it (first-use costs before a live stream attaches); no state
        changes."""
        st = sk_block_stats(wire_dev, self.cfg)
        _host(st["s1"])
        _host(st["s2"])

    def _take_next(self):
        """One sampling-grid step shared by both observe paths: the
        dispatch index if this block is sampled, else None."""
        take = self._seen % self.sample == 0
        idx = self._seen
        self._seen += 1
        return idx if take else None

    def wants_stats(self) -> bool:
        """True iff the NEXT observe call falls on the sampling grid (a
        peek, no grid advance).  The pipeline asks this before each block's
        dispatch and launches the SK variant of the kernel only then."""
        return self._seen % self.sample == 0

    def observe(self, wire_dev) -> None:
        """Run the standalone SK reduction for this block if it falls on
        the sampling grid (a second pass over the wire; the pipeline uses
        :meth:`observe_stats` with the kernel's accumulators)."""
        idx = self._take_next()
        if idx is not None:
            self._pending.append((idx, sk_block_stats(wire_dev, self.cfg)))

    def observe_stats(self, sk) -> None:
        """Record this block's fused SK accumulators (``[n_chan, 2]``: the
        kernel's S1, S2), or None on a block off the sampling grid.  The
        array is read only by :meth:`poll`, once its block has drained."""
        idx = self._take_next()
        if idx is not None:
            if sk is None:
                raise ValueError(
                    "observe_stats(None) on a sampled block: the caller "
                    "must dispatch with sk_stats=True whenever "
                    "wants_stats() is True (pipeline/monitor grid skew)")
            self._pending.append((idx, sk))

    def poll(self, n_drained: Optional[int] = None) -> None:
        """Take the stats of blocks the pipeline has already drained (dispatch
        index below ``n_drained``; None takes everything, at end of stream)
        and decide when a window is full."""
        while self._pending and (
            n_drained is None or self._pending[0][0] < n_drained
        ):
            _, st = self._pending.popleft()
            if isinstance(st, dict):  # standalone sk_block_stats
                s1, s2 = _host(st["s1"]), _host(st["s2"])
            else:  # fused [n_chan, 2] kernel output
                arr = _host(st)
                s1, s2 = arr[:, 0], arr[:, 1]
            self._s1 += s1
            self._s2 += s2
            self._n += 1
            if self._n >= self.interval:
                self._decide()

    def flush(self) -> None:
        """End of stream: decide on any partial window (>= 2 blocks, else
        the estimator is too noisy to act on).  Events emitted here carry
        ``"final": True``: no blocks are left to apply an excision to."""
        self._final = True
        self.poll()
        if self._n >= 2:
            self._decide()

    def _decide(self) -> None:
        m = self._n * sk_samples_per_block(self.cfg)
        sk = sk_estimate(self._s1, self._s2, m)
        flagged, med, sigma = sk_flags(sk, m, threshold=self.threshold)
        self._s1[:] = 0.0
        self._s2[:] = 0.0
        blocks, self._n = self._n, 0
        new = sorted(set(flagged) - self.zapped)
        if not new:
            return
        total = self.zapped | set(new)
        if len(total) > self.max_channels:
            # Refuse, but do not re-report an unchanged refusal every window.
            if self._last_cap != frozenset(new):
                self._last_cap = frozenset(new)
                self._emit({"type": "cap", "flagged": new,
                            "zapped": sorted(self.zapped),
                            "max_channels": self.max_channels})
            return
        self._last_cap = None
        self.zapped = total

        def _fin(v, nd):
            return round(float(v), nd) if np.isfinite(v) else None

        ev = {
            "type": "excise",
            "new": new,
            "zapped": sorted(self.zapped),
            "sk_median": _fin(med, 5),
            "sk_sigma": _fin(sigma, 6),
            "blocks": blocks,
        }
        if self._final:
            ev["final"] = True
        self._emit(ev)

    def _emit(self, event: dict) -> None:
        if len(self.events) < self._max_events:
            self.events.append(event)
        else:
            self.events_dropped += 1
        if self.on_event is not None:
            self.on_event(event)
