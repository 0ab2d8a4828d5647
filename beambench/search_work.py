"""The work of a search window's dedispersion bank, counted from the
configuration's numbers and the ``conv`` plan (``reference/search.py``),
not from how the port's kernels go about it.

Per beam of a ``T``-sample window of ``F`` channels, the plan's ``G``
groups of ``C`` channels (``F`` padded to ``G * C``) and ``J`` coarse
trials, ``t1 = T`` plus the largest shift between groups, ``t_pad = t1``
plus the largest within a group:

- stage 1: ``G * J * C * t1`` adds (one an output sample and channel), the
  float32 padded columns ``G * C * t_pad`` read once and its planes
  ``G * J * t1`` written once;
- stage 2: ``n_dm * G * T`` adds (one an output sample and group), those
  planes read once and the bank ``n_dm * T`` written once.

A stage's least time is the larger of its adds at the card's float32 add
rate (an add runs at the FMA rate: the float32 FLOP/s over two, PERF.md's
convention: 1.43e11 adds in 4.283 ms) and its bytes at the memory
bandwidth (``peaks.py``).  The top-k (``snr_topk_kernel``) is counted by
``topk_least_s``.
"""

from __future__ import annotations

import functools
from typing import Optional

from beambench import peaks
from beambench.reference import search as ref_search

#: float32 adds a second by a substring of the card's name (NVIDIA data
#: sheets: 51.2, 60 and 67 TFLOP/s float32 outside the tensor cores).
_F32_ADDS = (("h100 pcie", 51.2e12 / 2), ("h100 nvl", 60e12 / 2),
             ("h100", 67e12 / 2))


def peak_for(device_kind: str) -> Optional[dict]:
    """``peaks.peak_for`` with ``f32_adds_per_s``; None on an unknown card."""
    peak = peaks.peak_for(device_kind)
    if peak is None:
        return None
    kind = device_kind.lower()
    for key, adds in _F32_ADDS:
        if key in kind:
            return {**peak, "f32_adds_per_s": adds}
    return None


@functools.lru_cache(maxsize=4)
def _plan(obs_items: tuple, dm_max: float, dm_tol: float,
          chunk_t: int, max_w: int) -> dict:
    obs = dict(obs_items)
    f = ref_search.freqs_mhz(obs)
    ts = ref_search.tsamp_s(obs)
    dl = ref_search.delays(f, ref_search.dm_grid(f, ts, dm_max, dm_tol), ts)
    g, j, intra, inter, _rep_of, _pad = ref_search.plan(dl)
    t = chunk_t + int(dl.max()) + max_w
    t1 = t + int(inter.max())
    return {"n_dm": len(dl), "G": g, "J": j, "C": intra.shape[2], "T": t,
            "t1": t1, "t_pad": t1 + int(intra.max())}


def plan(config: dict) -> dict:
    """The window's sizes: ``n_dm``, ``G``, ``J``, ``C``, ``T``, ``t1``,
    ``t_pad``."""
    s = config["search"]
    return _plan(tuple(sorted(config["obs"].items())), float(s["dm_max"]),
                 float(s["dm_tol"]), int(s["chunk_t"]), max(s["widths"]))


def stage_work(config: dict) -> dict:
    """``{"stage1": (adds, bytes), "stage2": (adds, bytes)}`` a beam."""
    p = plan(config)
    g, j, c, t, t1 = p["G"], p["J"], p["C"], p["T"], p["t1"]
    planes = 4 * g * j * t1
    return {"stage1": (g * j * c * t1, 4 * g * c * p["t_pad"] + planes),
            "stage2": (p["n_dm"] * g * t, planes + 4 * p["n_dm"] * t)}


def least_time_s(config: dict, peak: dict) -> dict:
    """Each stage's least time a beam, seconds."""
    return {name: max(adds / peak["f32_adds_per_s"],
                      nbytes / peak["bytes_per_s"])
            for name, (adds, nbytes) in stage_work(config).items()}


def topk_least_s(config: dict, peak: dict) -> float:
    """The top-k's least time a beam: its cumulative sum (an add a sample)
    and each width's boxcar sums (a subtraction a start) of every trial
    series at the float32 add rate, or its bytes (the normalized bank read
    once, the S/N, starts and peaks written once) at the memory bandwidth,
    whichever is larger."""
    p, s = plan(config), config["search"]
    n_dm, t, widths = p["n_dm"], p["T"], s["widths"]
    adds = n_dm * (t + sum(t - w + 1 for w in widths))
    nbytes = 4 * n_dm * t + n_dm * len(widths) * (16 * s["topk"] + 8)
    return max(adds / peak["f32_adds_per_s"], nbytes / peak["bytes_per_s"])
