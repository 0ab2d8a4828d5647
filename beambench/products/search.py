"""``search``: the live FRB search over every beam the loop forms, as the
deployment runs it: the port's ``SearchMonitor`` (``bf.search_monitor``)
built from the configuration's ``search`` block, fed each drained block's
beams on the card.

``attach`` keeps, of each window that owns a sampled block, its
``SearchWindow`` (the per-(width, trial) peak S/N over the owned samples of
every beam, each beam's candidates before the coincidence veto, the size of
the beam groups it was searched in) and the ring slot each of its blocks
came from (slot ``k`` holds ``inputs.wire_block(seed, k)``).

``compare`` rebuilds two of those windows from the reference's products of
their slots (``ctx.reference``: the 8-bit counts of its powers at its own
scales, as the sink makes the program's): the first, on one beam of every
beam group (its first, its last or one between, drawn from the seed), and
one more drawn from the seed among the rest, on ``BEAMS`` beams drawn from
the seed.  It holds the program's numbers to ``reference/search.py``'s:

- ``search_snr_err``: the largest gap, in sigma, between the program's and
  the reference's peak S/N over the rebuilt beams x widths x trials;
- ``search_cand_faults``: candidates of the rebuilt beams in one list with
  no candidate of the same event in the other, leaving out those within
  ``search_snr_err``'s limit of the threshold;
- ``search_windows_missed``: sampled blocks that no searched window owned.

What the sample cannot see in a run: a fault confined to the beams of one
group other than the one rebuilt (each position is rebuilt in a third of
runs or fewer), or to windows other than the two compared.

Limits (``dsa10_frb``'s ``checks``).  The gap is counts the program rounds
the other way from the reference: its int8x2 weights put its powers ~1e-4
from the reference's, within ``power_err``, so ~1% of counts differ by one,
and a trial's boxcar by ~0.01 sigma (a MAD of ~340 counts); the largest over
3 beams x 6 widths x 4637 trials x 4096 starts read 0.036-0.061 sigma on 16
seeds.  The sums themselves are exact (8-bit counts under 2^24), the
float32 normalization and scan add ~1e-5 sigma.  ``search_snr_err`` is held
to 0.2 sigma, and candidates within that of the threshold are not counted
as faults.  In the control the reference's own sums, each partial sum
rounded to bfloat16 (the nearest precision below the program's float32),
stand in the program's place, as ``sk.py``'s accumulators do: its MAD
collapses and it reads ~1e32 sigma and 17-25 candidate faults.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from beambench.reference import search as ref_search

NUMBERS = ("search_snr_err", "search_cand_faults", "search_windows_missed")
#: Beams rebuilt of the second window compared, and beams the reference
#: holds at a time (its S/N series are ~2.2 GB a beam): it sums every
#: channel at every trial, ~1 s a beam on the card.
BEAMS = 3


class _Kept:
    """The windows that own sampled blocks, as the monitor reports them."""

    def __init__(self, keep, ring_log):
        self.keep = set(keep)
        self.log = ring_log
        self.kept: dict = {}
        self.records: list = []

    def on_window(self, w) -> None:
        end = w.t_base + (w.n_samples if w.own is None else w.own)
        owned = [s for s, t0 in w.blocks
                 if s in self.keep and w.t_base <= t0 < end]
        if not owned:
            return
        slot = {s: k for s, k, _t in self.log}
        record = {"window": w, "index": len(self.records),
                  "of": self.records,
                  "slots": [(s, t0, slot[s]) for s, t0 in w.blocks]}
        self.records.append(record)
        for s in owned:
            self.kept[s] = record


def attach(r, cfg, bf, keep, tracer):
    from dsabeamformer_tpu_torch.ops.dedisperse import SearchMonitor

    spec = r.config["search"]
    kept = _Kept(keep, bf.source.ring.log)
    mon = SearchMonitor.for_stream(
        cfg, spec["dm_max"], beam="all", widths=spec["widths"],
        threshold=spec["threshold"], chunk_t=spec["chunk_t"],
        topk=spec["topk"], method=spec["method"],
        coincidence=spec["coincidence"],
        coincidence_frac=spec["coincidence_frac"],
        on_window=kept.on_window, device=r.device)
    if len(mon.dms) != spec["n_trials"] or mon.dms[0] != spec["dm_min"]:
        raise ValueError(f"the monitor's grid has {len(mon.dms)} trials "
                         f"from {mon.dms[0]}, the configuration states "
                         f"{spec['n_trials']} from {spec['dm_min']}")
    bf.search_monitor = mon
    return kept


def _setup(ctx) -> dict:
    """The search's grid and plan, and a cache of each slot's counts, kept
    on the check's context."""
    cache = vars(ctx).get("search_cache")
    if cache is None:
        obs, spec = ctx.spec["obs"], ctx.spec["search"]
        f = ref_search.freqs_mhz(obs)
        ts = ref_search.tsamp_s(obs)
        dl = ref_search.delays(f, ref_search.dm_grid(
            f, ts, spec["dm_max"], spec["dm_tol"]), ts)
        cache = vars(ctx)["search_cache"] = {
            "delays": dl, "eff": ref_search.plan_delays(dl),
            "band_span": dl.max(axis=1), "counts": {}, "results": {}}
    return cache


def _counts(ctx, cache, slot: int) -> torch.Tensor:
    """The reference's 8-bit counts ``[F', T', B]`` of slot ``slot``."""
    got = cache["counts"].get(slot)
    if got is None:
        power = ctx.reference(slot).power
        got = cache["counts"][slot] = torch.clamp(
            torch.round(power * ctx.scales), 0, 255).to(torch.uint8)
    return got


def _window(ctx, cache, record, beams) -> torch.Tensor:
    """The window's ``[beams, F', T]`` counts, block by block."""
    w = record["window"]
    f = ctx.spec["obs"]["n_chan"] // ctx.spec["obs"]["navg_freq"]
    x = torch.empty((len(beams), f, w.n_samples), dtype=torch.uint8,
                    device=ctx.device)
    idx = torch.as_tensor(beams, device=ctx.device)
    for _s, t0, slot in record["slots"]:
        c = _counts(ctx, cache, slot).index_select(2, idx)   # [F, T, b]
        a = t0 - w.t_base
        lo, hi = max(a, 0), min(a + c.shape[1], w.n_samples)
        x[:, :, lo:hi] = c[:, lo - a:hi - a].permute(2, 0, 1)
    return x


def _candidates(series, lim, spec, t_base, band_span) -> list:
    k = min(spec["topk"], series[-1].shape[-1])
    pts = ref_search.points(series, lim, spec["widths"], k,
                            spec["threshold"], t_base)
    return [ref_search.cluster(p, band_span) for p in pts]


def _faults(a: list, b: list, floor: float, band_span) -> int:
    """Candidates of ``a`` at or above ``floor`` with no event in ``b``."""
    return sum(1 for c in a if c["snr"] >= floor
               and not any(ref_search.same_event(c, o, band_span)
                           for o in b))


def _compared(ctx, record) -> Optional[list]:
    """The rows of ``record``'s window that ``compare`` rebuilds: of the
    first window one of every beam group, of one more drawn from the seed
    ``BEAMS`` drawn from the seed; None for any other window."""
    w, n = record["window"], len(record["of"])
    rng = np.random.default_rng([ctx.seed, 21, record["index"]])
    if record["index"] == 0:
        rows = []
        for g0 in range(0, len(w.beams), w.group):
            g1 = min(g0 + w.group, len(w.beams)) - 1
            rows.append(int(rng.choice([g0, g1, rng.integers(g0, g1 + 1)])))
        return sorted(set(rows))
    if n > 1 and record["index"] == 1 + np.random.default_rng(
            [ctx.seed, 21]).integers(n - 1):
        return sorted(rng.choice(len(w.beams), min(BEAMS, len(w.beams)),
                                 replace=False).tolist())
    return None


def _compare_window(ctx, cache, record, rows) -> dict:
    gap, faults = 0.0, 0
    for i in range(0, len(rows), BEAMS):
        got = _compare_beams(ctx, cache, record, rows[i:i + BEAMS])
        gap = max(gap, got["search_snr_err"])
        faults += got["search_cand_faults"]
    return {"search_snr_err": gap, "search_cand_faults": faults}


def _compare_beams(ctx, cache, record, beams) -> dict:
    w, spec = record["window"], ctx.spec["search"]
    x = _window(ctx, cache, record, beams)
    dl, band_span = cache["delays"], cache["band_span"]
    lim = ref_search.limits(dl, w.n_samples, spec["widths"], w.own)
    series = ref_search.snr_series(ref_search.bank(x, cache["eff"]),
                                   spec["widths"])
    want = ref_search.peaks(series, lim)
    ref_cands = _candidates(series, lim, spec, w.t_base, band_span)
    del series
    if ctx.control:
        low = ref_search.snr_series(
            ref_search.bank(x, cache["eff"], torch.bfloat16),
            spec["widths"])
        got = ref_search.peaks(low, lim)
        got_cands = _candidates(low, lim, spec, w.t_base, band_span)
        del low
    else:
        got = torch.from_numpy(w.peaks[beams]).to(ctx.device)
        got_cands = [[{"snr": c.snr, "dm_idx": c.dm_idx, "t_samp": c.t_samp,
                       "width": c.width} for c in w.found[w.beams[b]]]
                     for b in beams]
    both_none = torch.isinf(want) & torch.isinf(got) & (want == got)
    gap = torch.where(both_none, torch.zeros_like(want), (got - want).abs())
    floor = spec["threshold"] + ctx.spec["checks"]["search_snr_err"]
    faults = sum(_faults(g, r, floor, band_span)
                 + _faults(r, g, floor, band_span)
                 for g, r in zip(got_cands, ref_cands))
    return {"search_snr_err": float(gap.max()), "search_cand_faults": faults}


def compare(ctx, ref, got) -> dict:
    if got is None:
        return {"search_snr_err": math.inf, "search_cand_faults": math.inf,
                "search_windows_missed": 1}
    out = {"search_snr_err": 0.0, "search_cand_faults": 0,
           "search_windows_missed": 0}
    rows = _compared(ctx, got)
    if rows is None:           # a window not rebuilt
        return out
    cache = _setup(ctx)
    key = got["index"]
    if key not in cache["results"]:
        cache["results"][key] = _compare_window(ctx, cache, got, rows)
    out.update(cache["results"][key])
    return out
