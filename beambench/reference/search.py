"""The live single-pulse search's numbers in float64, from their definitions.

Given a beam stack of 8-bit counts ``x[b, f, t]`` (channels ascending in
frequency) and the search's parameters:

- the DM trials: a linear grid from 0 whose step moves the band's sweep by
  ``tol`` output samples; each trial's integer delay of each channel after
  the band's top, ``rint(k DM (f^-2 - f_top^-2) / tsamp)``;
- the sums the search forms: ``bank[b, d, t] = sum_f x[b, f, t + e[d, f]]``,
  each sample past the data the channel's tail fill (its median over every
  ``max(1, T // 512)``-th sample);
- each trial's robust normalization ``(bank - median) / (1.4826 MAD)``, its
  boxcar sums of each width ``w`` over ``sqrt(w)``: the S/N;
- each (width, trial)'s peak S/N over the boxcar starts the window owns,
  and its ``k`` largest, above the threshold, clustered per beam (the
  friends-of-friends rule of heimdall) and, over a beam set, vetoed where a
  cluster spans a quarter of the beams.

Departures from the program's arithmetic, each on purpose:

- ``e`` is the delay table of the two-stage plan the program's ``conv``
  method sums on (channel groups of the fewest count that keeps a trial's
  span inside a group to 64 samples, each trial's within-group shifts
  those of a coarse trial within one sample): the plan is worked out here
  from the delay table, as the method defines it, and its sums taken
  directly, channel by channel;
- every sum and the normalization are float64 (the program's bank is
  float32: exact for 8-bit counts, whose sums stay under 2^24);
- the cumulative sum is a plain one (the program's is float32, in blocks
  of 16, as its reference's XLA scan);
- the S/N's top-k is a stable sort of float64 values, so two float32 sums
  the program finds equal may be ordered apart here.

Imports neither the port nor JAX; TF32 is off.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: Cold-plasma dispersion: delay_s = K * DM [pc cm^-3] * f [MHz]^-2.
DM_CONST_S = 4.148808e3
#: The conv plan: a group's worst within-group span, the counts tried.
SPAN_TARGET = 64
GROUP_COUNTS = (16, 32, 64, 128)


def freqs_mhz(obs: dict) -> np.ndarray:
    """The output channels' centres, ascending (MHz)."""
    df = obs["bandwidth_hz"] / obs["n_chan_total"]
    f = obs["f_start_hz"] + df * (np.arange(obs["n_chan"]) + 0.5)
    nf = obs["navg_freq"]
    return f.reshape(-1, nf).mean(axis=1) / 1e6


def tsamp_s(obs: dict) -> float:
    return obs["n_chan_total"] / obs["bandwidth_hz"] * obs["navg_time"]


def dm_grid(f: np.ndarray, tsamp: float, dm_max: float,
            tol: float) -> np.ndarray:
    span = DM_CONST_S * (float(f.min()) ** -2.0 - float(f.max()) ** -2.0)
    step = tol * tsamp / span
    n = int(np.ceil(dm_max / step)) + 1 if dm_max > 0 else 1
    return step * np.arange(n)


def delays(f: np.ndarray, dms: np.ndarray, tsamp: float) -> np.ndarray:
    """``[n_dm, F]`` integer sample delays after the band's top."""
    ref = float(f.max())
    return np.stack([np.rint(DM_CONST_S * float(dm) * (f ** -2.0 - ref ** -2.0)
                             / tsamp) for dm in dms]).astype(np.int64)


def plan(dl: np.ndarray, max_err: int = 1) -> tuple:
    """The conv plan's ``(groups G, coarse trials J, intra [G, J, C],
    inter [n_dm, G], rep_of [n_dm], pad)``: contiguous channel groups, each
    after its own top channel; a trial takes the within-group shifts of the
    last coarse trial when they differ from its own by at most ``max_err``
    samples anywhere, else it becomes a coarse trial."""
    n_dm, f = dl.shape
    worst = dl[int(np.argmax(dl.max(axis=1)))]
    g = min(GROUP_COUNTS[-1], f)
    for n in GROUP_COUNTS:
        if n >= f:
            break
        c = -(-f // n)
        w = np.concatenate([worst, np.zeros(n * c - f, np.int64)])
        if int(np.ptp(w.reshape(n, c), axis=1).max()) <= SPAN_TARGET:
            g = n
            break
    c = -(-f // g)
    pad = g * c - f
    grouped = np.concatenate([dl, np.zeros((n_dm, pad), np.int64)],
                             axis=1).reshape(n_dm, g, c)
    inter = grouped[:, :, -1].copy()
    if pad:
        inter[:, -1] = grouped[:, -1, :c - pad].min(axis=1)
    intra = grouped - inter[:, :, None]
    if pad:
        intra[:, -1, c - pad:] = 0
    reps, rep_of = [0], np.zeros(n_dm, np.int64)
    for d in range(1, n_dm):
        if np.abs(intra[d] - intra[reps[-1]]).max() > max_err:
            reps.append(d)
        rep_of[d] = len(reps) - 1
    return g, len(reps), intra[reps].transpose(1, 0, 2), inter, rep_of, pad


def plan_delays(dl: np.ndarray) -> np.ndarray:
    """``[n_dm, F]``: the shifts the conv plan sums each channel at."""
    _g, _j, intra, inter, rep_of, pad = plan(dl)
    g, _, c = intra.shape
    eff = inter[:, :, None] + intra[:, rep_of].transpose(1, 0, 2)
    return eff.reshape(len(dl), g * c)[:, : dl.shape[1]]


def limits(dl: np.ndarray, t: int, widths, own: Optional[int]) -> np.ndarray:
    """``[n_w, n_dm]`` boxcar starts each (width, trial) owns: covered by
    data, and inside the window's owned samples (``own``; None: all)."""
    valid = np.maximum(t - dl.max(axis=1), 0)
    lim = valid if own is None else np.minimum(valid, own)
    w = np.asarray(widths, np.int64)[:, None]
    return np.minimum(valid[None, :] - w + 1, lim[None, :])


def _median(x: torch.Tensor) -> torch.Tensor:
    s = x.sort(dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def bank(x: torch.Tensor, eff: np.ndarray,
         dtype=torch.float64) -> torch.Tensor:
    """``[B, n_dm, T]`` sums of the ``[B, F, T]`` counts ``x`` at the shifts
    ``eff``, channel by channel in ``dtype`` (float64; the control's
    lower precision rounds each partial sum to it)."""
    b, f, t = x.shape
    step = max(1, t // 512)
    fill = _median(x[..., ::step].to(torch.float64))           # [B, F]
    span = int(eff.max())
    idx = torch.as_tensor(eff, device=x.device)
    acc = torch.zeros((b, len(eff), t), dtype=dtype, device=x.device)
    for ch in range(f):
        row = torch.cat([x[:, ch].to(torch.float64),
                         fill[:, ch, None].expand(b, span)], dim=1)
        # [B, span + 1, T]: the row from each shift; the trials' shifts
        acc += row.unfold(1, t, 1).index_select(1, idx[:, ch]).to(dtype)
    return acc.to(torch.float64)


def snr_series(bank64: torch.Tensor, widths) -> list:
    """Per width ``[B, n_dm, T - w + 1]`` S/N of each boxcar start."""
    med = _median(bank64)[..., None]
    mad = _median((bank64 - med).abs())[..., None]
    norm = (bank64 - med) / torch.clamp(mad * 1.4826, min=1e-30)
    c = torch.cat([torch.zeros_like(norm[..., :1]), norm.cumsum(-1)], -1)
    return [(c[..., w:] - c[..., :-w]) / math.sqrt(w) for w in widths]


def peaks(series: list, lim: np.ndarray) -> torch.Tensor:
    """``[B, n_w, n_dm]``: each (width, trial)'s largest S/N over its owned
    starts (-inf where none)."""
    out = []
    for wi, s in enumerate(series):
        t_idx = torch.arange(s.shape[-1], device=s.device)
        own = t_idx < torch.as_tensor(lim[wi], device=s.device)[:, None]
        out.append(s.masked_fill(~own, -math.inf).amax(-1))
    return torch.stack(out, dim=1)


def points(series: list, lim: np.ndarray, widths, k: int, threshold: float,
           t_offset: int) -> List[list]:
    """Per beam, ``(snr, trial, start, width)`` of each (width, trial)'s
    ``k`` largest S/N at or above ``threshold`` within its owned starts."""
    out: List[list] = [[] for _ in range(series[0].shape[0])]
    for wi, s in enumerate(series):
        top = torch.sort(s, dim=-1, descending=True, stable=True)
        v, i = top.values[..., :k].cpu(), top.indices[..., :k].cpu()
        ok = (v >= threshold) & (i < torch.as_tensor(lim[wi])[:, None])
        for b, d, j in ok.nonzero().tolist():
            out[b].append((float(v[b, d, j]), d, int(i[b, d, j]) + t_offset,
                           int(widths[wi])))
    return out


def cluster(pts: list, band_span: np.ndarray) -> List[dict]:
    """Strongest point first, every point whose boxcar overlaps it within
    the dispersion smear between their trials joins it."""
    pts = sorted(pts, key=lambda p: -p[0])
    used = [False] * len(pts)
    out = []
    for i, (snr, d, t, w) in enumerate(pts):
        if used[i]:
            continue
        used[i] = True
        lo = hi = d
        for j in range(i + 1, len(pts)):
            if used[j]:
                continue
            _, dj, tj, wj = pts[j]
            pad = max(w, wj) + abs(int(band_span[d]) - int(band_span[dj]))
            if tj < t + w + pad and t < tj + wj + pad:
                used[j] = True
                lo, hi = min(lo, dj), max(hi, dj)
        out.append({"snr": snr, "dm_idx": d, "t_samp": t, "width": w,
                    "dm_lo": lo, "dm_hi": hi})
    return out


def same_event(a: dict, b: dict, band_span: np.ndarray) -> bool:
    """Whether two candidates of one beam are one event by the clustering
    rule (their boxcars overlap within the smear between their trials)."""
    pad = max(a["width"], b["width"]) + abs(int(band_span[a["dm_idx"]])
                                            - int(band_span[b["dm_idx"]]))
    return (b["t_samp"] < a["t_samp"] + a["width"] + pad
            and a["t_samp"] < b["t_samp"] + b["width"] + pad)
