"""Multi-DM incoherent dedispersion search over beam products.

The same search as ``dsabeamformer_tpu/ops/dedisperse.py``: a brute-force
or two-stage DM-trial bank, robust per-trial normalization, boxcar matched
filters, top-k extraction per (width, trial), then host-side thresholding,
clustering and cross-beam coincidence.  The live ``SearchMonitor`` runs it
over the streaming loop's own products.

Host half (NumPy, as in the JAX package): the trial grid, the delay table,
the subband plan, the conv plan, clustering, coincidence, preprocessing and
the candidate files.

Device half: the window (the monitor's is held on the device), its tail
fill and padded operand, the normalization, and every bank method on one
hand-written CUDA library, ``csrc/dedisperse.cu`` (``dedisperse_direct``,
``subband_stage1``, ``subband_stage2``), which replaces the reference's
XLA gathers
(``_dedisperse_jit`` and ``_subband_jit``, ``dsabeamformer_tpu/ops/
dedisperse.py:156`` and ``:179``).  ``method="conv"`` keeps the reference's
contract (automatic group count, a tail fill from a 512-row subsample, that
fill rounded for uint8 input, ``valid_len``) and computes the two-stage bank
on its plan with the same two subband kernels; the reference's one-hot
convolution is a TPU device and has no counterpart here.  After the robust
normalization, ``snr_topk`` of the same library takes each
trial series' cumulative sum, top-k and owned peaks; on the card one launch
of it (``_snr_topk``) normalizes each row first, where it holds it, and
``median_rows`` takes the tail fill's medians.  Each kernel has a plain
PyTorch version beside it (a loop of shifted adds in the kernel's order,
the scan and top-k in the reference's, ``_normalize`` and ``_median_last``
on ``kthvalue``) that a CPU tensor runs.

The delay curve is ``config.dm_delays_s`` (referenced to the top of the
band), shared with the pulse generator.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import math
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import DM_CONST_S, dm_delays_s
from dsabeamformer_tpu_torch.ops._build import CSRC_DIR, load_library
from dsabeamformer_tpu_torch.utils.device import resolve_device
from dsabeamformer_tpu_torch.utils.profiling import annotate

__all__ = [
    "dm_trial_grid",
    "delay_table",
    "dedisperse_bank",
    "dedisperse_bank_batch",
    "subband_plan",
    "subband_dedisperse_bank",
    "subband_dedisperse_bank_batch",
    "conv_dedisperse_bank",
    "conv_dedisperse_bank_batch",
    "Candidate",
    "coincidence_filter",
    "preprocess_spectrogram",
    "search_spectrogram",
    "search_spectrograms",
    "SearchMonitor",
    "SearchWindow",
    "write_candidates",
    "read_candidates",
]

#: Boxcar widths (output samples) matched-filtered by default: powers of two
#: up to 32, the usual single-pulse-search ladder.
DEFAULT_WIDTHS = (1, 2, 4, 8, 16, 32)


def _conv_auto_n_sub(delays: np.ndarray, span_target: int = 64,
                     choices: Tuple[int, ...] = (16, 32, 64, 128)) -> int:
    """Channel-group count of the conv method: the fewest groups whose worst
    within-group delay span stays under ``span_target`` samples (evaluated
    on the steepest trial), as the reference picks it."""
    f = delays.shape[1]
    worst = np.asarray(delays[int(np.argmax(delays.max(axis=1)))],
                       np.int64)
    for n in choices:
        if n >= f:
            break
        c = -(-f // n)
        pad = n * c - f
        w = np.concatenate([worst, np.zeros(pad, np.int64)]) if pad \
            else worst
        g = w.reshape(n, c)
        if int((g.max(axis=1) - g.min(axis=1)).max()) <= span_target:
            return n
    return min(choices[-1], f)


def dm_trial_grid(
    f_lo_mhz: float,
    f_hi_mhz: float,
    tsamp_s: float,
    dm_max: float,
    dm_min: float = 0.0,
    tol: float = 1.25,
) -> np.ndarray:
    """Linear DM trial grid with the diagonal-DM spacing: adjacent trials
    differ by ``tol`` output samples of differential delay across the band,

        step = tol * tsamp / (DM_CONST_S * (f_lo^-2 - f_hi^-2)).

    Always includes ``dm_min``; the last trial is the first one >=
    ``dm_max``.
    """
    if f_hi_mhz <= f_lo_mhz:
        raise ValueError(f"need f_hi > f_lo, got [{f_lo_mhz}, {f_hi_mhz}]")
    if dm_max < dm_min:
        raise ValueError(f"dm_max {dm_max} < dm_min {dm_min}")
    if tol <= 0 or tsamp_s <= 0:
        raise ValueError("tol and tsamp_s must be positive")
    span = DM_CONST_S * (f_lo_mhz ** -2.0 - f_hi_mhz ** -2.0)  # s per DM unit
    step = tol * tsamp_s / span
    n = int(np.ceil((dm_max - dm_min) / step)) + 1 if dm_max > dm_min else 1
    return dm_min + step * np.arange(n)


def delay_table(
    freqs_mhz: np.ndarray, dms: np.ndarray, tsamp_s: float
) -> np.ndarray:
    """Integer sample delays ``[n_dm, F]`` of each channel relative to the
    highest channel, rounded to nearest."""
    freqs = np.asarray(freqs_mhz, np.float64)
    ref = float(freqs.max())
    delays = np.stack(
        [dm_delays_s(freqs, float(dm), ref) for dm in np.asarray(dms)]
    )
    return np.rint(delays / tsamp_s).astype(np.int32)


# --------------------------------------------------------------------- #
# The CUDA kernels and their plain versions
# --------------------------------------------------------------------- #

#: The CUDA source of the three dedispersion kernels (``csrc/<name>.cu``).
KERNEL_SOURCE = "dedisperse"


def _kernel_constants() -> dict:
    """The ``constexpr int`` literals of ``csrc/dedisperse.cu``, read from
    the source: the banks' geometry is decided there alone."""
    src = (CSRC_DIR / f"{KERNEL_SOURCE}.cu").read_text()
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (-?\d+);", src)}


#: The banks' kernel (csrc/dedisperse.cu ``bank_kernel``, which
#: ``dedisperse_direct`` and ``subband_stage1`` launch), as its source
#: states it: consecutive output samples a lane owns (kR), trials a warp
#: owns (kK), warps of a block (kWarps), the steps between a warp's
#: consecutive trials on a row that its register window takes (kMinStep ..
#: kMaxStep), the widest span of the block's shifts on a row that its
#: staged rows take (kBlockSpan), rows a stage holds (kChunk).
_BANK = _kernel_constants()
BANK_LANE_SAMPLES = _BANK["kR"]
BANK_WARP_TRIALS = _BANK["kK"]
BANK_WARPS = _BANK["kWarps"]
BANK_MIN_STEP = _BANK["kMinStep"]
BANK_MAX_STEP = _BANK["kMaxStep"]
BANK_BLOCK_SPAN = _BANK["kBlockSpan"]
BANK_CHUNK = _BANK["kChunk"]
#: ``snr_topk_kernel``'s threads a row, the most peaks it keeps a (width,
#: trial), and its blocks where a row's scan is in global memory.
TOPK_THREADS = _BANK["kTopkThreads"]
TOPK_MAX_K = _BANK["kTopkMaxK"]
TOPK_SCRATCH_BLOCKS = _BANK["kTopkScratchBlocks"]
#: How a warp adds a row (``bank_paths``): from its register window, from
#: the staged row a load a trial, from global memory a load a trial.
WINDOW_PATH, STAGED_PATH, GLOBAL_PATH = 0, 1, 2


def bank_paths(table: np.ndarray) -> np.ndarray:
    """How the bank kernel adds each row of a shift table ``[n_trials,
    n_rows]`` (a direct bank's delays, or one group's stage-1 shifts):
    int8 ``[trial tiles, BANK_WARPS, n_rows]``, for warp ``w`` of trial
    tile ``i`` on row ``r``: ``WINDOW_PATH`` where each of its trials'
    shifts is its predecessor's plus ``BANK_MIN_STEP`` to
    ``BANK_MAX_STEP`` (one register window serves its trials) and the
    block's shifts span at most ``BANK_BLOCK_SPAN``; else ``STAGED_PATH``
    where its trials' shifts span under 256 and the block's fit; else
    ``GLOBAL_PATH``.  Trials past the table's last take its shifts, as in
    the kernel."""
    tab = np.asarray(table, np.int64)
    n, r = tab.shape
    per = BANK_WARPS * BANK_WARP_TRIALS
    tiles = -(-n // per)
    idx = np.minimum(np.arange(tiles * per), n - 1)
    t = tab[idx].reshape(tiles, BANK_WARPS, BANK_WARP_TRIALS, r)
    step = np.diff(t, axis=2)
    window = ((step >= BANK_MIN_STEP) & (step <= BANK_MAX_STEP)).all(axis=2)
    warp_span = t.max(axis=2) - t.min(axis=2)
    fits = (warp_span < 256).all(axis=1) \
        & (t.max(axis=(1, 2)) - t.min(axis=(1, 2)) <= BANK_BLOCK_SPAN)
    paths = np.where(window, WINDOW_PATH,
                     np.where(warp_span < 256, STAGED_PATH, GLOBAL_PATH))
    return np.where(fits[:, None, :], paths, GLOBAL_PATH).astype(np.int8)


def dedisperse_direct_plain(p: torch.Tensor, delays: torch.Tensor,
                            t_out: int) -> torch.Tensor:
    """``out[b, d, t] = sum_f p[b, f, t + delays[d, f]]`` over ascending
    ``f``, one float32 add a channel from zero (the reference's scan):
    ``p`` ``[B, F, T_pad]`` float32, ``delays`` ``[n_dm, F]`` int32."""
    b, f, _ = p.shape
    t_idx = torch.arange(t_out, device=p.device)
    acc = torch.zeros((b, delays.shape[0], t_out), dtype=torch.float32,
                      device=p.device)
    d64 = delays.to(torch.int64)
    for c in range(f):
        acc = acc + p[:, c, d64[:, c:c + 1] + t_idx]
    return acc


def subband_stage1_plain(p: torch.Tensor, intra: torch.Tensor,
                         t1: int) -> torch.Tensor:
    """``s[b, g, j, t] = sum_c p[b, g, c, t + intra[g, j, c]]`` over
    ascending ``c``, one float32 add a channel from zero: ``p``
    ``[B, G, C, T_pad]`` float32, ``intra`` ``[G, J, C]`` int32 ->
    ``[B, G, J, t1]``."""
    b, g, c, _ = p.shape
    j = intra.shape[1]
    t_idx = torch.arange(t1, device=p.device)
    acc = torch.zeros((b, g, j, t1), dtype=torch.float32, device=p.device)
    i64 = intra.to(torch.int64)
    for cc in range(c):
        idx = (i64[:, :, cc, None] + t_idx).reshape(1, g, j * t1)
        acc = acc + torch.gather(p[:, :, cc], 2, idx.expand(b, g, j * t1)
                                 ).view(b, g, j, t1)
    return acc


def subband_stage2_plain(s: torch.Tensor, offsets: torch.Tensor,
                         t_out: int) -> torch.Tensor:
    """``out[b, d, t] = sum_g s[b, g].flat[offsets[g, d] + t]`` over
    ascending ``g``, one float32 add a group from zero: ``s``
    ``[B, G, J, t1]`` float32, ``offsets`` ``[G, n_dm]`` int32."""
    b, g = s.shape[:2]
    t_idx = torch.arange(t_out, device=s.device)
    acc = torch.zeros((b, offsets.shape[1], t_out), dtype=torch.float32,
                      device=s.device)
    o64 = offsets.to(torch.int64)
    for gg in range(g):
        acc = acc + s[:, gg].reshape(b, -1)[:, o64[gg, :, None] + t_idx]
    return acc


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library(KERNEL_SOURCE)
    if lib.dsabf_dedisperse_direct.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dsabf_dedisperse_direct.argtypes = [p, p, p, i, i, ll, i, i, p]
        lib.dsabf_subband_stage1.argtypes = [p, p, p, i, i, i, ll, i, i, p]
        lib.dsabf_subband_stage2.argtypes = [p, p, p, i, i, ll, i, i, p]
        lib.dsabf_snr_topk.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                       p, p]
        lib.dsabf_median_rows.argtypes = [p, p, ll, i, p]
        for fn in (lib.dsabf_dedisperse_direct, lib.dsabf_subband_stage1,
                   lib.dsabf_subband_stage2, lib.dsabf_snr_topk,
                   lib.dsabf_median_rows):
            fn.restype = i
        lib.dsabf_error_string.argtypes = [i]
        lib.dsabf_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(name: str, data: torch.Tensor, table: torch.Tensor,
                    data_dims: int) -> None:
    """What every kernel assumes of its two inputs, checked before it reads
    them (the table's values, its shifts, are the caller's to bound)."""
    if data.dtype != torch.float32 or data.dim() != data_dims:
        raise ValueError(f"{name}: data must be float32 with {data_dims} "
                         f"dims, got {data.dtype} {tuple(data.shape)}")
    if table.dtype != torch.int32:
        raise ValueError(f"{name}: table must be int32, got {table.dtype}")
    if table.device != data.device:
        raise ValueError(f"{name}: table on {table.device}, data on "
                         f"{data.device}")
    if not (data.is_contiguous() and table.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA (kernel) or CPU (plain) "
                         f"tensors, got {data.device}")


def _launch(fn_name: str, args: list, device) -> None:
    lib = _kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc:
        raise RuntimeError(f"{fn_name} launch failed: error {rc}, "
                           f"{lib.dsabf_error_string(rc).decode()}")


def dedisperse_direct(p: torch.Tensor, delays: torch.Tensor,
                      t_out: int) -> torch.Tensor:
    """The brute-force bank ``[B, n_dm, t_out]`` of ``p`` ``[B, F, T_pad]``
    (float32, each channel's time series contiguous, padded past the data)
    over ``delays`` ``[n_dm, F]`` (int32, ``0 <= delays`` and ``delays +
    t_out <= T_pad``: the caller's to guarantee).

    A CPU tensor runs ``dedisperse_direct_plain``; a CUDA tensor launches
    the kernel on the current stream (bit-equal to the plain version: the
    same float32 adds in the same order) and counts it in
    ``dedisperse_direct.launches``."""
    _check_operands("dedisperse_direct", p, delays, 3)
    b, f, t_pad = p.shape
    if delays.dim() != 2 or delays.shape[1] != f:
        raise ValueError(f"delays {tuple(delays.shape)} do not cover the "
                         f"data's {f} channels")
    if p.device.type == "cpu":
        return dedisperse_direct_plain(p, delays, t_out)
    out = torch.empty((b, delays.shape[0], t_out), dtype=torch.float32,
                      device=p.device)
    _launch("dsabf_dedisperse_direct",
            [p.data_ptr(), delays.data_ptr(), out.data_ptr(), b, f, t_pad,
             delays.shape[0], t_out], p.device)
    dedisperse_direct.launches += 1
    return out


dedisperse_direct.launches = 0


def subband_stage1(p: torch.Tensor, intra: torch.Tensor,
                   t1: int) -> torch.Tensor:
    """Stage 1 of the two-stage bank, ``[B, G, J, t1]``: each group's
    channels summed over its coarse trials' within-group shifts.  ``p``
    ``[B, G, C, T_pad]`` float32, ``intra`` ``[G, J, C]`` int32 (``0 <=
    intra`` and ``intra + t1 <= T_pad``: the caller's).  A CPU tensor runs
    ``subband_stage1_plain``; a CUDA tensor launches the kernel (bit-equal)
    and counts it in ``subband_stage1.launches``."""
    _check_operands("subband_stage1", p, intra, 4)
    b, g, c, t_pad = p.shape
    if intra.dim() != 3 or intra.shape[0] != g or intra.shape[2] != c:
        raise ValueError(f"intra {tuple(intra.shape)} does not match data "
                         f"groups {g} x channels {c}")
    if p.device.type == "cpu":
        return subband_stage1_plain(p, intra, t1)
    j = intra.shape[1]
    out = torch.empty((b, g, j, t1), dtype=torch.float32, device=p.device)
    _launch("dsabf_subband_stage1",
            [p.data_ptr(), intra.data_ptr(), out.data_ptr(), b, g, c, t_pad,
             j, t1], p.device)
    subband_stage1.launches += 1
    return out


subband_stage1.launches = 0


def subband_stage2(s: torch.Tensor, offsets: torch.Tensor,
                   t_out: int) -> torch.Tensor:
    """Stage 2 of the two-stage bank, ``[B, n_dm, t_out]``: the groups'
    stage-1 rows combined at each trial's flat offset.  ``s``
    ``[B, G, J, t1]`` float32, ``offsets`` ``[G, n_dm]`` int32 (``0 <=
    offsets`` and ``offsets + t_out <= J * t1``: the caller's).  A CPU
    tensor runs ``subband_stage2_plain``; a CUDA tensor launches the kernel
    (bit-equal) and counts it in ``subband_stage2.launches``."""
    _check_operands("subband_stage2", s, offsets, 4)
    b, g, j, t1 = s.shape
    if offsets.dim() != 2 or offsets.shape[0] != g:
        raise ValueError(f"offsets {tuple(offsets.shape)} do not match "
                         f"{g} groups")
    if s.device.type == "cpu":
        return subband_stage2_plain(s, offsets, t_out)
    n_dm = offsets.shape[1]
    out = torch.empty((b, n_dm, t_out), dtype=torch.float32, device=s.device)
    _launch("dsabf_subband_stage2",
            [s.data_ptr(), offsets.data_ptr(), out.data_ptr(), b, g, j * t1,
             n_dm, t_out], s.device)
    subband_stage2.launches += 1
    return out


subband_stage2.launches = 0


# --------------------------------------------------------------------- #
# Banks: host plan and fill, device data, one of the kernels above
# --------------------------------------------------------------------- #

def _check_table(delays: np.ndarray, f: int) -> None:
    if delays.shape[1] != f:
        raise ValueError(
            f"delay table covers {delays.shape[1]} channels, data has {f}")
    if delays.min() < 0:
        raise ValueError("negative delays: delay_table is referenced to the "
                         "band top; check channel ordering (ascending)")


def _valid_len(delays: np.ndarray, t: int) -> np.ndarray:
    return np.maximum(t - delays.max(axis=1), 0).astype(np.int64)


def _upload(x_btf: np.ndarray, device) -> torch.Tensor:
    """A host ``[B, T, F]`` stack on ``device`` as it is (any real dtype),
    seen as ``[B, F, T]``: the banks' view of a window."""
    dev = resolve_device(device)
    return torch.from_numpy(np.ascontiguousarray(x_btf)).to(dev).transpose(
        1, 2)


def _window_columns(x: torch.Tensor, fill: torch.Tensor, t_pad: int,
                    pad_f: int) -> torch.Tensor:
    """``[B, F + pad_f, T_pad']`` float32 on ``x``'s device (``T_pad`` rounded
    up to a multiple of 4): the ``[B, F, T]`` window ``x`` (any real dtype,
    any strides: cast here), its tail filled with ``fill`` ``[B, F]``, zero
    channels appended, each channel's time series contiguous."""
    b, f, t = x.shape
    t_pad = -(-t_pad // 4) * 4   # rows on 16 bytes: the kernels' wide copies
    cols = torch.empty((b, f + pad_f, t_pad), dtype=torch.float32,
                       device=x.device)
    cols[:, :f, :t] = x
    cols[:, :f, t:] = fill[:, :, None]
    cols[:, f:] = 0.0
    return cols


def _fill(x: torch.Tensor, step: int, rounded: bool) -> torch.Tensor:
    """The tail fill ``[B, F]`` of a ``[B, F, T]`` window: each channel's
    median (the mean of the middle two, as NumPy's) over every ``step``-th
    sample, float32; rounded to an integer where ``rounded``."""
    fill = median_rows(x[..., ::step].to(torch.float32))
    return fill.round() if rounded else fill


def _table(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _direct_bank(x: torch.Tensor, fill: torch.Tensor,
                 delays: np.ndarray) -> torch.Tensor:
    """The brute-force bank ``[B, n_dm, T]`` of the ``[B, F, T]`` window
    ``x`` with tail fill ``fill``."""
    t = x.shape[2]
    p = _window_columns(x, fill, t + int(delays.max()), 0)
    return dedisperse_direct(p, _table(delays, x.device), t)


#: The most bytes of stage-1 planes made at once: a window's beams go
#: through both stages this many planes' worth at a time.
STAGE1_BYTES = 8 << 30


def _stage1_beams(plan, t: int) -> int:
    """Beams whose stage-1 planes ``STAGE1_BYTES`` holds (at least one)."""
    intra_c, inter, _, _ = plan
    g, j, _ = intra_c.shape
    return max(1, STAGE1_BYTES // (4 * g * j * (t + int(inter.max()))))


def _two_stage_bank(x: torch.Tensor, fill: torch.Tensor,
                    plan) -> torch.Tensor:
    """The two-stage bank of the ``[B, F, T]`` window ``x`` on ``plan``
    (``subband_plan``'s tuple): stage 1 on the groups, stage 2 at each
    trial's offsets, ``_stage1_beams`` beams at a time."""
    intra_c, inter, rep_of, pad_f = plan
    g, n_coarse, c = intra_c.shape
    b, _, t = x.shape
    t1 = t + int(inter.max())
    t_pad = t1 + (int(intra_c.max()) if intra_c.size else 0)
    intra = _table(intra_c, x.device)
    # flat offset of (group g, trial d) in group g's [J * t1] stage-1 plane
    offsets = _table(rep_of[None, :] * t1 + inter.T, x.device)   # [G, n_dm]
    step = _stage1_beams(plan, t)
    if step >= b:
        p = _window_columns(x, fill, t_pad, pad_f).view(b, g, c, -1)
        return subband_stage2(subband_stage1(p, intra, t1), offsets, t)
    bank = torch.empty((b, len(rep_of), t), dtype=torch.float32,
                       device=x.device)
    for b0 in range(0, b, step):
        n = min(step, b - b0)
        p = _window_columns(x[b0:b0 + n], fill[b0:b0 + n], t_pad,
                            pad_f).view(n, g, c, -1)
        s = subband_stage1(p, intra, t1)
        del p
        bank[b0:b0 + step] = subband_stage2(s, offsets, t)
        del s
    return bank


#: Conv-method plans keyed by the delay table's bytes: the streaming monitor
#: searches every window with the same table.
_CONV_PLAN_CACHE: dict = {}


def _conv_plan(delays: np.ndarray, n_sub: int, max_err_samples: int):
    key = (delays.shape, delays.tobytes(), n_sub, max_err_samples)
    hit = _CONV_PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    plan = subband_plan(delays, n_sub, max_err_samples)
    _CONV_PLAN_CACHE.clear()   # one live plan
    _CONV_PLAN_CACHE[key] = plan
    return plan


def _conv_bank(x: torch.Tensor, delays: np.ndarray, n_sub: Optional[int],
               max_err_samples: int, rounded: bool) -> torch.Tensor:
    """The conv method's bank of the ``[B, F, T]`` window ``x``, as the
    reference's: ``n_sub=None`` picks the group count
    (``_conv_auto_n_sub``), the plan is cached, and the tail fill is each
    channel's median over a subsample of at most 512 rows, rounded to an
    integer where ``rounded`` (the reference's rule for uint8 input)."""
    _check_table(delays, x.shape[1])
    if n_sub is None:
        n_sub = _conv_auto_n_sub(delays)
    plan = _conv_plan(delays, n_sub, max_err_samples)
    fill = _fill(x, max(1, x.shape[2] // 512), rounded)
    return _two_stage_bank(x, fill, plan)


def conv_dedisperse_bank(
    power_tf: np.ndarray,
    delays: np.ndarray,
    n_sub: Optional[int] = None,
    max_err_samples: int = 1,
    device="cuda",
) -> Tuple[torch.Tensor, np.ndarray]:
    """The live monitor's default bank: ``subband_dedisperse_bank``'s
    contract (at most ``max_err_samples`` of extra smearing) with the
    reference conv method's plan and fill: ``n_sub=None`` picks the fewest
    groups that bound the within-group span (``_conv_auto_n_sub``), and the
    tail fill is a 512-row-subsample median (rounded for uint8 input, which
    uploads as it is).  Returns ``(bank [n_dm, T] on device, valid_len)``."""
    bank, valid_len = conv_dedisperse_bank_batch(
        np.asarray(power_tf)[None], delays, n_sub, max_err_samples, device)
    return bank[0], valid_len


def conv_dedisperse_bank_batch(
    power_btf: np.ndarray,
    delays: np.ndarray,
    n_sub: Optional[int] = None,
    max_err_samples: int = 1,
    device="cuda",
) -> Tuple[torch.Tensor, np.ndarray]:
    """``conv_dedisperse_bank`` over a ``[B, T, F]`` beam stack (one plan,
    each beam's own fill): bank ``[B, n_dm, T]``."""
    x = np.asarray(power_btf)
    bank = _conv_bank(_upload(x, device), delays, n_sub, max_err_samples,
                      rounded=x.dtype == np.uint8)
    return bank, _valid_len(delays, x.shape[1])


def subband_plan(delays: np.ndarray, n_sub: int,
                 max_err_samples: int = 1):
    """Host plan for the two-stage bank: contiguous channel groups, each
    referenced to its own band-top channel, and a coarse trial subset chosen
    greedily so that every trial's within-group delay profile differs from
    its coarse representative by at most ``max_err_samples`` anywhere.

    Returns ``(intra_c [G, n_coarse, C], inter [n_dm, G], rep_of [n_dm],
    pad_f)``; ``pad_f`` trailing zero channels square off the last group.
    """
    n_dm, f = delays.shape
    if not 1 <= n_sub <= f:
        raise ValueError(f"n_sub must be in [1, {f}], got {n_sub}")
    c = -(-f // n_sub)
    pad_f = n_sub * c - f
    padded = np.concatenate(
        [delays, np.zeros((n_dm, pad_f), delays.dtype)], axis=1)
    grouped = padded.reshape(n_dm, n_sub, c)
    # ascending frequency within a group: its last channel is its band top,
    # except in the padded last group (the minimum over its real channels)
    inter = grouped[:, :, -1].copy()
    if pad_f:
        inter[:, -1] = grouped[:, -1, : c - pad_f].min(axis=1)
    intra = grouped - inter[:, :, None]  # [n_dm, G, C]
    if pad_f:  # zero-power pad channels at zero shift
        intra[:, -1, c - pad_f:] = 0
    reps = [0]
    rep_of = np.zeros(n_dm, np.int64)
    for d in range(1, n_dm):
        if np.abs(intra[d] - intra[reps[-1]]).max() > max_err_samples:
            reps.append(d)
        rep_of[d] = len(reps) - 1
    intra_c = np.ascontiguousarray(
        intra[reps].transpose(1, 0, 2)).astype(np.int32)
    return intra_c, inter.astype(np.int32), rep_of, pad_f


def subband_dedisperse_bank(
    power_tf: np.ndarray,
    delays: np.ndarray,
    n_sub: int = 64,
    max_err_samples: int = 1,
    device="cuda",
) -> Tuple[torch.Tensor, np.ndarray]:
    """``dedisperse_bank`` approximated by the two-stage subband algorithm:
    the same contract (channel-median tail fill, per-trial ``valid_len``),
    each output sample the sum of the same F input samples with per-channel
    shifts off by at most ``max_err_samples``."""
    t, f = power_tf.shape
    _check_table(delays, f)
    plan = subband_plan(delays, n_sub, max_err_samples)
    dev = resolve_device(device)
    fill = np.median(power_tf, axis=0).astype(np.float32)
    x = _upload(np.asarray(power_tf, np.float32)[None], dev)
    bank = _two_stage_bank(x, torch.from_numpy(fill[None]).to(dev), plan)[0]
    return bank, _valid_len(delays, t)


def subband_dedisperse_bank_batch(
    power_btf: np.ndarray,
    delays: np.ndarray,
    n_sub: int = 64,
    max_err_samples: int = 1,
    device="cuda",
) -> Tuple[torch.Tensor, np.ndarray]:
    """``subband_dedisperse_bank`` over a ``[B, T, F]`` beam stack, the plan
    computed once."""
    b, t, f = power_btf.shape
    x = _upload(np.asarray(power_btf, np.float32), device)
    return _subband_bank(x, delays, n_sub, max_err_samples), \
        _valid_len(delays, t)


def _subband_bank(x: torch.Tensor, delays: np.ndarray, n_sub: int,
                  max_err_samples: int = 1) -> torch.Tensor:
    """The subband method's bank of the ``[B, F, T]`` window ``x``: the
    plan computed here, each channel's median over the whole window as
    the tail fill."""
    _check_table(delays, x.shape[1])
    plan = subband_plan(delays, n_sub, max_err_samples)
    return _two_stage_bank(x, _fill(x, 1, False), plan)


def dedisperse_bank(
    power_tf: np.ndarray, delays: np.ndarray, device="cuda"
) -> Tuple[torch.Tensor, np.ndarray]:
    """Dedisperse ``[T, F]`` over a ``[n_dm, F]`` integer-delay table.

    Returns ``(bank, valid_len)``: ``bank[d, t]`` (on ``device``) is the
    channel sum with trial ``d``'s shifts applied, length T;
    ``valid_len[d]`` is the number of leading samples fully covered by data.
    Reads beyond the data come from padding filled with each channel's
    median, so the tail decays toward the baseline; candidates past
    ``valid_len`` must be discarded by the caller.
    """
    t, f = power_tf.shape
    _check_table(delays, f)
    dev = resolve_device(device)
    fill = np.median(power_tf, axis=0).astype(np.float32)  # [F]
    x = _upload(np.asarray(power_tf, np.float32)[None], dev)
    return _direct_bank(x, torch.from_numpy(fill[None]).to(dev), delays)[0], \
        _valid_len(delays, t)


def dedisperse_bank_batch(
    power_btf: np.ndarray, delays: np.ndarray, device="cuda"
) -> Tuple[torch.Tensor, np.ndarray]:
    """``dedisperse_bank`` over a ``[B, T, F]`` beam stack: bank
    ``[B, n_dm, T]``, each beam's tail filled with its own per-channel
    median; ``valid_len`` is shared."""
    b, t, f = power_btf.shape
    _check_table(delays, f)
    x = _upload(np.asarray(power_btf, np.float32), device)
    return _direct_bank(x, _fill(x, 1, False), delays), _valid_len(delays, t)


def _median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as the reference takes it: the mean of the
    two middle values for an even length (``torch.median`` returns the
    lower one).  The lower is found by selection, not a sort; the upper is
    the lower where more than half the values are at most it, else the
    least value above it."""
    n = x.shape[-1]
    lo = x.kthvalue((n - 1) // 2 + 1, dim=-1, keepdim=True).values
    hi = lo
    if n % 2 == 0:
        above = torch.where(x > lo, x, math.inf).amin(dim=-1, keepdim=True)
        hi = torch.where((x <= lo).sum(dim=-1, keepdim=True) > n // 2, lo,
                         above)
    return ((lo + hi) * 0.5)[..., 0]


def median_rows(x: torch.Tensor) -> torch.Tensor:
    """``_median_last`` of a float32 tensor, bit-equal: a CPU tensor runs
    it; a CUDA one launches ``median_rows_kernel`` (a block a row, an exact
    radix selection, no ``kthvalue``) on the current stream, counted in
    ``median_rows.launches``."""
    if x.dtype != torch.float32 or x.shape[-1] == 0:
        raise ValueError(f"median_rows: rows must be non-empty float32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return _median_last(x)
    x = x.contiguous()
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    _launch("dsabf_median_rows", [x.data_ptr(), out.data_ptr(),
                                  out.numel(), x.shape[-1]], x.device)
    median_rows.launches += 1
    return out


median_rows.launches = 0


#: Block length of the reference's cumulative sum (XLA's reduce-window
#: rewrite on the CPU: sequential within blocks of 16, the block totals
#: scanned the same way, recursively).
_SCAN_BLOCK = 16


def _cumsum_blocked(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumulative sum over the last axis in the
    reference's order (``_SCAN_BLOCK``), so that the boxcar sums, and the
    top-k's ties, come out bit for bit as the reference's do."""
    n = x.shape[-1]
    nb = -(-n // _SCAN_BLOCK)
    if nb == 1:
        blocks = x[..., None, :]
    else:
        pad = nb * _SCAN_BLOCK - n
        blocks = torch.nn.functional.pad(x, (0, pad)).reshape(
            *x.shape[:-1], nb, _SCAN_BLOCK)
    within = torch.empty_like(blocks)
    acc = torch.zeros_like(blocks[..., 0])
    for i in range(blocks.shape[-1]):
        acc = acc + blocks[..., i]
        within[..., i] = acc
    if nb == 1:
        return within[..., 0, :]
    carry = _cumsum_blocked(within[..., -1])              # [..., nb]
    excl = torch.cat([torch.zeros_like(carry[..., :1]), carry[..., :-1]],
                     dim=-1)
    return (excl[..., None] + within).reshape(*x.shape[:-1], -1)[..., :n]


def snr_topk_plain(norm: torch.Tensor, widths: Tuple[int, ...], k: int,
                   limit: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """Of normalized bank rows ``norm`` ``[B, n_dm, T]``: the cumulative sum
    in the reference's order (``_cumsum_blocked``), then for each boxcar
    width the top-k S/N per trial, ties to the lower start as ``lax.top_k``
    breaks them (the first largest, k times), and the peak S/N over each
    (width, trial)'s first ``limit [n_w, n_dm]`` starts (-inf where there
    are none): ``(snr [B, n_w, n_dm, k] float64, idx int64, peak [B, n_w,
    n_dm] float64)``.  The boxcar sums are float32 differences of the
    cumulative sum; the S/N is a sum times the float64 reciprocal of
    sqrt(width), as XLA compiles the reference's (a float32 array over
    NumPy's float64 ``sqrt``), which orders the sums as the float32 sums do.
    """
    csum = torch.cat([torch.zeros_like(norm[..., :1]),
                      _cumsum_blocked(norm)], dim=-1)  # [..., T+1]
    lim = torch.as_tensor(limit, device=norm.device)
    t_idx = torch.arange(csum.shape[-1], device=norm.device)
    snrs, idxs, peaks = [], [], []
    for wi, w in enumerate(widths):
        inv = 1.0 / math.sqrt(w)
        s = csum[..., w:] - csum[..., :-w]
        owned = t_idx[: s.shape[-1]] < lim[wi, :, None]        # [n_dm, T']
        peaks.append(s.masked_fill(~owned, -math.inf).amax(dim=-1).double()
                     * inv)
        rest, top = s.clone(), []
        for _ in range(k):
            i = rest.argmax(dim=-1, keepdim=True)
            top.append(i)
            rest.scatter_(-1, i, -math.inf)
        top = torch.cat(top, dim=-1)
        snrs.append(s.gather(-1, top).double() * inv)
        idxs.append(top)
        del s, rest
    return (torch.stack(snrs, dim=-3), torch.stack(idxs, dim=-3),
            torch.stack(peaks, dim=-2))


def snr_topk(norm: torch.Tensor, widths: Tuple[int, ...], k: int,
             limit: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """``snr_topk_plain``'s results.  A CPU tensor runs it; a CUDA one
    launches ``snr_topk_kernel`` (a block a row, the row in shared memory,
    or its scan in a global scratch where it does not fit there,
    ``snr_topk_fits``: bit-equal, the same adds in the same order) on the
    current stream, counted in ``snr_topk.launches``.  On the card ``k``
    must lie in 1 to ``TOPK_MAX_K``: anything else is a ``ValueError``."""
    _check_rows("snr_topk", norm)
    if norm.device.type == "cpu":
        return snr_topk_plain(norm, widths, k, limit)
    return _topk_kernel(norm, widths, k, limit, normalize=False)


def _check_rows(name: str, rows: torch.Tensor) -> None:
    if rows.dtype != torch.float32 or rows.dim() != 3 \
            or not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous float32 "
                         f"[B, n_dm, T], got {rows.dtype} "
                         f"{tuple(rows.shape)}")


def _topk_kernel(rows: torch.Tensor, widths: Tuple[int, ...], k: int,
                 limit: np.ndarray,
                 normalize: bool) -> Tuple[torch.Tensor, ...]:
    """One ``snr_topk_kernel`` launch on the card's ``rows``, which it
    robust-normalizes first where ``normalize`` (``_normalize``'s
    arithmetic, counted in ``snr_topk.normalized`` too)."""
    b, n_dm, t = rows.shape
    _check_topk(k)
    n_w = len(widths)
    dev = rows.device
    scratch = None
    if not snr_topk_fits(t):
        scratch = torch.empty((min(b * n_dm, TOPK_SCRATCH_BLOCKS),
                               _topk_scan_floats(t)), dtype=torch.float32,
                              device=dev)
    w_t = torch.tensor(widths, dtype=torch.int32, device=dev)
    lim = _table(np.clip(limit, -1, t), dev)
    snr = torch.empty((b, n_w, n_dm, k), dtype=torch.float64, device=dev)
    idx = torch.empty((b, n_w, n_dm, k), dtype=torch.int64, device=dev)
    peak = torch.empty((b, n_w, n_dm), dtype=torch.float64, device=dev)
    _launch("dsabf_snr_topk",
            [rows.data_ptr(), w_t.data_ptr(), lim.data_ptr(), snr.data_ptr(),
             idx.data_ptr(), peak.data_ptr(), b, n_dm, t, n_w, k,
             int(normalize), None if scratch is None else scratch.data_ptr()],
            dev)
    snr_topk.launches += 1
    snr_topk.normalized += int(normalize)
    return snr, idx, peak


snr_topk.launches = 0
snr_topk.normalized = 0


def _topk_scan_floats(t: int) -> int:
    """Floats of a ``t``-sample row's scan (``topk_scan_floats``): the
    cumulative sum and the block totals of every level above it."""
    floats, level = t + 1, t
    while -(-level // _SCAN_BLOCK) > 1:
        level = -(-level // _SCAN_BLOCK)
        floats += level
    return -(-floats // 4) * 4


def snr_topk_fits(t: int) -> bool:
    """Whether a ``t``-sample row's scan fits ``snr_topk_kernel``'s shared
    memory (as ``topk_smem_bytes`` counts it) on the card's 227 KB."""
    return 4 * _topk_scan_floats(t) + TOPK_THREADS * TOPK_MAX_K * 8 \
        <= 227 * 1024


def _topk_scratch_bytes(t: int) -> int:
    """Device bytes of ``snr_topk``'s global scratch at ``t``-sample rows
    (none where a row's scan fits shared memory)."""
    return 0 if snr_topk_fits(t) else \
        4 * TOPK_SCRATCH_BLOCKS * _topk_scan_floats(t)


def _check_topk(k: int) -> None:
    """Refuse, before any work, a ``k`` that ``snr_topk_kernel`` cannot
    keep: outside 1 to ``TOPK_MAX_K``."""
    if not 1 <= k <= TOPK_MAX_K:
        raise ValueError(f"top-k on the card keeps 1 to {TOPK_MAX_K} peaks "
                         f"per (width, trial), got {k}")


def _normalize(bank: torch.Tensor) -> torch.Tensor:
    """Each trial series of ``bank`` ``[B, n_dm, T]`` robust-normalized
    (median / MAD, float32, as the reference), a new tensor."""
    med = _median_last(bank)[..., None]
    dev = bank - med
    mad = _median_last(dev.abs())[..., None]
    sigma = torch.clamp(mad * 1.4826, min=1e-30)
    return dev.div_(sigma)


def _snr_topk(bank: torch.Tensor, widths: Tuple[int, ...], k: int,
              limit: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """``snr_topk`` of the ``_normalize``d bank ``[B, n_dm, T]``: on the card
    one ``snr_topk_kernel`` launch that normalizes each row where it holds
    it (bit-equal: the same selections and float32 steps); on the CPU
    ``_normalize``, then ``snr_topk_plain``."""
    if bank.device.type == "cuda":
        _check_rows("_snr_topk", bank)
        return _topk_kernel(bank, widths, k, limit, normalize=True)
    return snr_topk(_normalize(bank), widths, k, limit)


@dataclasses.dataclass
class Candidate:
    """One clustered single-pulse detection (heimdall-style fields)."""

    snr: float           # best-member matched-filter S/N
    t_samp: int          # start sample of the best-member boxcar
    time_s: float        # t_samp * tsamp
    width: int           # best-member boxcar width [samples]
    dm_idx: int          # best-member trial index
    dm: float            # best-member trial DM [pc cm^-3]
    members: int         # raw (width, trial, peak) points merged in
    dm_lo: float         # DM extent of the cluster
    dm_hi: float
    beam: int = -1       # beam index (-1: single-target search)

    def row(self) -> str:
        return (f"{self.snr:8.2f} {self.t_samp:10d} {self.time_s:12.6f} "
                f"{self.width:6d} {self.dm_idx:7d} {self.dm:10.3f} "
                f"{self.members:8d} {self.dm_lo:10.3f} {self.dm_hi:10.3f} "
                f"{self.beam:5d}")

    HEADER = ("#    snr     t_samp       time_s  width  dm_idx         dm "
              "members      dm_lo      dm_hi  beam")


def _cluster(
    points: List[Tuple[float, int, int, int]],  # (snr, dm_idx, t, w)
    dms: np.ndarray,
    tsamp_s: float,
    band_span: np.ndarray,  # [n_dm] full-band delay sweep per trial
    dm_link: Optional[int] = None,
) -> List[Candidate]:
    """Greedy friends-of-friends merge, strongest point first: two points
    are one event iff their boxcars overlap within the differential
    dispersion smear between their trials (``dm_link`` optionally caps the
    trial gap)."""
    pts = sorted(points, key=lambda p: -p[0])
    out: List[Candidate] = []
    used = [False] * len(pts)
    for i, (snr, d, t, w) in enumerate(pts):
        if used[i]:
            continue
        used[i] = True
        members, d_lo, d_hi = 1, d, d
        for j in range(i + 1, len(pts)):
            if used[j]:
                continue
            _, dj, tj, wj = pts[j]
            pad = max(w, wj) + abs(int(band_span[d]) - int(band_span[dj]))
            if (tj < t + w + pad and t < tj + wj + pad
                    and (dm_link is None or abs(dj - d) <= dm_link)):
                used[j] = True
                members += 1
                d_lo, d_hi = min(d_lo, dj), max(d_hi, dj)
        out.append(Candidate(
            snr=float(snr), t_samp=int(t), time_s=float(t * tsamp_s),
            width=int(w), dm_idx=int(d), dm=float(dms[d]), members=members,
            dm_lo=float(dms[d_lo]), dm_hi=float(dms[d_hi])))
    return out


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """``[..., F, T]`` -> ``[..., T]``: each sample's float32 sum over the
    channels, one channel after another, the order in which NumPy sums the
    reference's ``x[:, keep].mean(axis=1)`` (its fancy-indexed operand is
    column-major, so the reduction runs channel by channel)."""
    acc = torch.zeros_like(x[..., 0, :])
    for c in range(x.shape[-2]):
        acc = acc + x[..., c, :]
    return acc


def preprocess_spectrogram(
    x,
    zap: Optional[Sequence[int]] = None,
    zerodm: bool = False,
) -> torch.Tensor:
    """RFI conditioning before dedispersion, a float32 copy of the
    ``[..., F, T]`` tensor (or array) ``x`` on its device: ``zap`` channels
    set to the constant 0; ``zerodm`` subtracts each time sample's mean over
    the kept channels (summed as NumPy sums, ``_channel_sum``) from the
    kept channels.  Per block equals whole stream: the zap fill is a
    constant and zero-DM is per sample."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32, copy=True)
    else:
        x = torch.from_numpy(np.array(x, np.float32))
    f = x.shape[-2]
    keep = torch.ones(f, dtype=torch.bool, device=x.device)
    if zap:
        zap = sorted(set(int(c) for c in zap))
        bad = [c for c in zap if not 0 <= c < f]
        if bad:
            raise ValueError(f"zap channels {bad} outside [0, {f})")
        keep[zap] = False
        if not bool(keep.any()):
            raise ValueError("zap spec removes every channel")
        x[..., ~keep, :] = 0.0
    if zerodm:
        kept = x[..., keep, :]
        mean = _channel_sum(kept) / kept.shape[-2]
        x[..., keep, :] = kept - mean[..., None, :]
    return x


def _bank(method: str, x: torch.Tensor, delays: np.ndarray, n_sub: int,
          rounded: bool) -> torch.Tensor:
    """The ``[B, n_dm, T]`` bank of the ``[B, F, T]`` window ``x`` by
    ``method``; ``rounded``: the conv fill's rounding (uint8 input)."""
    if method == "conv":
        return _conv_bank(x, delays, None, 1, rounded)
    if method == "subband":
        return _subband_bank(x, delays, min(n_sub, x.shape[1]))
    if method == "direct":
        _check_table(delays, x.shape[1])
        return _direct_bank(x, _fill(x, 1, False), delays)
    raise ValueError(f"method must be conv|direct|subband, got {method!r}")


def _limits(valid_len: np.ndarray, widths: Tuple[int, ...],
            own: Optional[int]) -> np.ndarray:
    """``[n_w, n_dm]``: how many leading boxcar starts of each (width,
    trial) a window searches, its data-covered extent less the boxcar,
    within the samples it owns (``own``; None: every one)."""
    w_arr = np.asarray(widths, np.int64)[:, None]
    lim = valid_len if own is None else np.minimum(valid_len, own)
    return np.minimum(valid_len[None, :] - w_arr + 1, lim[None, :])


def _threshold_points(
    snr: torch.Tensor,        # [B, n_w, n_dm, k]
    idx: torch.Tensor,
    widths: Tuple[int, ...],
    limit: np.ndarray,        # [n_w, n_dm], _limits
    t_offset: int,
    threshold: float,
) -> List[List[tuple]]:
    """Thresholding of the top-k grid into each beam's raw candidate points
    ``(snr, dm_idx, t, width)``, in the grid's order, each (width, trial)
    limited to the boxcar starts ``limit`` allows: the mask is made on the
    grid's device and only the points cross to the host."""
    lim = torch.as_tensor(limit, device=snr.device)
    mask = (snr >= threshold) & (idx < lim[None, :, :, None])
    where = torch.nonzero(mask).cpu().numpy()
    vals = snr[mask].cpu().numpy()
    ts = idx[mask].cpu().numpy()
    out: List[List[tuple]] = [[] for _ in range(snr.shape[0])]
    for (bi, wi, d, _), v, t in zip(where, vals, ts):
        out[bi].append((float(v), int(d), int(t) + t_offset,
                        int(widths[wi])))
    return out


def _search_group(
    x: torch.Tensor,          # [B, F, T] window of a beam group
    delays: np.ndarray,
    widths: Tuple[int, ...],
    threshold: float,
    topk: int,
    own: Optional[int],       # samples owned by this window (None = final)
    t_offset: int,            # absolute sample index of the window's first
    method: str,
    n_sub: int,
    rounded: bool,
) -> tuple:
    """One window of a beam group: bank, normalization and top-k on the
    window's device (``dsabf.search.bank``, ``dsabf.search.topk``), the
    threshold's points to the host; returns ``(each beam's raw points,
    peak [B, n_w, n_dm] on the device)``."""
    t = x.shape[2]
    with annotate("dsabf.search.bank"):
        bank = _bank(method, x, delays, n_sub, rounded)
    limit = _limits(_valid_len(delays, t), widths, own)
    with annotate("dsabf.search.topk"):
        snr, idx, peak = _snr_topk(bank, widths,
                                   min(topk, t - max(widths) + 1), limit)
        del bank
        points = _threshold_points(snr, idx, widths, limit, t_offset,
                                   threshold)
    return points, peak


def _search_chunk_batch(
    chunk: torch.Tensor,      # [B, F, T_ext] float32 host beam group
    delays: np.ndarray,
    dms: np.ndarray,
    tsamp_s: float,
    band_span: np.ndarray,
    widths: Tuple[int, ...],
    threshold: float,
    topk: int,
    own: Optional[int],       # samples owned by this window (None = final)
    t_offset: int,            # absolute sample index of the chunk's first
    dm_link: Optional[int],
    method: str,
    n_sub: int,
    device: torch.device,
) -> List[List[Candidate]]:
    """One search window of a beam group: one batched bank and top-k on the
    device, thresholding, ownership gate and clustering per beam on the
    host."""
    points, _peak = _search_group(
        chunk.to(device), delays, widths, threshold, topk, own, t_offset,
        method, n_sub, rounded=False)
    dms = np.asarray(dms)
    return [_cluster(p, dms, tsamp_s, band_span, dm_link) for p in points]


def search_spectrogram(
    power_tf: np.ndarray,
    freqs_mhz: np.ndarray,
    tsamp_s: float,
    dms: np.ndarray,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    threshold: float = 7.0,
    chunk_t: int = 16384,
    topk: int = 4,
    dm_link: Optional[int] = None,
    zap: Optional[Sequence[int]] = None,
    zerodm: bool = False,
    method: str = "direct",
    n_sub: int = 64,
    device="cuda",
) -> List[Candidate]:
    """Search an ascending-frequency ``[T, F]`` dynamic spectrum for
    dispersed single pulses over DM trials ``dms``.

    Long observations go in chunks of ``chunk_t`` output samples, each
    extended by ``max_delay + max_width`` so that a pulse across a boundary
    is wholly inside one chunk (the extension is searched in the earlier
    chunk only).  Returns candidates sorted by S/N, strongest first (beam
    -1: ``search_spectrograms`` of the one spectrum).
    """
    return search_spectrograms(
        [(-1, power_tf)], freqs_mhz, tsamp_s, dms, widths=widths,
        threshold=threshold, chunk_t=chunk_t, topk=topk, dm_link=dm_link,
        zap=zap, zerodm=zerodm, method=method, n_sub=n_sub, beam_batch=1,
        device=device)[-1]


def search_spectrograms(
    spectra: Sequence[Tuple[int, np.ndarray]],
    freqs_mhz: np.ndarray,
    tsamp_s: float,
    dms: np.ndarray,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    threshold: float = 7.0,
    chunk_t: int = 16384,
    topk: int = 4,
    dm_link: Optional[int] = None,
    zap: Optional[Sequence[int]] = None,
    zerodm: bool = False,
    method: str = "direct",
    n_sub: int = 64,
    beam_batch: Optional[int] = None,
    device="cuda",
) -> dict:
    """Multi-beam ``search_spectrogram``: ``spectra`` is ``[(beam_label,
    [T, F]), ...]`` of one shape; returns ``{beam_label: [Candidate, ...]}``
    with each candidate's ``beam`` set.  Beams go ``beam_batch`` at a time
    through the batched bank and top-k (None: as many as ``_beam_group``
    sizes at a chunk's window, the live monitor's rule)."""
    if not spectra:
        raise ValueError("no spectra to search")
    labels = [b for b, _ in spectra]
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate beam labels: {sorted(labels)}")
    shapes = {x.shape for _, x in spectra}
    if len(shapes) != 1:
        raise ValueError(
            f"beam spectra shapes differ ({sorted(shapes)}): batched "
            f"search needs one [T, F] shape across beams")
    dev = resolve_device(device)
    xs = preprocess_spectrogram(
        np.stack([x for _, x in spectra]).transpose(0, 2, 1), zap,
        zerodm)  # [B, F, T]
    b, f, t_total = xs.shape
    delays = delay_table(freqs_mhz, dms, tsamp_s)
    widths = tuple(int(w) for w in widths)
    max_w = max(widths)
    overlap = int(delays.max()) + max_w
    band_span = delays.max(axis=1)
    if beam_batch is None:
        t_w = min(chunk_t + overlap, t_total)
        beam_batch = _beam_group(b, f, t_w, delays, method, n_sub, dev,
                                 upload=4 * f * t_w)
    by_beam: dict = {lab: [] for lab in labels}
    start = 0
    while start < t_total:
        stop = min(start + chunk_t, t_total)
        ext_stop = min(stop + overlap, t_total)
        # A chunk whose extension reaches the end owns every sample left.
        final = ext_stop >= t_total
        chunk = xs[..., start:ext_stop]
        if chunk.shape[2] <= max_w:
            break
        for g0 in range(0, b, beam_batch):
            per_beam_cands = _search_chunk_batch(
                chunk[g0:g0 + beam_batch], delays, dms, tsamp_s,
                band_span, widths, threshold, topk,
                own=None if final else (stop - start), t_offset=start,
                dm_link=dm_link, method=method, n_sub=n_sub, device=dev)
            for bi, cs in enumerate(per_beam_cands):
                lab = labels[g0 + bi]
                for c in cs:
                    c.beam = lab
                by_beam[lab].extend(cs)
        if final:
            break
        start = stop
    for cs in by_beam.values():
        cs.sort(key=lambda c: -c.snr)
    return by_beam


def coincidence_filter(
    cands_by_beam: dict,
    band_span: np.ndarray,
    n_beams_searched: int,
    frac: float = 0.25,
    min_beams: int = 3,
) -> Tuple[dict, List[dict]]:
    """Cross-beam coincidence RFI rejection: candidates of all beams are
    linked with the in-beam clustering rule; a linked cluster seen in
    ``>= max(min_beams, ceil(frac * n_beams_searched))`` distinct beams is
    tagged RFI and removed.  Returns ``(kept_by_beam, rfi_events)``, each
    event the rejected cluster's brightest member and ``n_beams``."""
    if not 0 < frac <= 1:
        raise ValueError(f"frac must be in (0, 1], got {frac}")
    thresh = max(min_beams, int(np.ceil(frac * n_beams_searched)))
    pts = [(c, b) for b, cs in cands_by_beam.items() for c in cs]
    pts.sort(key=lambda p: -p[0].snr)
    if not pts:
        return dict(cands_by_beam), []
    # A pair links only within max(width) + the largest smear difference,
    # so each seed tests a time window of candidates, not every pair.
    t_arr = np.array([p[0].t_samp for p in pts], np.int64)
    w_max = int(max(p[0].width for p in pts))
    span_max = (int(band_span.max() - band_span.min())
                if len(band_span) else 0)
    order = np.argsort(t_arr, kind="stable")
    t_sorted = t_arr[order]
    reach = 2 * w_max + span_max
    used = [False] * len(pts)
    rfi_members: set = set()
    rfi_events: List[dict] = []
    for i, (c, b) in enumerate(pts):
        if used[i]:
            continue
        used[i] = True
        cluster = [i]
        lo = np.searchsorted(t_sorted, c.t_samp - reach, "left")
        hi = np.searchsorted(t_sorted, c.t_samp + c.width + reach, "right")
        for j in order[lo:hi]:
            if used[j]:
                continue
            cj = pts[j][0]
            pad = (max(c.width, cj.width)
                   + abs(int(band_span[c.dm_idx])
                         - int(band_span[cj.dm_idx])))
            if (cj.t_samp < c.t_samp + c.width + pad
                    and c.t_samp < cj.t_samp + cj.width + pad):
                used[j] = True
                cluster.append(int(j))
        beams_hit = {pts[k][1] for k in cluster}
        if len(beams_hit) >= thresh:
            rfi_members.update(cluster)
            rfi_events.append({
                "snr": round(c.snr, 2), "dm": round(c.dm, 3),
                "t_samp": c.t_samp, "width": c.width,
                "n_beams": len(beams_hit),
                "members": sum(pts[k][0].members for k in cluster),
            })
    rfi_ids = {id(pts[k][0]) for k in rfi_members}
    kept = {b: [c for c in cs if id(c) not in rfi_ids]
            for b, cs in cands_by_beam.items()}
    return kept, rfi_events


@dataclasses.dataclass
class SearchWindow:
    """What one searched window of a ``SearchMonitor`` gives its caller."""

    #: ``(seq, absolute index of its first sample)`` of each block with
    #: samples in the window, in order.
    blocks: List[Tuple[int, int]]
    t_base: int             # absolute sample index of its first sample
    n_samples: int          # samples searched
    own: Optional[int]      # samples it owns from t_base (None: all)
    beams: List[int]        # beam of each row of ``peaks`` (-1: incoherent)
    group: int              # rows searched together (the last group: the rest)
    #: ``[B, n_w, n_dm]`` float64: each beam's peak S/N per (width, DM
    #: trial) over the boxcar starts the window owns, -inf where none.
    peaks: np.ndarray
    #: Each beam's candidates before the cross-beam coincidence veto.
    found: dict

    @property
    def seqs(self) -> Tuple[int, int]:
        """The first and last block with samples in the window."""
        return self.blocks[0][0], self.blocks[-1][0]


def _group_bytes(n_chan: int, t: int, delays: np.ndarray, method: str,
                 n_sub: int) -> tuple:
    """``(fixed, per beam)`` device bytes of a beam group at a ``t``-sample
    window.  Per beam: 6 bank-sized float32 buffers, of which the
    ``[n_dm, T]`` bank is the only one held: the top-k kernel normalizes
    each row in its shared memory, with no temporary beside the bank.  The
    other 5, the torch normalization's temporaries, are kept as a margin on
    purpose: they keep a window's beam groups, and so their schedule over
    the drains, as the torch normalization sized them.  Fixed: the top-k's scratch (``_topk_scratch_bytes``) and what makes a
    bank, one ``_stage1_beams`` chunk's padded operand and stage-1 planes
    (a direct bank's operand, per beam)."""
    n_dm = delays.shape[0]
    per = 6 * 4 * n_dm * t
    scratch = _topk_scratch_bytes(t)
    if method == "direct":
        return scratch, per + 4 * n_chan * (t + int(delays.max()) + 4)
    n = _conv_auto_n_sub(delays) if method == "conv" else min(n_sub, n_chan)
    plan = _conv_plan(delays, n, 1)
    intra_c, inter, _, _ = plan
    g, j, c = intra_c.shape
    t1 = t + int(inter.max())
    chunk = 4 * g * c * (t1 + int(intra_c.max()) + 4) + 4 * g * j * t1
    return scratch + _stage1_beams(plan, t) * chunk, per


def _beam_group(n_beams: int, n_chan: int, t: int, delays: np.ndarray,
                method: str, n_sub: int, device: torch.device,
                reserve: float = 0, upload: int = 0) -> int:
    """Beams to search together at a ``t``-sample window (``_group_bytes``
    a beam, plus the ``upload`` bytes of its window where the group's
    window is put on the device with it): on the card as many as 80% of its
    free memory holds, less ``reserve`` bytes still to be allocated; on the
    CPU as many as 256 MB holds."""
    fixed, per = _group_bytes(n_chan, t, delays, method, n_sub)
    per += upload
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        free += torch.cuda.memory_reserved(device) \
            - torch.cuda.memory_allocated(device)
        budget = 0.8 * (free - reserve) - fixed
    else:
        budget = 256e6
    return max(1, min(n_beams, int(budget // per)))


@dataclasses.dataclass
class _PendingWindow:
    """The window a ``SearchMonitor`` is searching, group by group."""

    n: int                   # its samples, the first held
    own: Optional[int]
    t_base: int
    beams: int
    group: int               # beams a group
    n_groups: int
    rounded: bool            # the conv fill rounded (``_bank``)
    per_block: int = 0       # groups searched after each block
    g0: int = 0              # the next group's first beam
    points: list = dataclasses.field(default_factory=list)
    peaks: list = dataclasses.field(default_factory=list)


class SearchMonitor:
    """Streaming single-pulse search over the beamformer's own product
    blocks: the live FRB trigger.

    The streaming loop hands it each drained block; it appends the searched
    beams (one beam, a beam set, ``beam="all"``, or the incoherent sum) to
    a rolling ``[B, F, T]`` window held on ``device``, uint8 where the
    blocks are 8-bit counts, and whenever ``chunk_t`` owned samples have
    accumulated it searches them extended by ``max_delay + max_width``
    carried samples: the offline chunk loop's windowing, so a pulse across
    block or window boundaries is found once.  A window's bank operand is
    built on the device from the window, in beam groups sized to the
    device's free memory (``beam_batch`` fixes the size instead); only
    the candidates' points and the window's peaks (``SearchWindow``, to
    ``on_window``) cross to the host.  Beam sets run cross-beam coincidence
    RFI rejection over every searched beam of the window.  A sequence gap
    flushes the window through a final-owned search and restarts it
    (``gaps`` counts them).

    Two ways in, one result: ``observe(seq, powers, inco)`` takes the whole
    ``[F, T, B]`` (or ``[F, T, 4, B]``) product as the reference's monitor
    does; the streaming loop instead takes ``select_beams`` of the product
    on the device and hands the selection to ``observe_selected``, with no
    copy to the host.  Windows are searched on ``device`` (the card unless
    the caller names another).
    """

    def __init__(
        self,
        freqs_mhz: np.ndarray,
        tsamp_s: float,
        dms: np.ndarray,
        *,
        beam=0,
        incoherent: bool = False,
        widths: Sequence[int] = DEFAULT_WIDTHS,
        threshold: float = 7.0,
        chunk_t: int = 4096,
        topk: int = 4,
        dm_link: Optional[int] = None,
        zap: Optional[Sequence[int]] = None,
        zerodm: bool = False,
        method: str = "conv",
        n_sub: int = 64,
        beam_batch: Optional[int] = None,
        on_candidate=None,
        coincidence: bool = True,
        coincidence_frac: float = 0.25,
        on_rfi=None,
        on_window=None,
        device="cuda",
    ):
        if method not in ("conv", "direct", "subband"):
            raise ValueError(
                f"method must be conv|direct|subband, got {method!r}")
        self.device = resolve_device(device)
        self.freqs_mhz = np.asarray(freqs_mhz, np.float64)
        self.tsamp_s = float(tsamp_s)
        self.dms = np.asarray(dms, np.float64)
        # One beam index, a set of indices, or "all" (labels resolved from
        # the first product).
        if isinstance(beam, str) and beam.strip().lower() == "all":
            self._beam_sel = "all"
            self.beam = -1
        elif isinstance(beam, (list, tuple, np.ndarray)):
            sel = [int(b) for b in beam]
            if not sel:
                raise ValueError("empty beam set")
            if len(sel) != len(set(sel)):
                raise ValueError(f"duplicate beams in {sel}")
            if len(sel) == 1:
                self._beam_sel = None
                self.beam = sel[0]
            else:
                self._beam_sel = sel
                self.beam = -1
        else:
            self._beam_sel = None
            self.beam = int(beam)
        self._labels: Optional[List[int]] = (
            self._beam_sel if isinstance(self._beam_sel, list) else None)
        self.coincidence = bool(coincidence)
        if not 0 < coincidence_frac <= 1:
            raise ValueError(
                f"coincidence_frac must be in (0, 1], got {coincidence_frac}")
        self.coincidence_frac = float(coincidence_frac)
        self.on_rfi = on_rfi
        self.rfi_rejected = 0
        self.incoherent = bool(incoherent)
        if self.incoherent and self._beam_sel is not None:
            raise ValueError("incoherent target is a single spectrogram; "
                             "beam sets/'all' don't apply")
        self.widths = tuple(int(w) for w in widths)
        self.threshold = float(threshold)
        self.topk = int(topk)
        self.dm_link = dm_link
        self.zap = tuple(int(c) for c in zap) if zap else None
        self.zerodm = bool(zerodm)
        self.method = method
        self.n_sub = int(n_sub)
        if beam_batch is not None and beam_batch < 1:
            raise ValueError(f"beam_batch must be >= 1, got {beam_batch}")
        self.beam_batch = beam_batch
        self.on_candidate = on_candidate
        self.on_window = on_window
        self.delays = delay_table(self.freqs_mhz, self.dms, self.tsamp_s)
        self.band_span = self.delays.max(axis=1)
        self.max_w = max(self.widths)
        self.overlap = int(self.delays.max()) + self.max_w
        self.chunk_t = int(chunk_t)
        if self.chunk_t < self.max_w:
            raise ValueError(
                f"chunk_t {chunk_t} shorter than the widest boxcar "
                f"{self.max_w}")
        if self.device.type == "cuda":
            _check_topk(min(self.topk, self.window_t - self.max_w + 1))
        self.candidates: List[Candidate] = []
        self.gaps = 0
        self.searched_windows = 0
        self.last_window: Optional[SearchWindow] = None
        self._win: Optional[torch.Tensor] = None   # [B, F, capacity]
        self._buffered = 0    # samples held in _win
        self._t_base = 0      # absolute sample index of _win's first
        self._blocks: collections.deque = collections.deque()  # (seq, t0)
        self._next_seq: Optional[int] = None
        self._pending: Optional[_PendingWindow] = None
        self._groups: dict = {}   # (beams, channels, samples) -> group

    @classmethod
    def for_stream(cls, cfg, dm_max: float, **kw) -> "SearchMonitor":
        """The live monitor of a stream of ``cfg`` (an ``ObsConfig``): its
        output channels' centres, its output sample period and the trial
        grid from 0 to ``dm_max`` at the default tolerance; ``kw`` as the
        constructor's."""
        from dsabeamformer_tpu_torch.ingest.sigproc import _avg_freqs_mhz

        freqs = _avg_freqs_mhz(cfg)
        tsamp = cfg.sample_period_s * cfg.navg_time
        dms = dm_trial_grid(float(freqs.min()), float(freqs.max()), tsamp,
                            dm_max=dm_max)
        return cls(freqs, tsamp, dms, **kw)

    @property
    def wants_beams(self) -> bool:
        """True when the monitor reads the beam product (the streaming loop
        then brings its beams back even with no sink attached)."""
        return not self.incoherent

    @property
    def window_t(self) -> int:
        """Samples in a full window: ``chunk_t`` owned plus the carry."""
        return self.chunk_t + self.overlap

    def select_beams(self, powers: torch.Tensor) -> torch.Tensor:
        """The searched beams of one ``[F, T, B]`` (or ``[F, T, 4, B]``,
        plane I) product block, on its device and in its dtype:
        ``[B_sel, T, F]`` for a beam set, ``[T, F]`` for one beam.  ``"all"``
        takes its labels from the first block."""
        if powers.dim() == 4:
            powers = powers[:, :, 0]  # Stokes I plane
        nb = powers.shape[-1]
        if self._beam_sel is not None:
            if self._labels is None:  # "all": resolve on the first block
                self._labels = list(range(nb))
            bad = [b for b in self._labels if not 0 <= b < nb]
            if bad:
                raise ValueError(f"search beams {bad} out of range "
                                 f"(product has {nb})")
            sel = powers if self._labels == list(range(nb)) \
                else powers[:, :, self._labels]
            return sel.permute(2, 1, 0).contiguous()
        if not 0 <= self.beam < nb:
            raise ValueError(f"search beam {self.beam} out of range "
                             f"(product has {nb})")
        return powers[:, :, self.beam].T.contiguous()

    def _condition(self, sel, inco) -> torch.Tensor:
        """One block as the window holds it, ``[B, F, T]`` on ``device``:
        the selection (``[B_sel, T, F]`` or ``[T, F]``, a tensor or an
        array) or the incoherent sum ``[F, T]``; uint8 counts stay uint8
        unless conditioned (``preprocess_spectrogram``'s zap / zero-DM),
        anything else is float32."""
        if self.incoherent:
            if inco is None:
                raise ValueError("search monitor targets the incoherent "
                                 "sum but the pipeline has no incoherent "
                                 "product enabled")
            x = torch.as_tensor(inco, device=self.device)[None]
        else:
            x = torch.as_tensor(sel, device=self.device)
            if x.dim() == 2:
                x = x[None]
            x = x.transpose(1, 2)
        if self.zap or self.zerodm:
            return preprocess_spectrogram(x, self.zap, self.zerodm)
        return x if x.dtype == torch.uint8 and not self.incoherent \
            else x.to(torch.float32)

    def observe(self, seq: int, powers: Optional[np.ndarray],
                inco: Optional[np.ndarray] = None) -> None:
        """Take one drained block: the whole product (``[F, T, B]`` or
        ``[F, T, 4, B]``, or None for an incoherent target) and the
        incoherent sum ``[F, T]``."""
        sel = None
        if not self.incoherent:
            if powers is None:
                raise ValueError("search monitor needs the beam product")
            sel = self.select_beams(
                torch.from_numpy(np.ascontiguousarray(powers)))
        self._push(seq, self._condition(sel, inco))

    def observe_selected(self, seq: int, sel, inco=None) -> None:
        """Take one drained block as ``select_beams`` of its product (a
        device tensor from the loop, or an array; None for an incoherent
        target) and the incoherent sum ``[F, T]``."""
        self._push(seq, self._condition(sel, inco))

    def _push(self, seq: int, x: torch.Tensor) -> None:
        if self._next_seq is not None and seq != self._next_seq:
            self.gaps += 1
            self.flush()
            self._t_base += self.overlap  # nominal; times stay per-run
        self._next_seq = seq + 1
        with annotate("dsabf.search.append"):
            self._append(seq, x)
        self._step(x.shape[2])

    def _append(self, seq: int, x: torch.Tensor) -> None:
        """Copy a ``[B, F, t]`` block behind the held samples, growing (or
        widening to float32) the window where it has to: it holds a window
        being searched and the next window's samples behind it."""
        n, held, win = x.shape[2], self._buffered, self._win
        if held and tuple(win.shape[:2]) != tuple(x.shape[:2]):
            raise ValueError(f"block of {tuple(x.shape[:2])} beams x "
                             f"channels after {tuple(win.shape[:2])}")
        dtype = x.dtype if not held else torch.promote_types(win.dtype,
                                                             x.dtype)
        if win is None or win.shape[2] < held + n or win.dtype != dtype \
                or tuple(win.shape[:2]) != tuple(x.shape[:2]):
            cap = max(held + n, self.window_t + self.chunk_t + n)
            grown = torch.empty((*x.shape[:2], cap), dtype=dtype,
                                device=self.device)
            if held:
                grown[..., :held] = win[..., :held]
            self._win = win = grown
        win[..., held:held + n] = x
        self._blocks.append((seq, self._t_base + held))
        self._buffered = held + n

    def _concat(self) -> Optional[torch.Tensor]:
        """The held samples, ``[B, F, T]`` (a view of the window)."""
        if self._win is None:
            return None
        return self._win[..., : self._buffered]

    def _drop(self, n: int) -> None:
        """Forget the first ``n`` held samples: the rest move to the front
        of the window, in pieces no longer than ``n`` so that no piece
        overlaps its own destination."""
        rest = self._buffered - n
        for a in range(0, rest, n):
            b = min(a + n, rest)
            self._win[..., a:b] = self._win[..., n + a:n + b]
        self._buffered = rest
        self._t_base += n
        while len(self._blocks) > 1 and self._blocks[1][1] <= self._t_base:
            self._blocks.popleft()

    def _emit(self, cands: List[Candidate]) -> None:
        self.searched_windows += 1
        for c in cands:
            self.candidates.append(c)
            if self.on_candidate is not None:
                self.on_candidate(c)

    def _group(self, n_beams: int, n_chan: int, t: int) -> int:
        """Beams searched together: ``beam_batch``, or ``_beam_group``'s
        count, less the window's own bytes where it is still to be made.
        Worked out once for each window shape (``warmup`` does so before a
        stream), so that every window asks the memory pool for the blocks
        it kept."""
        if self.beam_batch is not None:
            return min(self.beam_batch, n_beams)
        key = (n_beams, n_chan, t)
        if key not in self._groups:
            reserve = 0 if self._win is not None else \
                n_beams * n_chan * (self.window_t + 2 * self.chunk_t)
            self._groups[key] = _beam_group(
                n_beams, n_chan, t, self.delays, self.method, self.n_sub,
                self.device, reserve)
        return self._groups[key]

    def _step(self, block_t: int) -> None:
        """After a block of ``block_t`` samples: go on with the window being
        searched, as many beam groups as keep it ahead of the next window
        (all of them by the time ``chunk_t`` more samples have come), and
        start the next window once its samples are held.  A window's groups
        are so spread over the blocks that fill the next one; the drain
        that completes a window clusters it."""
        while True:
            p = self._pending
            if p is None:
                if self._buffered < self.window_t:
                    return
                p = self._start(own=self.chunk_t)
                p.per_block = -(-p.n_groups * block_t // self.chunk_t)
            if self._buffered >= p.n + self.chunk_t:
                self._finish()      # the next window is due: no more delay
                continue
            self._search_groups(p.per_block)
            if p.g0 < p.beams:
                return
            self._finish()

    def _start(self, own: Optional[int]) -> "_PendingWindow":
        """Take the first ``window_t`` held samples (or, final, all) as the
        window being searched."""
        n = self.window_t if own is not None else self._buffered
        b, f = self._win.shape[:2]
        g = self._group(b, f, n)
        # The conv fill of a single target's 8-bit counts is rounded, as
        # the reference's is for uint8 input.
        rounded = self._beam_sel is None and self._win.dtype == torch.uint8
        self._pending = _PendingWindow(n=n, own=own, t_base=self._t_base,
                                       beams=b, group=g, n_groups=-(-b // g),
                                       rounded=rounded)
        return self._pending

    def _search_groups(self, n_groups: int) -> None:
        """Search up to ``n_groups`` more beam groups of the window being
        searched."""
        p = self._pending
        if p.g0 >= p.beams or n_groups <= 0:
            return
        with annotate("dsabf.search.window"):
            window = self._win[..., : p.n]
            for _ in range(n_groups):
                if p.g0 >= p.beams:
                    break
                pts, peak = _search_group(
                    window[p.g0:p.g0 + p.group], self.delays, self.widths,
                    self.threshold, self.topk, p.own, p.t_base, self.method,
                    self.n_sub, p.rounded)
                p.points.extend(pts)
                p.peaks.append(peak.cpu())
                p.g0 += p.group

    def _finish(self) -> None:
        """Search the window's remaining groups, cluster its beams, run the
        coincidence veto over all of them, emit its candidates and
        ``SearchWindow``, and drop the samples it owned."""
        p = self._pending
        self._search_groups(p.beams)
        with annotate("dsabf.search.window"):
            self._emit(self._close(p))
        self._pending = None
        if p.own is None:
            return
        self._drop(self.chunk_t)

    def _close(self, p: "_PendingWindow") -> List[Candidate]:
        single = self._beam_sel is None
        labels = [-1 if self.incoherent else self.beam] if single \
            else list(self._labels)
        with annotate("dsabf.search.cluster"):
            by_beam = {}
            for lab, pts in zip(labels, p.points):
                cs = _cluster(pts, self.dms, self.tsamp_s, self.band_span,
                              self.dm_link)
                for c in cs:
                    c.beam = lab
                by_beam[lab] = cs
            found = {lab: list(cs) for lab, cs in by_beam.items()}
            if single:
                out = by_beam[labels[0]]
            else:
                if self.coincidence:
                    by_beam, events = coincidence_filter(
                        by_beam, self.band_span,
                        n_beams_searched=len(labels),
                        frac=self.coincidence_frac)
                    self.rfi_rejected += len(events)
                    if self.on_rfi is not None:
                        for ev in events:
                            self.on_rfi(ev)
                out = [c for cs in by_beam.values() for c in cs]
                out.sort(key=lambda c: -c.snr)
        self.last_window = SearchWindow(
            blocks=[(q, t0) for q, t0 in self._blocks
                    if t0 < p.t_base + p.n],
            t_base=p.t_base, n_samples=p.n,
            own=p.own, beams=labels, group=p.group,
            peaks=torch.cat(p.peaks).numpy(),
            found=found)
        if self.on_window is not None:
            self.on_window(self.last_window)
        return out

    def flush(self) -> None:
        """Finish the window being searched, search whatever remains (the
        final window owns everything its data covers), then reset the
        window.  Called at the end of a stream and on a sequence gap."""
        if self._pending is not None:
            self._finish()
        while self._buffered >= self.window_t:
            self._start(own=self.chunk_t)
            self._finish()
        if self._buffered > self.max_w:
            self._start(own=None)
            self._finish()
        self._t_base += self._buffered
        self._buffered = 0
        self._blocks.clear()

    def warmup(self, n_beams: int, n_chan: int, dtype=torch.uint8) -> None:
        """Search one all-zero full window of ``n_beams`` x ``n_chan`` once,
        leaving no trace in the monitor: builds the bank kernels, makes the
        plan and sizes the device's memory pool before a live stream, so
        that its first window costs what every later one does."""
        b = 1 if self._beam_sel is None else \
            len(self._labels) if self._labels is not None else n_beams
        g = self._group(b, n_chan, self.window_t)
        zero = torch.zeros((b, n_chan, self.window_t), dtype=dtype,
                           device=self.device)
        for g0 in range(0, b, g):
            _search_group(zero[g0:g0 + g], self.delays, self.widths,
                          self.threshold, self.topk, self.chunk_t, 0,
                          self.method, self.n_sub, rounded=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def write_candidates(path, cands: Sequence[Candidate], meta: dict) -> None:
    """Write a heimdall-style whitespace-column candidate file with a
    ``#``-comment header recording the search parameters."""
    with open(path, "w") as fh:
        for k, v in sorted(meta.items()):
            fh.write(f"# {k} = {v}\n")
        fh.write(Candidate.HEADER + "\n")
        for c in cands:
            fh.write(c.row() + "\n")


def read_candidates(path) -> Tuple[dict, List[Candidate]]:
    """Parse a ``write_candidates`` file back into ``(meta, cands)``: meta
    values restored to int / float where they parse as one; rows without the
    ``beam`` column load with ``beam=-1``."""
    meta: dict = {}
    cands: List[Candidate] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                key, sep, val = line[1:].partition(" = ")
                if sep:
                    val = val.strip()
                    for conv in (int, float):
                        try:
                            val = conv(val)
                            break
                        except ValueError:
                            pass
                    meta[key.strip()] = val
                continue  # the column-header line has no " = "
            f = line.split()
            if len(f) not in (9, 10):
                raise ValueError(f"{path}: expected 9/10 columns, got "
                                 f"{len(f)}: {line!r}")
            cands.append(Candidate(
                snr=float(f[0]), t_samp=int(f[1]), time_s=float(f[2]),
                width=int(f[3]), dm_idx=int(f[4]), dm=float(f[5]),
                members=int(f[6]), dm_lo=float(f[7]), dm_hi=float(f[8]),
                beam=int(f[9]) if len(f) == 10 else -1))
    return meta, cands
