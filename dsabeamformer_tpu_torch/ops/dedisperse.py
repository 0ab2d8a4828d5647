"""Multi-DM incoherent dedispersion search over beam products.

The same search as ``dsabeamformer_tpu/ops/dedisperse.py``: a brute-force
or two-stage DM-trial bank, robust per-trial normalization, boxcar matched
filters, top-k extraction per (width, trial), then host-side thresholding,
clustering and cross-beam coincidence.  The live ``SearchMonitor`` runs it
over the streaming loop's own products.

Host half (NumPy, as in the JAX package): the trial grid, the delay table,
the subband plan, the conv plan and its tail fill, clustering, coincidence,
preprocessing and the candidate files.

Device half: every bank method runs on one hand-written CUDA library,
``csrc/dedisperse.cu`` (``dedisperse_direct``, ``subband_stage1``,
``subband_stage2``), which replaces the reference's XLA gathers
(``_dedisperse_jit`` and ``_subband_jit``, ``dsabeamformer_tpu/ops/
dedisperse.py:156`` and ``:179``).  ``method="conv"`` keeps the reference's
contract (automatic group count, a tail fill from a 512-row subsample, that
fill rounded for uint8 input, ``valid_len``) and computes the two-stage bank
on its plan with the same two subband kernels; the reference's one-hot
convolution is a TPU device and has no counterpart here.  Each kernel has a
plain PyTorch version beside it (a loop of shifted adds in the kernel's
order) that a CPU tensor runs; the normalization and top-k are torch ops.

The delay curve is ``config.dm_delays_s`` (referenced to the top of the
band), shared with the pulse generator.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import DM_CONST_S, dm_delays_s
from dsabeamformer_tpu_torch.ops._build import load_library
from dsabeamformer_tpu_torch.utils.device import resolve_device

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
        for fn in (lib.dsabf_dedisperse_direct, lib.dsabf_subband_stage1,
                   lib.dsabf_subband_stage2):
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


def _padded_columns(x: np.ndarray, fill: np.ndarray, t_pad: int,
                    pad_f: int, device: torch.device) -> torch.Tensor:
    """``[B, F + pad_f, T_pad]`` float32 on ``device``: the ``[B, T, F]``
    window (any real dtype, uploaded as it is and cast there), its tail
    filled with ``fill`` ``[B, F]``, zero channels appended, each channel's
    time series contiguous."""
    b, t, f = x.shape
    xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    fd = torch.from_numpy(np.ascontiguousarray(fill, np.float32)).to(device)
    cols = torch.empty((b, f + pad_f, t_pad), dtype=torch.float32,
                       device=device)
    cols[:, :f, :t] = xd.transpose(1, 2)
    cols[:, :f, t:] = fd[:, :, None]
    cols[:, f:] = 0.0
    return cols


def _table(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _direct_bank(x: np.ndarray, fill: np.ndarray, delays: np.ndarray,
                 device) -> torch.Tensor:
    dev = resolve_device(device)
    t = x.shape[1]
    p = _padded_columns(x, fill, t + int(delays.max()), 0, dev)
    return dedisperse_direct(p, _table(delays, dev), t)


def _two_stage_bank(x: np.ndarray, fill: np.ndarray, plan,
                    device) -> torch.Tensor:
    """The two-stage bank of ``x`` ``[B, T, F]`` on ``plan`` (``subband_plan``'s
    tuple): stage 1 on the groups, stage 2 at each trial's offsets."""
    dev = resolve_device(device)
    intra_c, inter, rep_of, pad_f = plan
    g, n_coarse, c = intra_c.shape
    b, t, _ = x.shape
    t1 = t + int(inter.max())
    t_pad = t1 + (int(intra_c.max()) if intra_c.size else 0)
    p = _padded_columns(x, fill, t_pad, pad_f, dev).view(b, g, c, t_pad)
    s = subband_stage1(p, _table(intra_c, dev), t1)
    # flat offset of (group g, trial d) in group g's [J * t1] stage-1 plane
    offsets = rep_of[None, :] * t1 + inter.T                      # [G, n_dm]
    return subband_stage2(s, _table(offsets, dev), t)


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


def _conv_bank_prep(power_btf: np.ndarray, delays: np.ndarray,
                    n_sub: int, max_err_samples: int):
    """Host prep of the conv method, as the reference's: validate, plan
    (cached), and the tail fill from a subsample of at most 512 rows (the
    per-channel median; rounded to an integer for uint8 input).  Returns
    ``(plan, fill [B, F], valid_len)``."""
    b, t, f = power_btf.shape
    _check_table(delays, f)
    plan = _conv_plan(delays, n_sub, max_err_samples)
    x = np.asarray(power_btf)
    step = max(1, t // 512)
    fill = np.median(x[:, ::step].astype(np.float32, copy=False),
                     axis=1).astype(np.float32)     # [B, F]
    if x.dtype == np.uint8:
        np.rint(fill, out=fill)
    return plan, fill, _valid_len(delays, t)


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
    if n_sub is None:
        n_sub = _conv_auto_n_sub(delays)
    plan, fill, valid_len = _conv_bank_prep(
        np.asarray(power_btf), delays, n_sub, max_err_samples)
    return _two_stage_bank(np.asarray(power_btf), fill, plan,
                           device), valid_len


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
    fill = np.median(power_tf, axis=0).astype(np.float32)
    x = np.asarray(power_tf, np.float32)[None]
    bank = _two_stage_bank(x, fill[None], plan, device)[0]
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
    _check_table(delays, f)
    plan = subband_plan(delays, n_sub, max_err_samples)
    x = np.asarray(power_btf, np.float32)
    fill = np.median(x, axis=1).astype(np.float32)  # [B, F]
    return _two_stage_bank(x, fill, plan, device), _valid_len(delays, t)


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
    fill = np.median(power_tf, axis=0).astype(np.float32)  # [F]
    x = np.asarray(power_tf, np.float32)[None]
    return _direct_bank(x, fill[None], delays, device)[0], \
        _valid_len(delays, t)


def dedisperse_bank_batch(
    power_btf: np.ndarray, delays: np.ndarray, device="cuda"
) -> Tuple[torch.Tensor, np.ndarray]:
    """``dedisperse_bank`` over a ``[B, T, F]`` beam stack: bank
    ``[B, n_dm, T]``, each beam's tail filled with its own per-channel
    median; ``valid_len`` is shared."""
    b, t, f = power_btf.shape
    _check_table(delays, f)
    x = np.asarray(power_btf, np.float32)
    fill = np.median(x, axis=1).astype(np.float32)  # [B, F]
    return _direct_bank(x, fill, delays, device), _valid_len(delays, t)


def _median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as the reference takes it: the mean of the
    two middle values for an even length (``torch.median`` returns the
    lower one)."""
    s = x.sort(dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


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


def _snr_topk(bank: torch.Tensor, widths: Tuple[int, ...],
              k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Robust-normalize each trial series (median / MAD), then for each
    boxcar width the top-k S/N peaks per trial, ties to the lower index as
    ``lax.top_k`` breaks them: ``(snr, idx)`` each ``[..., n_w, n_dm, k]``
    on the host.  The boxcar sums are float32 differences of the cumulative
    sum; the division by sqrt(width) is a float64 multiply by its
    reciprocal, as XLA compiles the reference's (a float32 array over
    NumPy's float64 ``sqrt``)."""
    med = _median_last(bank)[..., None]
    mad = _median_last((bank - med).abs())[..., None]
    sigma = torch.clamp(mad * 1.4826, min=1e-30)
    norm = (bank - med) / sigma
    csum = torch.cat([torch.zeros_like(norm[..., :1]),
                      _cumsum_blocked(norm)], dim=-1)  # [..., T+1]
    snrs, idxs = [], []
    for w in widths:
        s = (csum[..., w:] - csum[..., :-w]).double() * (1.0 / math.sqrt(w))
        top = torch.sort(s, dim=-1, descending=True, stable=True)
        snrs.append(top.values[..., :k])
        idxs.append(top.indices[..., :k])
    snr = torch.stack(snrs, dim=-3)
    idx = torch.stack(idxs, dim=-3)
    return snr.cpu().numpy(), idx.cpu().numpy()


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


def preprocess_spectrogram(
    x: np.ndarray,
    zap: Optional[Sequence[int]] = None,
    zerodm: bool = False,
) -> np.ndarray:
    """RFI conditioning before dedispersion, float32 copy of ``[T, F]``:
    ``zap`` channels set to the constant 0; ``zerodm`` subtracts each time
    sample's mean over the kept channels from the kept channels."""
    x = np.array(x, np.float32, copy=True)
    keep = np.ones(x.shape[1], bool)
    if zap:
        zap = np.asarray(sorted(set(int(c) for c in zap)))
        if zap.size and (zap[0] < 0 or zap[-1] >= x.shape[1]):
            raise ValueError(
                f"zap channels {zap[zap < 0].tolist() + zap[zap >= x.shape[1]].tolist()} "
                f"outside [0, {x.shape[1]})")
        keep[zap] = False
        if not keep.any():
            raise ValueError("zap spec removes every channel")
        x[:, ~keep] = 0.0
    if zerodm:
        x[:, keep] -= x[:, keep].mean(axis=1, keepdims=True)
    return x


def _bank(method: str, x_btf: np.ndarray, delays: np.ndarray, n_sub: int,
          device) -> Tuple[torch.Tensor, np.ndarray]:
    """The ``[B, n_dm, T]`` bank of a beam stack by ``method``."""
    if method == "conv":
        return conv_dedisperse_bank_batch(x_btf, delays, n_sub=None,
                                          device=device)
    if method == "subband":
        return subband_dedisperse_bank_batch(
            x_btf, delays, n_sub=min(n_sub, x_btf.shape[2]), device=device)
    if method == "direct":
        return dedisperse_bank_batch(x_btf, delays, device=device)
    raise ValueError(f"method must be conv|direct|subband, got {method!r}")


def _search_chunk(
    chunk: np.ndarray,        # [T_ext, F] data incl. extension
    delays: np.ndarray,       # [n_dm, F]
    dms: np.ndarray,
    tsamp_s: float,
    band_span: np.ndarray,
    widths: Tuple[int, ...],
    threshold: float,
    topk: int,
    own: Optional[int],       # samples owned by this window (None = final)
    t_offset: int,            # absolute sample index of chunk[0]
    dm_link: Optional[int],
    method: str = "direct",
    n_sub: int = 64,
    device="cuda",
) -> List[Candidate]:
    """One search window: bank, normalization and top-k on the device,
    threshold, ownership gate and clustering on the host (a stack of one
    beam: the single-beam banks' fill equals the stacked one's)."""
    return _search_chunk_batch(
        np.asarray(chunk)[None], delays, dms, tsamp_s, band_span, widths,
        threshold, topk, own, t_offset, dm_link, method, n_sub, device)[0]


def _threshold_points(
    snr: np.ndarray,          # [n_w, n_dm, k]
    idx: np.ndarray,
    widths: Tuple[int, ...],
    valid_len: np.ndarray,
    own: Optional[int],
    t_offset: int,
    threshold: float,
) -> List[tuple]:
    """Host thresholding of the top-k grid into raw candidate points, each
    (width, trial) limited to its data-covered extent minus the boxcar and
    to the samples this window owns."""
    w_arr = np.asarray(widths, np.int64)[:, None]
    lim = valid_len if own is None else np.minimum(valid_len, own)
    limit = np.minimum(valid_len[None, :] - w_arr + 1, lim[None, :])
    mask = (snr >= threshold) & (idx < limit[:, :, None])
    return [(float(snr[wi, d, kk]), int(d), int(idx[wi, d, kk]) + t_offset,
             int(widths[wi]))
            for wi, d, kk in np.argwhere(mask)]


def _search_chunk_batch(
    chunk_btf: np.ndarray,    # [B, T_ext, F] beam-stacked window
    delays: np.ndarray,
    dms: np.ndarray,
    tsamp_s: float,
    band_span: np.ndarray,
    widths: Tuple[int, ...],
    threshold: float,
    topk: int,
    own: Optional[int],
    t_offset: int,
    dm_link: Optional[int],
    method: str = "direct",
    n_sub: int = 64,
    device="cuda",
) -> List[List[Candidate]]:
    """``_search_chunk`` over a beam stack: one batched bank and one batched
    top-k for the group; thresholding and clustering per beam."""
    bank, valid_len = _bank(method, chunk_btf, delays, n_sub, device)
    snr, idx = _snr_topk(bank, widths,
                         min(topk, bank.shape[2] - max(widths) + 1))
    dms = np.asarray(dms)
    return [
        _cluster(_threshold_points(snr[bi], idx[bi], widths, valid_len,
                                   own, t_offset, threshold),
                 dms, tsamp_s, band_span, dm_link)
        for bi in range(chunk_btf.shape[0])
    ]


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
    chunk only).  Returns candidates sorted by S/N, strongest first.
    """
    power_tf = preprocess_spectrogram(power_tf, zap, zerodm)
    t_total, f = power_tf.shape
    delays = delay_table(freqs_mhz, dms, tsamp_s)
    widths = tuple(int(w) for w in widths)
    max_w = max(widths)
    overlap = int(delays.max()) + max_w
    band_span = delays.max(axis=1)

    cands: List[Candidate] = []
    start = 0
    while start < t_total:
        stop = min(start + chunk_t, t_total)
        ext_stop = min(stop + overlap, t_total)
        # A chunk whose extension reaches the end owns every sample left.
        final = ext_stop >= t_total
        chunk = power_tf[start:ext_stop]
        if chunk.shape[0] <= max_w:
            break
        cands.extend(_search_chunk(
            chunk, delays, dms, tsamp_s, band_span, widths, threshold,
            topk, own=None if final else (stop - start),
            t_offset=start, dm_link=dm_link, method=method, n_sub=n_sub,
            device=device))
        if final:
            break
        start = stop
    cands.sort(key=lambda c: -c.snr)
    return cands


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
    through the batched bank and top-k (None: groups whose ``[g, n_dm, T]``
    bank and padded operand stay under ~256 MB)."""
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
    xs = np.stack([preprocess_spectrogram(x, zap, zerodm)
                   for _, x in spectra])  # [B, T, F]
    b, t_total, f = xs.shape
    delays = delay_table(freqs_mhz, dms, tsamp_s)
    widths = tuple(int(w) for w in widths)
    max_w = max(widths)
    overlap = int(delays.max()) + max_w
    band_span = delays.max(axis=1)
    if beam_batch is None:
        t_c = min(chunk_t, t_total)
        per_beam = 4 * (len(dms) * t_c + f * (t_c + overlap))
        beam_batch = max(1, min(b, int(256e6 // max(per_beam, 1))))
    by_beam: dict = {lab: [] for lab in labels}
    start = 0
    while start < t_total:
        stop = min(start + chunk_t, t_total)
        ext_stop = min(stop + overlap, t_total)
        final = ext_stop >= t_total
        chunk = xs[:, start:ext_stop]
        if chunk.shape[1] <= max_w:
            break
        for g0 in range(0, b, beam_batch):
            per_beam_cands = _search_chunk_batch(
                chunk[g0:g0 + beam_batch], delays, dms, tsamp_s,
                band_span, widths, threshold, topk,
                own=None if final else (stop - start), t_offset=start,
                dm_link=dm_link, method=method, n_sub=n_sub, device=device)
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


class SearchMonitor:
    """Streaming single-pulse search over the beamformer's own product
    blocks: the live FRB trigger.

    The streaming loop hands it each drained block; it keeps a rolling
    ``[T, F]`` buffer of the selected beam (or the incoherent sum; or
    ``[B, T, F]`` for a beam set / ``beam="all"``), and whenever
    ``chunk_t`` owned samples have accumulated it searches them extended by
    ``max_delay + max_width`` carried samples: the offline chunk loop's
    windowing, so a pulse across block or window boundaries is found once.
    Beam sets search batched, with per-window cross-beam coincidence RFI
    rejection.  A sequence gap flushes the buffer through a final-owned
    search and restarts it (``gaps`` counts them).

    Two ways in, one result: ``observe(seq, powers, inco)`` takes the whole
    ``[F, T, B]`` (or ``[F, T, 4, B]``) product as the reference's monitor
    does; the streaming loop instead takes ``select_beams`` of the product
    on the device and hands the selection to ``observe_selected``, so only
    the searched beams cross to the host.  Windows are searched on
    ``device`` (the card unless the caller names another).
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
        on_candidate=None,
        coincidence: bool = True,
        coincidence_frac: float = 0.25,
        on_rfi=None,
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
        self.on_candidate = on_candidate
        self.delays = delay_table(self.freqs_mhz, self.dms, self.tsamp_s)
        self.band_span = self.delays.max(axis=1)
        self.max_w = max(self.widths)
        self.overlap = int(self.delays.max()) + self.max_w
        self.chunk_t = int(chunk_t)
        if self.chunk_t < self.max_w:
            raise ValueError(
                f"chunk_t {chunk_t} shorter than the widest boxcar "
                f"{self.max_w}")
        self.candidates: List[Candidate] = []
        self.gaps = 0
        self.searched_windows = 0
        self._buf: List[np.ndarray] = []
        self._buffered = 0
        self._t_base = 0      # absolute sample index of _buf[0][0]
        self._next_seq: Optional[int] = None

    @property
    def wants_beams(self) -> bool:
        """True when the monitor reads the beam product (the streaming loop
        then brings its beams back even with no sink attached)."""
        return not self.incoherent

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

    def _extract(self, powers: Optional[np.ndarray],
                 inco: Optional[np.ndarray]) -> np.ndarray:
        """One block's ``[T_out, F]`` spectrogram (``[B_sel, T_out, F]`` for
        a beam set) from the whole drained product: ``[F, T]`` incoherent,
        ``[F, T, B]`` power or ``[F, T, 4, B]`` Stokes."""
        if self.incoherent:
            return self._condition(None, inco)
        if powers is None:
            raise ValueError("search monitor needs the beam product")
        sel = self.select_beams(torch.from_numpy(np.ascontiguousarray(powers)))
        return self._condition(sel.numpy(), None)

    def _condition(self, sel: Optional[np.ndarray],
                   inco: Optional[np.ndarray]) -> np.ndarray:
        """The buffered form of a selection (a copy: the caller may reuse
        its array): float32, except a single beam's uint8 product with no
        conditioning, which stays uint8 to the device; zap / zero-DM
        applied (per block equals whole stream: the zap fill is a constant
        and zero-DM is per sample)."""
        if self.incoherent:
            if inco is None:
                raise ValueError("search monitor targets the incoherent "
                                 "sum but the pipeline has no incoherent "
                                 "product enabled")
            x = np.asarray(inco, np.float32).T
        elif self._beam_sel is not None:
            x = sel.astype(np.float32)
            if self.zap or self.zerodm:
                x = np.stack([
                    preprocess_spectrogram(xb, self.zap, self.zerodm)
                    for xb in x])
            return x
        elif sel.dtype == np.uint8 and not (self.zap or self.zerodm):
            x = np.array(sel)
        else:
            x = np.array(sel, dtype=np.float32)
        if self.zap or self.zerodm:
            x = preprocess_spectrogram(x, self.zap, self.zerodm)
        return x

    def observe(self, seq: int, powers: Optional[np.ndarray],
                inco: Optional[np.ndarray] = None) -> None:
        """Take one drained block: the whole product (``[F, T, B]`` or
        ``[F, T, 4, B]``, or None for an incoherent target) and the
        incoherent sum ``[F, T]``."""
        self._push(seq, self._extract(powers, inco))

    def observe_selected(self, seq: int, sel: Optional[np.ndarray],
                         inco: Optional[np.ndarray] = None) -> None:
        """Take one drained block as ``select_beams`` of its product (None
        for an incoherent target) and the incoherent sum ``[F, T]``."""
        self._push(seq, self._condition(sel, inco))

    def _push(self, seq: int, x: np.ndarray) -> None:
        if self._next_seq is not None and seq != self._next_seq:
            self.gaps += 1
            self.flush()
            self._t_base += self.overlap  # nominal; times stay per-run
        self._next_seq = seq + 1
        self._buf.append(x)
        self._buffered += x.shape[-2]
        while self._buffered >= self.chunk_t + self.overlap:
            self._search_front()

    def _concat(self) -> np.ndarray:
        # time is the second-to-last axis for both [T, F] and [B, T, F]
        if len(self._buf) > 1:
            self._buf = [np.concatenate(self._buf, axis=-2)]
        return self._buf[0]

    def _emit(self, cands: List[Candidate]) -> None:
        self.searched_windows += 1
        for c in cands:
            self.candidates.append(c)
            if self.on_candidate is not None:
                self.on_candidate(c)

    def _search_window(self, window: np.ndarray,
                       own: Optional[int]) -> List[Candidate]:
        """One window: single target through ``_search_chunk``, a beam set
        batched with per-window cross-beam coincidence."""
        if self._beam_sel is None:
            cands = _search_chunk(
                window, self.delays, self.dms, self.tsamp_s,
                self.band_span, self.widths, self.threshold, self.topk,
                own=own, t_offset=self._t_base, dm_link=self.dm_link,
                method=self.method, n_sub=self.n_sub, device=self.device)
            if not self.incoherent:
                for c in cands:
                    c.beam = self.beam
            return cands
        per_beam = _search_chunk_batch(
            window, self.delays, self.dms, self.tsamp_s, self.band_span,
            self.widths, self.threshold, self.topk, own=own,
            t_offset=self._t_base, dm_link=self.dm_link,
            method=self.method, n_sub=self.n_sub, device=self.device)
        by_beam = {}
        for lab, cs in zip(self._labels, per_beam):
            for c in cs:
                c.beam = lab
            by_beam[lab] = cs
        if self.coincidence:
            by_beam, events = coincidence_filter(
                by_beam, self.band_span,
                n_beams_searched=len(self._labels),
                frac=self.coincidence_frac)
            self.rfi_rejected += len(events)
            if self.on_rfi is not None:
                for ev in events:
                    self.on_rfi(ev)
        out = [c for cs in by_beam.values() for c in cs]
        out.sort(key=lambda c: -c.snr)
        return out

    def _search_front(self) -> None:
        x = self._concat()
        window = x[..., : self.chunk_t + self.overlap, :]
        self._emit(self._search_window(window, own=self.chunk_t))
        self._buf = [x[..., self.chunk_t:, :]]
        self._buffered -= self.chunk_t
        self._t_base += self.chunk_t

    def flush(self) -> None:
        """Search whatever remains (the final window owns everything its
        data covers), then reset the buffer.  Called at the end of a stream
        and on a sequence gap."""
        if self._buffered > self.max_w:
            self._emit(self._search_window(self._concat(), own=None))
        self._t_base += self._buffered
        self._buf, self._buffered = [], 0


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
