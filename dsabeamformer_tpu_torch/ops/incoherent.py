"""Incoherent-sum detection and the wire-block diagnostics (drive levels,
spectral kurtosis), as plain PyTorch ops.

The same functions as ``dsabeamformer_tpu/ops/incoherent.py``, where they are
XLA programs (not Pallas): per channel and time sample, sum ``|v|^2`` over the
active antennas and both polarizations (the zero-gain "beam 0"), the
per-antenna drive level, and the spectral-kurtosis accumulators the RFI
monitor pools.  Each is one memory-bound pass over the wire bytes; the
streaming path takes the incoherent sum and the SK accumulators from the
detection kernel instead (``ops.gemm.beamform_power(incoherent=...,
sk_stats=...)``), so these run only where a block is looked at on its own.

Every function takes the canonical ``cfg.device_wire_shape`` form or the 4-D
host form, as a tensor or a NumPy array, and computes on the tensor's device.
Sums of integers are taken in int64 and converted to float32 once.
"""

from __future__ import annotations

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.ops.packing import unpack_4r4i, unpack_wire_to_complex


def _wire_tensor(wire, cfg: ObsConfig):
    """Validate the wire form -> ``(x [T,F,P,A] or [F,T,P,A] uint8,
    chan_axis)``."""
    if not isinstance(wire, torch.Tensor):
        wire = torch.as_tensor(np.asarray(wire))
    if wire.dtype != torch.uint8:
        raise ValueError(
            f"wire must be uint8 4R4I bytes, got "
            f"{str(wire.dtype).removeprefix('torch.')}")
    if tuple(wire.shape) not in (cfg.device_wire_shape, cfg.wire_block_shape):
        raise ValueError(
            f"wire shape {tuple(wire.shape)} is neither "
            f"{cfg.device_wire_shape} nor {cfg.wire_block_shape} for layout "
            f"{cfg.input_layout!r}"
        )
    if cfg.input_layout == "tfpa":
        return wire.reshape(cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant), 1
    return wire.reshape(cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant), 0


def _unpack_active(wire, cfg: ObsConfig):
    """``(re, im)`` int32 of the active antennas, and the channel axis."""
    x, chan_axis = _wire_tensor(wire, cfg)
    re, im = unpack_4r4i(x[..., : cfg.n_ant_active])
    return re.to(torch.int32), im.to(torch.int32), chan_axis


def _unpack_active_power(wire, cfg: ObsConfig):
    """``p = re^2 + im^2`` int32 ``[T,F,P,A']`` or ``[F,T,P,A']``, and the
    channel axis (the shared preamble of the diagnostics)."""
    re, im, chan_axis = _unpack_active(wire, cfg)
    return re * re + im * im, chan_axis


def incoherent_power(wire, cfg: ObsConfig, flag_ants: tuple = ()):
    """4R4I wire block -> incoherent total power ``[F/navg_freq,
    T/navg_time]`` float32.

    ``sum_{a<n_ant_active, p} (re^2 + im^2)`` per (channel, sample), summed
    over ``navg_time`` samples and ``navg_freq`` adjacent channels (raw 4-bit
    units^2; no weights).  ``flag_ants`` excludes bad antennas from the sum.
    """
    p, _ = _unpack_active_power(wire, cfg)
    if flag_ants:
        if min(flag_ants) < 0 or max(flag_ants) >= cfg.n_ant_active:
            raise ValueError(
                f"flag_ants {sorted(flag_ants)} out of range "
                f"[0, n_ant_active={cfg.n_ant_active})")
        keep = torch.ones(cfg.n_ant_active, dtype=torch.int32,
                          device=p.device)
        keep[list(flag_ants)] = 0
        p = p * keep
    p = p.sum(dim=(2, 3))  # over (pol, antenna), int64
    if cfg.input_layout == "tfpa":
        p = p.T  # [T, F] -> [F, T]
    f, t = p.shape
    p = p.reshape(f, t // cfg.navg_time, cfg.navg_time).sum(dim=2)
    if cfg.navg_freq > 1:
        p = p.reshape(f // cfg.navg_freq, cfg.navg_freq, -1).sum(dim=1)
    return p.to(torch.float32)


def wire_level_stats(wire, cfg: ObsConfig) -> dict:
    """Per-antenna drive-level diagnostics from one wire block:
    ``{"rms": [A'], "clip_fraction": [A']}`` float32 over the active
    antennas (both pols, all channels and samples).

    ``clip_fraction`` is the share of components sitting exactly on the
    -8/+7 rails (the standard proxy for saturation after quantization).
    The sums are float32, not int32: a railed DSA-10-scale antenna sums up
    to 33.5M samples x 128 = 4.3e9, past int32, and would report a NaN rms
    for exactly the broken antenna this exists to flag.
    """
    re, im, _ = _unpack_active(wire, cfg)
    n_samp = re.shape[0] * re.shape[1] * re.shape[2]
    ssq = (re * re + im * im).to(torch.float32).sum(dim=(0, 1, 2))
    clipped = ((re <= -8) | (re >= 7) | (im <= -8) | (im >= 7)) \
        .to(torch.float32).sum(dim=(0, 1, 2))
    return {
        "rms": torch.sqrt(ssq / (2 * n_samp)),
        "clip_fraction": clipped / n_samp,
    }


def incoherent_power_golden(wire, cfg: ObsConfig, flag_ants=()):
    """NumPy float64 oracle for ``incoherent_power``."""
    v = unpack_wire_to_complex(np.asarray(wire).reshape(cfg.wire_block_shape),
                               cfg.input_layout)  # [F, T, P, A] complex
    p = np.abs(v[..., : cfg.n_ant_active]) ** 2
    if flag_ants:
        p[..., sorted(flag_ants)] = 0.0
    p = p.sum(axis=(2, 3))
    f, t = p.shape
    p = p.reshape(f, t // cfg.navg_time, cfg.navg_time).sum(axis=2)
    if cfg.navg_freq > 1:
        p = p.reshape(f // cfg.navg_freq, cfg.navg_freq, -1).sum(axis=1)
    return p


def sk_block_stats(wire, cfg: ObsConfig, axis: str = "chan") -> dict:
    """Spectral-kurtosis accumulators from one wire block, resolved along
    ``axis``: ``{"s1": [n_chan], "s2": [n_chan]}`` (``"chan"``),
    ``{"s1": [n_ant_active], "s2": ...}`` (``"ant"``), or both
    (``"both"``: the channel keys plus ``ant_s1`` / ``ant_s2``).

    The sum and sum of squares of the per-sample powers ``p = re^2 + im^2``
    over every other axis, exact in int64 and returned as float32.  Callers
    accumulate them across blocks (float64 on the host) and form the
    estimator with :func:`sk_estimate`.  A CW carrier drives SK far below 1,
    impulsive interference far above, Gaussian noise leaves it near 1.
    """
    if axis not in ("chan", "ant", "both"):
        raise ValueError(f"axis must be chan|ant|both, got {axis!r}")
    p, chan_axis = _unpack_active_power(wire, cfg)
    p2 = p * p  # <= 128^2, exact in int32
    out = {}
    if axis in ("chan", "both"):
        axes = tuple(a for a in range(4) if a != chan_axis)
        out["s1"] = p.sum(dim=axes).to(torch.float32)
        out["s2"] = p2.sum(dim=axes).to(torch.float32)
    if axis in ("ant", "both"):
        key = ("ant_s1", "ant_s2") if axis == "both" else ("s1", "s2")
        out[key[0]] = p.sum(dim=(0, 1, 2)).to(torch.float32)
        out[key[1]] = p2.sum(dim=(0, 1, 2)).to(torch.float32)
    return out


def sk_samples_per_block(cfg: ObsConfig, axis: str = "chan") -> int:
    """M contributed to each SK accumulator bin per block."""
    if axis == "ant":
        return cfg.t_block * cfg.n_pol * cfg.n_chan
    return cfg.t_block * cfg.n_pol * cfg.n_ant_active


def sk_estimate(s1, s2, m: int):
    """Generalized spectral-kurtosis estimator from accumulated sums:
    ``SK = (M+1)/(M-1) * (M*S2/S1^2 - 1)``, expectation 1 for Gaussian
    noise, variance ~ 4/M; dead channels (S1 == 0) give NaN."""
    s1 = np.asarray(s1, np.float64)
    s2 = np.asarray(s2, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return (m + 1.0) / (m - 1.0) * (m * s2 / (s1 * s1) - 1.0)


def sk_flags(sk, m: int, threshold: float = 5.0):
    """Robust outlier channels from an SK vector: the null is the
    cross-channel median, the scale the larger of the MAD-derived sigma and
    the theoretical ``2/sqrt(M)``.  Returns ``(flagged_indices, median,
    sigma)``; NaN (dead) channels are always flagged."""
    sk = np.asarray(sk, np.float64)
    good = np.isfinite(sk)
    if not good.any():
        return list(range(sk.size)), float("nan"), float("nan")
    med = float(np.median(sk[good]))
    mad_sigma = 1.4826 * float(np.median(np.abs(sk[good] - med)))
    sigma = max(mad_sigma, 2.0 / np.sqrt(m))
    bad = ~good | (np.abs(sk - med) > threshold * sigma)
    return [int(i) for i in np.nonzero(bad)[0]], med, sigma


def format_zap_spec(channels) -> str:
    """Inverse of ``models.weights.parse_zap``: a sorted index list -> the
    compact ``"12,100-110"`` spec."""
    chans = sorted(set(int(c) for c in channels))
    if not chans:
        return ""
    runs = []
    start = prev = chans[0]
    for c in chans[1:]:
        if c == prev + 1:
            prev = c
            continue
        runs.append((start, prev))
        start = prev = c
    runs.append((start, prev))
    return ",".join(f"{a}-{b}" if b > a else f"{a}" for a, b in runs)
