"""Steering / fringe / calibration weight generation on the device.

``A[f, b, a] = g_a(f) * exp(-2*pi*i * f * tau(b, a))`` with the geometric
delay ``tau = x_a * sin(theta_b) / c + fringe_delay``, as plain tensor code on
the device the caller names, so a pointing or calibration change never
round-trips through the host.  Weights are planar (``CVec`` of float32).

Sign conventions (matched by ``ingest/generator.py``): a plane wave from
angle ``theta`` reaches antenna ``x_a`` with phase ``+2*pi*f*x_a*sin(theta)/c``;
the steering weight conjugates it.

The phase is computed in float64 on the CPU and in float32 on the card, and
is reduced to its fractional turn before any narrowing (the f32 ulp is then
~1e-5 turn for DSA-scale baselines).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import SPEED_OF_LIGHT_M_S, ObsConfig
from dsabeamformer_tpu_torch.models.arrays import ArrayLayout, array_for
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.ops.cplx import CVec
from dsabeamformer_tpu_torch.utils.device import resolve_device


def _phase_dtype(device: torch.device) -> torch.dtype:
    return torch.float64 if device.type == "cpu" else torch.float32


def steering_weights(
    positions_m: torch.Tensor,      # [A]
    beam_angles_rad: torch.Tensor,  # [B] absolute angles incl. pointing
    freqs_hz: torch.Tensor,         # [F]
    gains: CVec,                    # [A, F] planar complex calibration gains
    fringe_delay_s: float = 0.0,
) -> CVec:
    """Planar-complex weights ``A[f, b, a]`` as ``CVec`` float32, on the
    device of ``positions_m``."""
    dt = _phase_dtype(positions_m.device)
    f = freqs_hz.to(dt)[:, None, None]                      # [F,1,1]
    s = torch.sin(beam_angles_rad.to(dt))[None, :, None]    # [1,B,1]
    x = positions_m.to(dt)[None, None, :]                   # [1,1,A]
    tau = x * s / SPEED_OF_LIGHT_M_S + fringe_delay_s
    turns = f * tau
    # Keep only the fractional turn before any float32 narrowing.
    phase = (-2.0 * math.pi) * (turns - torch.round(turns))
    c = torch.cos(phase).to(torch.float32)
    si = torch.sin(phase).to(torch.float32)
    gr = gains.re.to(torch.float32).T[:, None, :]           # [F,1,A]
    gi = gains.im.to(torch.float32).T[:, None, :]
    # (c + i*si) * (gr + i*gi)
    return CVec(re=c * gr - si * gi, im=si * gr + c * gi)


def make_weights(
    cfg: ObsConfig,
    layout: ArrayLayout | None = None,
    cal: CalTable | None = None,
    pointing_rad: float = 0.0,
    fringe_delay_s: float = 0.0,
    device="cuda",
) -> CVec:
    """Weights for a config -> ``CVec`` with re/im float32 ``[F, B, A]`` on
    ``device`` (the card unless the caller names another; raises when no
    card is usable)."""
    dev = resolve_device(device)
    layout = layout if layout is not None else array_for(cfg)
    cal = cal if cal is not None else CalTable.unity(cfg)
    if layout.n_ant < cfg.n_ant:
        # Surveyed tables list only physical dishes; pad to the GEMM dim.
        layout = layout.padded(cfg.n_ant)
    if layout.n_ant != cfg.n_ant:
        raise ValueError(
            f"layout has {layout.n_ant} antennas, config {cfg.name!r} "
            f"expects {cfg.n_ant}"
        )
    if layout.n_active != cfg.n_ant_active:
        raise ValueError(
            f"layout has {layout.n_active} active antennas, config "
            f"{cfg.name!r} expects {cfg.n_ant_active} (override with "
            f"--set n_ant_active={layout.n_active} if the table is right)"
        )
    if cal.gains.shape != (cfg.n_ant, cfg.n_chan):
        raise ValueError(
            f"calibration table shaped {cal.gains.shape} != "
            f"[n_ant, n_chan] = {(cfg.n_ant, cfg.n_chan)}"
        )
    angles = pointing_rad + cfg.beam_angles_rad()
    return steering_weights(
        torch.as_tensor(layout.positions_m, device=dev),
        torch.as_tensor(angles, device=dev),
        torch.as_tensor(cfg.freqs_hz(), device=dev),
        CVec.from_numpy(cal.gains, device=dev),
        fringe_delay_s,
    )


def weights_numpy_golden(
    cfg: ObsConfig,
    layout: ArrayLayout | None = None,
    cal: CalTable | None = None,
    pointing_rad: float = 0.0,
    fringe_delay_s: float = 0.0,
) -> np.ndarray:
    """complex128 NumPy oracle for ``make_weights``."""
    layout = layout if layout is not None else array_for(cfg)
    cal = cal if cal is not None else CalTable.unity(cfg)
    f = cfg.freqs_hz()[:, None, None]
    s = np.sin(pointing_rad + cfg.beam_angles_rad())[None, :, None]
    x = layout.positions_m[None, None, :]
    tau = x * s / SPEED_OF_LIGHT_M_S + fringe_delay_s
    w = np.exp(-2j * np.pi * f * tau)
    return w * cal.gains.astype(np.complex128).T[:, None, :]


def parse_zap(spec: str) -> list:
    """Parse a channel-zap spec -- comma-separated raw channel indices and
    inclusive ranges, e.g. ``"12,100-110,500"`` -- into a sorted
    duplicate-free index list."""
    chans: set = set()
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "-" in tok:
            lo, hi = tok.split("-", 1)
            lo, hi = int(lo), int(hi)
            if hi < lo:
                raise ValueError(f"bad zap range {tok!r}")
            chans.update(range(lo, hi + 1))
        else:
            chans.add(int(tok))
    return sorted(chans)


def zap_weights(w: CVec, channels, cfg: ObsConfig) -> CVec:
    """Zero the weight rows of RFI channels: every coherent product of a
    zapped channel is then exactly zero (zero weights quantize to zero
    integers; the per-channel scale floor keeps the divide finite)."""
    idx = np.asarray(parse_zap(channels) if isinstance(channels, str)
                     else sorted(set(int(c) for c in channels)))
    if idx.size == 0:
        return w
    if idx.min() < 0 or idx.max() >= cfg.n_chan:
        raise ValueError(
            f"zap channels {idx[(idx < 0) | (idx >= cfg.n_chan)].tolist()} "
            f"out of range [0, {cfg.n_chan})")
    sel = torch.as_tensor(idx, device=w.device)
    re, im = w.re.clone(), w.im.clone()
    re[sel] = 0.0
    im[sel] = 0.0
    return CVec(re=re, im=im)


def flag_antennas(w: CVec, ants, cfg: ObsConfig) -> CVec:
    """Zero the weight columns of bad antennas: flagged antennas contribute
    exactly nothing to every coherent product, with no renormalization.
    Accepts a spec string (``"3,17-19"``) or an index iterable; indices are
    raw antenna slots ``< n_ant_active``."""
    idx = np.asarray(parse_zap(ants) if isinstance(ants, str)
                     else sorted(set(int(a) for a in ants)))
    if idx.size == 0:
        return w
    if idx.min() < 0 or idx.max() >= cfg.n_ant_active:
        raise ValueError(
            f"flagged antennas "
            f"{idx[(idx < 0) | (idx >= cfg.n_ant_active)].tolist()} out of "
            f"range [0, n_ant_active={cfg.n_ant_active})")
    sel = torch.as_tensor(idx, device=w.device)
    re, im = w.re.clone(), w.im.clone()
    re[..., sel] = 0.0
    im[..., sel] = 0.0
    return CVec(re=re, im=im)


def zap_mask_avg(channels, cfg: ObsConfig) -> np.ndarray:
    """``[n_chan/navg_freq]`` float32 mask for the incoherent product: 0 for
    averaged groups containing any zapped raw channel, else 1 (the
    incoherent sum is computed from the data, so a partly contaminated group
    stays contaminated)."""
    idx = parse_zap(channels) if isinstance(channels, str) else channels
    mask = np.ones(cfg.n_chan, np.float32)
    mask[np.asarray(sorted(set(int(c) for c in idx)), dtype=int)] = 0.0
    return mask.reshape(-1, cfg.navg_freq).min(axis=1)
