"""Phase-up calibration solver: per-antenna complex gains from a
calibrator observation, on the device the caller names.

The counterpart of ``dsabeamformer_tpu/models/calsolver.py``.  Given wire
blocks of a calibrator at a known angle:

1. unpack and remove the known geometric phase, leaving
   ``u_a(f, t) = g_a(f) * s(t) + noise`` per antenna,
2. cross-correlate each antenna against a reference antenna over the
   block's time samples and both pols:
   ``r_a = <u_a conj(u_ref)> = g_a conj(g_ref) |s|^2``,
3. the solution to APPLY (``CalTable`` convention: already inverted) is
   ``1 / (r_a / <|u_ref|^2>)`` normalized to unit median amplitude over
   (active antennas, channels).

The sums ``r [F, a]`` and ``auto [F]`` accumulate in complex128 / float64 on
the device, ``t_chunk`` samples at a time; the small ``[F, a]`` result is
normalized on the host with NumPy's median (the mean of the two middle
values of an even count, as the original: ``torch.median`` takes the lower
one).  Amplitude accuracy depends on the calibrator's S/N per (antenna,
channel); phases converge much faster.  Solving from N blocks sums the N
blocks' ``r`` and ``auto``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import SPEED_OF_LIGHT_M_S, ObsConfig
from dsabeamformer_tpu_torch.models.arrays import ArrayLayout, array_for
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.ops.packing import unpack_4r4i
from dsabeamformer_tpu_torch.utils.device import resolve_device


def _accumulate_block(wire: torch.Tensor, cfg: ObsConfig, angle_rad: float,
                      layout: ArrayLayout, ref_ant: int,
                      t_chunk: int = 512) -> tuple:
    """One block's cross/auto sums on the wire's device: (r [F, a]
    complex128, auto [F] float64).

    ``t_chunk`` samples at a time: the complex128 expansion is 16x the wire
    bytes, but the estimator is a plain sum over time, so chunking bounds
    peak memory at ~t_chunk/t_block of that."""
    dev = wire.device
    wire = wire.reshape(cfg.wire_block_shape)
    act = cfg.n_ant_active
    f = torch.as_tensor(cfg.freqs_hz(), dtype=torch.float64,
                        device=dev)[:, None]
    x = torch.as_tensor(layout.positions_m[None, :act], dtype=torch.float64,
                        device=dev)
    steer = torch.exp(
        (2j * math.pi) * f * x * math.sin(angle_rad) / SPEED_OF_LIGHT_M_S
    )  # [F, a]
    unsteer = torch.conj(steer)[:, None, None, :]
    r = torch.zeros((cfg.n_chan, act), dtype=torch.complex128, device=dev)
    auto = torch.zeros(cfg.n_chan, dtype=torch.float64, device=dev)
    for t0 in range(0, cfg.t_block, t_chunk):
        sl = slice(t0, min(t0 + t_chunk, cfg.t_block))
        chunk = (wire[:, sl] if cfg.input_layout == "ftpa"
                 else wire[sl].permute(1, 0, 2, 3))  # [F, Tc, P, A]
        cre, cim = unpack_4r4i(chunk[..., :act].contiguous())
        v = torch.complex(cre.to(torch.float64), cim.to(torch.float64))
        u = v * unsteer                                 # geometry removed
        uref = u[..., ref_ant]
        r += torch.einsum("ftpa,ftp->fa", u, torch.conj(uref))
        auto += (torch.abs(uref) ** 2).sum(dim=(1, 2))
    return r, auto


def solve_gains_blocks(blocks, cfg: ObsConfig, angle_rad: float,
                       layout: ArrayLayout | None = None,
                       ref_ant: int = 0, device="cuda") -> CalTable:
    """Solve per-(antenna, channel) gains from wire ``blocks`` (NumPy
    arrays or uint8 tensors, host or device form) of a calibrator at
    ``angle_rad``, summing on ``device`` (the card unless the caller names
    another); returns the ``CalTable`` to APPLY."""
    dev = resolve_device(device)
    layout = layout if layout is not None else array_for(cfg)
    act = cfg.n_ant_active
    if not (0 <= ref_ant < act):
        raise ValueError(f"ref_ant={ref_ant} not an active antenna")
    r_sum = torch.zeros((cfg.n_chan, act), dtype=torch.complex128,
                        device=dev)
    auto_sum = torch.zeros(cfg.n_chan, dtype=torch.float64, device=dev)
    n = 0
    for wire in blocks:
        r, auto = _accumulate_block(torch.as_tensor(wire).to(dev), cfg,
                                    angle_rad, layout, ref_ant)
        r_sum += r
        auto_sum += auto
        n += 1
    if n == 0:
        raise ValueError("no blocks given")
    r_sum = r_sum.cpu().numpy()
    auto_sum = auto_sum.cpu().numpy()
    # g_a conj(g_ref) |s|^2 / (|g_ref|^2 |s|^2) = g_a / g_ref, up to the
    # noise bias in the reference auto power (small at calibrator S/N).
    g_rel = r_sum / np.maximum(auto_sum[:, None], 1e-30)  # [F, a]
    # Unit median amplitude over (active antennas, channels); the reference
    # antenna's phase is zero by construction.
    scale = np.median(np.abs(g_rel))
    g_rel = g_rel / np.maximum(scale, 1e-30)
    gains = np.zeros((cfg.n_ant, cfg.n_chan), np.complex64)
    gains[:act] = (1.0 / g_rel.T).astype(np.complex64)
    return CalTable(gains=gains)


def solve_gains(wire, cfg: ObsConfig, angle_rad: float,
                layout: ArrayLayout | None = None,
                ref_ant: int = 0, device="cuda") -> CalTable:
    """Single-block convenience wrapper for ``solve_gains_blocks``."""
    return solve_gains_blocks([wire], cfg, angle_rad, layout=layout,
                              ref_ant=ref_ant, device=device)
