"""Beam-pattern analysis: the formed-beam power response to a point source
swept across the sky, on the device the caller names.

The counterpart of ``dsabeamformer_tpu/models/beampattern.py``.
``beam_response`` sweeps a unit plane wave across angle and returns the
formed-beam power response matrix; ``beam_response_lm`` does the same for
(l, m) beam grids; ``plot_beam_pattern`` renders it when matplotlib is
present (optional, not needed in the hot path).

The responses use the float64 golden weight model (``weights_numpy_golden``
/ ``weights_lm_numpy_golden`` with unity gains), in complex128 on the
device: weights, arrivals and the ``[F, S, B]`` product, summed over
channels a chunk at a time so that peak memory stays bounded (the whole
product is 8.6 GB at DSA-110 with 512 sweep points).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import SPEED_OF_LIGHT_M_S, ObsConfig
from dsabeamformer_tpu_torch.models.arrays import ArrayLayout, array_for
from dsabeamformer_tpu_torch.utils.device import resolve_device

#: Elements of one channel chunk's ``[F, S, B]`` complex128 product (2^25:
#: 512 MiB).
_CHUNK_ELEMENTS = 1 << 25


def _response(cfg: ObsConfig, n_beams: int, n_sweep: int, weights, arrival,
              chan: int | None, device) -> np.ndarray:
    """``[S, B]`` mean over channels of ``|sum_a w[f,b,a] v[f,s,a]|^2 /
    act^2`` in complex128 on ``device``: ``weights(f)`` and ``arrival(f)``
    give ``w [Fc, B, a]`` and ``v [Fc, S, a]`` for a ``[Fc, 1, 1]`` float64
    tensor of channel frequencies, each phase formed in the NumPy
    original's order of operations."""
    dev = resolve_device(device)
    freqs = cfg.freqs_hz()
    if chan is not None:
        freqs = freqs[chan : chan + 1]
    fs = torch.as_tensor(freqs, dtype=torch.float64, device=dev)
    step = max(1, _CHUNK_ELEMENTS // max(1, n_sweep * n_beams))
    power = torch.zeros((n_sweep, n_beams), dtype=torch.float64, device=dev)
    for f0 in range(0, len(freqs), step):
        f = fs[f0 : f0 + step, None, None]                      # [Fc,1,1]
        # B[f,s,b] = sum_a w[f,b,a] * v[f,s,a]
        b = torch.matmul(arrival(f), weights(f).transpose(1, 2))  # [Fc,S,B]
        power += (torch.abs(b) ** 2).sum(dim=0)
    return (power / len(freqs) / cfg.n_ant_active**2).cpu().numpy()


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64),
                           device=resolve_device(device))


def beam_response(
    cfg: ObsConfig,
    sweep_angles_rad: np.ndarray,
    layout: ArrayLayout | None = None,
    chan: int | None = None,
    device="cuda",
) -> np.ndarray:
    """Power response of every formed beam to a unit plane wave swept
    across ``sweep_angles_rad``, on ``device`` (the card unless the caller
    names another).

    Returns ``[n_sweep, n_beams]`` float64, normalized so a matched beam at
    boresight = 1; ``chan`` takes one channel instead of the mean over the
    band."""
    layout = layout if layout is not None else array_for(cfg)
    x = _f64(layout.positions_m[: cfg.n_ant_active], device)[None, None, :]
    s_beam = _f64(np.sin(cfg.beam_angles_rad()), device)[None, :, None]
    s_sweep = _f64(np.sin(sweep_angles_rad), device)[None, :, None]
    tau = x * s_beam / SPEED_OF_LIGHT_M_S                      # [1,B,a]

    def weights(f):
        return torch.exp((-2j * math.pi) * f * tau)

    def arrival(f):
        return torch.exp((2j * math.pi) * f * x * s_sweep / SPEED_OF_LIGHT_M_S)

    return _response(cfg, s_beam.shape[1], s_sweep.shape[1], weights, arrival,
                     chan, device)


def beam_response_lm(
    cfg: ObsConfig,
    beam_l: np.ndarray,
    beam_m: np.ndarray,
    sweep_l: np.ndarray,
    sweep_m: np.ndarray,
    layout: ArrayLayout | None = None,
    chan: int | None = None,
    device="cuda",
) -> np.ndarray:
    """2-D analog of ``beam_response`` for (l, m) beam grids
    (``make_weights_lm``): power response of every beam to unit plane
    waves arriving from the ``(sweep_l[i], sweep_m[i])`` direction
    cosines.  Returns ``[n_sweep, n_beams]`` normalized so a matched beam
    at boresight = 1 (a 2-D map: pass a flattened meshgrid and reshape)."""
    layout = layout if layout is not None else array_for(cfg)
    act = cfg.n_ant_active
    x = _f64(layout.positions_m[:act], device)[None, None, :]
    ns = _f64(layout.ns[:act], device)[None, None, :]

    def path(l, m):
        return (x * _f64(l, device)[None, :, None]
                + ns * _f64(m, device)[None, :, None])

    tau = path(beam_l, beam_m) / SPEED_OF_LIGHT_M_S            # [1,B,a]
    sweep = path(sweep_l, sweep_m)                             # [1,S,a]

    def weights(f):
        return torch.exp((-2j * math.pi) * f * tau)

    def arrival(f):
        return torch.exp((2j * math.pi) * f * sweep / SPEED_OF_LIGHT_M_S)

    return _response(cfg, tau.shape[1], sweep.shape[1], weights, arrival,
                     chan, device)


def beam_fwhm_rad(cfg: ObsConfig, layout: ArrayLayout | None = None) -> float:
    """Analytic beam width estimate: 0.886 lambda / aperture for the line
    array (a sanity anchor for tests)."""
    layout = layout if layout is not None else array_for(cfg)
    x = layout.positions_m[: cfg.n_ant_active]
    aperture = x.max() - x.min()
    lam = SPEED_OF_LIGHT_M_S / np.median(cfg.freqs_hz())
    return 0.886 * lam / aperture


def plot_beam_pattern(cfg: ObsConfig, out_path: str, n_sweep: int = 512,
                      device="cuda") -> str:
    """Render the beam-pattern matrix (computed on ``device``) to an image
    file.  Requires matplotlib (optional dependency): without it this
    raises ImportError before any work."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    half = cfg.beam_span_deg * 0.75
    sweep = np.deg2rad(np.linspace(-half, half, n_sweep))
    resp = beam_response(cfg, sweep, device=device)
    fig, ax = plt.subplots(figsize=(10, 5))
    im = ax.imshow(
        10 * np.log10(np.maximum(resp.T, 1e-6)),
        aspect="auto",
        origin="lower",
        extent=[-half, half, 0, cfg.n_beams],
        vmin=-30,
        vmax=0,
    )
    ax.set_xlabel("source angle (deg)")
    ax.set_ylabel("beam index")
    ax.set_title(f"{cfg.name}: formed-beam response (dB)")
    fig.colorbar(im, ax=ax, label="dB")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
