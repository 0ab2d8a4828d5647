"""Synthetic 4R4I voltage-block generators (host-side, NumPy).

The same generators as ``dsabeamformer_tpu/ingest/generator.py``, drawing
from ``np.random.default_rng(seed)`` in the same order, so both packages make
byte-identical blocks from a seed.  Sign convention matches
models/weights.py: a source at angle ``theta`` induces antenna phase
``+2*pi*f*x_a*sin(theta)/c``.
"""

from __future__ import annotations

import numpy as np

from dsabeamformer_tpu_torch.config import SPEED_OF_LIGHT_M_S, ObsConfig
from dsabeamformer_tpu_torch.models.arrays import ArrayLayout, array_for
from dsabeamformer_tpu_torch.ops.packing import pack_4r4i


def _emit(cfg: ObsConfig, re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """[F, T, P, A] float re/im -> wire uint8 block in cfg.input_layout."""
    wire = pack_4r4i(np.round(re), np.round(im))
    if cfg.input_layout == "tfpa":
        wire = np.ascontiguousarray(wire.transpose(1, 0, 2, 3))
    return wire


def make_random_bytes_block(cfg: ObsConfig, seed: int = 0) -> np.ndarray:
    """Uniform random 4R4I bytes on active inputs: bit-format-valid and fast
    to generate at full band (throughput runs).  Padded antenna slots carry
    zero bytes, as the wire contract requires."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, 256, size=cfg.wire_block_shape, dtype=np.uint8)
    blk[..., cfg.n_ant_active:] = 0
    return blk


def make_noise_block(cfg: ObsConfig, rms: float = 2.0, seed: int = 0) -> np.ndarray:
    """Gaussian noise on active antennas, zeros on padding."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant)
    re = np.zeros(shape, np.float32)
    im = np.zeros(shape, np.float32)
    a = cfg.n_ant_active
    sub = shape[:-1] + (a,)
    re[..., :a] = rng.standard_normal(sub, dtype=np.float32)
    im[..., :a] = rng.standard_normal(sub, dtype=np.float32)
    if rms != 1.0:
        re *= np.float32(rms)
        im *= np.float32(rms)
    return _emit(cfg, re, im)


def make_point_source_block(
    cfg: ObsConfig,
    angle_rad: float,
    layout: ArrayLayout | None = None,
    amplitude: float = 5.0,
    noise_rms: float = 0.5,
    seed: int = 0,
    instrumental_gains: np.ndarray | None = None,
) -> np.ndarray:
    """A single point source at ``angle_rad`` plus receiver noise.

    The per-channel source signal is complex Gaussian, identical across
    antennas up to the geometric phase and across pols up to an independent
    realization.  ``instrumental_gains`` (``[n_ant, n_chan]`` complex)
    corrupts each antenna's signal path before the receiver noise.
    """
    rng = np.random.default_rng(seed)
    layout = layout if layout is not None else array_for(cfg)
    f = cfg.freqs_hz()[:, None, None]                      # [F,1,1]
    x = layout.positions_m[None, None, : cfg.n_ant_active]  # [1,1,a]
    steer = np.exp(
        2j * np.pi * f * x * np.sin(angle_rad) / SPEED_OF_LIGHT_M_S
    )  # [F,1,a]

    shape = (cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant)
    sig = amplitude / np.sqrt(2) * (
        rng.standard_normal((cfg.n_chan, cfg.t_block, cfg.n_pol))
        + 1j * rng.standard_normal((cfg.n_chan, cfg.t_block, cfg.n_pol))
    )  # [F,T,P]
    v = sig[..., None] * steer[:, :, None, :]  # [F,T,P,a]
    if instrumental_gains is not None:
        g = np.asarray(instrumental_gains)[: cfg.n_ant_active].T  # [F,a]
        v = v * g[:, None, None, :]

    re = np.zeros(shape, np.float64)
    im = np.zeros(shape, np.float64)
    a = cfg.n_ant_active
    re[..., :a] = v.real + rng.normal(0.0, noise_rms, v.shape)
    im[..., :a] = v.imag + rng.normal(0.0, noise_rms, v.shape)
    return _emit(cfg, re, im)
