"""Per-antenna complex calibration gains (NumPy).

A copy of ``dsabeamformer_tpu/models/calibration.py`` (reachable there only
through a package ``__init__`` that imports JAX).  A ``CalTable`` is plain
data, loadable and savable as ``.npz``, folded into the steering weights by
``models.weights.make_weights``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dsabeamformer_tpu_torch.config import ObsConfig


@dataclasses.dataclass(frozen=True)
class CalTable:
    """Complex gain per (antenna, channel): the calibration solution to
    *apply* (already inverted w.r.t. the instrumental gain)."""

    gains: np.ndarray  # [n_ant, n_chan] complex64

    @property
    def n_ant(self) -> int:
        return self.gains.shape[0]

    @property
    def n_chan(self) -> int:
        return self.gains.shape[1]

    @staticmethod
    def unity(cfg: ObsConfig) -> "CalTable":
        g = np.zeros((cfg.n_ant, cfg.n_chan), dtype=np.complex64)
        g[: cfg.n_ant_active, :] = 1.0
        return CalTable(gains=g)

    @staticmethod
    def random(cfg: ObsConfig, seed: int = 0, amp_sigma: float = 0.1,
               phase_sigma: float = 0.5) -> "CalTable":
        """Plausible non-trivial solution for tests: amplitudes near 1,
        random phases."""
        rng = np.random.default_rng(seed)
        amp = 1.0 + amp_sigma * rng.standard_normal((cfg.n_ant, cfg.n_chan))
        ph = phase_sigma * rng.standard_normal((cfg.n_ant, cfg.n_chan))
        g = (amp * np.exp(1j * ph)).astype(np.complex64)
        g[cfg.n_ant_active:, :] = 0.0
        return CalTable(gains=g)

    def save(self, path: str) -> None:
        np.savez(path, gains=self.gains)

    @staticmethod
    def load(path: str) -> "CalTable":
        return CalTable(gains=np.asarray(np.load(path)["gains"], dtype=np.complex64))
