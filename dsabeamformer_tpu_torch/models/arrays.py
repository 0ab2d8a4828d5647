"""Antenna array layouts (NumPy).

A copy of ``dsabeamformer_tpu/models/arrays.py``: that module is reachable
only through ``dsabeamformer_tpu/models/__init__.py``, which imports JAX.
The coordinates are synthetic but physically plausible linear east-west
layouts; positions are data, so surveyed coordinates drop in through
``ArrayLayout(positions_m=...)`` or ``ArrayLayout.load``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dsabeamformer_tpu_torch.config import ObsConfig


@dataclasses.dataclass(frozen=True)
class ArrayLayout:
    """Antenna coordinates for a phased array.

    ``positions_m`` is the east-west coordinate, length ``n_ant`` (the
    padded GEMM dim); entries beyond the active antennas are zero and
    carry no signal.  ``positions_ns_m`` (optional north-south coordinate)
    generalizes to 2-D station layouts.
    """

    positions_m: np.ndarray  # [n_ant] float64, east-west
    n_active: int
    positions_ns_m: np.ndarray | None = None  # [n_ant] float64, north-south

    @property
    def n_ant(self) -> int:
        return len(self.positions_m)

    @property
    def ns(self) -> np.ndarray:
        if self.positions_ns_m is None:
            return np.zeros_like(self.positions_m)
        return self.positions_ns_m

    @property
    def active_mask(self) -> np.ndarray:
        m = np.zeros(self.n_ant, dtype=bool)
        m[: self.n_active] = True
        return m

    def padded(self, n_ant: int) -> "ArrayLayout":
        """Zero-pad the antenna axis to the config's padded GEMM dim
        (a surveyed table lists only physical dishes)."""
        if n_ant < self.n_ant:
            raise ValueError(
                f"cannot pad {self.n_ant} antennas down to {n_ant}"
            )
        if n_ant == self.n_ant:
            return self
        pos = np.zeros(n_ant, dtype=np.float64)
        pos[: self.n_ant] = self.positions_m
        ns = None
        if self.positions_ns_m is not None:
            ns = np.zeros(n_ant, dtype=np.float64)
            ns[: self.n_ant] = self.positions_ns_m
        return ArrayLayout(positions_m=pos, n_active=self.n_active,
                           positions_ns_m=ns)

    def save(self, path: str) -> None:
        np.savez(path, positions_m=self.positions_m, n_active=self.n_active,
                 positions_ns_m=self.ns)

    @staticmethod
    def load(path: str) -> "ArrayLayout":
        """Load a position table: the package's ``.npz`` (``save``), or a
        plain-text table with one row per physical antenna and 1 column
        (east-west metres) or 2 (east-west, north-south); ``#`` comments
        allowed."""
        if str(path).endswith(".npz"):
            d = np.load(path)
            ns = None
            if "positions_ns_m" in d and np.any(d["positions_ns_m"]):
                ns = np.asarray(d["positions_ns_m"], dtype=np.float64)
            return ArrayLayout(
                positions_m=np.asarray(d["positions_m"], dtype=np.float64),
                n_active=int(d["n_active"]),
                positions_ns_m=ns,
            )
        table = np.atleast_2d(np.loadtxt(path, comments="#", ndmin=2))
        if table.shape[1] not in (1, 2):
            raise ValueError(
                f"position table {path!r} has {table.shape[1]} columns "
                f"(expected 1 [EW] or 2 [EW, NS])"
            )
        ew = np.ascontiguousarray(table[:, 0], dtype=np.float64)
        ns = (np.ascontiguousarray(table[:, 1], dtype=np.float64)
              if table.shape[1] == 2 and np.any(table[:, 1]) else None)
        return ArrayLayout(positions_m=ew, n_active=len(ew),
                           positions_ns_m=ns)


def linear_array(n_ant: int, n_active: int, spacing_m: float) -> ArrayLayout:
    pos = np.zeros(n_ant, dtype=np.float64)
    pos[:n_active] = np.arange(n_active) * spacing_m
    # Center the active array so beam phases are balanced around 0.
    pos[:n_active] -= pos[:n_active].mean()
    return ArrayLayout(positions_m=pos, n_active=n_active)


def array_for(cfg: ObsConfig) -> ArrayLayout:
    """Default layout for a config preset: the active dishes on an E-W
    line at 5 m pitch (synthetic coordinates)."""
    spacing = 5.0
    return linear_array(cfg.n_ant, cfg.n_ant_active, spacing)
