"""Fringe / pointing tracking over time.

The same tracker as ``dsabeamformer_tpu/models/tracking.py``: as the sky
rotates, the fringe phase of the pointing centre drifts, and the weights are
regenerated (``make_weights`` then ``quantize_weights``, on the tracker's
device) when the accumulated drift would cost more than
``max_phase_error_rad`` of phase at the top of the band on the longest
baseline.  The streaming loop polls ``maybe_update(t)`` between blocks and
swaps the new weights in without draining.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from dsabeamformer_tpu_torch.config import SPEED_OF_LIGHT_M_S, ObsConfig
from dsabeamformer_tpu_torch.models.arrays import ArrayLayout, array_for
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops.quantize import QuantWeights, quantize_weights
from dsabeamformer_tpu_torch.utils.device import resolve_device

#: Earth rotation rate (sidereal), rad/s.
EARTH_ROT_RAD_S = 7.2921159e-5


@dataclasses.dataclass
class FringeTracker:
    """Drift-scan pointing model: the tracked direction moves across the fan
    at the sidereal rate (projected by cos(declination)).  Weights are made
    on ``device`` (the card unless the caller names another)."""

    cfg: ObsConfig
    layout: Optional[ArrayLayout] = None
    cal: Optional[CalTable] = None
    pointing0_rad: float = 0.0
    declination_rad: float = 0.0
    max_phase_error_rad: float = 0.05
    #: Optional CVec -> CVec edit applied to every regenerated table before
    #: quantization (channel zap, antenna flags), so that an update does not
    #: undo an excision.
    edit: Optional[Callable] = None
    device: object = "cuda"
    _last_update_t: Optional[float] = dataclasses.field(default=None,
                                                        init=False)
    _n_updates: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.layout is None:
            self.layout = array_for(self.cfg)
        if self.cal is None:
            self.cal = CalTable.unity(self.cfg)

    def pointing_at(self, t_s: float) -> float:
        return (
            self.pointing0_rad
            + EARTH_ROT_RAD_S * np.cos(self.declination_rad) * t_s
        )

    @property
    def update_interval_s(self) -> float:
        """Time for the drift to accumulate ``max_phase_error_rad`` at the
        top of the band on the longest baseline."""
        x = self.layout.positions_m[: self.cfg.n_ant_active]
        bl = float(x.max() - x.min()) if len(x) > 1 else 1.0
        f_max = float(self.cfg.freqs_hz().max())
        dphase_dt = (
            2 * np.pi * f_max * bl / SPEED_OF_LIGHT_M_S
            * EARTH_ROT_RAD_S * abs(np.cos(self.declination_rad))
        )
        return self.max_phase_error_rad / max(dphase_dt, 1e-30)

    def weights_at(self, t_s: float) -> QuantWeights:
        w = make_weights(
            self.cfg,
            layout=self.layout,
            cal=self.cal,
            pointing_rad=self.pointing_at(t_s),
            device=self.device,
        )
        if self.edit is not None:
            w = self.edit(w)
        return quantize_weights(w, self.cfg.weight_mode, self.cfg.a_compute)

    def maybe_update(self, t_s: float) -> Optional[QuantWeights]:
        """Fresh weights if the drift since the last update exceeds the
        phase budget, else None."""
        if (
            self._last_update_t is not None
            and t_s - self._last_update_t < self.update_interval_s
        ):
            return None
        self._last_update_t = t_s
        self._n_updates += 1
        return self.weights_at(t_s)

    @property
    def n_updates(self) -> int:
        return self._n_updates

    def set_calibration(self, cal: CalTable) -> None:
        """A new calibration solution: regenerate at the next poll."""
        self.cal = cal
        self._last_update_t = None

    def invalidate(self) -> None:
        """Regenerate at the next poll, at the stream's current pointing
        (an excision reaches the new table through ``edit``)."""
        self._last_update_t = None
