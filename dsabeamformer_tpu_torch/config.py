"""Observation configuration: the array, band and block geometry.

The same dataclass, presets and derived quantities as
``dsabeamformer_tpu/config.py``, field for field, kept here so that the port
imports nothing of the JAX package; ``tests/test_torch_config.py`` holds the
two definitions equal for every preset.  The TPU tiling knobs of the JAX
config (``time_tile``, ``chan_tile`` and ``shrink_tiles``) size Pallas grid
cells and have no meaning for the port's kernels, so they are absent.

Wire format: one byte per complex voltage sample, the real part in the high
nibble and the imaginary part in the low nibble, each 4-bit two's complement
in [-8, 7].  A block is ``[T, F, P, A]`` (``"tfpa"``, time-major) or
``[F, T, P, A]`` (``"ftpa"``), and reaches the device in the canonical 2-D or
3-D form ``device_wire_shape``.  Only the first ``n_ant_active`` antenna
slots carry signal; the others are zero by contract.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

SPEED_OF_LIGHT_M_S = 299_792_458.0

#: Cold-plasma dispersion: delay_s = DM_CONST_S * DM[pc cm^-3] * f[MHz]^-2
#: (shared by the pulse generator and the dedispersion search).
DM_CONST_S = 4.148808e3


def dm_delays_s(f_mhz, dm: float, ref_mhz: float):
    """Cold-plasma arrival delays [s] of channels ``f_mhz`` relative to
    ``ref_mhz`` (conventionally the top of the band, which arrives first):
    the one definition of the curve that the pulse generator and the search
    share."""
    f = np.asarray(f_mhz, np.float64)
    return DM_CONST_S * dm * (f ** -2.0 - float(ref_mhz) ** -2.0)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Static observation configuration (immutable, hashable)."""

    name: str = "dsa10"
    # --- array geometry ---
    n_ant: int = 64            # padded antenna axis of the wire
    n_ant_active: int = 10     # physical dishes carrying signal
    n_beams: int = 256
    n_chan: int = 2048         # channels processed by this instance
    n_chan_total: int = 2048   # channels in the full band (sets sample rate)
    n_pol: int = 2
    # --- streaming block geometry ---
    t_block: int = 2048        # time samples per ingest block
    navg_time: int = 16        # post-detection time averaging
    navg_freq: int = 1         # optional adjacent-channel averaging
    # --- band / beam geometry ---
    f_start_hz: float = 1.28e9
    bandwidth_hz: float = 250e6
    beam_span_deg: float = 2.6   # full fan width, beams uniform in sin(theta)
    # --- numerics ---
    weight_mode: str = "int8x2"  # int13 | int12 | int8x2 | int8 | bf16
                                 # | bf16x2 | f32 (see ops/quantize.py)
    n_ant_compute: int = 0       # antennas contracted; 0 = auto (a_compute)
    input_layout: str = "tfpa"   # wire layout delivered by the capture

    def __post_init__(self):
        if self.n_pol != 2:
            raise ValueError("n_pol must be 2 (wire format and epilogue assume dual pol)")
        if self.n_ant_active > self.n_ant:
            raise ValueError("n_ant_active must be <= n_ant")
        if self.t_block % self.navg_time:
            raise ValueError("t_block must be a multiple of navg_time")
        if self.n_chan % self.navg_freq:
            raise ValueError("n_chan must be a multiple of navg_freq")
        if self.weight_mode not in ("int13", "int12", "int8x2", "int8",
                                    "bf16", "bf16x2", "f32"):
            raise ValueError(f"unknown weight_mode: {self.weight_mode}")
        if self.input_layout not in ("tfpa", "ftpa"):
            raise ValueError(f"unknown input_layout: {self.input_layout}")
        if self.n_ant_compute:
            if self.n_ant_compute % 8:
                raise ValueError("n_ant_compute must be a multiple of 8")
            if not (self.n_ant_active <= self.n_ant_compute <= self.n_ant):
                raise ValueError(
                    "n_ant_compute must satisfy "
                    "n_ant_active <= n_ant_compute <= n_ant"
                )

    # ------------------------------------------------------------------ #
    # Derived quantities
    # ------------------------------------------------------------------ #

    @property
    def sample_period_s(self) -> float:
        """Per-channel complex sample period (DSA-10: 2048 ch / 250 MHz =
        8.192 us)."""
        return self.n_chan_total / self.bandwidth_hz

    @property
    def block_duration_s(self) -> float:
        return self.t_block * self.sample_period_s

    @property
    def wire_block_shape(self) -> Tuple[int, int, int, int]:
        if self.input_layout == "tfpa":
            return (self.t_block, self.n_chan, self.n_pol, self.n_ant)
        return (self.n_chan, self.t_block, self.n_pol, self.n_ant)

    @property
    def wire_block_bytes(self) -> int:
        return self.t_block * self.n_chan * self.n_pol * self.n_ant

    @property
    def device_wire_shape(self) -> Tuple[int, ...]:
        """The device-side wire block: ``[T, F*P*A]`` for tfpa,
        ``[F, T, P*A]`` for ftpa (a free view of the 4-D host block)."""
        pa = self.n_pol * self.n_ant
        if self.input_layout == "tfpa":
            return (self.t_block, self.n_chan * pa)
        return (self.n_chan, self.t_block, pa)

    @property
    def out_block_shape(self) -> Tuple[int, int, int]:
        """[F/navg_f, T/navg_t, B] float32 averaged beam powers."""
        return (
            self.n_chan // self.navg_freq,
            self.t_block // self.navg_time,
            self.n_beams,
        )

    @property
    def realtime_bytes_per_s(self) -> float:
        """Wire byte rate of a 1x real-time stream for this config."""
        return self.wire_block_bytes / self.block_duration_s

    def freqs_hz(self) -> np.ndarray:
        """Center frequency of each channel processed by this instance."""
        df = self.bandwidth_hz / self.n_chan_total
        return self.f_start_hz + df * (np.arange(self.n_chan) + 0.5)

    def beam_angles_rad(self) -> np.ndarray:
        """Beam steering angles, uniform in sin(theta) across the fan."""
        half = np.sin(np.deg2rad(self.beam_span_deg / 2.0))
        s = np.linspace(-half, half, self.n_beams)
        return np.arcsin(s)

    def subband(self, chan_start: int, n_chan: int) -> "ObsConfig":
        """Config for a contiguous subband slice."""
        df = self.bandwidth_hz / self.n_chan_total
        return dataclasses.replace(
            self,
            n_chan=n_chan,
            f_start_hz=self.f_start_hz + chan_start * df,
        )

    def replace(self, **kw) -> "ObsConfig":
        return dataclasses.replace(self, **kw)

    @property
    def a_compute(self) -> int:
        """Antennas the GEMM contracts over: ``n_ant_compute``, or
        ``n_ant_active`` rounded up to 32 (16 for int13), capped at
        ``n_ant``.  Slots past it are zero on the wire."""
        if self.n_ant_compute:
            return self.n_ant_compute
        mult = 16 if self.weight_mode == "int13" else 32
        return min(self.n_ant, -(-self.n_ant_active // mult) * mult)

    @property
    def gemm_k(self) -> int:
        """Contraction length of each weight term: 2*a_compute (4x and 8x
        for the x16-folded int12 / int13 modes)."""
        mult = {"int12": 4, "int13": 8}.get(self.weight_mode, 2)
        return mult * self.a_compute

    @property
    def macs_per_block(self) -> int:
        """Real multiply-accumulates per block for ONE weight term."""
        return (self.n_pol * self.t_block * self.gemm_k
                * 2 * self.n_beams * self.n_chan)

    @property
    def n_weight_terms(self) -> int:
        return 2 if self.weight_mode in ("int8x2", "bf16x2") else 1


# --------------------------------------------------------------------- #
# Presets
# --------------------------------------------------------------------- #

#: DSA-10 full band on one device: 64 ant (10 active), 256 beams, 2048 chan,
#: 8192-sample blocks (67.1 ms of sky, 2.1 GB of wire).
DSA10 = ObsConfig(name="dsa10", t_block=8192)

#: DSA-10 on a compact 16-slot wire: same science, a quarter of the bytes.
DSA10_COMPACT = DSA10.replace(name="dsa10c", n_ant=16)

#: DSA-110 scale: 110 ant padded to 128, 512 beams.
DSA110 = ObsConfig(
    name="dsa110",
    n_ant=128,
    n_ant_active=110,
    n_beams=512,
    n_chan=2048,
    n_chan_total=2048,
    t_block=4096,
)

#: Tiny geometry for CPU unit tests.
TINY = ObsConfig(
    name="tiny",
    n_ant=16,
    n_ant_active=6,
    n_beams=32,
    n_chan=8,
    n_chan_total=8,
    t_block=64,
    navg_time=16,
    f_start_hz=1.4e9,
    bandwidth_hz=250e6,
)


def presets() -> dict:
    return {"dsa10": DSA10, "dsa10c": DSA10_COMPACT, "dsa110": DSA110,
            "tiny": TINY}
