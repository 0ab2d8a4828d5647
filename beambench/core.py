"""What a cell's run is given (``Run``) and what its kind hands back
(``Outcome``), shared by the kinds, the metric readers and the check."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Run:
    cell: str
    config: dict          # configs/<name>.json
    mix: dict             # traffic/<name>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float      # perf_counter() at process start
    control: bool = False  # the program's lower-precision path
    device_kind: str = "cpu"
    chips: int = 1

    @property
    def block_s(self) -> float:
        obs = self.config["obs"]
        return obs["t_block"] * obs["n_chan_total"] / obs["bandwidth_hz"]

    @property
    def trace_window(self) -> tuple:
        """``(lead, length)`` in seconds of the traced sub-window inside the
        measured one."""
        lead = min(float(self.mix["trace_lead_s"]), 0.2 * self.seconds)
        return lead, min(float(self.mix["trace_s"]), 0.6 * self.seconds)

    def rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng([int(self.seed), stream])


@dataclasses.dataclass
class Kept:
    """One sampled block's products as the program returned them."""

    content: int    # index of the input block (inputs.wire_block)
    products: dict  # product name (products/<name>.py) -> its data, or None


@dataclasses.dataclass
class Outcome:
    t0: float                    # window open (perf_counter)
    t1: float                    # window close
    setup_s: float
    attempted: int
    failed: int
    kept: list                   # [Kept]
    memory_peak_bytes: int = 0
    drains: list = dataclasses.field(default_factory=list)  # [(seq, t)]
    due: dict = dataclasses.field(default_factory=dict)     # seq -> t due
    completed: int = 0           # resident: launches completed in the window
    order_faults: int = 0        # blocks drained out of order or twice
    lost: int = 0                # sampled blocks offered and never drained
    scales: Optional[np.ndarray] = None  # the program's 8-bit scales, [B]
    trace: object = None         # trace.TraceView of a --trace 1 run
    trace_blocks: int = 0        # blocks completed in the traced window
    notes: dict = dataclasses.field(default_factory=dict)  # stderr only

    def drained_in_window(self) -> int:
        return sum(1 for _, t in self.drains if self.t0 < t <= self.t1)

    def latencies_ms(self) -> list:
        """Due-to-drain latency of every block due in the window; a block
        that never drained reads as infinite."""
        drained = dict(self.drains)
        return [(drained[s] - t) * 1e3 if s in drained else math.inf
                for s, t in self.due.items()]
