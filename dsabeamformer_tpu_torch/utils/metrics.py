"""Per-block metrics and the stream's stats record.

The same records as ``dsabeamformer_tpu/utils/metrics.py``, with the
utilization taken against the published dense tensor-core peak, for the
operand type of ``cfg.weight_mode`` (int8 or bfloat16), of the card the run
used, found from ``torch.cuda.get_device_name``.  A device the table does
not know (the CPU included) has no peak unless ``DSABF_PEAK_INT8_MACS`` /
``DSABF_PEAK_BF16_MACS`` (MAC/s) give one, and the f32 mode, whose MACs do
not run on the tensor cores, never has: the utilization is then reported
as ``None``, never guessed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

from dsabeamformer_tpu_torch.config import ObsConfig

#: Dense (no sparsity) tensor-core peaks, (int8 TOP/s, bf16 TFLOP/s), from
#: NVIDIA's data sheets, by a substring of ``torch.cuda.get_device_name``.
#: Checked in order: the PCIe and NVL parts of the H100 are named apart from
#: the SXM part ("NVIDIA H100 80GB HBM3").
_PEAK_TOPS = (
    ("h100 pcie", (1513e12, 756e12)),
    ("h100 nvl", (1670.5e12, 835.5e12)),
    ("h100", (1979e12, 989e12)),
    ("h200", (1979e12, 989e12)),
)

#: Operand type of each weight mode's MACs: index into ``_PEAK_TOPS``, or
#: None for f32, which has no tensor-core path (TF32 is not float32).
_MODE_OPERAND = {"int8": 0, "int8x2": 0, "int12": 0, "int13": 0,
                 "bf16": 1, "bf16x2": 1, "f32": None}


def peak_macs_per_s(device_kind: str,
                    weight_mode: str = "int8x2") -> Optional[float]:
    """Dense tensor-core peak in MAC/s (operations / 2) of the card named
    ``device_kind`` for the operand type of ``weight_mode``; None for a
    device the table does not know and for the f32 mode.

    As in the JAX package, ``DSABF_PEAK_INT8_MACS`` / ``DSABF_PEAK_BF16_MACS``
    (MAC/s) override the table for their operand type: for a card it does
    not know, or one held below its data-sheet rate."""
    operand = _MODE_OPERAND[weight_mode]
    if operand is None:
        return None
    env = os.environ.get(
        ("DSABF_PEAK_INT8_MACS", "DSABF_PEAK_BF16_MACS")[operand])
    if env:
        return float(env)
    kind = device_kind.lower()
    for key, tops in _PEAK_TOPS:
        if key in kind:
            return tops[operand] / 2.0
    return None


def tensor_core_utilization(macs: int, wall_s: float, cfg: ObsConfig,
                            device_kind: str) -> Optional[dict]:
    """Two labeled accountings of one measurement against the peak for
    ``cfg.weight_mode``'s operand type (``peak_macs_per_s``):

    - ``issued``: MACs the kernel issues (the a_compute-sliced contraction)
      per second / peak.
    - ``padded_k``: the same time booked with the full zero-padded ``n_ant``
      contraction, ``n_ant/a_compute`` more nominal MACs.

    None when the device or the mode has no peak, or the time is zero."""
    peak = peak_macs_per_s(device_kind, cfg.weight_mode)
    if peak is None or not wall_s:
        return None
    issued = macs / wall_s / peak
    return {"issued": issued, "padded_k": issued * (cfg.n_ant / cfg.a_compute)}


#: The streaming loop's host stages, each timed on the host's clock: the
#: source's release and read, the wait for a ring slot's H2D copy, the
#: enqueue (weights, scales, the launches), the wait for a block's D2H
#: copies, the sinks and the search monitor, the RFI monitor's poll and the
#: caller's ``on_block``.
STAGES = ("read", "h2d_wait", "enqueue", "drain_wait", "sinks", "rfi",
          "on_block")

#: The loop's counters and stage seconds in ``StreamStats.record``, beyond
#: the JAX package's record.
LOOP_KEYS = ("weight_swaps", "rfi_events", "sk_blocks", "float_blocks",
             "drains_waited", "early_drains", *(f"{k}_s" for k in STAGES),
             "search_windows", "search_candidates", "search_rfi_rejected",
             "search_s")


@dataclasses.dataclass
class BlockStats:
    """One record per processed block.

    The stage seconds are this block's: ``read_s`` (the source's release of
    the block before and read of this one) ends where ``wall_s`` begins;
    ``enqueue_s``, ``inflight_s`` (enqueue end -> drain start, which holds
    ``h2d_wait_s``), ``drain_wait_s`` and ``sinks_s`` lie inside it, and
    ``rfi_s`` (the block's retire) follows it.  A block delivered before
    its retire point reaches ``on_block`` with ``rfi_s`` still 0.
    ``search_s`` is the search monitor's part of ``sinks_s``: the block's
    append to its window and the beam groups searched after it."""

    block_idx: int
    seq: int                 # source sequence number
    wall_s: float            # enqueue -> drained, for this block
    bytes_in: int
    dropped: int             # cumulative source drops at this point
    skipped: int             # cumulative reader skip-aheads
    read_s: float = 0.0
    enqueue_s: float = 0.0
    h2d_wait_s: float = 0.0
    inflight_s: float = 0.0
    drain_wait_s: float = 0.0
    sinks_s: float = 0.0
    rfi_s: float = 0.0
    search_s: float = 0.0

    def line(self, cfg: ObsConfig) -> str:
        gbs = self.bytes_in / self.wall_s / 1e9 if self.wall_s > 0 else 0.0
        rt = cfg.block_duration_s / self.wall_s if self.wall_s > 0 else 0.0
        return (
            f"block {self.block_idx:6d} seq {self.seq:6d} "
            f"{self.wall_s * 1e3:7.2f} ms  {gbs:6.2f} GB/s  {rt:6.2f}x RT  "
            f"dropped {self.dropped}  skipped {self.skipped}"
        )


@dataclasses.dataclass
class StreamStats:
    """Aggregate over a streaming run."""

    cfg_name: str
    device_kind: str = "cpu"
    n_blocks: int = 0
    bytes_in: int = 0
    wall_s: float = 0.0
    dropped: int = 0
    skipped: int = 0
    macs: int = 0
    weight_swaps: int = 0    # weights swapped in mid-stream (tracker, RFI)
    rfi_events: int = 0      # the RFI monitor's events (excisions, caps)
    sk_blocks: int = 0       # blocks launched with the SK accumulators
    float_blocks: int = 0    # 8-bit sink blocks run without the uint8 epilogue
    drains_waited: int = 0   # drains whose D2H copies were not yet done
    early_drains: int = 0    # blocks delivered in a wait, before retire
    search_windows: int = 0  # windows the search monitor searched
    search_candidates: int = 0  # its candidates, after the coincidence veto
    search_rfi_rejected: int = 0  # its clusters rejected as RFI
    read_s: float = 0.0      # host seconds by stage (STAGES)
    h2d_wait_s: float = 0.0
    enqueue_s: float = 0.0
    drain_wait_s: float = 0.0
    sinks_s: float = 0.0
    rfi_s: float = 0.0
    on_block_s: float = 0.0
    search_s: float = 0.0    # host seconds in the search monitor (of sinks_s)
    _t_start: float = dataclasses.field(default_factory=time.perf_counter)

    def finish(self) -> "StreamStats":
        self.wall_s = time.perf_counter() - self._t_start
        return self

    @property
    def gb_per_s(self) -> float:
        return self.bytes_in / self.wall_s / 1e9 if self.wall_s else 0.0

    def realtime_factor(self, cfg: ObsConfig) -> float:
        data_s = self.n_blocks * cfg.block_duration_s
        return data_s / self.wall_s if self.wall_s else 0.0

    def tensor_core_utilization(self, cfg: ObsConfig) -> Optional[dict]:
        return tensor_core_utilization(self.macs, self.wall_s, cfg,
                                       self.device_kind)

    def record(self, cfg: ObsConfig) -> dict:
        util = self.tensor_core_utilization(cfg)
        return {
            "config": self.cfg_name,
            "device": self.device_kind,
            "blocks": self.n_blocks,
            "bytes": self.bytes_in,
            "wall_s": self.wall_s,
            "gb_per_s": self.gb_per_s,
            "realtime_factor": self.realtime_factor(cfg),
            "tc_utilization_issued": None if util is None else util["issued"],
            "tc_utilization_padded_k":
                None if util is None else util["padded_k"],
            "dropped": self.dropped,
            "skipped": self.skipped,
            **{k: getattr(self, k) for k in LOOP_KEYS},
        }

    def json_line(self, cfg: ObsConfig) -> str:
        return json.dumps(self.record(cfg))
