"""Multi-process deployment: one process per host (or per card), each on its
own subband, under ``torch.distributed``.

The reference split the band across GPUs by having the packet capture fan
out disjoint subbands to each process, with no data path between them.
The port keeps that shape: each process ingests only its subband, streams
it through the slots of its own mesh (``MultihostMeshStreamingBeamformer``)
and writes its own subband's products (the per-subband files that
``dsabf-torch splice`` merges).  Voltages never cross processes; the only
collective is the optional band total power, summed over the process's
slots and then ``all_reduce``d over the processes.

``initialize_multihost`` starts the process group.  Nothing on a machine
tells a program of its cluster, so the caller names the coordinator's
``host:port``, the number of processes and this process's index.  The
subband arithmetic below is plain host logic.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.ops.quantize import QuantWeights
from dsabeamformer_tpu_torch.parallel.sharding import place_weights
from dsabeamformer_tpu_torch.pipeline import MeshStreamingBeamformer


@dataclasses.dataclass(frozen=True)
class HostSubband:
    """The contiguous channel range a host ingests and beamforms."""

    host_index: int
    n_hosts: int
    chan_start: int
    n_chan: int

    def config(self, cfg: ObsConfig) -> ObsConfig:
        """Per-host ObsConfig (correct subband frequencies for weight
        generation)."""
        return cfg.subband(self.chan_start, self.n_chan)


def host_subbands(cfg: ObsConfig, n_hosts: int) -> List[HostSubband]:
    """Disjoint contiguous subband per host: the capture fan-out plan (the
    reference's per-GPU subband assignment)."""
    if cfg.n_chan % n_hosts:
        raise ValueError(f"n_chan={cfg.n_chan} not divisible by {n_hosts} hosts")
    per = cfg.n_chan // n_hosts
    return [
        HostSubband(h, n_hosts, h * per, per) for h in range(n_hosts)
    ]


def _world() -> tuple:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without
    one (as ``jax.process_index`` / ``process_count`` outside a pod)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def my_subband(cfg: ObsConfig) -> HostSubband:
    """This process's subband under ``torch.distributed``."""
    rank, world = _world()
    return host_subbands(cfg, world)[rank]


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, *,
                         backend: Optional[str] = None) -> None:
    """Join the process group: ``dist.init_process_group`` over TCP at
    ``coordinator_address`` (``host:port``, process 0's).

    ``backend=None`` takes ``"nccl"`` when a card is visible and ``"gloo"``
    on the CPU; processes that share one card pass ``"gloo"`` (NCCL refuses
    two ranks on one device).  A backend that fails raises; nothing falls
    back to another."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = "tcp://" + addr
    dist.init_process_group(backend=backend, init_method=addr,
                            world_size=num_processes, rank=process_id)


class MultihostMeshStreamingBeamformer(MeshStreamingBeamformer):
    """The per-process stream of a multi-process deployment.

    Every process runs one of these in lockstep over the same block
    sequence.  ``cfg`` is the full band; the process's subband
    (``my_subband(cfg)``) is its stream's config, its source yields that
    subband's blocks (shaped by ``my_subband(cfg).config(cfg)``), and its
    ``mesh`` holds its own slots.  ``weights`` (also in
    ``update_weights``) is the full-band table every process makes alike
    (weights are a pure function of the config and calibration): each takes
    its subband's channels and splits them over its slots.  The drain hands
    the process's own products to its sinks.  With ``with_band_power``
    each block's band sum over the process's slots is ``all_reduce``d over
    the processes (a collective every process makes at the same drain).

    No RFI monitor: attaching one raises (``ROADMAP.md``: a per-host
    monitor is a feature the JAX package lacks as well).  The search monitor
    works as it is, on the process's own product."""

    def __init__(self, cfg: ObsConfig, weights: QuantWeights, source,
                 sink=None, *, mesh, **kwargs):
        self._sub = my_subband(cfg)
        self._full_cfg = cfg
        super().__init__(self._sub.config(cfg), weights, source, sink,
                         mesh=mesh, **kwargs)

    @property
    def rfi_monitor(self):
        return None

    @rfi_monitor.setter
    def rfi_monitor(self, monitor) -> None:
        if monitor is not None:
            raise ValueError(
                "the multihost stream takes no RFI monitor: its SK "
                "statistics would cover one process's subband only "
                "(ROADMAP.md, after the port: a per-host RFI monitor on "
                "each process's own subband)")

    def _place(self, qw: QuantWeights) -> tuple:
        full = self._full_cfg.n_chan
        if qw.n_chan != full:
            raise ValueError(
                f"the multihost stream takes the full-band table "
                f"({full} channels) and takes its subband itself; got "
                f"{qw.n_chan} channels")
        sl = slice(self._sub.chan_start,
                   self._sub.chan_start + self._sub.n_chan)
        return place_weights(
            QuantWeights(terms=tuple(t[sl] for t in qw.terms),
                         scales=qw.scales[sl]), self.mesh)

    def _reduce_band(self, band: torch.Tensor) -> torch.Tensor:
        if _world()[1] == 1:
            return band
        if dist.get_backend() != "nccl":
            band = band.cpu()
        dist.all_reduce(band)
        return band
