"""Channel-sharded beamforming over a mesh of device slots.

The reference scaled out by running one process per GPU on a disjoint
subband, with no traffic between them: "multi-GPU correctness reduces to
single-GPU correctness".  Here one process drives a 1-D ``("chan",)`` mesh
of device slots: each slot runs the single-device detect kernel
(``ops.gemm.beamform_power`` / ``beamform_stokes``) on its own contiguous
subband, and the products are gathered along the channel axis on the mesh's
first slot.  The per-channel arithmetic does not depend on the number of
channels, so the gathered product is the single-device product byte for
byte.  The optional band-total-power monitor is the one reduction: each
slot sums its product over channels and beams, and the slots' sums are added
(the JAX package's ``psum`` over the channel axis).

A slot is a ``torch.device``, and a device may fill several slots: eight
``"cpu"`` slots are the tests' mesh, eight ``"cuda:0"`` slots run the mesh
on one card (the counterpart of the JAX package's virtual CPU devices).

The DSA-110 deployment (2048 channels as eight 256-channel subbands, 110
antennas in 128 slots, 512 beams) is the acceptance configuration.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.models.arrays import ArrayLayout
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops.gemm import (
    _prepare_wire,
    beamform_power,
    beamform_stokes,
)
from dsabeamformer_tpu_torch.ops.quantize import QuantWeights, quantize_weights
from dsabeamformer_tpu_torch.utils.device import resolve_device

AXIS = "chan"


class Mesh:
    """Device slots on named axes: the port's counterpart of
    ``jax.sharding.Mesh``.  ``devices`` is an object array of
    ``torch.device`` whose shape gives the axes' sizes (``shape``, a dict as
    JAX's); ``slots`` lists them in row-major order."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {grid.shape} needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        self.devices = np.empty(grid.shape, dtype=object)
        self.devices.flat[:] = [resolve_device(d) for d in grid.flat]
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def slots(self) -> list:
        return list(self.devices.flat)

    @property
    def home(self) -> torch.device:
        """The first slot: where the products are gathered."""
        return self.devices.flat[0]


def visible_devices(devices: Optional[Sequence] = None) -> list:
    """``devices`` as ``torch.device``s (repeats allowed), or by default
    every visible CUDA device once."""
    if devices is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def make_mesh(n_devices: Optional[int] = None, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D channel mesh over the first ``n_devices`` devices: by default the
    visible CUDA devices, each once (raises ``ValueError("requested N
    devices, have M")`` when fewer exist, as the JAX package does);
    ``devices`` names the slots instead, and may repeat one device (``["cpu"]
    * 8``, ``["cuda:0"] * 8``: several slots on one device, the counterpart
    of the JAX package's virtual CPU devices).  Each slot owns a contiguous
    subband."""
    devs = visible_devices(devices)
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    if n_devices < 1:
        raise ValueError("a mesh needs at least one device: none is visible "
                         "(name the slots with devices=[...])")
    return Mesh(devs[:n_devices], (AXIS,))


def _check_divisible(cfg: ObsConfig, n: int) -> None:
    if cfg.n_chan % n:
        raise ValueError(f"n_chan={cfg.n_chan} not divisible by mesh size {n}")
    if (cfg.n_chan // n) % cfg.navg_freq:
        raise ValueError("per-shard channels must be a multiple of navg_freq")


class WireSharding:
    """The channel split of a wire block in the canonical device form
    (``cfg.device_wire_shape``) over a mesh, JAX's ``NamedSharding`` of the
    wire:

    - tfpa ``[T, F*P*A]``: channels are channel-major in dim 1, so an equal
      split of dim 1 is the contiguous subband split (each part is a column
      block of row stride F*P*A, copied once to be contiguous, as the
      kernels read it);
    - ftpa ``[F, T, P*A]``: channels are dim 0 (each part already
      contiguous).
    """

    def __init__(self, cfg: ObsConfig, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.dim = 0 if cfg.input_layout == "ftpa" else 1

    def put(self, wire) -> tuple:
        """One contiguous part of ``wire`` (a tensor or NumPy array, device
        or 4-D host form) on each slot's device, in slot order."""
        x, _ = _prepare_wire(wire, self.cfg)
        n = self.mesh.size
        # A tfpa part is copied: as 8-byte words where its rows are whole
        # words (a copy of single bytes ran at a quarter of the rate).
        wide = self.dim == 1 and x.is_contiguous() \
            and x.shape[1] % (8 * n) == 0
        if wide:
            x = x.view(torch.int64)
        parts = (p.to(d).contiguous()
                 for p, d in zip(x.chunk(n, dim=self.dim), self.mesh.slots))
        return tuple(p.view(torch.uint8) if wide else p for p in parts)


def sharded_wire_sharding(cfg: ObsConfig, mesh: Mesh) -> WireSharding:
    """How wire blocks split over ``mesh``: ``sharded_wire_sharding(cfg,
    mesh).put(wire)`` is the port's ``jax.device_put(wire, ...)`` (each
    capture NIC feeding its own subband's slot)."""
    return WireSharding(cfg, mesh)


def place_weights(qw: QuantWeights, mesh: Mesh) -> tuple:
    """Split an already-quantized full-band ``QuantWeights`` by channel over
    the mesh: one ``QuantWeights`` a slot, in slot order, on the slot's
    device (a view of the table where it is already there).  The
    mid-stream weight-update path of the mesh stream: trackers and solvers
    make ordinary tables, and the swap re-splits them without
    regeneration."""
    n = mesh.size
    if qw.n_chan % n:
        raise ValueError(f"a table of {qw.n_chan} channels does not split "
                         f"over {n} slots")
    w = qw.n_chan // n
    return tuple(
        QuantWeights(
            terms=tuple(t[k * w:(k + 1) * w].to(d) for t in qw.terms),
            scales=qw.scales[k * w:(k + 1) * w].to(d))
        for k, d in enumerate(mesh.slots))


def shard_weights(
    cfg: ObsConfig,
    mesh: Mesh,
    layout: Optional[ArrayLayout] = None,
    cal: Optional[CalTable] = None,
    pointing_rad: float = 0.0,
) -> tuple:
    """Make and quantize the full-band table on the mesh's first slot, then
    split it by channel (``place_weights``)."""
    qw = quantize_weights(
        make_weights(cfg, layout=layout, cal=cal, pointing_rad=pointing_rad,
                     device=mesh.home),
        cfg.weight_mode, cfg.a_compute)
    return place_weights(qw, mesh)


def sharded_beamformer(cfg: ObsConfig, mesh: Mesh, *,
                       with_band_power: bool = False,
                       products: str = "power",
                       incoherent: bool = False,
                       flag_ants: tuple = (),
                       sk_stats: bool = False,
                       fused_quant8: bool = False):
    """The multi-slot block step.

    Returns ``step(wire, qw_sh[, quant8_scales])``: ``wire`` is a full
    block (tensor or array, split by ``sharded_wire_sharding``) or the
    tuple its ``put`` made; ``qw_sh`` the tuple ``shard_weights`` /
    ``place_weights`` made.  Each slot runs the single-device detect kernel
    at ``cfg.replace(n_chan=n_chan // n)`` on its device's current stream,
    and every single-device side output rides along (each is per-channel
    arithmetic the split leaves shared-nothing):

    - ``products="stokes"``: I/Q/U/V, ``[F/navg_f, T/navg_t, 4, B]``;
    - ``incoherent=True``: the incoherent sum ``[F/navg_f, T/navg_t]``
      (without ``flag_ants``);
    - ``sk_stats=True``: the per-raw-channel SK accumulators
      ``[n_chan, 2]``;
    - ``fused_quant8=True``: the step takes a third argument, the
      ``[n_beams]`` scale vector (every slot gets a copy), and the product
      comes back uint8;
    - ``with_band_power=True``: the all-band total power ``[T/navg_t]``,
      the sum over the slots of each slot's product summed over channels
      and beams (Stokes: the I plane): JAX's ``psum``.

    The outputs come back gathered along the channel axis on the mesh's
    first slot, as ``out`` or a tuple ``(out[, inco][, sk][, band])`` in
    that fixed order."""
    if products not in ("power", "stokes"):
        raise ValueError(f"products must be power|stokes, got {products!r}")
    if fused_quant8 and with_band_power:
        raise ValueError("fused_quant8 + with_band_power: band power "
                         "over quantized uint8 counts would be "
                         "scale-distorted; pick one")
    n = mesh.shape[AXIS]
    _check_divisible(cfg, n)
    local_cfg = cfg.replace(n_chan=cfg.n_chan // n)
    stokes = products == "stokes"
    detect = beamform_stokes if stokes else beamform_power
    flag_ants = tuple(sorted(flag_ants))
    sharding = sharded_wire_sharding(cfg, mesh)
    slots = mesh.slots
    home = mesh.home

    def step(wire, qw_sh, *scales):
        if len(scales) != int(fused_quant8):
            raise TypeError(f"the step takes {2 + fused_quant8} arguments "
                            f"(fused_quant8={fused_quant8}), got "
                            f"{2 + len(scales)}")
        shards = tuple(wire) if isinstance(wire, (tuple, list)) \
            else sharding.put(wire)
        if len(shards) != n or len(qw_sh) != n:
            raise ValueError(f"a {n}-slot mesh takes {n} wire parts and "
                             f"{n} weight parts, got {len(shards)} and "
                             f"{len(qw_sh)}")
        per_slot = []
        for x, qw, dev in zip(shards, qw_sh, slots):
            kw = {}
            if fused_quant8:
                kw["quant8_scales"] = torch.as_tensor(
                    scales[0], dtype=torch.float32).to(dev)
            res = detect(x, qw, local_cfg, incoherent=incoherent,
                         flag_ants=flag_ants, sk_stats=sk_stats, **kw)
            parts = list(res) if isinstance(res, tuple) else [res]
            if with_band_power:
                plane = parts[0][:, :, 0] if stokes else parts[0]
                parts.append(plane.sum(dim=(0, 2)))
            per_slot.append(parts)
        n_gathered = len(per_slot[0]) - with_band_power
        outs = [torch.cat([p[i].to(home) for p in per_slot], dim=0)
                for i in range(n_gathered)]
        if with_band_power:
            band = per_slot[0][-1].to(home)
            for p in per_slot[1:]:
                band = band + p[-1].to(home)
            outs.append(band)
        return outs[0] if len(outs) == 1 else tuple(outs)

    return step
