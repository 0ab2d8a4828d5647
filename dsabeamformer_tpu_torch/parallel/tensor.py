"""Antenna (tensor-parallel) scale-out: the K-split contraction with one sum
of partial beam voltages before detection, the second axis of scale-out.

The channel axis (``parallel/sharding.py``) is the reference's
shared-nothing scale-out and stays the first axis.  It stops being enough
when one channel's GEMM outgrows a device (DSA-2000 scale: ~2000 dishes,
K = 4096 a weight term).  Then each slot beamforms only its antenna group's
voltages against its K-row slice of the weights, with the voltage kernel
(``ops.gemm.beamform_voltages``),

    B[f] = sum_g  X_g[f] @ W_g[f]          (g = antenna shard)

and the partial beam *voltages* are summed over the ``"ant"`` axis (the
JAX package's ``psum``) before detection, because |.|^2 is nonlinear.
Detection and averaging then run once per channel group, as PyTorch ops
(they are XLA in the JAX package, not Pallas; it replicates them over the
antenna axis, with the same numbers).

It composes with channel sharding on a 2-D ``("chan", "ant")`` mesh.  The
quantization scales come from the full per-channel weight matrix before the
K rows are split, so every shard's integers share one scale and the sum of
the dequantized partials is the single-device product up to float32
rounding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.models.arrays import ArrayLayout
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops.gemm import beamform_voltages
from dsabeamformer_tpu_torch.ops.quantize import QuantWeights, quantize_weights
from dsabeamformer_tpu_torch.parallel.sharding import Mesh, visible_devices

CHAN_AXIS = "chan"
ANT_AXIS = "ant"


def make_tp_mesh(n_chan_shards: int, n_ant_shards: int, *,
                 devices: Optional[Sequence] = None) -> Mesh:
    """2-D ``(chan, ant)`` mesh over the first nc*na devices (a 1-D antenna
    mesh is ``make_tp_mesh(1, na)``); ``devices`` as for
    ``sharding.make_mesh`` (repeats allowed)."""
    need = n_chan_shards * n_ant_shards
    devs = visible_devices(devices)
    if need > len(devs):
        raise ValueError(f"requested {need} devices, have {len(devs)}")
    grid = np.array(devs[:need], dtype=object).reshape(n_chan_shards,
                                                        n_ant_shards)
    return Mesh(grid, (CHAN_AXIS, ANT_AXIS))


def _check_tp(cfg: ObsConfig, nc: int, na: int) -> None:
    if cfg.n_chan % nc:
        raise ValueError(f"n_chan={cfg.n_chan} not divisible by {nc}")
    if cfg.n_ant % na:
        raise ValueError(f"n_ant={cfg.n_ant} not divisible by {na}")
    if (cfg.n_ant // na) % 8:
        raise ValueError("per-shard antennas must be a multiple of 8")
    if cfg.weight_mode not in ("f32", "bf16", "bf16x2", "int8x2"):
        raise ValueError(
            "antenna sharding supports weight_mode f32|bf16|bf16x2|int8x2 "
            "— modes whose terms keep the plain [re | im] K layout and "
            "whose per-channel scales are independent of which K rows a "
            "shard keeps (bf16-family scales are constant 1; int8x2 "
            "scales are computed from the FULL weight table before "
            "slicing, see shard_weights_tp).  int8 is excluded because "
            "its single-term accuracy already fails the 1e-3 bar; "
            "int12/int13 are excluded because their x16 K-folds "
            "restructure the contraction axis itself (hi/lo row blocks "
            "matched to a folded data operand with per-channel amax over "
            "full K), so an antenna split of K would cut across fold "
            "blocks and desynchronize the data-side fold"
        )


def _local_cfg(cfg: ObsConfig, nc: int, na: int) -> ObsConfig:
    a_local = cfg.n_ant // na
    return cfg.replace(
        n_chan=cfg.n_chan // nc,
        n_ant=a_local,
        # Every local antenna row takes part (activity masking happened when
        # the full table was made and split).
        n_ant_active=a_local,
        n_ant_compute=a_local,
    )


def _tp_shape(mesh: Mesh) -> tuple:
    return mesh.shape[CHAN_AXIS], mesh.shape[ANT_AXIS]


def shard_weights_tp(
    cfg: ObsConfig,
    mesh: Mesh,
    layout: Optional[ArrayLayout] = None,
    cal: Optional[CalTable] = None,
    pointing_rad: float = 0.0,
) -> tuple:
    """Quantize with the full table's per-channel scales, then split by
    antenna and channel.

    The full ``Wc [F, 2A, 2B]`` is quantized once on the mesh's first slot
    (``a_compute=None`` keeps every K row; the per-channel amax sees the
    whole matrix, as on one device), and the K rows are regrouped per
    antenna shard as ``[re_g | im_g]``, so that each shard's rows are
    ``cat_weights`` of its antenna group.  Returns one ``QuantWeights`` a
    slot, in the mesh's row-major slot order, each contiguous on its
    slot's device (scales: the channel group's, whole)."""
    nc, na = _tp_shape(mesh)
    _check_tp(cfg, nc, na)
    w = make_weights(cfg, layout=layout, cal=cal, pointing_rad=pointing_rad,
                     device=mesh.home)
    qw = quantize_weights(w, cfg.weight_mode, None)
    a = cfg.n_ant
    a_l = a // na
    # Regroup K rows by antenna shard: [re_0..re_A | im_0..im_A] ->
    # [re_g0 im_g0 | re_g1 im_g1 | ...] so an equal split of the K dim is
    # the per-group cat_weights layout.
    idx = np.concatenate(
        [np.concatenate([np.arange(g * a_l, (g + 1) * a_l),
                         a + np.arange(g * a_l, (g + 1) * a_l)])
         for g in range(na)])
    idx = torch.as_tensor(idx, device=mesh.home)
    terms = [t.index_select(1, idx) for t in qw.terms]
    f_l, k_l = cfg.n_chan // nc, 2 * a_l
    out = []
    for s, dev in enumerate(mesh.slots):
        c, g = divmod(s, na)
        fs, ks = slice(c * f_l, (c + 1) * f_l), slice(g * k_l, (g + 1) * k_l)
        out.append(QuantWeights(
            terms=tuple(t[fs, ks].to(dev).contiguous() for t in terms),
            scales=qw.scales[fs].to(dev).contiguous()))
    return tuple(out)


class TPWireSharding:
    """The channel and antenna split of a 4-D host-form wire block
    (``cfg.wire_block_shape``, ``[.., P, A]``): each slot's (subband,
    antenna group) block, made contiguous on its device (each capture NIC
    feeding its own chip)."""

    def __init__(self, cfg: ObsConfig, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.chan_dim = 0 if cfg.input_layout == "ftpa" else 1

    def put(self, wire) -> tuple:
        """One contiguous ``[.., P, A/na]`` block a slot, in slot order, on
        the slot's device (``wire``: a tensor or NumPy array in the 4-D host
        form or the canonical device form)."""
        cfg = self.cfg
        x = wire if isinstance(wire, torch.Tensor) \
            else torch.as_tensor(np.asarray(wire))
        if x.numel() != cfg.wire_block_bytes or x.dtype != torch.uint8:
            raise ValueError(
                f"wire {x.dtype} {tuple(x.shape)} is not a uint8 "
                f"{cfg.wire_block_shape} block")
        x = x.reshape(cfg.wire_block_shape)
        nc, na = _tp_shape(self.mesh)
        out = []
        for s, dev in enumerate(self.mesh.slots):
            c, g = divmod(s, na)
            part = x.chunk(nc, dim=self.chan_dim)[c].chunk(na, dim=3)[g]
            out.append(part.to(dev).contiguous())
        return tuple(out)


def tp_wire_sharding(cfg: ObsConfig, mesh: Mesh) -> TPWireSharding:
    """How 4-D wire blocks split over a ``(chan, ant)`` mesh:
    ``tp_wire_sharding(cfg, mesh).put(wire)``."""
    return TPWireSharding(cfg, mesh)


def _detect(bv: torch.Tensor, cfg: ObsConfig, products: str) -> torch.Tensor:
    """Beam voltages ``[F_l, T, P, 2B]`` -> averaged power ``[F_l/navg_f,
    T/navg_t, B]`` or Stokes ``[.., 4, B]``: the JAX package's detection
    and averaging (parallel/tensor.py:196-219)."""
    b = cfg.n_beams
    f_l, t = bv.shape[0], bv.shape[1]
    nt, nf = cfg.navg_time, cfg.navg_freq

    def avg(z):  # [F_l, T, B] -> time (+ freq) accumulated
        z = z.reshape(f_l, t // nt, nt, b).sum(dim=2)
        if nf > 1:
            z = z.reshape(f_l // nf, nf, t // nt, b).sum(dim=1)
        return z

    bxr, bxi = bv[:, :, 0, :b], bv[:, :, 0, b:]
    byr, byi = bv[:, :, 1, :b], bv[:, :, 1, b:]
    px = bxr * bxr + bxi * bxi
    py = byr * byr + byi * byi
    if products == "power":
        return avg(px + py)
    cr = bxr * byr + bxi * byi
    ci = bxi * byr - bxr * byi
    return torch.stack(
        [avg(px + py), avg(px - py), avg(cr + cr), avg(ci + ci)], dim=2)


def tp_beamformer(cfg: ObsConfig, mesh: Mesh, *, products: str = "power"):
    """The antenna-sharded (and optionally channel-sharded) block step:
    ``step(wire, qw_tp) -> powers`` (or Stokes ``[F, T/navg, 4, B]`` with
    ``products="stokes"``: detection follows the sum either way).

    ``wire`` is a 4-D host-form block (split by ``tp_wire_sharding``) or
    the tuple its ``put`` made; ``qw_tp`` the tuple ``shard_weights_tp``
    made.  Each slot runs the voltage kernel on its block, the partial
    voltages of a channel group are summed on the group's first slot, and
    the group's product is gathered along the channel axis on the mesh's
    first slot."""
    if products not in ("power", "stokes"):
        raise ValueError(f"products must be power|stokes, got {products!r}")
    nc, na = _tp_shape(mesh)
    _check_tp(cfg, nc, na)
    local = _local_cfg(cfg, nc, na)
    sharding = tp_wire_sharding(cfg, mesh)
    slots = mesh.slots

    def step(wire, qw_tp):
        shards = tuple(wire) if isinstance(wire, (tuple, list)) \
            else sharding.put(wire)
        if len(shards) != len(slots) or len(qw_tp) != len(slots):
            raise ValueError(f"a {len(slots)}-slot mesh takes {len(slots)} "
                             f"wire parts and weight parts, got "
                             f"{len(shards)} and {len(qw_tp)}")
        groups = []
        for c in range(nc):
            lead = slots[c * na]
            acc = None
            for g in range(na):
                s = c * na + g
                bv = beamform_voltages(shards[s], qw_tp[s], local).to(lead)
                # The one collective: the partial voltages summed over the
                # antenna axis, before the nonlinear detection.
                acc = bv if acc is None else acc.add_(bv)
            groups.append(_detect(acc, cfg, products).to(mesh.home))
            del acc
        return torch.cat(groups, dim=0) if nc > 1 else groups[0]

    return step
