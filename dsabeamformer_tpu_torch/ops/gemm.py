"""The fused beamforming step: 4-bit wire block -> averaged beam powers or
full-Stokes spectra, with the deployed path's side outputs; and the unfused
beam voltages that hold the fused products to account.

Hand-written CUDA kernels replace the JAX package's two Pallas kernels
(``dsabeamformer_tpu/ops/gemm.py``) in all seven weight modes:

- ``csrc/detect_power.cu`` (``_detect_kernel`` launched by ``_fused_detect``,
  with ``_power_epilogue`` or ``_stokes_epilogue``): per channel, unpack the
  wire bytes of the first ``a_compute`` antennas of each pol into
  ``[re | im]``, multiply by each int8 sub-term in int32 on the tensor cores
  (``wgmma`` s8, ``csrc/mma_gemm.cuh``), combine them
  (int8x2 ``M_hi * 256 + M_lo``; int12 ``M_hi * 16 + M_lo``; int13
  ``(M_h1 + M_h2) * 16 + M_l1 + M_l2``),
  convert to float32 once (the float modes: multiply by each bfloat16 term,
  f32's weights as three bfloat16 parts that sum to them exactly, on the
  tensor cores too, ``wgmma`` bf16 into float32 sums), then detect:
  ``|B|^2`` summed over pols (power), or I, Q, U, V (Stokes), summed over
  ``navg_time`` samples and scaled by the channel's ``s^2``.  Unpacked
  voltages and beam voltages never reach device memory.  Optionally, from
  the same read of the wire bytes:

  - ``quant8_scales``: the product is stored as uint8
    ``clip(rint((x * s^2) * scale_b [+ offset]), 0, 255)`` (the 8-bit
    filterbank; Stokes Q/U/V at the midpoint offset ``STOKES_QUV_OFFSET``);
  - ``incoherent``: the incoherent sum ``[F, T/navg]`` over the active,
    unflagged antennas;
  - ``sk_stats``: the spectral-kurtosis accumulators S1 = sum p,
    S2 = sum p^2 per channel (``ops.incoherent.sk_block_stats`` semantics).

- ``csrc/beam_voltages.cu`` (``_voltage_kernel``, launched by
  ``beamform_voltages``): the same unpack and GEMM on the same tensor cores,
  times the channel's scale, stored as float32 ``[F, T, P, 2B]`` with no
  detection.

Both kernels take any a_compute (DSA-10 as built: 10 slots; DSA-110: 110
active antennas in 128 slots; 2056 in every mode), in every weight mode, and
are built on ``csrc/mma_gemm.cuh`` (``kernel_path``: ``"wgmma"``): a block
stages a 64-beam tile of weight columns in shared memory (32 beams where a
bf16 tile would leave room for fewer than two warpgroups, or an int8 one
for no row:
``_detect_tiles``, ``_voltage_tiles``), K-major, keeps the wire bytes packed
beside it (a wire row that starts off 4 bytes staged from byte loads) and
walks K in steps of 32 bytes, the last step's tail zero in the weights;
``_mma_operands`` (int8) and
``_bf16_operands`` (bf16, f32) state its operand layouts in torch.  The
voltage kernel takes 8 samples of both pols as one m-tile, restages each
warp's m-tile through shared memory and writes whole rows of Re and of Im
(``_voltage_store_map`` states where each accumulator goes).  Where not
even the 32-beam tile fits beside one output row, both take the K loop
(``kernel_path``: ``"wgmma-kloop"``, ``_sliced_tiles``): one warpgroup a
block stages 256-byte K slices of a 64-beam tile and of its m-tiles' wire
rows, sub-term by sub-term, and sums them in the same accumulators.

``fused_detect`` and ``beamform_voltages`` are the wrappers: a CUDA tensor
goes to the kernel (or the call raises), a CPU tensor to the plain PyTorch
version of the same function (``detect_power_plain``, ``voltages_plain``).
``fused_detect.launches`` counts kernel launches per variant
(``variant_name``) and ``fused_detect.launches_by_mode`` per ``(weight_mode,
variant)``; ``beamform_voltages.launches`` counts the voltage kernel's
launches and ``beamform_voltages.launches_by_mode`` those per weight mode.

Public API: ``beamform_power``, ``beamform_stokes``, ``beamform_voltages``,
``voltages_to_complex``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.ops._build import load_library
from dsabeamformer_tpu_torch.ops.quantize import (
    FOLDED_SUBTERMS,
    TERM_DTYPES,
    QuantWeights,
)

#: Weight modes the kernels and their plain versions compute: all of them.
KERNEL_MODES = tuple(TERM_DTYPES)
#: Modes whose terms are float (bfloat16 or float32), scales all 1.
FLOAT_MODES = ("bf16", "bf16x2", "f32")
#: Words of the incoherent mask the detect kernel keeps in shared memory
#: (csrc kMaskWords): 2048 antennas, past any a_compute whose weight tile
#: fits; the K loop reads the mask from device memory.
MASK_WORDS = 64
#: The tensor-core instruction of the detect kernel, every weight mode.
DETECT_MMA = "wgmma"
#: The kernels' path where the weight tile leaves no room for one output
#: row: the same wgmma product, K walked in slices (csrc/mma_gemm.cuh "The
#: K loop"): ``kernel_path``.
KLOOP_MMA = "wgmma-kloop"
#: The detect kernel (csrc/mma_gemm.cuh): beams of a block's weight tile
#: (kTileBeams; kNarrowTileBeams for a bf16 tile that leaves room for fewer
#: than two warpgroups), output rows a warpgroup takes at a time
#: (kRoundRows), most output rows of a span (kMaxSpanRows), most warpgroups
#: of a block for the power and the Stokes product (kMaxGroups, max_groups),
#: K bytes of one mma step (kStepBytes: 32 int8, or 16 bf16).
_TILE_BEAMS = 64
_NARROW_TILE_BEAMS = 32
_ROUND_ROWS = 4
_MAX_SPAN_ROWS = 16
_MAX_GROUPS = {False: 4, True: 2}
_STEP_BYTES = 32
#: Dynamic shared memory a block of either kernel may stage into: an SM's
#: 227 KB less the detect kernel's static copy of the incoherent mask
#: (kMmaDynSmem).
_MMA_DYN_SMEM = 227 * 1024 - 4 * MASK_WORDS
#: The voltage kernel (csrc/beam_voltages.cu): samples of an m-tile
#: (kMtileSamples), rows a warp restages (kStageRows: 8 samples x 2 pols),
#: floats after each restaged row (csrc/mma_gemm.cuh kStagePad).
_MTILE_SAMPLES = 8
_STAGE_ROWS = 16
_STAGE_PAD = 4
#: The voltage kernel's bf16 tile is 32 beams where one of 64 leaves room
#: for fewer warpgroups than this (kMinGroups; the detect kernel's: 2).
_VOLTAGE_MIN_GROUPS = 3
#: The K loop (csrc kSliceKBytes, kSliceRows): K bytes of a weight column a
#: slice stages (int8: 128 antennas, bf16: 64), wire rows a pol it stages
#: (four warps' m-tiles of 8 samples).
_SLICE_K_BYTES = 256
_SLICE_ROWS = 32
#: Bytes of a 64-beam weight slice (csrc kSliceBytes).
_SLICE_BYTES = 2 * _TILE_BEAMS * _SLICE_K_BYTES
#: Signed Q/U/V planes of an 8-bit Stokes product ride the unsigned payload
#: at this fixed midpoint offset; I keeps offset 0 (the SIGPROC files'
#: convention, recorded in their scales.json; csrc: kQuvOffset).
STOKES_QUV_OFFSET = 128.0


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _check_weights(qw: QuantWeights, cfg: ObsConfig) -> None:
    want = (cfg.n_chan, cfg.gemm_k, 2 * cfg.n_beams)
    for term in qw.terms:
        got = tuple(term.shape)
        if got != want:
            raise ValueError(
                f"quantized weight term shaped {got} does not match config "
                f"{cfg.name!r} (expected [F,K,2B] = {want} for mode "
                f"{cfg.weight_mode!r} / a_compute={cfg.a_compute}); "
                f"regenerate with prepare_weights(cfg, make_weights(cfg))"
            )
    if qw.scales.shape != (cfg.n_chan, len(qw.terms)):
        raise ValueError(
            f"weight scales shaped {tuple(qw.scales.shape)} do not match "
            f"[F, n_terms] = {(cfg.n_chan, len(qw.terms))}"
        )
    want = TERM_DTYPES[cfg.weight_mode]
    if len(qw.terms) != cfg.n_weight_terms \
            or any(w.dtype != want for w in qw.terms):
        raise ValueError(
            f"mode {cfg.weight_mode!r} takes {cfg.n_weight_terms} "
            f"{_dtype_name(want)} weight terms, got "
            f"{[_dtype_name(w.dtype) for w in qw.terms]}")
    if qw.scales.dtype != torch.float32:
        raise ValueError(
            f"scales must be float32, got {_dtype_name(qw.scales.dtype)}")


#: The bf16 parts the detect kernel splits each f32 weight into.
F32_PARTS = 3


def n_subterms(cfg: ObsConfig) -> int:
    """Sub-terms ``[2*a_compute, 2B]`` the detect kernel multiplies per
    channel: int8 1, int8x2 and int12 2, int13 4; bf16 1, bf16x2 2, f32 3
    (``F32_PARTS``, the bf16 parts of its one term)."""
    if cfg.weight_mode == "f32":
        return F32_PARTS
    return FOLDED_SUBTERMS.get(cfg.weight_mode, cfg.n_weight_terms)


def _prepare_wire(wire, cfg: ObsConfig) -> tuple:
    """Wire block -> ``(x, time_major)``, the kernel's input tensor.

    The canonical device form is ``cfg.device_wire_shape``: ``[T, F*P*A]``
    for 'tfpa' (read time-major; the corner turn happens in the kernel's
    loads) and ``[F, T, P*A]`` for 'ftpa'.  The 4-D ``cfg.wire_block_shape``
    form is accepted as a view of the same bytes.  NumPy arrays become CPU
    tensors (no copy).
    """
    if not isinstance(wire, torch.Tensor):
        wire = torch.as_tensor(np.asarray(wire))
    if wire.dtype != torch.uint8:
        raise ValueError(
            f"wire must be uint8 4R4I bytes, got {_dtype_name(wire.dtype)}")
    pa = cfg.n_pol * cfg.n_ant
    if wire.shape == cfg.device_wire_shape:
        return wire, cfg.input_layout == "tfpa"
    if wire.shape != cfg.wire_block_shape:
        raise ValueError(
            f"wire shape {tuple(wire.shape)} is neither the canonical device "
            f"form {cfg.device_wire_shape} nor the 4-D host form "
            f"{cfg.wire_block_shape} for layout {cfg.input_layout!r}"
        )
    if cfg.input_layout == "tfpa":
        return wire.reshape(cfg.t_block, cfg.n_chan * pa), True
    return wire.reshape(cfg.n_chan, cfg.t_block, pa), False


def device_wire_view(wire, cfg: ObsConfig):
    """Host-side 4-D capture block -> the canonical device form (a free
    reshape view; upload this, not the 4-D array)."""
    arr = np.asarray(wire)
    if arr.shape != cfg.wire_block_shape:
        raise ValueError(
            f"wire shape {arr.shape} != host form {cfg.wire_block_shape}"
        )
    return arr.reshape(cfg.device_wire_shape)


def _wire_strides(cfg: ObsConfig, time_major: bool) -> tuple:
    """(time stride, channel stride) in bytes of the device wire form."""
    pa = cfg.n_pol * cfg.n_ant
    if time_major:
        return cfg.n_chan * pa, pa
    return pa, cfg.t_block * pa


def incoherent_mask(cfg: ObsConfig, flag_ants=()) -> int:
    """Bit ``a`` set for every antenna the incoherent sum takes: ``a <
    n_ant_active`` and not in ``flag_ants`` (a Python int, as wide as
    ``n_ant_active``: 110 bits at DSA-110)."""
    mask = (1 << cfg.n_ant_active) - 1
    for a in flag_ants:
        mask &= ~(1 << int(a))
    return mask


def _mask_words(mask: int, a_compute: int):
    """The mask as the ``ceil(a_compute / 32)`` uint32 words the detect
    kernel reads (bit ``a`` in word ``a // 32``), a ctypes array."""
    n = -(-a_compute // 32)
    return (ctypes.c_uint * n)(*((mask >> (32 * i)) & 0xFFFFFFFF
                                 for i in range(n)))


def kernel_path(cfg: ObsConfig, kernel: str = "detect") -> str:
    """The design of the detect kernel (``kernel="voltage"``: the voltage
    kernel) for ``cfg``, every weight mode on ``csrc/mma_gemm.cuh`` (int8
    ``wgmma`` for the int8 modes, bf16 ``wgmma`` into float32 sums for the
    float ones): ``DETECT_MMA`` (``"wgmma"``) where the whole weight tile
    fits in a block's shared memory beside one output row
    (``_detect_tiles`` / ``_voltage_tiles``: at ``navg_time`` 16 up to f32
    272, int13 384, bf16x2 392, bf16, int8x2 and int12 704, int8 1152),
    else ``KLOOP_MMA`` (``"wgmma-kloop"``): the same product with K walked
    in slices, which takes any a_compute (the power and the Stokes product
    take the same path: one row fits for both or for neither)."""
    if kernel not in ("detect", "voltage"):
        raise ValueError(f"no kernel {kernel!r}: 'detect' or 'voltage'")
    tiles = _detect_tiles(cfg) if kernel == "detect" else _voltage_tiles(cfg)
    return KLOOP_MMA if tiles.slices else DETECT_MMA


class DetectTiles(NamedTuple):
    """How the detect kernel cuts its work (``_detect_tiles``)."""

    beams: int    # of a block's weight tile
    groups: int   # warpgroups of a block
    rows: int     # output rows of a warpgroup's span
    smem: int     # dynamic shared memory of a block, bytes
    slices: int = 0  # K slices of a sub-term (0: the whole tile staged)


def _fit_spans(wbytes: int, row_bytes: int, group_bytes: int, n_out: int,
               max_groups: int) -> tuple:
    """(warpgroups, rows of a span) beside a weight tile of ``wbytes``, an
    output row's wire bytes being ``row_bytes`` and each warpgroup keeping
    ``group_bytes`` of its own; None when not one row fits: csrc
    fit_spans."""
    if wbytes + group_bytes + row_bytes > _MMA_DYN_SMEM:
        return None
    left = _MMA_DYN_SMEM - wbytes
    want = min(n_out, _ROUND_ROWS)
    groups = min(max_groups, -(-n_out // _ROUND_ROWS))
    while groups > 1 \
            and (left - groups * group_bytes) // (groups * row_bytes) < want:
        groups -= 1
    rows = min((left - groups * group_bytes) // (groups * row_bytes),
               _MAX_SPAN_ROWS, n_out)
    if rows > _ROUND_ROWS:
        rows -= rows % _ROUND_ROWS
    return groups, rows


def _stage_bytes(stage_rows: int, beams: int) -> int:
    """Bytes a warpgroup restages its output through: ``stage_rows`` rows a
    warp, each the tile's width (the Re, then the Im columns) and
    ``_STAGE_PAD`` floats more (csrc stage_bytes)."""
    return 4 * stage_rows * (beams + _STAGE_PAD) * 4


def _sliced_tiles(cfg: ObsConfig, n_out: int,
                  stage_rows: int) -> DetectTiles:
    """The K loop's tile and spans (csrc make_sliced_geom): a 64-beam slice
    of ``_SLICE_K_BYTES`` K bytes a column (one sub-term), one warpgroup,
    spans of one round (at most ``_ROUND_ROWS`` output rows, or the voltage
    kernel's m-tiles), one buffer of ``_SLICE_ROWS`` wire rows a pol, each
    the slice's antennas padded to an odd number of 16-byte units, each of
    the two in two buffers, and the restaged output rows; ``slices`` slices
    of a sub-term's K."""
    ants = _slice_antennas(cfg)
    raw_stride = 16 * ((ants // 16) | 1)
    smem = 2 * (_SLICE_BYTES + 2 * _SLICE_ROWS * raw_stride) \
        + _stage_bytes(stage_rows, _TILE_BEAMS)
    return DetectTiles(_TILE_BEAMS, 1, min(n_out, _ROUND_ROWS), smem,
                       -(-cfg.a_compute // ants))


def _slice_antennas(cfg: ObsConfig) -> int:
    """Antennas of a K-loop slice: 128 int8, 64 bf16."""
    return _SLICE_K_BYTES // _STEP_BYTES \
        * (8 if cfg.weight_mode in FLOAT_MODES else 16)


def _slice_layout(terms, cfg: ObsConfig) -> torch.Tensor:
    """The weight terms in the K loop's slice order (csrc/mma_gemm.cuh, The
    K loop): uint8 ``[F, beam tiles, sub-terms, slices, _SLICE_BYTES]``,
    each slice the 64-beam tile's columns ``2 * beam + (0 Re, 1 Im)`` over
    its antennas, byte for byte where the tile's matrix descriptor reads
    them (``w_offset``: column group ``c // 8`` of 2048 bytes, then per k
    step of the slice its re and its im core matrices of 8 columns x 16
    bytes), zeros past a_compute and n_beams.  The int8 sub-terms as the
    kernel reads them (``_mma_operands``' order), the bf16 terms, or f32's
    three bfloat16 parts (``_split_f32``)."""
    mode = cfg.weight_mode
    n_chan, a, b = cfg.n_chan, cfg.a_compute, cfg.n_beams
    if mode == "f32":
        subs = _split_f32(terms[0])
    elif mode in FOLDED_SUBTERMS:
        subs = terms[0].view(n_chan, n_subterms(cfg), 2 * a, 2 * b).unbind(1)
    else:
        subs = terms
    bf16 = mode in FLOAT_MODES
    ants = _slice_antennas(cfg)
    lane = ants // 8                  # antennas of one k step's core matrix
    n_sl, n_bt = -(-a // ants), -(-b // _TILE_BEAMS)
    out = []
    for w in subs:
        w = w.view(torch.int16) if bf16 else w.view(torch.uint8)
        pad = w.new_zeros((n_chan, 2, n_sl * ants, 2, n_bt * _TILE_BEAMS))
        pad[:, :, :a, :, :b] = w.view(n_chan, 2, a, 2, b)
        # [f, part, slice, step, antenna of the step, ri, tile, c // 8,
        # beam % 4] -> [f, tile, slice, c // 8, step, part, beam % 4, ri,
        # antenna of the step]
        pad = pad.view(n_chan, 2, n_sl, 8, lane, 2, n_bt, 16, 4)
        out.append(pad.permute(0, 6, 2, 7, 3, 1, 8, 5, 4)
                   .reshape(n_chan, n_bt, n_sl, -1))
    return torch.stack(out, 2).contiguous().view(torch.uint8)


#: The K loop's laid-out weights of the last weight sets it ran with:
#: ``key -> (terms, layout)``; the terms are kept so that a key's tensors
#: cannot be freed and their addresses reused while it is cached.
_SLICED = collections.OrderedDict()
_SLICED_KEEP = 2


def _sliced_weights(terms, cfg: ObsConfig) -> torch.Tensor:
    """``_slice_layout`` of these terms, made once per weight set (on their
    device and its current stream, then waited for, so any stream may read
    it) and cached; an in-place edit of a term (its ``_version``) makes it
    anew."""
    key = (cfg.weight_mode, cfg.n_chan, cfg.a_compute, cfg.n_beams,
           tuple(id(t) for t in terms), tuple(t._version for t in terms))
    hit = _SLICED.get(key)
    if hit is not None and all(x is y for x, y in zip(hit[0], terms)):
        _SLICED.move_to_end(key)
        return hit[1]
    layout = _slice_layout(terms, cfg)
    if layout.is_cuda:
        torch.cuda.current_stream(layout.device).synchronize()
    _SLICED[key] = (tuple(terms), layout)
    while len(_SLICED) > _SLICED_KEEP:
        _SLICED.popitem(last=False)
    return layout


def _mma_tiles(cfg: ObsConfig, navg: int, n_out: int, max_groups: int,
               min_groups: int, stage_rows: int,
               scratch: int = 0) -> DetectTiles:
    """The weight tile and spans of a kernel on csrc/mma_gemm.cuh, output
    rows of ``navg`` samples (``n_out`` of them a channel), each warpgroup
    keeping ``scratch`` bytes beside its rows, the 32-beam tile where a
    bf16 one of 64 leaves room for fewer than ``min_groups`` warpgroups or
    any one of 64 for no row: csrc make_mma_geom (see ``_detect_tiles``);
    the K loop's (``_sliced_tiles``) where not even that fits."""
    ac = cfg.a_compute
    bf16 = cfg.weight_mode in FLOAT_MODES
    n_steps = -(-ac // 8) if bf16 else -(-ac // 16)
    raw_stride = 16 * (-(-ac // 16) | 1)
    k_total = n_subterms(cfg) * _STEP_BYTES * n_steps
    row_bytes = 2 * navg * 2 * raw_stride
    enough = min(min_groups, max_groups, -(-n_out // _ROUND_ROWS))

    def fit(beams):
        return _fit_spans(2 * beams * k_total, row_bytes,
                          _stage_bytes(stage_rows, beams) + scratch, n_out,
                          max_groups)

    beams = _TILE_BEAMS
    got = fit(beams)
    if got is None or (bf16 and got[0] < enough):
        beams = _NARROW_TILE_BEAMS
        got = fit(beams)
    wbytes = 2 * beams * k_total
    stage = _stage_bytes(stage_rows, beams) + scratch
    if got is None:
        return _sliced_tiles(cfg, n_out, stage_rows)
    groups, rows = got
    return DetectTiles(beams, groups, rows,
                       wbytes + groups * (rows * row_bytes + stage))


def _detect_tiles(cfg: ObsConfig, stokes: bool = False) -> DetectTiles:
    """The detect kernel's weight tile and spans: csrc make_mma_geom.

    A block holds a weight tile of 64 beams, every sub-term K-major (``2 *
    beams * n_subterms * 32 * n_steps`` bytes; a step is 32 bytes of a
    column: 16 antennas of int8 ``[re | im]``, ``n_steps = ceil(a_compute /
    16)``, or 8 of bf16, ``n_steps = ceil(a_compute / 8)``), and for each of
    its warpgroups two buffers of a span's wire rows, packed as they arrive:
    ``navg_time * 2`` rows an output row, each a_compute bytes padded to an
    odd number of 16-byte units, and its SK partial sums (``2 * a_compute``
    int32).  A block is as many warpgroups (at most 4,
    Stokes 2, and no more than there are rounds of ``_ROUND_ROWS`` output
    rows) as can each hold a span of ``_ROUND_ROWS`` rows; the span is then
    what fits, at most ``_MAX_SPAN_ROWS`` and a multiple of ``_ROUND_ROWS``
    once past it.  A bf16 tile (the float modes) that leaves room for fewer
    than two warpgroups (or the rounds, if fewer) is 32 beams instead: f32's
    three parts from a_compute 113; so is an int8 tile of 64 that
    leaves room for no row (int13 from a_compute 209 at navg 16, int8x2
    and int12 from 385, int8 from 705).  Where not one output row fits
    beside the 32-beam tile, the K loop's tile (``_sliced_tiles``,
    ``slices`` > 0)."""
    return _mma_tiles(cfg, cfg.navg_time, cfg.t_block // cfg.navg_time,
                      _MAX_GROUPS[stokes], 2, 0, 8 * cfg.a_compute)


class VoltageTiles(NamedTuple):
    """How the voltage kernel cuts its work (``_voltage_tiles``)."""

    beams: int    # of a block's weight tile
    groups: int   # warpgroups of a block
    rows: int     # m-tiles (8 samples each) of a warpgroup's span
    samples: int  # samples of a span: rows * 8
    smem: int     # dynamic shared memory of a block, bytes
    slices: int = 0  # K slices of a sub-term (0: the whole tile staged)


def _voltage_tiles(cfg: ObsConfig) -> VoltageTiles:
    """The voltage kernel's weight tile and spans: csrc make_mma_geom as
    ``dsabf_beam_voltages`` calls it.

    The detect kernel's tile and wire buffers (``_detect_tiles``) with an
    output row of one m-tile (8 samples, ``ceil(t_block / 8)`` of them a
    channel), at most 4 warpgroups, and each warp's 16 rows of restaged
    voltages beside its warpgroup's wire buffers (a row is the tile's Re,
    then its Im columns, and 4 floats more: 4,352 bytes a warp on a 64-beam
    tile, 2,304 on a 32-beam one).  A bf16 tile that leaves room for fewer than
    three warpgroups is 32 beams (the detect kernel's rule says two): bf16x2
    from a_compute 120, f32 from 88."""
    n_mt = -(-cfg.t_block // _MTILE_SAMPLES)
    t = _mma_tiles(cfg, _MTILE_SAMPLES, n_mt, _MAX_GROUPS[False],
                   _VOLTAGE_MIN_GROUPS, _STAGE_ROWS)
    return VoltageTiles(t.beams, t.groups, t.rows, t.rows * _MTILE_SAMPLES,
                        t.smem, t.slices)


def _staged_grid_z(n_shares: int, n_chan: int, chunks: int) -> int:
    """gridDim.z of a kernel that walks spans: csrc staged_grid_x."""
    return min(-(-2048 // (n_chan * chunks)), n_shares)


def _voltage_store_map(cfg: ObsConfig) -> tuple:
    """What the voltage kernel holds in each accumulator it stores, and
    where it stores it, in torch: ``(src, dst)``, int64 tensors of one entry
    per stored register of a channel's blocks.

    The grid (``_voltage_tiles``; the beam tiles, then ``_staged_grid_z``
    shares of the spans) gives warp ``w`` of warpgroup ``g`` of block
    ``(bt, f, z)`` the m-tiles ``span * rows + 4 * round + w`` of the spans
    ``z * groups + g``, every ``gridDim.z * groups``-th after it.

    ``src = (t, p, beam, ri)``: register ``c`` of n-tile ``nt`` of lane
    ``l`` holds the wgmma fragment's row ``l // 4`` (pol x) or ``l // 4 +
    8`` (pol y, ``c >= 2``) of its m-tile, i.e. sample ``8 * mtile + l //
    4``, and column ``2 * (4 * nt + l % 4) + c % 2`` of the tile: Re
    (``ri`` 0) or Im of beam ``bt * beams + 4 * nt + l % 4``.

    ``dst = (t, p, col)``: the kernel restages it to row ``8 * (c // 2) + l
    // 4``, column ``4 * nt + l % 4`` of the warp's Re (``c`` even) or Im
    rows, and a lane writes 4 columns ``4 * k .. 4 * k + 3`` of a row from
    there to ``out[f, t0 + row % 8, row // 8, half * B + bt * beams + 4 * k
    + j]``; only samples below ``t_block`` and beams below ``n_beams``."""
    tiles = _voltage_tiles(cfg)
    t_all, b_all = cfg.t_block, cfg.n_beams
    n_spans = -(-t_all // tiles.samples)
    chunks = -(-b_all // tiles.beams)
    grid_z = _staged_grid_z(-(-n_spans // tiles.groups), cfg.n_chan, chunks)
    rounds = -(-tiles.rows // _ROUND_ROWS)
    mtiles = []
    for z in range(grid_z):
        for g in range(tiles.groups):
            for span in range(z * tiles.groups + g, n_spans,
                              grid_z * tiles.groups):
                for r in range(rounds):
                    for w in range(_ROUND_ROWS):
                        local = r * _ROUND_ROWS + w
                        mt = span * tiles.rows + local
                        if local < tiles.rows \
                                and _MTILE_SAMPLES * mt < t_all:
                            mtiles.append(mt)
    mt = torch.tensor(mtiles).view(1, -1, 1, 1, 1)
    bt = torch.arange(chunks).view(-1, 1, 1, 1, 1) * tiles.beams
    lane = torch.arange(32).view(1, 1, -1, 1, 1)
    nt = torch.arange(tiles.beams // 4).view(1, 1, 1, -1, 1)
    c = torch.arange(4).view(1, 1, 1, 1, -1)
    t0 = _MTILE_SAMPLES * mt
    src = (t0 + lane // 4, c // 2, bt + 4 * nt + lane % 4, c % 2)
    row, stage_col, half = (c // 2) * 8 + lane // 4, 4 * nt + lane % 4, c % 2
    k, j = stage_col // 4, stage_col % 4
    every = torch.broadcast_tensors(*src, t0 + row % 8, row // 8, half,
                                    bt + 4 * k + j)
    keep = (every[4] < t_all) & (every[7] < b_all)
    t, p, half, beam = (v[keep] for v in every[4:])
    return tuple(v[keep] for v in every[:4]), (t, p, half * b_all + beam)


def _voltage_value(acc: torch.Tensor, ps: int, s: torch.Tensor):
    """The voltage kernel's epilogue: accumulators (int32 sums times the
    product scale ``ps``, or float32 sums) to float32, times ``1 / ps``
    (exact: a power of two) and then the channel's scale ``s``, each
    multiply rounded once."""
    return (acc.to(torch.float32) * (1.0 / ps)) * s


def _detect_smem(cfg: ObsConfig, stokes: bool = False) -> tuple:
    """(bytes, limit) of the shared memory one detect-kernel block stages:
    its weight tile, its spans' rows and its SK partial sums."""
    return _detect_tiles(cfg, stokes).smem, _MMA_DYN_SMEM


def _mma_operands(re, im, terms, cfg: ObsConfig) -> tuple:
    """The int8 detect kernel's GEMM operands as ``csrc/mma_gemm.cuh`` lays
    them out (the weight tile in shared memory, the A fragments in
    registers), in torch: ``(x, subs)``.

    ``x`` is int8 ``[Fc, T, P, Kp]``, ``Kp = 32 * ceil(a_compute / 16)``:
    k32 steps of ``[re of 16 antennas | im of the same 16]``, zeros past
    a_compute.  ``subs`` lists the mode's sub-terms (int8x2: the two terms;
    int12 ``[hi; lo]`` and int13 ``[h1; l1; h2; l2]`` cut along K), each
    int8 ``[Fc, Kp, B, 2]``: rows in x's K order, the columns of a beam
    ``(Re, Im)`` side by side (columns ``b`` and ``B + b`` of the term)."""
    ac, b = cfg.a_compute, cfg.n_beams
    n_steps = -(-ac // 16)
    pad = 16 * n_steps - ac

    def k_order(r, i, dim):
        """[re | im] halves along ``dim`` -> k32 steps, zero-filled."""
        shape = list(r.shape)
        shape[dim] = pad
        z = r.new_zeros(shape)
        r, i = (torch.cat([v, z], dim=dim) for v in (r, i))
        lead = list(r.shape[:dim])
        tail = list(r.shape[dim + 1:])
        r = r.reshape(*lead, n_steps, 16, *tail)
        i = i.reshape(*lead, n_steps, 16, *tail)
        return torch.cat([r, i], dim=dim + 1).reshape(
            *lead, n_steps * _STEP_BYTES, *tail)

    x = k_order(re.to(torch.int8), im.to(torch.int8), 3)
    n_sub = n_subterms(cfg)
    stacked = terms if cfg.weight_mode not in FOLDED_SUBTERMS \
        else terms[0].split(2 * ac, dim=1)
    assert len(stacked) == n_sub
    subs = []
    for sub in stacked:
        w = k_order(sub[:, :ac], sub[:, ac:], 1)            # [Fc, Kp, 2B]
        subs.append(torch.stack([w[..., :b], w[..., b:]], dim=-1))
    return x, subs


def _product_scale(cfg: ObsConfig) -> int:
    """What the int8 kernels' sums are a multiple of (csrc product_scale):
    16 where the unfolded modes multiply 16 x (int8, int8x2 up to a_compute
    255, while ``16 * 257 * 2048 * a_compute < 2**31``), else 1 (the folded
    modes, wider unfolded ones, the float modes)."""
    if cfg.weight_mode in FLOAT_MODES or cfg.weight_mode in FOLDED_SUBTERMS:
        return 1
    return 16 if 16 * 257 * 2048 * cfg.a_compute < 2 ** 31 else 1


def _mma_product(x, subs, cfg: ObsConfig) -> torch.Tensor:
    """The integers the int8 detect kernel's accumulators end with, from
    ``_mma_operands``: int32 ``[Fc, T, P, B, 2]`` (Re, Im).  The sub-terms
    share one accumulator: int8x2 multiplies the hi term's sums by 256
    before the lo term adds on top; the folded modes multiply their even
    sub-terms by 16 x, which fits int8 (the kernel takes it from the wire
    byte's nibbles in place), and the odd ones by x.  (In the unfolded
    modes the kernel multiplies 16 x throughout and divides the 16 out of
    its float32 result, a power of two and so exact: the same integers
    times 16, below 2^31, ``_product_scale``.)"""
    fold = cfg.weight_mode in FOLDED_SUBTERMS
    x16 = ((x.to(torch.int32) << 4) & 0xF0).to(torch.uint8).view(torch.int8)
    acc = None
    for t, sub in enumerate(subs):
        a = (x16 if fold and t % 2 == 0 else x).to(torch.int32)
        part = torch.einsum("ftpk,fkbc->ftpbc", a, sub.to(torch.int32))
        if acc is None:
            acc = part
        else:
            acc = (acc if fold else acc * 256) + part
    return acc


def _nibble_bf16(v: torch.Tensor) -> torch.Tensor:
    """The low nibbles of ``v`` (4-bit two's complement) as bfloat16, the
    way the bf16 detect kernel makes its A operand (mma_gemm.cuh
    nibbles_bf16): the bits ``0x4300 | (u ^ 8)``, which are bf16(136 + n)
    for the nibble ``u`` of value ``n``, less 136 in bfloat16, which is
    exact.  No table."""
    u = v.to(torch.int32) & 15
    biased = (0x4300 | (u ^ 8)).to(torch.int16).view(torch.bfloat16)
    return biased - torch.tensor(136.0, dtype=torch.bfloat16)


def _split_f32(w: torch.Tensor) -> tuple:
    """float32 weights -> ``F32_PARTS`` bfloat16 tensors that sum to them
    exactly, as the detect kernel splits an f32 tile (mma_gemm.cuh
    split_f32): ``w1 = bf16(w)``, ``w2 = bf16(w - w1)``, ``w3 = bf16(w -
    w1 - w2)``, each difference exact in float32.  ``w3`` holds at most 8
    significant bits in units of ``w``'s last bit, so it is a bfloat16
    (possibly subnormal) wherever that unit is at least bfloat16's least
    subnormal, ``|w| >= 2**-110``; beamforming weights are O(1)."""
    w1 = w.to(torch.bfloat16)
    r1 = w - w1.to(torch.float32)
    w2 = r1.to(torch.bfloat16)
    return w1, w2, (r1 - w2.to(torch.float32)).to(torch.bfloat16)


def _bf16_operands(wire, terms, cfg: ObsConfig) -> tuple:
    """The bf16 detect kernel's GEMM operands as ``csrc/mma_gemm.cuh`` lays
    them out, in torch: ``(x, subs)``.

    ``wire`` is the uint8 wire bytes ``[Fc, T, P, a_compute]`` of the
    channels (``_wire_chunk``).  ``x`` is bfloat16 ``[Fc, T, P, Kp]``,
    ``Kp = 16 * ceil(a_compute / 8)``: k16 steps of ``[re of 8 antennas |
    im of the same 8]`` made from the nibbles by ``_nibble_bf16``, zeros
    past a_compute.  ``subs`` lists the bf16 sub-terms (bf16 its term,
    bf16x2 hi and lo, f32 the ``_split_f32`` parts of its term), each
    bfloat16 ``[Fc, Kp, B, 2]``: rows in x's K order (zeros past
    a_compute), the columns of a beam ``(Re, Im)`` side by side (columns
    ``b`` and ``B + b`` of the term)."""
    ac, b = cfg.a_compute, cfg.n_beams
    n_steps = -(-ac // 8)
    pad = 8 * n_steps - ac

    def k_order(r, i, dim):
        """[re | im] halves along ``dim`` -> k16 steps, zero-filled."""
        shape = list(r.shape)
        shape[dim] = pad
        z = r.new_zeros(shape)
        r, i = (torch.cat([v, z], dim=dim) for v in (r, i))
        lead, tail = list(r.shape[:dim]), list(r.shape[dim + 1:])
        r = r.reshape(*lead, n_steps, 8, *tail)
        i = i.reshape(*lead, n_steps, 8, *tail)
        return torch.cat([r, i], dim=dim + 1).reshape(
            *lead, 16 * n_steps, *tail)

    x = k_order(_nibble_bf16(wire >> 4), _nibble_bf16(wire), 3)
    parts = _split_f32(terms[0]) if cfg.weight_mode == "f32" else terms
    assert len(parts) == n_subterms(cfg)
    subs = []
    for sub in parts:
        w = k_order(sub[:, :ac], sub[:, ac:], 1)            # [Fc, K, 2B]
        subs.append(torch.stack([w[..., :b], w[..., b:]], dim=-1))
    return x, subs


def _bf16_product(x, subs) -> torch.Tensor:
    """What the bf16 detect kernel's float32 accumulators sum, from
    ``_bf16_operands``: float64 ``[Fc, T, P, B, 2]`` (Re, Im), every
    sub-term's products in one sum.  Each product of a 4-bit voltage and a
    bfloat16 is exact, and so is their float64 sum for weights within 2**20
    of each other; the kernel rounds its float32 sums as it goes."""
    xd = x.to(torch.float64)
    return sum(torch.einsum("ftpk,fkbc->ftpbc", xd, sub.to(torch.float64))
               for sub in subs)


def variant_name(quant8: bool, incoherent: bool, sk: bool,
                 stokes: bool = False) -> str:
    """Launch-count key of a detect-kernel variant: the product (``"base"``
    for power, ``"stokes"``) and the side outputs joined by ``+``
    (``"sk"``, ``"q8"``, ``"sk+q8+inco"``, ``"stokes+sk+q8+inco"``, ...)."""
    parts = [n for n, on in (("stokes", stokes), ("sk", sk), ("q8", quant8),
                             ("inco", incoherent)) if on]
    return "+".join(parts) or "base"


def _fma(a, b, c):
    """``a * b + c`` with one rounding to float32: the contraction XLA makes
    of the JAX kernel's ``x*y + z`` on the CPU (mirrored so that the plain
    version and the JAX package agree to the bit).  Computed in float64,
    where the product of two float32 is exact; so is the sum for the
    detection products, whose operands are integers below 2^50.  For the
    uint8 quantizer's ``x * scale + offset`` the float64 sum may round
    first, which moves the float32 result only for values within 2^-53
    (relative) of a float32 rounding midpoint."""
    r = a.double() * b.double()
    r += c.double()  # in place: a DSA-10 Stokes block is 8.6 GB in float64
    return r.float()


def _time_sum(z: torch.Tensor, navg: int) -> torch.Tensor:
    """``[Fc, T, ...]`` -> ``[Fc, T/navg, ...]``: sums of ``navg`` adjacent
    samples, as a halving tree (first half plus second half, repeated): the
    order of XLA's CPU reduction of a 16-sample sum, so at the presets'
    navg_time the plain version and the JAX package agree to the bit."""
    fc, t = z.shape[:2]
    z = z.reshape(fc, t // navg, navg, *z.shape[2:])
    n = navg
    while n > 1:
        h = n // 2
        head = z[:, :, :h] + z[:, :, h:2 * h]
        z = torch.cat([head, z[:, :, 2 * h:]], dim=2) if n % 2 else head
        n = z.shape[2]
    return z[:, :, 0]


def _power_epilogue(acc, n_time, n_beams, navg_time):
    """``[Fc, P*T, 2B]`` f32 (pol-major rows) -> ``[Fc, T/navg, B]``:
    ``|B|^2``, pol sum, ``navg_time`` sum."""
    br = acc[..., :n_beams]
    bi = acc[..., n_beams:]
    p = _fma(br, br, bi * bi)
    return _time_sum(p[:, :n_time] + p[:, n_time:], navg_time)


def _stokes_epilogue(acc, n_time, n_beams, navg_time):
    """``[Fc, P*T, 2B]`` f32 (pol-major rows) -> ``[Fc, T/navg, 4, B]``:
    I = |Bx|^2+|By|^2, Q = |Bx|^2-|By|^2, U = 2 Re(Bx By*),
    V = 2 Im(Bx By*) (linear feeds, x = pol 0), each summed over
    ``navg_time`` samples."""
    bxr = acc[:, :n_time, :n_beams]
    bxi = acc[:, :n_time, n_beams:]
    byr = acc[:, n_time:, :n_beams]
    byi = acc[:, n_time:, n_beams:]
    px = _fma(bxr, bxr, bxi * bxi)
    py = _fma(byr, byr, byi * byi)
    cr = _fma(bxr, byr, bxi * byi)            # Re(Bx By*)
    ci = _fma(bxi, byr, -(bxr * byi))         # Im(Bx By*)
    planes = torch.stack([px + py, px - py, cr + cr, ci + ci], dim=2)
    return _time_sum(planes, navg_time)


def stokes_offsets(device=None) -> torch.Tensor:
    """Per-plane uint8 offsets of the Stokes product: 0 for I,
    ``STOKES_QUV_OFFSET`` for Q, U, V (float32 ``[4]``)."""
    return torch.tensor([0.0] + [STOKES_QUV_OFFSET] * 3, dtype=torch.float32,
                        device=device)


def quantize_u8(x: torch.Tensor, scales: torch.Tensor,
                offsets: torch.Tensor | None = None) -> torch.Tensor:
    """``clip(rint(x * scale_b), 0, 255)`` as uint8, per beam (last axis),
    rounding half to even: the 8-bit filterbank quantizer.  ``offsets``
    (one per Stokes plane, the second-last axis) are added in the same
    rounding as the product, as XLA contracts the JAX package's
    ``x * scale + offset`` on the CPU."""
    v = x * scales if offsets is None else _fma(x, scales, offsets[:, None])
    return torch.clamp(torch.round(v), 0, 255).to(torch.uint8)


@contextlib.contextmanager
def _exact_float32_matmul():
    """TF32 and reduced-precision bfloat16 reductions off for the plain
    versions' float32 GEMMs on the card."""
    mm = torch.backends.cuda.matmul
    prev = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = prev


def _wire_chunk(x, cfg: ObsConfig, time_major: bool, f0: int, f1: int):
    """Channels ``f0:f1`` of the device wire form -> their uint8 bytes
    ``[Fc, T, P, a_compute]`` (a view)."""
    f_all, t = cfg.n_chan, cfg.t_block
    p, a = cfg.n_pol, cfg.n_ant
    if time_major:
        w = x.view(t, f_all, p, a)[:, f0:f1].permute(1, 0, 2, 3)
    else:
        w = x.view(f_all, t, p, a)[f0:f1]
    return w[..., :cfg.a_compute]


def _unpack_chunk(x, cfg: ObsConfig, time_major: bool, f0: int, f1: int):
    """Channels ``f0:f1`` of the device wire form -> ``(re, im)`` int32
    ``[Fc, T, P, a_compute]`` (high nibble re, low nibble im)."""
    v = _wire_chunk(x, cfg, time_major, f0, f1).to(torch.int32)
    return (((v >> 4) + 8) & 15) - 8, ((v + 8) & 15) - 8


def _gemm_chunk(re, im, terms, f0: int, f1: int, mode: str) -> torch.Tensor:
    """The X operand of channels ``f0:f1`` times every weight term ->
    ``[Fc, P*T, 2B]`` float32 in quantized units (pol-major rows), as the
    JAX kernel's ``_build_x`` and ``_accumulate`` do it for ``mode``:

    - int8, int8x2: ``[re | im]``; int8x2 terms combined as ``M_hi * 256 +
      M_lo``, converted to float32 once;
    - int12: the operand ``[16re | 16im | re | im]`` against the one term
      ``[[hi], [lo]]``; int13: that block twice against ``[[h1], [l1],
      [h2], [l2]]`` (built literally, so this checks the CUDA kernels'
      ``M_hi * 16 + M_lo`` algebra independently);
    - bf16, bf16x2, f32: ``[re | im]`` as float32 times each term widened to
      float32, the terms' partial sums added in term order.

    On the CPU the integer operands are widened to int32 and multiplied
    exactly (``torch.matmul`` on int8 CPU tensors returns int8 and wraps).
    On the card ``torch.matmul`` has no int32 kernel, so it multiplies in
    float32 with TF32 off, which is exact here: whatever order the sum is
    taken in, every partial sum of one term is an integer of magnitude at
    most 8 * 127 * K for the plain operand (260,096 at K = 256) and
    (128 + 8) * 127 * K / 2 with the 16x planes, which at DSA-110 int13
    (K = 1024) is 8,843,264: below 2^24.  Terms combine in int64.  The
    float modes' products are exact in float32 for bfloat16 weights (8 + 4
    significant bits), so only the order of the K-sum separates this from
    the kernels and from XLA."""
    fc, t, p, _ = re.shape
    planes = [re, im]
    if mode in FOLDED_SUBTERMS:
        planes = [16 * re, 16 * im, re, im] * (FOLDED_SUBTERMS[mode] // 2)
    xk = torch.cat(planes, dim=-1)                # [Fc, T, P, K]
    xk = xk.permute(0, 2, 1, 3).reshape(fc, p * t, -1)
    if mode in FLOAT_MODES:
        xk = xk.to(torch.float32)
        acc = None
        for term in terms:
            part = torch.matmul(xk, term[f0:f1].to(torch.float32))
            acc = part if acc is None else acc + part
        return acc
    mm_dtype = torch.int32 if re.device.type == "cpu" else torch.float32
    xk = xk.to(mm_dtype)
    m = None
    for term in terms:
        part = torch.matmul(xk, term[f0:f1].to(mm_dtype)).to(torch.int64)
        m = part if m is None else m * 256 + part
    return m.to(torch.float32)


def detect_power_plain(x, terms, scales, cfg: ObsConfig, time_major: bool,
                       chan_chunk: int = 32, *, quant8_scales=None,
                       inco_mask=None, sk: bool = False,
                       stokes: bool = False) -> tuple:
    """The detect kernel's computation in plain PyTorch, on any device:
    ``(out, inco, sk)``.

    ``out`` is float32 ``[F, T/navg_time, B]`` (power) or
    ``[F, T/navg_time, 4, B]`` (``stokes``: I, Q, U, V), channel ``f``
    scaled by ``scales[f, -1]**2`` (uint8 through ``quantize_u8`` with
    ``quant8_scales``, Q/U/V at ``STOKES_QUV_OFFSET``).  ``inco`` (with
    ``inco_mask``, see ``incoherent_mask``) is the float32
    ``[F, T/navg_time]`` incoherent sum; ``sk`` the int64
    ``[F, 2, a_compute]`` per-antenna S1 and S2.  Both are exact integers,
    as the kernel's; None when not asked for.

    The detection arithmetic is the JAX kernel's as XLA evaluates it on the
    CPU (products contracted to FMAs, the time sum as a halving tree), so
    on the CPU this agrees with the JAX package to the bit at the presets'
    ``navg_time``; the CUDA kernel sums in sample order, within float32
    rounding of this.  Runs ``chan_chunk`` channels at a time: at full
    DSA-10 width the ``[F, 2T, 2B]`` f32 accumulator alone would be about
    69 GB (DSA-110: the same), a 32-channel chunk's 1.1 GB.
    """
    f_all, t, b = cfg.n_chan, cfg.t_block, cfg.n_beams
    ac, navg = cfg.a_compute, cfg.navg_time
    shape = (f_all, t // navg) + ((4,) if stokes else ()) + (b,)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    epilogue = _stokes_epilogue if stokes else _power_epilogue
    inco = sk_out = keep = None
    if inco_mask is not None:
        inco = torch.empty((f_all, t // navg), dtype=torch.float32,
                           device=x.device)
        keep = torch.tensor([(inco_mask >> i) & 1 for i in range(ac)],
                            dtype=torch.int32, device=x.device)
    if sk:
        sk_out = torch.empty((f_all, 2, ac), dtype=torch.int64,
                             device=x.device)
    s = scales[:, -1]
    with _exact_float32_matmul():
        for f0 in range(0, f_all, chan_chunk):
            f1 = min(f_all, f0 + chan_chunk)
            re, im = _unpack_chunk(x, cfg, time_major, f0, f1)
            if inco is not None or sk_out is not None:
                pw = re * re + im * im                    # [Fc, T, P, ac]
                if inco is not None:
                    tot = (pw * keep).sum(dim=(2, 3))     # int64 [Fc, T]
                    inco[f0:f1] = tot.reshape(f1 - f0, t // navg, navg) \
                        .sum(dim=2).to(torch.float32)
                if sk_out is not None:
                    sk_out[f0:f1, 0] = pw.sum(dim=(1, 2))
                    sk_out[f0:f1, 1] = (pw * pw).sum(dim=(1, 2))
            acc = _gemm_chunk(re, im, terms, f0, f1, cfg.weight_mode)
            sc = s[f0:f1]
            out[f0:f1] = epilogue(acc, t, b, navg) \
                * (sc * sc).view(-1, *([1] * (out.dim() - 1)))
    if quant8_scales is not None:
        out = quantize_u8(out, quant8_scales,
                          stokes_offsets(x.device) if stokes else None)
    return out, inco, sk_out


def voltages_plain(x, terms, scales, cfg: ObsConfig, time_major: bool,
                   chan_chunk: int = 32) -> torch.Tensor:
    """The voltage kernel's computation in plain PyTorch, on any device:
    float32 ``[F, T, P, 2B]`` beam voltages, ``[..., :B]`` Re and
    ``[..., B:]`` Im, channel ``f`` the GEMM of ``_gemm_chunk`` times
    ``scales[f, -1]`` (for the int8 modes an exact integer and one float32
    multiply, so the kernel agrees to the bit)."""
    f_all, t, p, b = cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_beams
    out = torch.empty((f_all, t, p, 2 * b), dtype=torch.float32,
                      device=x.device)
    s = scales[:, -1]
    with _exact_float32_matmul():
        for f0 in range(0, f_all, chan_chunk):
            f1 = min(f_all, f0 + chan_chunk)
            re, im = _unpack_chunk(x, cfg, time_major, f0, f1)
            acc = _gemm_chunk(re, im, terms, f0, f1, cfg.weight_mode) \
                * s[f0:f1, None, None]
            out[f0:f1] = acc.view(f1 - f0, p, t, 2 * b).permute(0, 2, 1, 3)
    return out


def kernel_library(cfg: ObsConfig, kernel: str) -> str:
    """The CUDA source (``csrc/<name>.cu``) that holds ``kernel``
    (``"detect_power"`` or ``"beam_voltages"``) for ``cfg.weight_mode``."""
    if kernel not in KERNEL_SOURCES:
        raise ValueError(f"no kernel {kernel!r}; the kernels are "
                         f"{KERNEL_SOURCES}")
    return kernel   # one library each: the operand type chosen at run time


#: Every CUDA source with a C entry point ``dsabf_<name>``.
KERNEL_SOURCES = ("detect_power", "beam_voltages")


def _kernel_lib(name: str) -> ctypes.CDLL:
    lib = load_library(name)
    fn = getattr(lib, f"dsabf_{name}")
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # Both take (n_terms, fold, elem_size) after the sizes
        # (_operand_args); the detect library then navg and stokes.
        if name == "detect_power":
            fn.argtypes = [p, p, p, p, p, p, p, p,
                           ctypes.POINTER(ctypes.c_uint), p, p, i, i, i, i,
                           i, i, i, i, i, i, ll, ll, p]
        else:
            fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, ll, ll,
                           p]
        fn.restype = i
        lib.dsabf_error_string.argtypes = [i]
        lib.dsabf_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_operands(x, terms, scales, cfg: ObsConfig,
                           time_major: bool, extra=()) -> None:
    """Everything both kernels assume about their pointers, checked before
    they read them (``extra``: more ``(name, tensor)`` that must be
    contiguous)."""
    if x.dtype != torch.uint8 or tuple(x.shape) != cfg.device_wire_shape \
            or time_major != (cfg.input_layout == "tfpa"):
        raise ValueError(
            f"wire must be the {cfg.input_layout} device form uint8 "
            f"{cfg.device_wire_shape}, got {_dtype_name(x.dtype)} "
            f"{tuple(x.shape)} (time_major={time_major})")
    _check_weights(QuantWeights(tuple(terms), scales), cfg)
    operands = [("wire", x), ("scales", scales)] + [
        (f"term{k}", w) for k, w in enumerate(terms)] + list(extra)
    for name, t in operands:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cfg.n_pol != 2:
        raise ValueError(f"kernel needs 2 pols, got n_pol={cfg.n_pol}")
    if cfg.n_chan > 65535:
        raise ValueError(f"kernel takes at most 65535 channels, got {cfg.n_chan}")


def _check_same_device(x, tensors) -> None:
    for t in tensors:
        if t is not None and t.device != x.device:
            raise ValueError(
                f"weights are on {t.device}, wire on {x.device}: move both "
                f"to one device")


def _operand_args(cfg: ObsConfig, terms) -> list:
    """The three integers that tell either library how to read the terms:
    ``(n_terms, fold, element size)``: int8 sub-terms and fold for the int8
    modes (element size 1), the bfloat16 or float32 tensors for the float
    ones (fold 0)."""
    if cfg.weight_mode in FLOAT_MODES:
        return [len(terms), 0, terms[0].element_size()]
    return [n_subterms(cfg), int(cfg.weight_mode in FOLDED_SUBTERMS), 1]


def _launch(lib, name: str, args: list, device) -> None:
    """Call ``dsabf_<name>`` on ``device``'s current stream; raise on a
    refused launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"dsabf_{name}")(*args, stream)
    if rc:
        raise RuntimeError(f"{name} launch failed: error {rc}, "
                           f"{lib.dsabf_error_string(rc).decode()}")


def fused_detect(x, terms, scales, cfg: ObsConfig, time_major: bool, *,
                 quant8_scales=None, inco_mask=None, sk: bool = False,
                 stokes: bool = False) -> tuple:
    """Detection product of one wire block and its side outputs:
    ``(out, inco, sk)`` as ``detect_power_plain`` returns them.

    ``x`` is the device wire form from ``_prepare_wire``.  A CPU tensor runs
    ``detect_power_plain``; a CUDA tensor launches the kernel on the current
    stream and counts it in ``fused_detect.launches[variant_name(...)]`` and
    in ``fused_detect.launches_by_mode[(cfg.weight_mode, variant)]``, or
    raises.  Any other device raises.
    """
    _check_same_device(x, (scales, *terms, quant8_scales))
    if x.device.type == "cpu":
        return detect_power_plain(x, terms, scales, cfg, time_major,
                                  quant8_scales=quant8_scales,
                                  inco_mask=inco_mask, sk=sk, stokes=stokes)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_detect runs on CUDA (kernel) or CPU (plain) tensors, "
            f"got {x.device}")
    out = _launch_detect(x, terms, scales, cfg, time_major,
                         quant8_scales=quant8_scales, inco_mask=inco_mask,
                         sk=sk, stokes=stokes)
    variant = variant_name(quant8_scales is not None, inco_mask is not None,
                           sk, stokes)
    fused_detect.launches[variant] += 1
    fused_detect.launches_by_mode[(cfg.weight_mode, variant)] += 1
    return out


fused_detect.launches = collections.Counter()
fused_detect.launches_by_mode = collections.Counter()


def _launch_detect(x, terms, scales, cfg: ObsConfig, time_major: bool, *,
                   quant8_scales, inco_mask, sk: bool, stokes: bool) -> tuple:
    """Check the operands, allocate the outputs on ``x``'s device and launch
    the mode's detect kernel (``kernel_library``): ``(out, inco, sk)``."""
    quant8 = quant8_scales is not None
    _check_kernel_operands(
        x, terms, scales, cfg, time_major,
        [("quant8_scales", quant8_scales)] if quant8 else ())
    if quant8 and (quant8_scales.dtype != torch.float32
                   or tuple(quant8_scales.shape) != (cfg.n_beams,)):
        raise ValueError(
            f"quant8_scales must be float32 [{cfg.n_beams}], got "
            f"{_dtype_name(quant8_scales.dtype)} "
            f"{tuple(quant8_scales.shape)}")
    if inco_mask is not None and inco_mask >> cfg.a_compute:
        raise ValueError(
            f"incoherent mask {inco_mask:#x} selects antennas past "
            f"a_compute={cfg.a_compute}")
    n_out = cfg.t_block // cfg.navg_time
    shape = (cfg.n_chan, n_out) + ((4,) if stokes else ()) + (cfg.n_beams,)
    out = torch.empty(shape, dtype=torch.uint8 if quant8 else torch.float32,
                      device=x.device)
    inco = sk_out = None
    if inco_mask is not None:
        inco = torch.empty((cfg.n_chan, n_out), dtype=torch.float32,
                           device=x.device)
    if sk:
        # Zeroed on the launch's stream, so ordered before the kernel.
        sk_out = torch.zeros((cfg.n_chan, 2, cfg.a_compute),
                             dtype=torch.int64, device=x.device)
    mask_dev = sliced = None
    if _detect_tiles(cfg, stokes).slices:
        # The K loop reads the weights in slice order and the mask from
        # device memory.
        sliced = _sliced_weights(terms, cfg)
        if inco_mask is not None:
            mask_dev = torch.tensor(
                np.frombuffer(_mask_words(inco_mask, cfg.a_compute),
                              np.int32), device=x.device)
    time_stride, chan_stride = _wire_strides(cfg, time_major)
    name = kernel_library(cfg, "detect_power")
    _launch(_kernel_lib(name), name, [
        x.data_ptr(), terms[0].data_ptr(), terms[-1].data_ptr(),
        scales.data_ptr(), quant8_scales.data_ptr() if quant8 else None,
        out.data_ptr(), None if inco is None else inco.data_ptr(),
        None if sk_out is None else sk_out.data_ptr(),
        None if inco_mask is None else _mask_words(inco_mask, cfg.a_compute),
        None if mask_dev is None else mask_dev.data_ptr(),
        None if sliced is None else sliced.data_ptr(), cfg.n_chan,
        cfg.t_block, cfg.n_beams, cfg.n_ant, cfg.a_compute,
        *_operand_args(cfg, terms), cfg.navg_time, int(stokes),
        time_stride, chan_stride], x.device)
    return out, inco, sk_out


def _beamform(wire, qw: QuantWeights, cfg: ObsConfig, *, stokes: bool,
              incoherent: bool, flag_ants: tuple, quant8_scales,
              sk_stats: bool):
    """``beamform_power`` / ``beamform_stokes``: the JAX package's checks,
    the kernel call, the ``navg_freq`` sum and the return order."""
    if quant8_scales is not None and cfg.navg_freq != 1:
        raise ValueError(
            f"quant8_scales requires navg_freq=1 (got {cfg.navg_freq}): "
            f"in-epilogue quantization must be the LAST averaging step; "
            f"use FilterbankSink.device_post for navg_freq > 1")
    _check_weights(qw, cfg)
    if flag_ants and (min(flag_ants) < 0
                      or max(flag_ants) >= cfg.n_ant_active):
        raise ValueError(
            f"flag_ants {sorted(flag_ants)} out of range "
            f"[0, n_ant_active={cfg.n_ant_active})")
    x, time_major = _prepare_wire(wire, cfg)
    if quant8_scales is not None:
        quant8_scales = torch.as_tensor(quant8_scales, dtype=torch.float32,
                                        device=x.device)
        if tuple(quant8_scales.shape) != (cfg.n_beams,):
            raise ValueError(
                f"quant8_scales must be [n_beams]={cfg.n_beams}, "
                f"got {tuple(quant8_scales.shape)}")
    if incoherent or sk_stats:
        what = "incoherent product" if incoherent else "SK stats"
        if cfg.n_ant_active > cfg.a_compute:
            raise ValueError(
                f"fused {what} needs n_ant_active="
                f"{cfg.n_ant_active} <= a_compute={cfg.a_compute}"
            )
    out, inco, sk = fused_detect(
        x, qw.terms, qw.scales, cfg, time_major, quant8_scales=quant8_scales,
        inco_mask=incoherent_mask(cfg, flag_ants) if incoherent else None,
        sk=sk_stats, stokes=stokes)
    nf = cfg.navg_freq
    if nf > 1:
        out = out.reshape(out.shape[0] // nf, nf, *out.shape[1:]).sum(dim=1)
        if incoherent:
            inco = inco.reshape(inco.shape[0] // nf, nf, -1).sum(dim=1)
    parts = [out]
    if incoherent:
        parts.append(inco)
    if sk_stats:
        # The antenna sum happens here, exactly in int64, then one rounding
        # to float32 (S2 of a full DSA-10 channel is ~4e8, past 2^24).
        parts.append(sk[:, :, :cfg.n_ant_active].sum(dim=2)
                     .to(torch.float32))
    return tuple(parts) if len(parts) > 1 else out


def beamform_power(wire, qw: QuantWeights, cfg: ObsConfig,
                   incoherent: bool = False, flag_ants: tuple = (),
                   quant8_scales=None, sk_stats: bool = False):
    """Fused pipeline: 4R4I wire block -> averaged beam powers.

    Returns float32 ``[F/navg_freq, T/navg_time, B]`` (sum over navg_time
    samples, both pols, and navg_freq adjacent channels -- matching
    ``ops.reference.beamform_block_ref``) on the wire's device.  The wire may
    be a tensor or a NumPy array (a CPU tensor without a copy).

    As the JAX package's ``beamform_power``, the same kernel call can add,
    in this order after the product (a tuple then comes back):

    - ``incoherent=True``: the incoherent-sum total power
      ``[F/navg_freq, T/navg_time]`` float32 (``ops.incoherent.
      incoherent_power`` semantics), without the antennas in ``flag_ants``
      (raw indices below ``n_ant_active``);
    - ``sk_stats=True``: the per-raw-channel spectral-kurtosis accumulators
      ``[n_chan, 2]`` float32 (S1, S2 over every active antenna, flagged
      ones included: ``ops.incoherent.sk_block_stats`` semantics).

    ``quant8_scales`` (``[n_beams]`` float32) stores the product as uint8
    ``clip(rint(p * scale_b), 0, 255)``, byte for byte the rint/clip of the
    float32 product times the scale; it needs ``navg_freq == 1``.
    """
    return _beamform(wire, qw, cfg, stokes=False, incoherent=incoherent,
                     flag_ants=flag_ants, quant8_scales=quant8_scales,
                     sk_stats=sk_stats)


def beamform_stokes(wire, qw: QuantWeights, cfg: ObsConfig,
                    incoherent: bool = False, flag_ants: tuple = (),
                    quant8_scales=None, sk_stats: bool = False):
    """Fused full-Stokes pipeline: 4R4I wire block -> averaged Stokes
    spectra.

    Returns float32 ``[F/navg_freq, T/navg_time, 4, B]`` with the Stokes
    axis ordered ``[I, Q, U, V]`` for the linear-feed convention

        I = |Bx|^2 + |By|^2        Q = |Bx|^2 - |By|^2
        U = 2 Re(Bx conj(By))      V = 2 Im(Bx conj(By))

    (x = pol 0, y = pol 1 of the wire block), on the wire's device;
    ``[..., 0, :]`` is ``beamform_power``'s output (the CUDA kernel's to the
    bit).  ``incoherent``, ``flag_ants`` and ``sk_stats`` add the same side
    outputs, in the same order, as ``beamform_power``.

    ``quant8_scales`` (``[n_beams]`` float32) stores the product as uint8
    ``[F, T/navg, 4, B]``, ``counts = x * scale_b + offset`` with offset 0
    for I and ``STOKES_QUV_OFFSET`` for Q/U/V, rounded half to even and
    clipped to [0, 255]: the bytes of the two-pass
    ``FilterbankSink.device_post`` quantizer.  Requires ``navg_freq == 1``.
    """
    return _beamform(wire, qw, cfg, stokes=True, incoherent=incoherent,
                     flag_ants=flag_ants, quant8_scales=quant8_scales,
                     sk_stats=sk_stats)


def beamform_voltages(wire, qw: QuantWeights, cfg: ObsConfig):
    """Unfused tail: 4R4I wire block -> beamformed voltages.

    Returns float32 ``[F, T, P, 2B]`` where ``[..., :B]`` is Re and
    ``[..., B:]`` is Im, in the units of the weights (the exact integer GEMM
    times the channel's scale; the float modes' float32 GEMM), on the wire's
    device.  Device-memory heavy by
    design (a DSA-10 block's voltages are 68.7 GB; use a sub-band): this is
    the validation path that the fused detection products are held against.

    A CPU tensor runs ``voltages_plain``; a CUDA tensor launches the
    voltage kernel (``csrc/beam_voltages.cu``) on the current stream, which
    reads
    tfpa and ftpa through strides, and counts it in
    ``beamform_voltages.launches`` and
    ``beamform_voltages.launches_by_mode[cfg.weight_mode]``.
    """
    _check_weights(qw, cfg)
    x, time_major = _prepare_wire(wire, cfg)
    _check_same_device(x, (qw.scales, *qw.terms))
    if x.device.type == "cpu":
        return voltages_plain(x, qw.terms, qw.scales, cfg, time_major)
    if x.device.type != "cuda":
        raise ValueError(
            f"beamform_voltages runs on CUDA (kernel) or CPU (plain) "
            f"tensors, got {x.device}")
    out = _launch_voltages(x, qw.terms, qw.scales, cfg, time_major)
    beamform_voltages.launches += 1
    beamform_voltages.launches_by_mode[cfg.weight_mode] += 1
    return out


beamform_voltages.launches = 0
beamform_voltages.launches_by_mode = collections.Counter()


def _launch_voltages(x, terms, scales, cfg: ObsConfig,
                     time_major: bool) -> torch.Tensor:
    """Check the operands, allocate the output on ``x``'s device and launch
    the voltage kernel (every mode: ``csrc/beam_voltages.cu``)."""
    _check_kernel_operands(x, terms, scales, cfg, time_major)
    out = torch.empty((cfg.n_chan, cfg.t_block, cfg.n_pol, 2 * cfg.n_beams),
                      dtype=torch.float32, device=x.device)
    time_stride, chan_stride = _wire_strides(cfg, time_major)
    sliced = _sliced_weights(terms, cfg) if _voltage_tiles(cfg).slices \
        else None
    name = kernel_library(cfg, "beam_voltages")
    _launch(_kernel_lib(name), name, [
        x.data_ptr(), terms[0].data_ptr(), terms[-1].data_ptr(),
        scales.data_ptr(), None if sliced is None else sliced.data_ptr(),
        out.data_ptr(), cfg.n_chan, cfg.t_block,
        cfg.n_beams, cfg.n_ant, cfg.a_compute, *_operand_args(cfg, terms),
        time_stride, chan_stride], x.device)
    return out


def voltages_to_complex(bv):
    """``[F, T, P, 2B]`` float32 -> ``[F, T, P, B]`` complex: NumPy in,
    NumPy out (complex64); a tensor gives a complex64 tensor."""
    b = bv.shape[-1] // 2
    if isinstance(bv, np.ndarray):
        return bv[..., :b] + 1j * bv[..., b:]
    return torch.complex(bv[..., :b], bv[..., b:])
