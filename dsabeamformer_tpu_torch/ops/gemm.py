"""The fused beamforming step: 4-bit wire block -> averaged beam powers.

One hand-written CUDA kernel (``csrc/detect_power.cu``) does what three
stages of the original CUDA program did (unpack, complex GEMM, detect) and
what the JAX package's Pallas kernel does (``dsabeamformer_tpu/ops/gemm.py``,
``_detect_kernel`` with ``_power_epilogue``, launched by ``_fused_detect``):
per channel, unpack the wire bytes of the first ``a_compute`` antennas of each
pol into ``[re | im]``, multiply by each int8 weight term in int32, combine
int8x2 terms as ``M_hi * 256 + M_lo``, convert to float32 once, then
``|B|^2``, pol sum, ``navg_time`` sum and the channel's ``s^2``.  Unpacked
voltages and beam voltages never reach device memory.

``fused_detect`` is the wrapper: a CUDA tensor goes to the kernel (or the
call raises), a CPU tensor to ``detect_power_plain``, the same function in
plain PyTorch.  ``fused_detect.launches`` counts kernel launches.

Public API: ``beamform_power`` (power product, int8 / int8x2 weights).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.ops._build import load_library
from dsabeamformer_tpu_torch.ops.quantize import QuantWeights

#: Weight modes the kernel and its plain version compute.
KERNEL_MODES = ("int8", "int8x2")
#: Antenna counts the kernel is instantiated for (K = 2 * a_compute).
KERNEL_A_COMPUTE = (8, 16, 32)
#: Time samples the kernel stages per thread block (csrc: kSpanSamples).
_SPAN_SAMPLES = 256
_MAX_SMEM = 48 * 1024


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


def _power_epilogue(acc, n_time, n_beams, navg_time):
    """``[Fc, P*T, 2B]`` f32 (pol-major rows) -> ``[Fc, T/navg, B]``:
    ``|B|^2``, pol sum, ``navg_time`` sum."""
    br = acc[..., :n_beams]
    bi = acc[..., n_beams:]
    p = br * br + bi * bi
    power = p[:, :n_time] + p[:, n_time:]
    fc = acc.shape[0]
    return power.reshape(fc, n_time // navg_time, navg_time, n_beams).sum(dim=2)


def detect_power_plain(x, terms, scales, cfg: ObsConfig, time_major: bool,
                       chan_chunk: int = 32) -> torch.Tensor:
    """The kernel's computation in plain PyTorch, on any device:
    ``[F, T/navg_time, B]`` float32, channel ``f`` scaled by
    ``scales[f, -1]**2``.

    On the CPU the operands are widened to int32 and multiplied exactly
    (``torch.matmul`` on int8 CPU tensors returns int8 and wraps).  On the
    card ``torch.matmul`` has no int32 kernel, so it multiplies in float32
    with TF32 off, which is exact here: every partial sum of one term is an
    integer of magnitude at most 8 * 127 * K, below 2^24 for any K of
    the presets (64 at DSA-10).  Terms combine in int64.
    Runs ``chan_chunk`` channels at a time: at full DSA-10 width the
    ``[F, 2T, 2B]`` f32 accumulator alone would be about 69 GB.
    """
    f_all, t, b = cfg.n_chan, cfg.t_block, cfg.n_beams
    p, a, ac = cfg.n_pol, cfg.n_ant, cfg.a_compute
    wire4 = x.view(t, f_all, p, a) if time_major else x.view(f_all, t, p, a)
    mm_dtype = torch.int32 if x.device.type == "cpu" else torch.float32
    out = torch.empty((f_all, t // cfg.navg_time, b), dtype=torch.float32,
                      device=x.device)
    s = scales[:, -1]
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for f0 in range(0, f_all, chan_chunk):
            f1 = min(f_all, f0 + chan_chunk)
            w = wire4[:, f0:f1] if time_major else wire4[f0:f1]
            if time_major:
                w = w.permute(1, 0, 2, 3)                 # [Fc, T, P, A]
            v = w[..., :ac].to(torch.int32)
            re = (((v >> 4) + 8) & 15) - 8                # high nibble
            im = ((v + 8) & 15) - 8                       # low nibble
            xk = torch.cat([re, im], dim=-1)              # [Fc, T, P, 2ac]
            xk = xk.permute(0, 2, 1, 3).reshape(f1 - f0, p * t, 2 * ac)
            xk = xk.to(mm_dtype)
            m = None
            for term in terms:
                part = torch.matmul(xk, term[f0:f1].to(mm_dtype))
                part = part.to(torch.int64)
                m = part if m is None else m * 256 + part
            acc = m.to(torch.float32)                     # [Fc, P*T, 2B]
            sc = s[f0:f1]
            out[f0:f1] = _power_epilogue(acc, t, b, cfg.navg_time) \
                * (sc * sc)[:, None, None]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return out


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("detect_power")
    if lib.dsabf_detect_power.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dsabf_detect_power.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                           ll, ll, p]
        lib.dsabf_detect_power.restype = i
        lib.dsabf_error_string.argtypes = [i]
        lib.dsabf_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_operands(x, terms, scales, cfg: ObsConfig,
                           time_major: bool) -> None:
    """Everything the kernel assumes about its pointers, checked before it
    reads them."""
    if x.dtype != torch.uint8 or tuple(x.shape) != cfg.device_wire_shape \
            or time_major != (cfg.input_layout == "tfpa"):
        raise ValueError(
            f"wire must be the {cfg.input_layout} device form uint8 "
            f"{cfg.device_wire_shape}, got {_dtype_name(x.dtype)} "
            f"{tuple(x.shape)} (time_major={time_major})")
    _check_weights(QuantWeights(tuple(terms), scales), cfg)
    for name, t in [("wire", x), ("scales", scales)] + [
            (f"term{k}", w) for k, w in enumerate(terms)]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 4:
        raise ValueError("wire must start on a 4-byte boundary")
    if any(w.dtype != torch.int8 for w in terms):
        raise ValueError(
            f"kernel takes int8 weight terms, got "
            f"{[_dtype_name(w.dtype) for w in terms]}")
    if scales.dtype != torch.float32:
        raise ValueError(
            f"scales must be float32, got {_dtype_name(scales.dtype)}")
    if len(terms) not in (1, 2):
        raise ValueError(f"kernel takes 1 or 2 weight terms, got {len(terms)}")
    if cfg.a_compute not in KERNEL_A_COMPUTE:
        raise ValueError(
            f"kernel is built for a_compute in {KERNEL_A_COMPUTE}, "
            f"config {cfg.name!r} has {cfg.a_compute}")
    if cfg.n_ant % 4:
        raise ValueError(f"kernel needs n_ant % 4 == 0, got {cfg.n_ant}")
    if cfg.n_chan > 65535:
        raise ValueError(f"kernel takes at most 65535 channels, got {cfg.n_chan}")
    rows = max(1, _SPAN_SAMPLES // cfg.navg_time) * cfg.navg_time
    if rows * 2 * (cfg.a_compute // 2) * 4 > _MAX_SMEM:
        raise ValueError(
            f"navg_time={cfg.navg_time} needs more shared memory than the "
            f"kernel stages ({_MAX_SMEM} bytes)")


def fused_detect(x, terms, scales, cfg: ObsConfig,
                 time_major: bool) -> torch.Tensor:
    """Detect-power of one wire block: ``[F, T/navg_time, B]`` float32.

    ``x`` is the device wire form from ``_prepare_wire``.  A CPU tensor runs
    ``detect_power_plain``; a CUDA tensor launches the kernel on the current
    stream and counts it in ``fused_detect.launches``, or raises.  Any other
    device raises.
    """
    for t in (scales, *terms):
        if t.device != x.device:
            raise ValueError(
                f"weights are on {t.device}, wire on {x.device}: move both "
                f"to one device")
    if x.device.type == "cpu":
        return detect_power_plain(x, terms, scales, cfg, time_major)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_detect runs on CUDA (kernel) or CPU (plain) tensors, "
            f"got {x.device}")
    _check_kernel_operands(x, terms, scales, cfg, time_major)
    out = torch.empty((cfg.n_chan, cfg.t_block // cfg.navg_time, cfg.n_beams),
                      dtype=torch.float32, device=x.device)
    time_stride, chan_stride = _wire_strides(cfg, time_major)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dsabf_detect_power(
            x.data_ptr(), terms[0].data_ptr(), terms[-1].data_ptr(),
            scales.data_ptr(), out.data_ptr(), cfg.n_chan, cfg.t_block,
            cfg.n_beams, cfg.n_ant, cfg.a_compute, len(terms),
            cfg.navg_time, time_stride, chan_stride, stream)
    if rc:
        raise RuntimeError(f"detect_power launch failed: error {rc}, "
                           f"{lib.dsabf_error_string(rc).decode()}")
    fused_detect.launches += 1
    return out


fused_detect.launches = 0


def beamform_power(wire, qw: QuantWeights, cfg: ObsConfig) -> torch.Tensor:
    """Fused pipeline: 4R4I wire block -> averaged beam powers.

    Returns float32 ``[F/navg_freq, T/navg_time, B]`` (sum over navg_time
    samples, both pols, and navg_freq adjacent channels -- matching
    ``ops.reference.beamform_block_ref``) on the wire's device.  The wire may
    be a tensor or a NumPy array (a CPU tensor without a copy).
    """
    if cfg.weight_mode not in KERNEL_MODES:
        raise NotImplementedError(
            f"weight mode {cfg.weight_mode!r} is not ported yet (ROADMAP.md "
            f"Queue 2 item 1: the remaining weight modes)")
    _check_weights(qw, cfg)
    x, time_major = _prepare_wire(wire, cfg)
    out = fused_detect(x, qw.terms, qw.scales, cfg, time_major)
    if cfg.navg_freq > 1:
        f, t, b = out.shape
        out = out.reshape(f // cfg.navg_freq, cfg.navg_freq, t, b).sum(dim=1)
    return out
