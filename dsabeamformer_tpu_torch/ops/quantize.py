"""Weight preparation for the int8 GEMM: K-concatenated real form +
quantization.

A complex GEMM ``B = V @ W^T`` becomes ONE real GEMM by concatenating real
and imaginary parts along the contraction axis:

    Xc = [Xr | Xi]                      # [T, 2A]
    Wc = [[Wr^T,  Wi^T],
          [-Wi^T, Wr^T]]               # [2A, 2B]
    Xc @ Wc = [Br | Bi]                # [T, 2B]

Antennas past ``a_compute`` are zero on the wire and are dropped from the
contraction axis.  Voltages are 4-bit integers, exact in int8, so all
quantization error lives in the weights.

Modes computed by the port:

- ``int8``   : one int8 term, per-channel scale.
- ``int8x2`` : hi + lo int8 terms whose scales differ by exactly 2^8
               (residual quantization, ~15-bit effective): the kernel
               combines the int32 partials as ``M_hi * 256 + M_lo`` and
               applies one scale.  Default.

The JAX package's other modes (int13, int12, bf16, bf16x2, f32) raise
``NotImplementedError`` here until they are ported (ROADMAP.md, Queue 2
item 1).  Tables are saved in the JAX package's ``.npz`` format, so a table
written by either package loads in the other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.ops.cplx import CVec
from dsabeamformer_tpu_torch.utils.device import resolve_device

#: Weight modes of the JAX package that the port does not compute yet.
UNPORTED_MODES = ("int13", "int12", "bf16", "bf16x2", "f32")


class QuantWeights(NamedTuple):
    """GEMM-ready weights.

    terms:  tuple of ``[F, K, 2B]`` int8 tensors, K = 2*a_compute.
    scales: ``[F, n_terms]`` float32 per-channel per-term scale such that
            ``Wc[f] ~= sum_k scales[f, k] * terms[k][f]``.
    """

    terms: tuple
    scales: torch.Tensor

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    @property
    def n_chan(self) -> int:
        return self.terms[0].shape[0]

    @property
    def device(self) -> torch.device:
        return self.scales.device

    def dequantize(self) -> torch.Tensor:
        """Reconstruct ``Wc`` in float32 (test oracle)."""
        acc = None
        for k, t in enumerate(self.terms):
            part = self.scales[:, k, None, None] * t.to(torch.float32)
            acc = part if acc is None else acc + part
        return acc


def cat_weights(weights: CVec, a_compute: int | None = None) -> torch.Tensor:
    """Planar ``CVec`` ``[F, B, A]`` -> K-concatenated real ``Wc
    [F, 2*a_compute, 2B]``; antennas >= ``a_compute`` (zero-padded wire
    slots) are dropped from the contraction axis."""
    wr = weights.re.to(torch.float32)  # [F, B, A]
    wi = weights.im.to(torch.float32)
    if a_compute is not None:
        if not (0 < a_compute <= wr.shape[2]):
            raise ValueError(
                f"a_compute={a_compute} out of range for A={wr.shape[2]}"
            )
        wr = wr[:, :, :a_compute]
        wi = wi[:, :, :a_compute]
    wrT = wr.transpose(1, 2)  # [F, A, B]
    wiT = wi.transpose(1, 2)
    top = torch.cat([wrT, wiT], dim=2)     # [F, A, 2B]
    bot = torch.cat([-wiT, wrT], dim=2)    # [F, A, 2B]
    return torch.cat([top, bot], dim=1)    # [F, 2A, 2B]


def _per_chan_scale(wc: torch.Tensor) -> torch.Tensor:
    # amax * float32(1/127), not amax / 127: XLA compiles the JAX
    # quantizer's division by that constant into this multiply, and the two
    # differ in the last bit for some channels.
    s = wc.abs().amax(dim=(1, 2)) * torch.tensor(1.0 / 127.0,
                                                  dtype=torch.float32)
    return torch.clamp_min(s, 1e-30)


def _round_int8(x: torch.Tensor) -> torch.Tensor:
    # torch.round is round-half-to-even, as jnp.round.
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def _quant_int8(wc):
    s = _per_chan_scale(wc)
    return (_round_int8(wc / s[:, None, None]),), s[:, None]


def _quant_int8x2(wc):
    s_hi = _per_chan_scale(wc)
    q_hi = _round_int8(wc / s_hi[:, None, None])
    # wc - s_hi * q_hi rounded ONCE to float32, as the fused multiply-add
    # XLA compiles the JAX line into; the float64 difference is exact
    # because wc lies within s_hi/2 of s_hi * q_hi.
    resid = (wc.double() - s_hi.double()[:, None, None]
             * q_hi.double()).float()
    # Exactly s_hi / 256 (a power of two), so the kernel combines the int32
    # partials as M_hi * 256 + M_lo and applies ONE scale.  |resid| <=
    # s_hi/2 => round(resid/s_lo) in [-128, 128]; the rare +-128 clips.
    s_lo = s_hi * (1.0 / 256.0)
    q_lo = _round_int8(resid / s_lo[:, None, None])
    return (q_hi, q_lo), torch.stack([s_hi, s_lo], dim=1)


_QUANTIZERS = {
    "int8": _quant_int8,
    "int8x2": _quant_int8x2,
}


def quantize_weights(
    weights: CVec, mode: str = "int8x2", a_compute: int | None = None
) -> QuantWeights:
    """Planar-complex weights ``[F, B, A]`` -> GEMM-ready ``QuantWeights``
    on the weights' device.  ``a_compute`` drops zero-padded antennas from
    the contraction axis (pass ``cfg.a_compute``; None keeps all A)."""
    if mode in UNPORTED_MODES:
        raise NotImplementedError(
            f"weight mode {mode!r} is not ported yet (ROADMAP.md Queue 2 "
            f"item 1: the remaining weight modes); use int8x2 or int8")
    try:
        fn = _QUANTIZERS[mode]
    except KeyError:
        raise ValueError(f"unknown weight mode {mode!r}") from None
    terms, scales = fn(cat_weights(weights, a_compute))
    return QuantWeights(terms=tuple(t.contiguous() for t in terms),
                        scales=scales.contiguous())


def prepare_weights(cfg: ObsConfig, weights: CVec) -> QuantWeights:
    """Config-driven quantization: mode and antenna slicing from cfg."""
    return quantize_weights(weights, cfg.weight_mode, cfg.a_compute)


def quant_weights_from_numpy(terms, scales, device="cpu") -> QuantWeights:
    """NumPy terms and scales (e.g. the JAX package's ``QuantWeights`` after
    ``np.asarray``) -> the port's ``QuantWeights`` on ``device``, the same
    integers and scales."""
    dev = resolve_device(device)
    # np.array copies: the source may be a read-only view (a JAX array).
    return QuantWeights(
        terms=tuple(torch.from_numpy(np.array(t)).to(dev) for t in terms),
        scales=torch.from_numpy(np.array(scales, np.float32)).to(dev),
    )


def save_quant_weights(path: str, qw: QuantWeights) -> None:
    """Persist GEMM-ready weights (``term0``, ``term1``, ``scales``)."""
    arrays = {f"term{k}": t.cpu().numpy() for k, t in enumerate(qw.terms)}
    np.savez(path, scales=qw.scales.cpu().numpy(), **arrays)


def load_quant_weights(path: str, device="cpu") -> QuantWeights:
    d = np.load(path)
    if "terms" in d:  # round-1 stacked format
        stacked = d["terms"]
        terms = [stacked[k] for k in range(stacked.shape[0])]
    else:
        keys = sorted(k for k in d.files if k.startswith("term"))
        terms = [d[k] for k in keys]
    return quant_weights_from_numpy(terms, d["scales"], device)
