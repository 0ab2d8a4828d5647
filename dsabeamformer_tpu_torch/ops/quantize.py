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

Modes (the JAX package's seven; same ``Wc`` in, the same terms byte for
byte and equal scales out):

- ``int8``   : one int8 term, per-channel scale.
- ``int8x2`` : hi + lo int8 terms whose scales differ by exactly 2^8
               (residual quantization, ~15-bit effective): the kernel
               combines the int32 partials as ``M_hi * 256 + M_lo`` and
               applies one scale.  Default.
- ``int12``  : ONE int8 term ``[[hi], [lo]]`` stacked along K (K =
               4*a_compute) with ``Wc ~= s * (16*hi + lo)``, s = amax/2040:
               the kernel combines ``M_hi * 16 + M_lo``.
- ``int13``  : ONE int8 term ``[[h1], [l1], [h2], [l2]]`` (K = 8*a_compute),
               two such folds summed: ``Wc ~= s * (16*(h1+h2) + l1 + l2)``,
               s = amax/4318.
- ``bf16``   : one bfloat16 term, scale 1.
- ``bf16x2`` : ``hi = bf16(Wc)`` and ``lo = bf16(Wc - hi)``, scales 1; the
               kernel adds the two float32 partial sums.
- ``f32``    : ``Wc`` itself, scale 1 (the validation mode).

Tables are saved in the JAX package's ``.npz`` format (bfloat16 terms as the
two-byte ``|V2`` records ``np.savez`` makes of them), so a table written by
either package loads in the other wherever the JAX package can load its own
(it cannot load a bfloat16 table it saved).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.ops.cplx import CVec
from dsabeamformer_tpu_torch.utils.device import resolve_device

#: Every weight mode, and the dtype of its terms.
TERM_DTYPES = {
    "int13": torch.int8, "int12": torch.int8, "int8x2": torch.int8,
    "int8": torch.int8, "bf16": torch.bfloat16, "bf16x2": torch.bfloat16,
    "f32": torch.float32,
}


#: Folded modes: int8 sub-terms ``[2*a_compute, 2B]`` stacked along K in the
#: one term (int12 ``[[hi], [lo]]``; int13 ``[[h1], [l1], [h2], [l2]]``).
FOLDED_SUBTERMS = {"int12": 2, "int13": 4}


class QuantWeights(NamedTuple):
    """GEMM-ready weights.

    terms:  tuple of ``[F, K, 2B]`` tensors (int8, bfloat16 or float32).
            K = 2*a_compute, except int12, whose single term holds hi over
            lo (``[[W_hi], [W_lo]]``, K = 4*a_compute), and int13, whose
            term holds two such folds (K = 8*a_compute).
    scales: ``[F, n_terms]`` float32 per-channel per-term scale such that
            ``Wc[f] ~= sum_k scales[f, k] * terms[k][f]`` (int12:
            ``scales[f, 0] * (16*hi + lo)``; int13: the sum of its two
            folds; float modes: all 1).
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

    def dequantize(self, mode: str = "linear") -> torch.Tensor:
        """Reconstruct ``Wc`` in float32 (test oracle).  Pass
        ``mode="int12"`` or ``"int13"`` for the folded terms, whose K axis
        holds ``[[hi], [lo]]`` (int13: twice)."""
        if mode in ("int12", "int13"):
            t = self.terms[0].to(torch.float32)
            hi, lo = fold_sum(t, FOLDED_SUBTERMS[mode])
            return self.scales[:, 0, None, None] * (16.0 * hi + lo)
        acc = None
        for k, t in enumerate(self.terms):
            part = self.scales[:, k, None, None] * t.to(torch.float32)
            acc = part if acc is None else acc + part
        return acc


def fold_sum(term: torch.Tensor, n_sub: int) -> tuple:
    """``(hi, lo)`` of a folded term ``[F, n_sub*k2, 2B]`` whose K axis holds
    ``n_sub`` sub-terms ``[[h1], [l1], [h2], [l2]]`` (int13, 4) or
    ``[[hi], [lo]]`` (int12, 2): the sums ``h1 + h2`` and ``l1 + l2``, in
    the dtype the caller widened the term to (the sums pass int8)."""
    k2 = term.shape[1] // n_sub
    subs = [term[:, i * k2:(i + 1) * k2] for i in range(n_sub)]
    if n_sub == 2:
        return subs[0], subs[1]
    return subs[0] + subs[2], subs[1] + subs[3]


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


def _folded_scale(wc: torch.Tensor, full_scale: float) -> torch.Tensor:
    # amax * float32(1/full_scale): the multiply XLA makes of the JAX
    # quantizer's division by the constant (see _per_chan_scale).
    s = wc.abs().amax(dim=(1, 2)) * torch.tensor(1.0 / full_scale,
                                                  dtype=torch.float32)
    return torch.clamp_min(s, 1e-30)


def _quant_int12(wc):
    # s = amax/2040 puts round(wc/(16s)) within +-127.5; after the clip
    # |wc/s - 16*hi| <= 8, so lo is a 4-bit residual in an int8 operand.
    s = _folded_scale(wc, 2040.0)
    sn = s[:, None, None]
    hi = torch.clamp(torch.round(wc / (16.0 * sn)), -127, 127)
    lo = torch.clamp(torch.round(wc / sn - 16.0 * hi), -127, 127)
    return (torch.cat([hi, lo], dim=1).to(torch.int8),), s[:, None]


def _quant_int13(wc):
    # Two x16 folds: each spans +-(16*127 + 127) = +-2159, their sum
    # +-4318.  t = t1 + t2 with t1 = round(t/2); per fold hi = round(tk/16)
    # clipped to +-127 and lo = tk - 16*hi, which absorbs the excess when hi
    # clips (|lo| <= 127), so 16*hi + lo == tk over the whole range.
    s = _folded_scale(wc, 4318.0)
    t = torch.clamp(torch.round(wc / s[:, None, None]), -4318, 4318)
    t1 = torch.clamp(torch.round(t * 0.5), -2159, 2159)
    parts = []
    for tk in (t1, t - t1):
        hi = torch.clamp(torch.round(tk / 16.0), -127, 127)
        parts += [hi, tk - 16.0 * hi]
    return (torch.cat(parts, dim=1).to(torch.int8),), s[:, None]


def _ones(wc, n_terms):
    return torch.ones((wc.shape[0], n_terms), dtype=torch.float32,
                      device=wc.device)


def _quant_bf16(wc):
    # .to(bfloat16) rounds to nearest even, as XLA's convert.
    return (wc.to(torch.bfloat16),), _ones(wc, 1)


def _quant_bf16x2(wc):
    hi = wc.to(torch.bfloat16)
    # The residual against the ROUNDED hi, in float32 (exact: hi keeps wc's
    # leading 8 bits), then rounded to bfloat16 itself.
    lo = (wc - hi.to(torch.float32)).to(torch.bfloat16)
    return (hi, lo), _ones(wc, 2)


def _quant_f32(wc):
    return (wc,), _ones(wc, 1)


_QUANTIZERS = {
    "int13": _quant_int13,
    "int12": _quant_int12,
    "int8": _quant_int8,
    "int8x2": _quant_int8x2,
    "bf16": _quant_bf16,
    "bf16x2": _quant_bf16x2,
    "f32": _quant_f32,
}


def quantize_weights(
    weights: CVec, mode: str = "int8x2", a_compute: int | None = None
) -> QuantWeights:
    """Planar-complex weights ``[F, B, A]`` -> GEMM-ready ``QuantWeights``
    on the weights' device.  ``a_compute`` drops zero-padded antennas from
    the contraction axis (pass ``cfg.a_compute``; None keeps all A)."""
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


def _term_from_numpy(t) -> torch.Tensor:
    """One NumPy term -> a CPU tensor of the same bits.  int8 and float32
    as they are; any two-byte element type is taken as bfloat16 bits: the
    ``bfloat16`` extension dtype ``np.asarray`` gives for a JAX array, the
    ``|V2`` records ``np.savez`` makes of it, or uint16."""
    # np.array copies: the source may be a read-only view (a JAX array).
    a = np.array(t)
    if a.dtype in (np.int8, np.float32):
        return torch.from_numpy(a)
    if a.dtype.itemsize == 2 and a.dtype.kind in "Vu":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    raise ValueError(
        f"weight term of dtype {a.dtype} is none of int8, float32 or "
        f"two-byte bfloat16 bits")


def quant_weights_from_numpy(terms, scales, device="cuda") -> QuantWeights:
    """NumPy terms and scales (e.g. the JAX package's ``QuantWeights`` after
    ``np.asarray``) -> the port's ``QuantWeights`` on ``device`` (the card
    unless the caller names another), the same bits and scales, for every
    weight mode (see ``_term_from_numpy`` for bfloat16)."""
    dev = resolve_device(device)
    return QuantWeights(
        terms=tuple(_term_from_numpy(t).to(dev) for t in terms),
        scales=torch.from_numpy(np.array(scales, np.float32)).to(dev),
    )


def _term_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        # The two-byte void records the JAX package's np.savez writes.
        return t.view(torch.uint16).numpy().view("V2")
    return t.numpy()


def save_quant_weights(path: str, qw: QuantWeights) -> None:
    """Persist GEMM-ready weights (``term0``, ``term1``, ``scales``);
    bfloat16 terms as two-byte ``|V2`` records."""
    arrays = {f"term{k}": _term_to_numpy(t) for k, t in enumerate(qw.terms)}
    np.savez(path, scales=qw.scales.cpu().numpy(), **arrays)


def load_quant_weights(path: str, device="cuda") -> QuantWeights:
    """A table saved by either package -> ``QuantWeights`` on ``device``
    (the card unless the caller names another)."""
    d = np.load(path)
    if "terms" in d:  # round-1 stacked format
        stacked = d["terms"]
        terms = [stacked[k] for k in range(stacked.shape[0])]
    else:
        keys = sorted(k for k in d.files if k.startswith("term"))
        terms = [d[k] for k in keys]
    return quant_weights_from_numpy(terms, d["scales"], device)
