"""The beamformer's products in float64, straight from their definitions.

For one 4R4I wire block and complex weights ``w[f, b, a]``:

- beam voltages ``B[f, t, p, b] = sum_a w[f, b, a] v[f, t, p, a]``;
- beam power ``P[f', t', b]``: ``|B|^2`` summed over both polarizations,
  ``navg_time`` samples and ``navg_freq`` adjacent channels;
- incoherent power ``I[f', t']``: ``|v|^2`` summed over the active
  antennas, both polarizations and the same samples and channels;
- spectral-kurtosis accumulators ``S[f] = (sum p, sum p^2)`` of the
  per-sample powers ``p = re^2 + im^2`` over time, polarization and active
  antenna.

The wire's byte holds the real part in the high nibble and the imaginary
part in the low nibble, each 4-bit two's complement.  Computed a few
channels at a time so that a full block fits beside nothing else.
"""

from __future__ import annotations

import torch

#: Bytes of complex128 beam voltages held at once.
_BUDGET = 2 << 30


def unpack(wire: torch.Tensor) -> tuple:
    """4R4I bytes -> (re, im) int64."""
    s = wire.view(torch.int8).to(torch.int64)
    return s >> 4, ((s & 0xF) ^ 8) - 8


def products(obs: dict, weights: torch.Tensor, wire: torch.Tensor) -> tuple:
    """``(power [F', T', B], incoherent [F', T'], sk [F, 2])`` float64 on the
    wire's device; ``weights`` is ``[F, B, A_active]`` complex."""
    n_act = obs["n_ant_active"]
    nt, nf = obs["navg_time"], obs["navg_freq"]
    f_all, t_all, n_b = obs["n_chan"], obs["t_block"], obs["n_beams"]
    n_p = obs["n_pol"]
    tfpa = obs["input_layout"] == "tfpa"
    dev = wire.device
    wire = wire.reshape((t_all, f_all, n_p, obs["n_ant"]) if tfpa
                        else (f_all, t_all, n_p, obs["n_ant"]))
    w = weights.to(torch.complex128)
    power = torch.empty((f_all // nf, t_all // nt, n_b), dtype=torch.float64,
                        device=dev)
    inco = torch.empty((f_all // nf, t_all // nt), dtype=torch.float64,
                       device=dev)
    sk = torch.empty((f_all, 2), dtype=torch.float64, device=dev)
    per_chan = t_all * n_p * n_b * 16
    step = max(nf, (_BUDGET // per_chan) // nf * nf)
    for f0 in range(0, f_all, step):
        fc = min(step, f_all - f0)
        part = wire[:, f0:f0 + fc] if tfpa else wire[f0:f0 + fc]
        re, im = unpack(part[..., :n_act])
        if tfpa:  # -> [fc, T, P, A]
            re, im = re.permute(1, 0, 2, 3), im.permute(1, 0, 2, 3)
        v = torch.complex(re.to(torch.float64), im.to(torch.float64))
        bv = v.reshape(fc, t_all * n_p, n_act) @ w[f0:f0 + fc].transpose(1, 2)
        pw = (bv.real.square() + bv.imag.square()).reshape(
            fc, t_all, n_p, n_b).sum(dim=2)
        del bv
        pw = pw.reshape(fc // nf, nf, t_all // nt, nt, n_b).sum(dim=(1, 3))
        power[f0 // nf:(f0 + fc) // nf] = pw
        p = re * re + im * im                              # [fc, T, P, A]
        pi = p.sum(dim=(2, 3)).reshape(fc // nf, nf, t_all // nt, nt)
        inco[f0 // nf:(f0 + fc) // nf] = pi.sum(dim=(1, 3)).to(torch.float64)
        sk[f0:f0 + fc, 0] = p.sum(dim=(1, 2, 3)).to(torch.float64)
        sk[f0:f0 + fc, 1] = (p * p).sum(dim=(1, 2, 3)).to(torch.float64)
    return power, inco, sk


def beam_medians(power: torch.Tensor) -> torch.Tensor:
    """Per-beam median of ``[F', T', B]`` powers (of an even count, the
    mean of the two middle values)."""
    flat = power.reshape(-1, power.shape[-1]).sort(dim=0).values
    n = flat.shape[0]
    if n % 2:
        return flat[n // 2].to(torch.float64)
    return (flat[n // 2 - 1].to(torch.float64)
            + flat[n // 2].to(torch.float64)) / 2.0


def quant8_scales(power: torch.Tensor) -> torch.Tensor:
    """Counts per unit power that put each beam's median at 64 (1.0 for a
    beam whose median is not positive)."""
    med = beam_medians(power)
    return torch.where(med > 0, 64.0 / med.clamp_min(1e-300),
                       torch.ones_like(med))
