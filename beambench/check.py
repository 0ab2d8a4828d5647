"""The comparison that decides ``correct``.

Run once the window has closed and the program's state is freed.  The
reference (``reference/beamform.py``, float64) works everything out again
from the inputs the benchmark made: the weights from the seed, each
sampled block's wire from the seed and its index, and the 8-bit scales from
its own powers of block 0, as the sink made the program's.  Numbers, each
held to the configuration file's limit (``checks``):

- ``power_err``: over every sample of the kept uint8 beam powers, how far
  the count lies outside the half count of rounding around the reference's
  scaled power ``r`` (clipped to [0, 255]), relative to ``max(r, 1)``: the
  configuration's power bar, carried through the 8-bit rounding;
- ``scale_err``: the largest relative gap between the program's 8-bit
  scales, which its sink set from its own powers of block 0, and the
  reference's.  A gain in all the program's powers leaves the counts as
  they were (the scales take it back) and shows here alone;
- ``inco_err``: the incoherent sums' largest relative gap (exact integers);
- ``sk_err``: the SK accumulators' largest relative gap;
- ``order_faults``: blocks drained out of order, twice, or never;
- ``lost``: sampled blocks offered and never drained whole;
- ``compared``: sampled blocks compared; its limit is the least number.

In the control (``control=True``) the side outputs are the reference's own,
rounded to bfloat16, in the program's place.
"""

from __future__ import annotations

import torch

from beambench import inputs
from beambench.core import Outcome
from beambench.reference import beamform as ref


def _power_err(counts: torch.Tensor, power: torch.Tensor,
               scales: torch.Tensor) -> float:
    r = (power * scales).clamp(0.0, 255.0)
    gap = ((counts.to(torch.float64) - r).abs() - 0.5).clamp_min(0.0)
    return float((gap / r.clamp_min(1.0)).max())


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    gap = (got.to(torch.float64) - want).abs()
    return float((gap / want.abs().clamp_min(1.0)).max())


def compare(spec: dict, seed: int, outcome: Outcome, device,
            control: bool = False) -> dict:
    """``{name: (value, limit)}``."""
    obs = spec["obs"]
    limits = spec["checks"]
    weights = inputs.steering_weights(spec, seed, device)

    def reference(content):
        wire = inputs.wire_block(spec, seed, content, device)
        return ref.products(obs, weights, wire)

    power0, _, _ = reference(0)
    scales = ref.quant8_scales(power0)
    del power0
    worst = {"power_err": 0.0, "inco_err": 0.0, "sk_err": 0.0,
             "scale_err": float("inf")}
    if outcome.scales is not None:
        got = torch.as_tensor(outcome.scales, dtype=torch.float64,
                              device=device)
        worst["scale_err"] = float(((got - scales).abs() / scales).max())
    n = 0
    by_content: dict = {}
    for k in outcome.kept:
        by_content.setdefault(k.content, []).append(k)
    for content, group in sorted(by_content.items()):
        power, inco, sk = reference(content)
        for k in group:
            counts = torch.from_numpy(k.power).to(device)
            if k.layout == "fil":  # [B, T', F'] channels descending
                counts = counts.flip(2).permute(2, 1, 0)
            worst["power_err"] = max(worst["power_err"],
                                     _power_err(counts, power, scales))
            got_inco, got_sk = k.inco, k.sk
            if control:
                got_inco = inco.to(torch.bfloat16)
                got_sk = sk.to(torch.bfloat16)
            if got_inco is None or got_sk is None:
                worst["inco_err"] = worst["sk_err"] = float("inf")
            else:
                worst["inco_err"] = max(worst["inco_err"], _rel_err(
                    torch.as_tensor(got_inco, device=device), inco))
                worst["sk_err"] = max(worst["sk_err"], _rel_err(
                    torch.as_tensor(got_sk, device=device), sk))
            n += 1
        del power, inco, sk
    checks = {name: (value, limits[name]) for name, value in worst.items()}
    checks["order_faults"] = (outcome.order_faults, limits["order_faults"])
    checks["lost"] = (outcome.lost, limits["lost"])
    checks["compared"] = (n, limits["compared"])
    return checks


def passed(checks: dict) -> bool:
    """Every number within its limit (``compared``: at least its limit)."""
    return all(value >= limit if name == "compared" else value <= limit
               for name, (value, limit) in checks.items())
