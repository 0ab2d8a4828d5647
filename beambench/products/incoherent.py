"""``incoherent``: the incoherent sum ``[F', T']`` of the active antennas.

- ``inco_err``: its largest relative gap (sums of integers: exact).

In the control the reference's own sums, rounded to bfloat16, stand in the
program's place.
"""

from __future__ import annotations

import math

import torch

from beambench.products import rel_err

NUMBERS = ("inco_err",)


def compare(ctx, ref, got) -> dict:
    if ctx.control:
        got = ref.inco.to(torch.bfloat16)
    if got is None:
        return {"inco_err": math.inf}
    return {"inco_err": rel_err(torch.as_tensor(got, device=ctx.device),
                                ref.inco)}
