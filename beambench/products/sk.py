"""``sk``: the kernel's spectral-kurtosis accumulators ``[F, 2]`` (the sum
of the per-sample powers and of their squares), which the RFI monitor
reads.

- ``sk_err``: their largest relative gap.

In the control the reference's own accumulators, rounded to bfloat16,
stand in the program's place.
"""

from __future__ import annotations

import math

import torch

from beambench.products import rel_err

NUMBERS = ("sk_err",)


def compare(ctx, ref, got) -> dict:
    if ctx.control:
        got = ref.sk.to(torch.bfloat16)
    if got is None:
        return {"sk_err": math.inf}
    return {"sk_err": rel_err(torch.as_tensor(got, device=ctx.device),
                              ref.sk)}
