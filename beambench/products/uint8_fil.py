"""``uint8_fil``: the 8-bit sink's blocks in the ``.fil`` layout it makes
on the device, ``[B, T', F']`` with channels descending; held to the
``uint8`` numbers once the layout is undone."""

from __future__ import annotations

import torch

from beambench.products import uint8

NUMBERS = uint8.NUMBERS


def compare(ctx, ref, got) -> dict:
    counts = None
    if got is not None:
        counts = torch.from_numpy(got).to(ctx.device).flip(2).permute(2, 1, 0)
    return uint8.counts_err(ctx, ref, counts)
