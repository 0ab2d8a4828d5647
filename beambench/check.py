"""The comparison that decides ``correct``.

Run once the window has closed and the program's state is freed.  The
reference (``reference/beamform.py``, float64) works everything out again
from the inputs the benchmark made: the weights from the seed, each
sampled block's wire from the seed and its index, and the 8-bit scales from
its own powers of block 0, as the sink made the program's.  The reference's
products of each sampled content are computed once and handed to the
module of every product the mix names (``products/<name>.py``), which
returns its own numbers; the check keeps each number's largest over the
blocks.  Beside them, for every mix:

- ``order_faults``: blocks drained out of order, twice, or never;
- ``lost``: sampled blocks offered and never drained whole;
- ``compared``: sampled blocks compared; its limit is the least number.

Each number is held to the configuration file's limit of that name
(``checks``).  Every limit has to be returned by exactly one of these or
one of the mix's products, and every number returned has to have a limit:
``product_modules`` refuses a pairing of configuration and mix that breaks
this before the run starts.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from beambench import inputs, products
from beambench.core import Outcome
from beambench.reference import beamform as ref

#: The numbers of every mix, whatever its products.
GENERIC = ("order_faults", "lost", "compared")


class Reference(NamedTuple):
    """The reference's products of one input block, float64."""

    power: torch.Tensor  # [F', T', B]
    inco: torch.Tensor   # [F', T']
    sk: torch.Tensor     # [F, 2]


@dataclasses.dataclass
class Context:
    """What a product's ``compare`` knows of the run."""

    spec: dict              # configs/<name>.json
    seed: int
    outcome: Outcome
    device: torch.device
    control: bool
    weights: torch.Tensor   # the reference's [F, B, A_active] weights

    def reference(self, content: int) -> Reference:
        wire = inputs.wire_block(self.spec, self.seed, content, self.device)
        return Reference(*ref.products(self.spec["obs"], self.weights, wire))

    @functools.cached_property
    def scales(self) -> torch.Tensor:
        """The reference's 8-bit scales ``[B]``, from its own powers of
        block 0."""
        return ref.quant8_scales(self.reference(0).power)


def product_modules(spec: dict, mix: dict) -> dict:
    """``{name: module}`` of each product the mix names, once the
    configuration's limits are found to match the numbers returned."""
    mods = {name: products.module(name) for name in mix["products"]}
    returned = list(GENERIC) + [n for m in mods.values() for n in m.NUMBERS]
    limits = set(spec["checks"])
    faults = []
    if twice := sorted({n for n in returned if returned.count(n) > 1}):
        faults.append(f"returned by more than one part: {twice}")
    if unlimited := sorted(set(returned) - limits):
        faults.append(f"returned with no limit in checks: {unlimited}")
    if unreturned := sorted(limits - set(returned)):
        faults.append(f"limits that nothing returns: {unreturned}")
    if faults:
        raise ValueError(f"{spec['name']} under products {mix['products']}: "
                         + "; ".join(faults))
    return mods


def compare(spec: dict, mix: dict, seed: int, outcome: Outcome, device,
            control: bool = False) -> dict:
    """``{name: (value, limit)}``; a product's number that no block gave
    reads as infinite."""
    mods = product_modules(spec, mix)
    limits = spec["checks"]
    ctx = Context(spec, seed, outcome, torch.device(device), control,
                  inputs.steering_weights(spec, seed, device))
    worst: dict = {}
    n = 0
    by_content: dict = {}
    for k in outcome.kept:
        by_content.setdefault(k.content, []).append(k)
    for content, group in sorted(by_content.items()):
        reference = ctx.reference(content)
        for k in group:
            for name, mod in mods.items():
                got = mod.compare(ctx, reference, k.products.get(name))
                if set(got) != set(mod.NUMBERS):
                    raise ValueError(f"product {name} returned {sorted(got)},"
                                     f" not its NUMBERS {mod.NUMBERS}")
                for number, value in got.items():
                    value = math.inf if math.isnan(value) else value
                    worst[number] = max(worst.get(number, value), value)
            n += 1
        del reference
    checks = {number: (worst.get(number, math.inf), limits[number])
              for mod in mods.values() for number in mod.NUMBERS}
    checks["order_faults"] = (outcome.order_faults, limits["order_faults"])
    checks["lost"] = (outcome.lost, limits["lost"])
    checks["compared"] = (n, limits["compared"])
    return checks


def passed(checks: dict) -> bool:
    """Every number within its limit (``compared``: at least its limit)."""
    return all(value >= limit if name == "compared" else value <= limit
               for name, (value, limit) in checks.items())
