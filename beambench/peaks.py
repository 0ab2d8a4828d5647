"""Published peaks of the cards the benchmark knows (NVIDIA data sheets,
dense rates without sparsity, at the full power limit), matched by a
substring of ``torch.cuda.get_device_name()``, the first match winning: the
PCIe and NVL parts of the H100 are named apart from the SXM part ("NVIDIA
H100 80GB HBM3").  A card not listed has no peak, and its roofline shares
are not reported."""

from __future__ import annotations

from typing import Optional

_PEAKS = (
    ("h100 pcie", {"int8_ops_per_s": 1513e12, "bytes_per_s": 2.0e12}),
    ("h100 nvl", {"int8_ops_per_s": 1670.5e12, "bytes_per_s": 3.9e12}),
    ("h100", {"int8_ops_per_s": 1979e12, "bytes_per_s": 3.35e12}),
)


def peak_for(device_kind: str) -> Optional[dict]:
    kind = device_kind.lower()
    for key, peak in _PEAKS:
        if key in kind:
            return {**peak, "int8_macs_per_s": peak["int8_ops_per_s"] / 2.0}
    return None
