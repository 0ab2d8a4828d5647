"""Planar complex representation: ``CVec`` of (re, im) float32 tensors.

The port keeps the JAX package's planar convention at its public functions:
weights are a ``CVec``, the GEMM uses the K-concatenation identity
(ops/quantize.py) and the epilogue squares the planar parts.  NumPy complex
appears only in the host golden model.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsabeamformer_tpu_torch.utils.device import resolve_device


class CVec(NamedTuple):
    """A complex array as (re, im) planar float tensors of equal shape."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    @property
    def device(self) -> torch.device:
        return self.re.device

    @staticmethod
    def from_numpy(arr: np.ndarray, device="cuda",
                   dtype=torch.float32) -> "CVec":
        """NumPy complex -> planar tensors on ``device`` (the card unless
        the caller names another; raises when no card is usable)."""
        dev = resolve_device(device)
        arr = np.asarray(arr)
        return CVec(
            re=torch.as_tensor(np.ascontiguousarray(arr.real), dtype=dtype,
                               device=dev),
            im=torch.as_tensor(np.ascontiguousarray(arr.imag), dtype=dtype,
                               device=dev),
        )

    def to_numpy(self) -> np.ndarray:
        """Fetch to host as NumPy complex."""
        return self.re.cpu().numpy() + 1j * self.im.cpu().numpy()
