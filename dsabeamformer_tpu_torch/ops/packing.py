"""4R4I packed voltage format: exact bit-level pack and unpack.

One byte per complex sample: 4-bit two's-complement real part in the HIGH
nibble, imaginary part in the LOW nibble, each in [-8, 7].  Every function
takes a torch tensor or a NumPy array and returns the same kind; the NumPy
branch is the golden path shared with the synthetic generators.  The hot path
re-implements the unpack inside the CUDA kernel (csrc/detect_power.cu), so
unpacked voltages never reach device memory.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_4r4i(re, im):
    """Pack integer real/imag in [-8, 7] into 4R4I uint8 bytes.

    Values outside [-8, 7] are clipped (the wire format saturates).
    """
    if isinstance(re, torch.Tensor):
        re = torch.clamp(re, -8, 7).to(torch.int8).to(torch.uint8)
        im = torch.clamp(im, -8, 7).to(torch.int8).to(torch.uint8)
        return ((re & 0xF) << 4) | (im & 0xF)
    re = np.clip(re, -8, 7).astype(np.int8)
    im = np.clip(im, -8, 7).astype(np.int8)
    return (
        ((re.astype(np.uint8) & 0xF) << 4) | (im.astype(np.uint8) & 0xF)
    ).astype(np.uint8)


def unpack_4r4i(b):
    """Unpack 4R4I uint8 bytes -> (re, im) int8 in [-8, 7].

    The bytes are reinterpreted as int8 (two's complement), so the right
    shift is arithmetic and sign-extends the nibble.
    """
    if isinstance(b, torch.Tensor):
        return b.view(torch.int8) >> 4, (b << 4).view(torch.int8) >> 4
    hi = b.view(np.int8)
    lo = np.left_shift(b, 4).view(np.int8)  # uint8 << wraps mod 256
    return np.right_shift(hi, 4), np.right_shift(lo, 4)


def unpack_wire_to_complex(wire, layout: str):
    """Golden unpack + corner-turn: wire uint8 block -> complex [F, T, P, A].

    ``layout`` is ``"tfpa"`` or ``"ftpa"``.  Output is complex64 for tensors,
    complex128 for NumPy arrays (oracle precision).
    """
    re, im = unpack_4r4i(wire)
    if layout == "tfpa":
        re = re.permute(1, 0, 2, 3) if isinstance(re, torch.Tensor) \
            else re.transpose(1, 0, 2, 3)
        im = im.permute(1, 0, 2, 3) if isinstance(im, torch.Tensor) \
            else im.transpose(1, 0, 2, 3)
    elif layout != "ftpa":
        raise ValueError(f"unknown layout {layout}")
    if isinstance(wire, torch.Tensor):
        return torch.complex(re.to(torch.float32), im.to(torch.float32))
    return re.astype(np.float64) + 1j * im.astype(np.float64)
