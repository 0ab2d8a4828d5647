"""Device selection: the port never carries on somewhere other than asked."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no usable card
    raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False (torch {torch.__version__}, CUDA {torch.version.cuda})")
    return dev
