"""Tolerance harness: the <=1e-3 relative-power-error gate.

The same metric as ``dsabeamformer_tpu/utils/testing.py`` (NumPy only), so
the port and the JAX package gate on one number;
``tests/test_torch_config.py`` holds the two equal.
"""

from __future__ import annotations

import numpy as np

#: The accuracy bar against the float64 golden model.
POWER_RTOL = 1e-3


def relative_power_error(p, p_ref) -> float:
    """Max relative power error with a floor tied to the block's peak
    power, so near-zero bins don't blow up the ratio."""
    p = np.asarray(p, dtype=np.float64)
    p_ref = np.asarray(p_ref, dtype=np.float64)
    if p.shape != p_ref.shape:
        raise ValueError(f"shape mismatch: {p.shape} vs {p_ref.shape}")
    scale = np.max(np.abs(p_ref))
    if scale == 0.0:
        return float(np.max(np.abs(p)))
    denom = np.maximum(np.abs(p_ref), 1e-3 * scale)
    return float(np.max(np.abs(p - p_ref) / denom))


def assert_power_close(p, p_ref, rtol: float = POWER_RTOL, what: str = ""):
    err = relative_power_error(p, p_ref)
    assert err <= rtol, (
        f"relative power error {err:.3e} > {rtol:.1e}" + (f" ({what})" if what else "")
    )
    return err
