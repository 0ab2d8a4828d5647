"""Golden-model pipeline in float64 NumPy: the accuracy oracle.

The same math as ``dsabeamformer_tpu/ops/reference.py`` on its NumPy branch
(unpack -> per-channel ``A[f] @ V[f]`` -> ``|B|^2`` -> pol sum -> time and
channel sums), importable without JAX so that a machine with only PyTorch can
hold the port to the <=1e-3 relative-power-error bar.
"""

from __future__ import annotations

import numpy as np

from dsabeamformer_tpu_torch.ops.packing import unpack_wire_to_complex


def beamform_voltages_ref(weights, volt):
    """Per-channel complex GEMM.

    weights: ``[F, B, A]`` complex; volt: ``[F, T, P, A]`` complex.
    Returns ``[F, T, P, B]`` beamformed voltages.
    """
    return np.einsum("fba,ftpa->ftpb", weights, volt, optimize=True)


def detect_ref(bvolt):
    """Power detection summing polarizations:
    ``[F, T, P, B]`` -> ``[F, T, B]`` with ``P = sum_p |B|^2``."""
    return (bvolt.real * bvolt.real + bvolt.imag * bvolt.imag).sum(axis=2)


def average_ref(power, navg_time: int, navg_freq: int = 1):
    """Sum over ``navg_time`` samples and ``navg_freq`` adjacent channels:
    ``[F, T, B]`` -> ``[F/navg_f, T/navg_t, B]``."""
    f, t, b = power.shape
    p = power.reshape(f // navg_freq, navg_freq, t // navg_time, navg_time, b)
    return p.sum(axis=(1, 3))


def beamform_block_ref(weights, wire, layout: str, navg_time: int,
                       navg_freq: int = 1):
    """Full golden pipeline: 4R4I wire block (NumPy, 4-D) -> averaged beam
    powers ``[F/navg_f, T/navg_t, B]`` float64."""
    volt = unpack_wire_to_complex(np.asarray(wire), layout)
    bv = beamform_voltages_ref(np.asarray(weights), volt)
    return average_ref(detect_ref(bv), navg_time, navg_freq)
