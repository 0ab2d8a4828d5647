"""Compute ops: bit-level packing, the float64 golden model, weight
quantization, and the CUDA beamforming kernels (fused power and full-Stokes
detection, unfused beam voltages)."""

from dsabeamformer_tpu_torch.ops.packing import (
    pack_4r4i,
    unpack_4r4i,
    unpack_wire_to_complex,
)
from dsabeamformer_tpu_torch.ops.reference import (
    average_ref,
    beamform_block_ref,
    beamform_stokes_ref,
    beamform_voltages_ref,
    detect_ref,
    stokes_ref,
)
from dsabeamformer_tpu_torch.ops.quantize import QuantWeights, quantize_weights
from dsabeamformer_tpu_torch.ops.gemm import (
    beamform_power,
    beamform_stokes,
    beamform_voltages,
    voltages_to_complex,
)

__all__ = [
    "pack_4r4i",
    "unpack_4r4i",
    "unpack_wire_to_complex",
    "beamform_block_ref",
    "beamform_stokes_ref",
    "beamform_voltages_ref",
    "detect_ref",
    "stokes_ref",
    "average_ref",
    "QuantWeights",
    "quantize_weights",
    "beamform_power",
    "beamform_stokes",
    "beamform_voltages",
    "voltages_to_complex",
]
