"""Array models: antenna layouts, calibration tables, and steering weight
generation on the device."""

from dsabeamformer_tpu_torch.models.arrays import ArrayLayout, array_for
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import make_weights, steering_weights

__all__ = [
    "ArrayLayout",
    "array_for",
    "CalTable",
    "make_weights",
    "steering_weights",
]
