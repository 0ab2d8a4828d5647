"""Utilities: tolerance metric, device selection, per-block stats."""

from dsabeamformer_tpu_torch.utils.testing import assert_power_close, relative_power_error

__all__ = ["relative_power_error", "assert_power_close"]
