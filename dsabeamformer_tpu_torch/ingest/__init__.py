"""Ingest: synthetic voltage-block generation."""

from dsabeamformer_tpu_torch.ingest.generator import (
    make_noise_block,
    make_point_source_block,
    make_random_bytes_block,
)

__all__ = [
    "make_noise_block",
    "make_point_source_block",
    "make_random_bytes_block",
]
