"""Ingest: synthetic voltage-block generation, PSRDADA headers and files,
SIGPROC filterbank output, the shared-memory ring (``ingest.ring``)."""

from dsabeamformer_tpu_torch.ingest.generator import (
    make_dispersed_pulse_block,
    make_noise_block,
    make_point_source_block,
    make_random_bytes_block,
    make_tone_block,
)

__all__ = [
    "make_dispersed_pulse_block",
    "make_noise_block",
    "make_point_source_block",
    "make_random_bytes_block",
    "make_tone_block",
]
