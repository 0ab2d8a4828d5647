"""dsabeamformer_tpu_torch -- the beamformer on PyTorch and CUDA (NVIDIA Hopper).

A port of ``dsabeamformer_tpu`` (the JAX/Pallas package beside it, which
stays the reference): the same module paths, public names and layouts at the
public functions, so each counterpart is easy to find and the tests compare
like with like.  The main path runs today:

    config -> models.weights.make_weights -> ops.quantize.prepare_weights
      -> pipeline.StreamingBeamformer: pinned staging -> H2D
      -> ops.gemm.beamform_power (hand-written CUDA kernel,
         csrc/detect_power.cu) -> D2H -> sink

This package imports PyTorch and NumPy, never JAX.
"""

from dsabeamformer_tpu_torch.config import ObsConfig, DSA10, DSA110, TINY, presets

__version__ = "0.1.0"

__all__ = [
    "ObsConfig",
    "DSA10",
    "DSA110",
    "TINY",
    "presets",
    "make_weights",
    "quantize_weights",
    "beamform_power",
    "StreamingBeamformer",
    "run_stream",
    "__version__",
]


def __getattr__(name):
    # Lazy top-level API (keeps `import dsabeamformer_tpu_torch` light).
    if name == "make_weights":
        from dsabeamformer_tpu_torch.models.weights import make_weights

        return make_weights
    if name == "quantize_weights":
        from dsabeamformer_tpu_torch.ops.quantize import quantize_weights

        return quantize_weights
    if name == "beamform_power":
        from dsabeamformer_tpu_torch.ops.gemm import beamform_power

        return beamform_power
    if name in ("StreamingBeamformer", "run_stream"):
        from dsabeamformer_tpu_torch import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
