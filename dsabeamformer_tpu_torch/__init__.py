"""dsabeamformer_tpu_torch -- the beamformer on PyTorch and CUDA (NVIDIA Hopper).

A port of ``dsabeamformer_tpu`` (the JAX/Pallas package beside it, which
stays the reference): the same module paths, public names and layouts at the
public functions, so each counterpart is easy to find and the tests compare
like with like.  The main path, the deployed path and the full-Stokes path
run today:

    config -> models.weights.make_weights -> ops.quantize.prepare_weights
      -> pipeline.StreamingBeamformer(products="power" | "stokes"):
         pipeline.RingSource (the capture process's shared-memory ring,
         ingest.ring; slots registered with CUDA, H2D straight from them)
         or pinned staging -> H2D
      -> ops.gemm.beamform_power / beamform_stokes (hand-written CUDA
         kernel, csrc/detect_power.cu: power or I/Q/U/V, uint8 epilogue,
         incoherent sum, spectral-kurtosis accumulators) -> D2H
      -> sinks (ingest.sigproc.FilterbankSink .fil, 1 or 4 IFs;
         pipeline.FileSink .dada) and ops.rfi.RFIMonitor, whose excisions
         regenerate the weights mid-stream, models.tracking.FringeTracker,
         and the live single-pulse search ops.dedisperse.SearchMonitor
         (dedispersion banks on csrc/dedisperse.cu) -> candidates

and the unfused validation path, ops.gemm.beamform_voltages
(csrc/beam_voltages.cu), that the fused products are held against.

Entry points run on the card unless the caller names another device.
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
    "beamform_stokes",
    "beamform_voltages",
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
    if name in ("beamform_power", "beamform_stokes", "beamform_voltages"):
        from dsabeamformer_tpu_torch.ops import gemm

        return getattr(gemm, name)
    if name in ("StreamingBeamformer", "run_stream"):
        from dsabeamformer_tpu_torch import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
