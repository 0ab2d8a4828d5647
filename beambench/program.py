"""What the benchmark hands the port and what it takes back.

The port (``dsabeamformer_tpu_torch``) gets the configuration as its own
``ObsConfig``, the benchmark's complex weights (which it quantizes itself,
``ops.quantize.prepare_weights``) and wire blocks.  It gives back its
products through the sinks below: the deployed ``FilterbankSink``, which
sets its 8-bit scales itself from its first block, and an incoherent sink.
Both keep the blocks the check samples and drop the rest once ``write``
returns: a deployment's files would be far past a run's disk.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig, presets
from dsabeamformer_tpu_torch.ingest.sigproc import FilterbankSink
from dsabeamformer_tpu_torch.ops import gemm
from dsabeamformer_tpu_torch.ops.cplx import CVec
from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor


def require_products(mix: dict, own: tuple) -> list:
    """A kind builds its own products: refuse a mix that lacks one of
    them; -> the mix's other products, in its order."""
    if missing := [p for p in own if p not in mix["products"]]:
        raise ValueError(f"this kind makes {list(own)}, the mix lacks "
                         f"{missing}")
    return [p for p in mix["products"] if p not in own]


#: The program's own path in the nearest precision below each weight mode
#: a configuration may state: the control of the comparison.
LOWER_MODE = {"int8x2": "int8"}


def obs_config(spec: dict, control: bool = False) -> ObsConfig:
    """The configuration file's ``obs`` as the port's ``ObsConfig``, held
    equal to its preset (cut to ``subband``) but for the keys the file lists
    in ``reduced``; ``control`` switches the weights to the lower mode."""
    cfg = ObsConfig(**spec["obs"])
    base = presets()[spec["preset"]]
    if spec.get("subband"):
        base = base.subband(*spec["subband"])
    reduced = set(spec.get("reduced", ()))
    for key, value in spec["obs"].items():
        if key not in reduced and getattr(base, key) != value:
            raise ValueError(f"{spec['name']}: {key}={value!r} differs from "
                             f"the preset's {getattr(base, key)!r}")
    if control:
        cfg = cfg.replace(weight_mode=LOWER_MODE[cfg.weight_mode])
    return cfg


def port_weights(cfg: ObsConfig, weights: torch.Tensor):
    """``[F, B, A_active]`` complex weights -> the port's ``QuantWeights``
    (the padded antenna slots get zero weights)."""
    f, b, a = weights.shape
    re = torch.zeros((f, b, cfg.n_ant), dtype=torch.float32,
                     device=weights.device)
    im = torch.zeros_like(re)
    re[..., :a] = weights.real.to(torch.float32)
    im[..., :a] = weights.imag.to(torch.float32)
    return prepare_weights(cfg, CVec(re=re, im=im))


def _touched(shape, dtype) -> np.ndarray:
    """A host buffer with its pages already mapped, so that keeping a
    sampled block in the window costs a copy and no page faults."""
    buf = np.empty(shape, dtype)
    buf.fill(0)
    return buf


class _Discard:
    """A beam file that takes bytes and keeps none."""

    def write(self, data) -> None:
        pass

    def close(self) -> None:
        pass


class KeepSink(FilterbankSink):
    """The deployed 8-bit ``.fil`` sink with its files taken away.

    Everything but the files is ``FilterbankSink``'s: the per-beam auto
    scale from the first (float32) block it is given, the kernel's uint8
    epilogue at those scales (``fused_quant8_scales``) and the ``.fil``
    layout made on the device (``device_layout``).  The beam files hold
    only their headers, in a temporary directory gone before the sink is
    used; the blocks then written go nowhere, but for the blocks whose
    ``seq`` is in ``keep``, which are copied for the check."""

    def __init__(self, cfg: ObsConfig, keep, span):
        with tempfile.TemporaryDirectory() as d:
            super().__init__(d, cfg, nbits=8, scale="auto")
            for f in self._files.values():
                f.close()
        self._files = {b: _Discard() for b in self.beams}
        self._span = span
        self._bufs = {s: _touched(self.layout_shape, np.uint8) for s in keep}
        self.kept: dict = {}

    def write_beams(self, seq: int, slabs) -> None:
        with self._span("sink.write"):
            if slabs.dtype != np.uint8:  # the auto scale's float32 block
                super().write_beams(seq, slabs)
                return
            buf = self._bufs.get(seq)
            if buf is not None:
                np.copyto(buf, slabs)
                self.kept[seq] = buf

    def calibrate(self, wire: torch.Tensor, qw) -> torch.Tensor:
        """The scales from the port's float32 product of ``wire``, set by
        the sink's own rule, as the kernel's epilogue gets them."""
        out = gemm.beamform_power(wire.reshape(self.cfg.device_wire_shape),
                                  qw, self.cfg)
        self.write_beams(-1, self.device_layout(out).cpu().numpy())
        return self.fused_quant8_scales(wire.device)

    def scale_vector(self) -> np.ndarray:
        """The per-beam scales in effect, ``[B]`` float64."""
        return np.array([self._scales[b] for b in self.beams], np.float64)

    def close(self) -> None:
        pass


class KeepIncoherent:
    """The incoherent sink: keeps the sampled blocks' ``[F', T']`` sums."""

    def __init__(self, cfg: ObsConfig, keep, span):
        self._span = span
        self._bufs = {s: _touched(cfg.out_block_shape[:2], np.float32)
                      for s in keep}
        self.kept: dict = {}

    def write(self, seq: int, block) -> None:
        with self._span("inco.write"):
            buf = self._bufs.get(seq)
            if buf is not None:
                np.copyto(buf, block)
                self.kept[seq] = buf

    def close(self) -> None:
        pass


class KeepRFIMonitor(RFIMonitor):
    """The deployed RFI monitor, which also hands each block's SK
    accumulators to ``take`` once the block has drained (``drained``)."""

    def __init__(self, cfg: ObsConfig, **kw):
        super().__init__(cfg, **kw)
        self._arrays: list = []

    def observe_stats(self, sk) -> None:
        self._arrays.append(sk)
        super().observe_stats(sk)

    def drained(self):
        """The SK array of the oldest block not yet drained (filled now)."""
        return self._arrays.pop(0)
