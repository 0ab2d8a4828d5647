"""Card-only tests of the port: the CUDA detect-power kernel against its
plain PyTorch version and the float64 golden model, at small shapes, and the
streaming driver's CUDA path against its CPU path.

Marked ``cuda``; each test skips (inside a fixture) when no card is present.
Imports no JAX, so on a machine with only PyTorch they run as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dsabeamformer_tpu_torch.config import DSA10, DSA10_COMPACT, DSA110, TINY
from dsabeamformer_tpu_torch.ingest.generator import (
    make_noise_block,
    make_point_source_block,
    make_random_bytes_block,
)
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import make_weights, weights_numpy_golden
from dsabeamformer_tpu_torch.ops import gemm
from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
from dsabeamformer_tpu_torch.ops.reference import beamform_block_ref
from dsabeamformer_tpu_torch.pipeline import (
    CollectSink,
    StreamingBeamformer,
    SyntheticSource,
)
from dsabeamformer_tpu_torch.utils.testing import relative_power_error

pytestmark = pytest.mark.cuda

#: Kernel vs plain: identical integers, f32 summation order only.
KERNEL_RTOL = 1e-6

GEOMS = {
    "tiny": TINY,
    "dsa10_small": DSA10.replace(n_chan=8, t_block=512),
    "dsa10c_small": DSA10_COMPACT.replace(n_chan=8, t_block=512),
    "odd_beams": TINY.replace(n_beams=300, navg_time=8),
    "narrow_k": TINY.replace(n_ant=8, n_ant_active=6),
}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _weights(cfg, device, seed=3):
    cal = CalTable.random(cfg, seed=seed)
    return prepare_weights(cfg, make_weights(cfg, cal=cal, device=device))


def _to(qw, device):
    return type(qw)(tuple(t.to(device) for t in qw.terms), qw.scales.to(device))


@pytest.mark.parametrize("navg_freq", [1, 2])
@pytest.mark.parametrize("mode", ["int8x2", "int8"])
@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_kernel_matches_plain(dev, geom, layout, mode, navg_freq):
    cfg = GEOMS[geom].replace(input_layout=layout, weight_mode=mode,
                              navg_freq=navg_freq)
    wire = make_random_bytes_block(cfg, seed=11)
    qw = _weights(cfg, dev)
    before = gemm.fused_detect.launches
    got = gemm.beamform_power(torch.from_numpy(wire).to(dev), qw, cfg)
    torch.cuda.synchronize()
    assert gemm.fused_detect.launches == before + 1
    assert got.device == dev and got.shape == cfg.out_block_shape
    # The plain version on the CPU (exact int32) and on the card (f32 GEMM).
    want_cpu = gemm.beamform_power(wire, _to(qw, "cpu"), cfg).numpy()
    x, tm = gemm._prepare_wire(torch.from_numpy(wire).to(dev), cfg)
    want_dev = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm)
    assert gemm.fused_detect.launches == before + 1
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    assert relative_power_error(got, want_cpu) <= KERNEL_RTOL
    if navg_freq == 1:
        assert relative_power_error(got, want_dev.cpu().numpy()) <= KERNEL_RTOL


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_kernel_point_source_vs_golden(dev, layout):
    cfg = DSA10.replace(n_chan=16, t_block=256, input_layout=layout)
    angles = cfg.beam_angles_rad()
    wire = make_point_source_block(cfg, angle_rad=angles[100], noise_rms=0.4,
                                   seed=7)
    qw = prepare_weights(cfg, make_weights(cfg, device=dev))
    p = gemm.beamform_power(torch.from_numpy(wire).to(dev), qw,
                            cfg).cpu().numpy()
    ref = beamform_block_ref(weights_numpy_golden(cfg), wire, layout,
                             cfg.navg_time)
    assert int(np.argmax(p.sum(axis=(0, 1)))) == 100
    assert relative_power_error(p, ref) <= 1e-3


def test_kernel_rejects_what_it_does_not_take(dev):
    cfg = TINY
    qw = _weights(cfg, dev)
    x = torch.from_numpy(make_noise_block(cfg, seed=1)).to(dev)
    x2, tm = gemm._prepare_wire(x, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        gemm.fused_detect(x2.t().contiguous().t(), qw.terms, qw.scales, cfg, tm)
    with pytest.raises(ValueError, match="int8 weight terms"):
        gemm.fused_detect(x2, tuple(t.to(torch.int16) for t in qw.terms),
                          qw.scales, cfg, tm)
    with pytest.raises(ValueError, match="weights are on"):
        gemm.fused_detect(x2, qw.terms, qw.scales.cpu(), cfg, tm)
    big = DSA110.replace(n_chan=4, t_block=64)
    qwb = _weights(big, dev)
    xb = torch.from_numpy(make_noise_block(big, seed=1)).to(dev)
    with pytest.raises(ValueError, match="a_compute"):
        gemm.beamform_power(xb, qwb, big)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_cuda_stream_matches_cpu_stream(dev, depth):
    cfg = DSA10.replace(n_chan=8, t_block=256)
    blocks = [make_noise_block(cfg, rms=2.0, seed=s) for s in range(3)]
    w1, w2 = _weights(cfg, dev, seed=1), _weights(cfg, dev, seed=2)
    outs = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        sink = CollectSink()
        bf = StreamingBeamformer(cfg, _to(w1, device),
                                 SyntheticSource(cfg, blocks, n_blocks=7),
                                 sink, depth=depth)
        if name == "cuda":
            bf.warmup()
            before = gemm.fused_detect.launches
        s1 = bf.run(max_blocks=4)
        bf.update_weights(_to(w2, device))
        s2 = bf.run()
        assert (s1.n_blocks, s2.n_blocks) == (4, 3)
        if name == "cuda":
            assert gemm.fused_detect.launches == before + 7
            assert s2.device_kind == torch.cuda.get_device_name(dev)
        outs[name] = sink.outputs
    assert [s for s, _ in outs["cuda"]] == list(range(7))
    for (sc, pc), (sg, pg) in zip(outs["cpu"], outs["cuda"]):
        assert sc == sg
        assert relative_power_error(pg, pc) <= KERNEL_RTOL
    assert relative_power_error(outs["cuda"][5][1], outs["cuda"][2][1]) > 1e-3
