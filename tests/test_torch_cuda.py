"""Card-only tests of the port: the CUDA detect kernel (power and full
Stokes, with its side outputs) and the beam-voltage kernel against their
plain PyTorch versions and the float64 golden model, at small shapes, at
a_compute 8, 16, 24, 32, 64, 96 and 128 (the DSA-110 width) and on the random
geometries of ``utils.testing.random_geometry``, and the streaming loop's
CUDA path against its CPU path.

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
    # a_compute 24: the last k32 step of the tensor-core kernel half empty.
    "ac24": DSA10.replace(n_chan=4, t_block=256, n_ant_active=21,
                          n_ant_compute=24, n_beams=72, navg_time=4),
    # a_compute 128 (DSA-110: 110 active, 512 beams, 8 beam tiles), 96 and
    # 64, with partial beam tiles and navg_time 8.
    "dsa110_small": DSA110.replace(n_chan=4, t_block=256),
    "ac96": DSA110.replace(n_chan=2, t_block=256, n_ant=96, n_ant_active=90,
                           n_beams=130, navg_time=8),
    "ac64": DSA110.replace(n_chan=2, t_block=256, n_ant_active=60,
                           n_ant_compute=64, n_beams=100),
}

#: A config whose a_compute (160) the kernels do not take.
TOO_WIDE = DSA110.replace(n_chan=4, t_block=64, n_ant=160, n_ant_active=150)


def _flags(cfg) -> tuple:
    """Antennas flagged out of the incoherent sum: 1, and 77 where it is
    active (a bit in the mask's third word)."""
    return (1, 77) if cfg.n_ant_active > 77 else (1,)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _weights(cfg, device, seed=3):
    cal = CalTable.random(cfg, seed=seed)
    return prepare_weights(cfg, make_weights(cfg, cal=cal, device=device))


def _launches() -> int:
    return sum(gemm.fused_detect.launches.values())


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
    before = _launches()
    got = gemm.beamform_power(torch.from_numpy(wire).to(dev), qw, cfg)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    assert got.device == dev and got.shape == cfg.out_block_shape
    # The plain version on the CPU (exact int32) and on the card (f32 GEMM).
    want_cpu = gemm.beamform_power(wire, _to(qw, "cpu"), cfg).numpy()
    x, tm = gemm._prepare_wire(torch.from_numpy(wire).to(dev), cfg)
    want_dev = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm)[0]
    assert _launches() == before + 1
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
    # No kernel takes a_compute 160: refused before any launch.
    big = TOO_WIDE
    assert big.a_compute == 160
    qwb = _weights(big, dev)
    xb = torch.from_numpy(make_noise_block(big, seed=1)).to(dev)
    before = _launches()
    with pytest.raises(ValueError, match="a_compute"):
        gemm.beamform_power(xb, qwb, big)
    assert _launches() == before


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
            before = _launches()
        s1 = bf.run(max_blocks=4)
        bf.update_weights(_to(w2, device))
        s2 = bf.run()
        assert (s1.n_blocks, s2.n_blocks) == (4, 3)
        if name == "cuda":
            assert _launches() == before + 7
            assert s2.device_kind == torch.cuda.get_device_name(dev)
        outs[name] = sink.outputs
    assert [s for s, _ in outs["cuda"]] == list(range(7))
    for (sc, pc), (sg, pg) in zip(outs["cpu"], outs["cuda"]):
        assert sc == sg
        assert relative_power_error(pg, pc) <= KERNEL_RTOL
    assert relative_power_error(outs["cuda"][5][1], outs["cuda"][2][1]) > 1e-3


# --------------------------------------------------------------------- #
# The deployed path's variants: uint8 epilogue, incoherent and SK outputs
# --------------------------------------------------------------------- #

#: variant -> (quant8, incoherent, sk)
SIDE_VARIANTS = {
    "q8": (True, False, False),
    "inco": (False, True, False),
    "sk": (False, False, True),
    "sk+q8": (True, False, True),
    "sk+q8+inco": (True, True, True),
}

SIDE_GEOMS = dict(GEOMS, dsa10_sub=DSA10.replace(n_chan=64, t_block=1024),
                  beams_600=TINY.replace(n_beams=600))


def _beam_scales(power, cfg, seed):
    """Per-beam 8-bit scales around mid-rail, spread so the rails engage."""
    rng = np.random.default_rng(seed)
    med = float(power.float().median())
    s = 64.0 / med * rng.uniform(0.5, 4.0, cfg.n_beams)
    return torch.from_numpy(s.astype(np.float32)).to(power.device)


@pytest.mark.parametrize("variant", sorted(SIDE_VARIANTS))
@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(SIDE_GEOMS))
def test_side_outputs_match_plain(dev, geom, layout, variant):
    """Kernel vs plain version on the same inputs: incoherent and SK
    equal; the uint8 product byte-equal to the rint/clip of the kernel's
    own float32 product, and within 1 count of the plain version's (only
    where the two float32 products differ)."""
    q8, inco, sk = SIDE_VARIANTS[variant]
    cfg = SIDE_GEOMS[geom].replace(input_layout=layout)
    wire = make_random_bytes_block(cfg, seed=13)
    qw = _weights(cfg, dev)
    x, tm = gemm._prepare_wire(torch.from_numpy(wire).to(dev), cfg)
    f32_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm)[0]
    f32_p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm)[0]
    kw = dict(quant8_scales=_beam_scales(f32_k, cfg, 13) if q8 else None,
              inco_mask=gemm.incoherent_mask(cfg, _flags(cfg)) if inco
              else None,
              sk=sk)
    before = gemm.fused_detect.launches[variant]
    out_k, inco_k, sk_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                                            **kw)
    out_p, inco_p, sk_p = gemm.detect_power_plain(x, qw.terms, qw.scales,
                                                  cfg, tm, **kw)
    torch.cuda.synchronize()
    assert gemm.fused_detect.launches[variant] == before + 1
    if q8:
        assert out_k.dtype == torch.uint8
        assert torch.equal(out_k, gemm.quantize_u8(f32_k, kw["quant8_scales"]))
        diff = (out_k.int() - out_p.int()).abs()
        assert int(diff.max()) <= 1
        assert not diff[f32_k == f32_p].any()
        assert bool((out_k == 255).any())  # the clip is exercised
    else:
        assert relative_power_error(out_k.cpu().numpy(),
                                    out_p.cpu().numpy()) <= KERNEL_RTOL
    assert (inco_k is None) == (not inco) and (sk_k is None) == (not sk)
    if inco:
        assert torch.equal(inco_k, inco_p)
    if sk:
        assert sk_k.dtype == torch.int64 and torch.equal(sk_k, sk_p)


@pytest.mark.parametrize("n_beams", [32, 300, 600])
def test_side_outputs_counted_once_per_span(dev, n_beams):
    """With more than 256 beams the grid has several beam chunks; the side
    outputs come from the first only, so they equal the standalone ops."""
    from dsabeamformer_tpu_torch.ops.incoherent import (
        incoherent_power,
        sk_block_stats,
    )

    cfg = TINY.replace(n_beams=n_beams)
    wire = make_random_bytes_block(cfg, seed=5)
    qw = _weights(cfg, dev)
    p, inco, sk = gemm.beamform_power(torch.from_numpy(wire).to(dev), qw, cfg,
                                      incoherent=True, flag_ants=(4,),
                                      sk_stats=True)
    ref = sk_block_stats(wire, cfg)
    assert torch.equal(sk.cpu(), torch.stack([ref["s1"], ref["s2"]], dim=1))
    assert torch.equal(inco.cpu(), incoherent_power(wire, cfg, (4,)))
    assert tuple(p.shape) == cfg.out_block_shape


def test_sk_with_fewer_threads_than_outputs(dev):
    """32 beams at a_compute 32: a 32-thread block writes all 64 SK sums
    of a channel (S2 as well as S1)."""
    from dsabeamformer_tpu_torch.ops.incoherent import sk_block_stats

    cfg = DSA10.replace(n_chan=4, t_block=512, n_beams=32)
    wire = make_random_bytes_block(cfg, seed=8)
    qw = _weights(cfg, dev)
    _, sk = gemm.beamform_power(torch.from_numpy(wire).to(dev), qw, cfg,
                                sk_stats=True)
    ref = sk_block_stats(wire, cfg)
    assert float(sk[:, 1].min()) > 0
    assert torch.equal(sk.cpu(), torch.stack([ref["s1"], ref["s2"]], dim=1))


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_staged_point_source_vs_golden(dev, layout):
    """The DSA-110 width (a_compute 128): a point source at beam 300 of 512
    peaks there, within 1e-3 of the float64 golden model, power and
    Stokes."""
    from dsabeamformer_tpu_torch.ops.reference import beamform_stokes_ref

    cfg = DSA110.replace(n_chan=8, t_block=256, input_layout=layout)
    wire = make_point_source_block(cfg, angle_rad=cfg.beam_angles_rad()[300],
                                   noise_rms=0.4, seed=7)
    qw = prepare_weights(cfg, make_weights(cfg, device=dev))
    x = torch.from_numpy(wire).to(dev)
    p = gemm.beamform_power(x, qw, cfg).cpu().numpy()
    gold = weights_numpy_golden(cfg)
    assert int(np.argmax(p.sum(axis=(0, 1)))) == 300
    assert relative_power_error(
        p, beamform_block_ref(gold, wire, layout, cfg.navg_time)) <= 1e-3
    st = gemm.beamform_stokes(x, qw, cfg)
    ref = torch.from_numpy(beamform_stokes_ref(gold, wire, layout,
                                               cfg.navg_time))
    assert max(_stokes_peak_errors(st, ref)) <= 1e-3


def test_sk_full_channel_exact_past_2_24(dev):
    """A full-length DSA-10 channel: S2 is ~4e8 (past 2^24), still the
    exact integer once rounded to float32."""
    from dsabeamformer_tpu_torch.ops.incoherent import sk_block_stats

    cfg = DSA10.replace(n_chan=4)
    wire = make_random_bytes_block(cfg, seed=9)
    qw = _weights(cfg, dev)
    _, sk = gemm.beamform_power(torch.from_numpy(wire).to(dev), qw, cfg,
                                sk_stats=True)
    ref = sk_block_stats(wire, cfg)
    assert float(sk[:, 1].min()) > 2 ** 24
    assert torch.equal(sk.cpu(), torch.stack([ref["s1"], ref["s2"]], dim=1))


def test_kernel_rejects_bad_side_operands(dev):
    cfg = TINY
    qw = _weights(cfg, dev)
    x, tm = gemm._prepare_wire(
        torch.from_numpy(make_noise_block(cfg, seed=1)).to(dev), cfg)
    with pytest.raises(ValueError, match="quant8_scales must be float32"):
        gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                          quant8_scales=torch.ones(cfg.n_beams,
                                                   dtype=torch.float64,
                                                   device=dev))
    with pytest.raises(ValueError, match="weights are on"):
        gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                          quant8_scales=torch.ones(cfg.n_beams))
    with pytest.raises(ValueError, match="past a_compute"):
        gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                          inco_mask=1 << cfg.a_compute)
    # One output row's wire bytes must fit in shared memory beside the
    # weight tile.
    long = DSA110.replace(n_chan=1, t_block=4096, navg_time=4096)
    qwl = _weights(long, dev)
    xl, tml = gemm._prepare_wire(
        torch.from_numpy(make_noise_block(long, seed=1)).to(dev), long)
    with pytest.raises(ValueError, match="shared memory"):
        gemm.fused_detect(xl, qwl.terms, qwl.scales, long, tml)


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_deployed_stream_matches_cpu_stream(dev, layout, tmp_path):
    """The deployed path (8-bit filterbank from the kernel's epilogue,
    incoherent .dada, RFI monitor with mid-stream excision) on the card
    against the same stream on the CPU: the same events, .fil payloads
    within 1 count, the incoherent file and the scales equal."""
    from dsabeamformer_tpu_torch.ingest.dada import read_product_file
    from dsabeamformer_tpu_torch.ingest.generator import make_tone_block
    from dsabeamformer_tpu_torch.ingest.sigproc import (
        FilterbankSink,
        read_filterbank,
    )
    from dsabeamformer_tpu_torch.models.weights import zap_weights
    from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor
    from dsabeamformer_tpu_torch.pipeline import FileSink

    cfg = TINY.replace(input_layout=layout)
    blocks = []
    for s in range(4):
        w = make_noise_block(cfg, rms=2.0, seed=60 + s).reshape(
            cfg.wire_block_shape).copy()
        tone = make_tone_block(cfg, chan=2, amplitude=6.0)
        if layout == "tfpa":
            w[:, 2] = tone[:, 2]
        else:
            w[2] = tone[2]
        blocks.append(w)
    runs = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        events = []
        qw = prepare_weights(cfg, make_weights(cfg, device=device))
        fil = FilterbankSink(tmp_path / name, cfg, nbits=8)
        inco = FileSink(tmp_path / f"{name}.dada", cfg, products="incoherent")
        bf = StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks, 8),
                                 fil, depth=2, incoherent_sink=inco,
                                 flag_ants=(1,))

        def on_event(ev, bf=bf, device=device):
            events.append(ev)
            if ev["type"] == "excise" and not ev.get("final"):
                w = zap_weights(make_weights(cfg, device=device),
                                ev["zapped"], cfg)
                bf.update_weights(prepare_weights(cfg, w))

        bf.rfi_monitor = RFIMonitor(cfg, interval=2, sample=2,
                                    on_event=on_event)
        bf.warmup()
        before = dict(gemm.fused_detect.launches)
        stats = bf.run()
        fil.close()
        inco.close()
        assert stats.n_blocks == 8 and stats.dropped == 0
        if name == "cuda":
            got = {k: v - before.get(k, 0)
                   for k, v in gemm.fused_detect.launches.items()}
            assert {k: v for k, v in got.items() if v} == {
                "sk+inco": 1, "q8+inco": 4, "sk+q8+inco": 3}
        runs[name] = events, fil.scales
    assert runs["cuda"][0] == runs["cpu"][0]
    assert [e["type"] for e in runs["cuda"][0]] == ["excise"]
    assert runs["cuda"][0][0]["new"] == [2]
    for b in range(cfg.n_beams):
        np.testing.assert_allclose(runs["cuda"][1][b], runs["cpu"][1][b],
                                   rtol=1e-6)
        _, dc = read_filterbank(tmp_path / "cpu" / f"beam{b:04d}.fil")
        _, dg = read_filterbank(tmp_path / "cuda" / f"beam{b:04d}.fil")
        assert np.abs(dc.astype(int) - dg.astype(int)).max() <= 1
        # Channel 2 (file column F-1-2) is zero once the new weights run.
        assert not dg[-cfg.out_block_shape[1]:, 0, cfg.n_chan - 3].any()
    _, ic = read_product_file(tmp_path / "cpu.dada")
    _, ig = read_product_file(tmp_path / "cuda.dada")
    np.testing.assert_array_equal(np.asarray(ig), np.asarray(ic))


# --------------------------------------------------------------------- #
# The full-Stokes epilogue and the beam-voltage kernel
# --------------------------------------------------------------------- #

#: Stokes kernel vs plain, per plane over the I peak: identical integers,
#: float32 order and FMA contraction only.
STOKES_RTOL = 1e-5

#: Stokes variant -> (quant8, incoherent, sk)
STOKES_VARIANTS = {
    "stokes": (False, False, False),
    "stokes+q8": (True, False, False),
    "stokes+sk+inco": (False, True, True),
    "stokes+sk+q8+inco": (True, True, True),
}


def _stokes_peak_errors(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    peak = float(want[:, :, 0].abs().max())
    return [float((got[:, :, k] - want[:, :, k]).abs().max()) / peak
            for k in range(4)]


@pytest.mark.parametrize("variant", sorted(STOKES_VARIANTS))
@pytest.mark.parametrize("mode", ["int8x2", "int8"])
@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(SIDE_GEOMS))
def test_stokes_kernel_matches_plain(dev, geom, layout, mode, variant):
    """Kernel vs plain version on the same inputs (a_compute 8, 16 and 32;
    1 and 2 terms): each plane within 1e-5 of the I peak, the I plane equal
    to the power kernel's to the bit, incoherent and SK equal; uint8
    byte-equal to the rint/clip of the kernel's own float32 times the
    scales plus the Q/U/V offset, within 1 count of the plain version's
    only where the float32 products differ."""
    q8, inco, sk = STOKES_VARIANTS[variant]
    cfg = SIDE_GEOMS[geom].replace(input_layout=layout, weight_mode=mode)
    wire = make_random_bytes_block(cfg, seed=17)
    qw = _weights(cfg, dev)
    x, tm = gemm._prepare_wire(torch.from_numpy(wire).to(dev), cfg)
    f32_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm, stokes=True)[0]
    f32_p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm,
                                    stokes=True)[0]
    power_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm)[0]
    assert torch.equal(f32_k[:, :, 0], power_k)
    kw = dict(quant8_scales=_beam_scales(f32_k[:, :, 0], cfg, 17) if q8
              else None,
              inco_mask=gemm.incoherent_mask(cfg, _flags(cfg)) if inco
              else None,
              sk=sk, stokes=True)
    before = gemm.fused_detect.launches[variant]
    out_k, inco_k, sk_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                                            **kw)
    out_p, inco_p, sk_p = gemm.detect_power_plain(x, qw.terms, qw.scales,
                                                  cfg, tm, **kw)
    torch.cuda.synchronize()
    assert gemm.fused_detect.launches[variant] == before + 1
    assert max(_stokes_peak_errors(f32_k, f32_p)) <= STOKES_RTOL
    assert bool(torch.isfinite(f32_k).all())
    if q8:
        assert out_k.dtype == torch.uint8 and out_k.shape == f32_k.shape
        own = gemm.quantize_u8(f32_k, kw["quant8_scales"],
                               gemm.stokes_offsets(dev))
        assert torch.equal(out_k, own)
        diff = (out_k.int() - out_p.int()).abs()
        assert int(diff.max()) <= 1
        assert not diff[f32_k == f32_p].any()
    else:
        assert torch.equal(out_k, f32_k)
    if inco:
        assert torch.equal(inco_k, inco_p)
    if sk:
        assert torch.equal(sk_k, sk_p)


@pytest.mark.parametrize("n_beams", [300, 600])
def test_stokes_side_outputs_counted_once(dev, n_beams):
    from dsabeamformer_tpu_torch.ops.incoherent import (
        incoherent_power,
        sk_block_stats,
    )

    cfg = TINY.replace(n_beams=n_beams)
    wire = make_random_bytes_block(cfg, seed=6)
    qw = _weights(cfg, dev)
    st, inco, sk = gemm.beamform_stokes(torch.from_numpy(wire).to(dev), qw,
                                        cfg, incoherent=True, flag_ants=(4,),
                                        sk_stats=True)
    ref = sk_block_stats(wire, cfg)
    assert torch.equal(sk.cpu(), torch.stack([ref["s1"], ref["s2"]], dim=1))
    assert torch.equal(inco.cpu(), incoherent_power(wire, cfg, (4,)))
    f, t, b = cfg.out_block_shape
    assert tuple(st.shape) == (f, t, 4, b)
    want = gemm.beamform_stokes(wire, _to(qw, "cpu"), cfg)
    assert max(_stokes_peak_errors(st, want)) <= STOKES_RTOL


@pytest.mark.parametrize("mode", ["int8x2", "int8"])
@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("geom", sorted(SIDE_GEOMS))
def test_voltage_kernel_equals_plain(dev, geom, layout, mode):
    """The voltage kernel equals its plain version bit for bit (on the card
    and on the CPU), and its launch is counted."""
    cfg = SIDE_GEOMS[geom].replace(input_layout=layout, weight_mode=mode)
    wire = make_random_bytes_block(cfg, seed=21)
    qw = _weights(cfg, dev)
    before = gemm.beamform_voltages.launches
    got = gemm.beamform_voltages(torch.from_numpy(wire).to(dev), qw, cfg)
    torch.cuda.synchronize()
    assert gemm.beamform_voltages.launches == before + 1
    assert tuple(got.shape) == (cfg.n_chan, cfg.t_block, 2, 2 * cfg.n_beams)
    x, tm = gemm._prepare_wire(torch.from_numpy(wire).to(dev), cfg)
    assert torch.equal(got, gemm.voltages_plain(x, qw.terms, qw.scales, cfg,
                                                tm))
    assert torch.equal(got.cpu(),
                       gemm.beamform_voltages(wire, _to(qw, "cpu"), cfg))
    assert gemm.beamform_voltages.launches == before + 1


def test_voltage_kernel_rejects_what_it_does_not_take(dev):
    cfg = TINY
    qw = _weights(cfg, dev)
    x = torch.from_numpy(make_noise_block(cfg, seed=1)).to(dev)
    with pytest.raises(ValueError, match="int8 weight terms"):
        gemm.beamform_voltages(x, type(qw)(tuple(t.to(torch.int16)
                                                 for t in qw.terms),
                                           qw.scales), cfg)
    with pytest.raises(ValueError, match="weights are on"):
        gemm.beamform_voltages(x, _to(qw, "cpu"), cfg)
    with pytest.raises(ValueError, match="scales must be float32"):
        gemm.beamform_voltages(x, type(qw)(qw.terms, qw.scales.double()), cfg)
    # No kernel takes a_compute 160: refused before any launch.
    big = TOO_WIDE
    xb = torch.from_numpy(make_noise_block(big, seed=1)).to(dev)
    before = (gemm.beamform_voltages.launches, _launches())
    with pytest.raises(ValueError, match="a_compute"):
        gemm.beamform_voltages(xb, _weights(big, dev), big)
    with pytest.raises(ValueError, match="a_compute"):
        gemm.beamform_stokes(xb, _weights(big, dev), big)
    assert (gemm.beamform_voltages.launches, _launches()) == before


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_stokes_stream_matches_cpu_stream(dev, layout, tmp_path):
    """The 8-bit Stokes stream (uint8 4-IF .fil from the kernel's epilogue,
    incoherent .dada) on the card against the same stream on the CPU:
    .fil payloads within 1 count, the auto-calibrated scales within 1e-5
    (the medians of block 0, whose float32 sums differ in order), the
    incoherent file equal, and the Stokes launch pattern."""
    from dsabeamformer_tpu_torch.ingest.dada import read_product_file
    from dsabeamformer_tpu_torch.ingest.sigproc import (
        FilterbankSink,
        read_filterbank,
    )
    from dsabeamformer_tpu_torch.pipeline import FileSink

    cfg = TINY.replace(input_layout=layout)
    blocks = [make_noise_block(cfg, rms=2.0, seed=80 + s) for s in range(3)]
    qw_cpu = prepare_weights(cfg, make_weights(cfg, device="cpu"))
    runs = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        qw = _to(qw_cpu, device)
        fil = FilterbankSink(tmp_path / name, cfg, nbits=8, products="stokes")
        inco = FileSink(tmp_path / f"{name}.dada", cfg, products="incoherent")
        bf = StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks, 5),
                                 fil, depth=2, products="stokes",
                                 incoherent_sink=inco)
        bf.warmup()
        before = dict(gemm.fused_detect.launches)
        stats = bf.run()
        fil.close()
        inco.close()
        assert stats.n_blocks == 5 and stats.dropped == 0
        if name == "cuda":
            got = {k: v - before.get(k, 0)
                   for k, v in gemm.fused_detect.launches.items()}
            assert {k: v for k, v in got.items() if v} == {
                "stokes+inco": 1, "stokes+q8+inco": 4}
        runs[name] = fil.scales
    for b in range(cfg.n_beams):
        np.testing.assert_allclose(runs["cuda"][b], runs["cpu"][b], rtol=1e-5)
        hc, dc = read_filterbank(tmp_path / "cpu" / f"beam{b:04d}.fil")
        _, dg = read_filterbank(tmp_path / "cuda" / f"beam{b:04d}.fil")
        assert hc["nifs"] == 4 and dc.shape == dg.shape
        assert np.abs(dc.astype(int) - dg.astype(int)).max() <= 1
    _, ic = read_product_file(tmp_path / "cpu.dada")
    _, ig = read_product_file(tmp_path / "cuda.dada")
    np.testing.assert_array_equal(np.asarray(ig), np.asarray(ic))


# --------------------------------------------------------------------- #
# The other weight modes: int12, int13, bf16, bf16x2, f32
# --------------------------------------------------------------------- #

NEW_MODES = ("int12", "int13", "bf16", "bf16x2", "f32")

#: a_compute -> a small geometry contracting exactly that many antennas
#: (set explicitly: int13's automatic a_compute rounds to 16, not 32).
MODE_GEOMS = {
    8: TINY.replace(n_ant=8, n_ant_active=6, n_ant_compute=8),
    16: TINY.replace(n_ant_compute=16, n_beams=40),
    24: DSA10.replace(n_chan=3, t_block=128, n_ant_active=21,
                      n_ant_compute=24, n_beams=72, navg_time=4),
    32: DSA10.replace(n_chan=4, t_block=256, n_ant_compute=32),
    64: DSA110.replace(n_chan=2, t_block=128, n_ant_active=60,
                       n_ant_compute=64, n_beams=100),
    128: DSA110.replace(n_chan=2, t_block=128, n_ant_compute=128,
                        n_beams=130, navg_time=8),
}


def _mode_rtol(mode) -> float:
    """Kernel vs plain, relative to the block's peak: the int8 modes give
    identical integers (float32 summation order of the detection only); the
    float modes also sum K = 2 * a_compute <= 256 float32 products in
    another order than the library GEMM of the plain version."""
    return 1e-5 if mode in gemm.FLOAT_MODES else KERNEL_RTOL


#: variant name -> (quant8, incoherent, sk, stokes): all sixteen.
ALL_VARIANTS = {gemm.variant_name(q8, inco, sk, st): (q8, inco, sk, st)
                for st in (False, True) for q8 in (False, True)
                for inco in (False, True) for sk in (False, True)}
#: The products alone and with every side output.
CORE_VARIANTS = ("base", "sk+q8+inco", "stokes", "stokes+sk+q8+inco")
#: a_compute at which the float modes run all sixteen variants: a k16 step
#: short of a k32 one (24), the DSA-10 width (32), the DSA-110 width (128,
#: f32's 32-beam tile).
FLOAT_ALL_VARIANTS_AC = (24, 32, 128)
MODE_CASES = [(mode, ac, v) for mode in NEW_MODES for ac in sorted(MODE_GEOMS)
              for v in (ALL_VARIANTS if mode in gemm.FLOAT_MODES
                        and ac in FLOAT_ALL_VARIANTS_AC else CORE_VARIANTS)]


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("mode,ac,variant", MODE_CASES,
                         ids=lambda v: str(v))
def test_mode_kernels_match_plain(dev, mode, ac, variant, layout):
    """Every weight mode's detect kernel against its plain version, power
    and Stokes, without and with all side outputs (the float modes: all
    sixteen variants at a_compute 24, 32 and 128): float32 within
    ``_mode_rtol`` of the peak, the Stokes I plane equal to the power
    kernel's output, the uint8 product byte-equal to the rint/clip of the
    kernel's own float32 and within 1 count of the plain version's,
    incoherent and SK equal."""
    q8, inco, sk, stokes = ALL_VARIANTS[variant]
    cfg = MODE_GEOMS[ac].replace(input_layout=layout, weight_mode=mode)
    assert cfg.a_compute == ac
    wire = make_random_bytes_block(cfg, seed=13)
    qw = _weights(cfg, dev)
    x, tm = gemm._prepare_wire(torch.from_numpy(wire).to(dev), cfg)
    f32_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                              stokes=stokes)[0]
    f32_p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm,
                                    stokes=stokes)[0]
    peak = float(f32_p.abs().max())
    assert bool(torch.isfinite(f32_k).all())
    assert float((f32_k - f32_p).abs().max()) <= _mode_rtol(mode) * peak
    if stokes:
        power_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm)[0]
        assert torch.equal(f32_k[:, :, 0], power_k)
    plane = f32_k[:, :, 0] if stokes else f32_k
    kw = dict(quant8_scales=_beam_scales(plane, cfg, 13) if q8 else None,
              inco_mask=(gemm.incoherent_mask(cfg, _flags(cfg)) if inco
                         else None), sk=sk, stokes=stokes)
    before = gemm.fused_detect.launches_by_mode[(mode, variant)]
    out_k, inco_k, sk_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                                            **kw)
    out_p, inco_p, sk_p = gemm.detect_power_plain(x, qw.terms, qw.scales,
                                                  cfg, tm, **kw)
    torch.cuda.synchronize()
    assert gemm.fused_detect.launches_by_mode[(mode, variant)] == before + 1
    if q8:
        offsets = gemm.stokes_offsets(dev) if stokes else None
        assert out_k.dtype == torch.uint8
        assert torch.equal(out_k, gemm.quantize_u8(f32_k, kw["quant8_scales"],
                                                   offsets))
        assert int((out_k.int() - out_p.int()).abs().max()) <= 1
    else:
        assert torch.equal(out_k, f32_k)
    assert (inco_k is None) == (not inco) and (sk_k is None) == (not sk)
    if inco:
        assert torch.equal(inco_k, inco_p)
    if sk:
        assert sk_k.dtype == torch.int64 and torch.equal(sk_k, sk_p)


def test_f32_split_reaches_the_product(dev):
    """On a block where each voltage meets one product (one antenna, its im
    nibbles 0; one sample an output), the f32 kernel is within
    ``F32_SPLIT_RTOL`` of its plain version, and bf16x2's kernel on the
    first two of the three bf16 parts the f32 kernel splits each weight
    into misses that bar: the third part reaches the product."""
    from dsabeamformer_tpu_torch.ops.quantize import QuantWeights
    from dsabeamformer_tpu_torch.utils.testing import (
        F32_SPLIT_RTOL,
        one_product_block,
    )

    cfg = MODE_GEOMS[32].replace(weight_mode="f32", navg_time=1)
    wire = torch.from_numpy(one_product_block(cfg, seed=4)).to(dev)
    qw = _weights(cfg, dev)
    got = gemm.beamform_power(wire, qw, cfg)
    x, tm = gemm._prepare_wire(wire, cfg)
    want = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm)[0]
    assert relative_power_error(got.cpu().numpy(), want.cpu().numpy()) \
        <= F32_SPLIT_RTOL
    two = cfg.replace(weight_mode="bf16x2")
    w1, w2, _ = gemm._split_f32(qw.terms[0])
    control = gemm.beamform_power(wire, QuantWeights(
        (w1, w2), torch.ones((cfg.n_chan, 2), device=dev)), two)
    assert relative_power_error(control.cpu().numpy(),
                                want.cpu().numpy()) > F32_SPLIT_RTOL


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("ac", sorted(MODE_GEOMS))
@pytest.mark.parametrize("mode", NEW_MODES)
def test_mode_voltages_match_plain(dev, mode, ac, layout):
    """Every weight mode's voltage kernel against its plain version: equal
    for the int8 modes, within ``_mode_rtol`` of the largest voltage for
    the float ones."""
    cfg = MODE_GEOMS[ac].replace(input_layout=layout, weight_mode=mode)
    wire = make_random_bytes_block(cfg, seed=19)
    qw = _weights(cfg, dev)
    before = gemm.beamform_voltages.launches_by_mode[mode]
    got = gemm.beamform_voltages(torch.from_numpy(wire).to(dev), qw, cfg)
    torch.cuda.synchronize()
    assert gemm.beamform_voltages.launches_by_mode[mode] == before + 1
    x, tm = gemm._prepare_wire(torch.from_numpy(wire).to(dev), cfg)
    want = gemm.voltages_plain(x, qw.terms, qw.scales, cfg, tm)
    if mode in gemm.FLOAT_MODES:
        assert float((got - want).abs().max()) \
            <= _mode_rtol(mode) * float(want.abs().max())
    else:
        assert torch.equal(got, want)


#: Edges of the voltage kernel's grid: a t_block that is no multiple of 8
#: (its last m-tile half live, the samples past it not stored) with 72 beams
#: (a partial 64-beam tile), and the DSA-110 width (a_compute 128, 512 beams:
#: eight 64-beam tiles, or sixteen 32-beam ones for bf16x2 and f32).
VOLTAGE_EDGES = {
    "t_tail": DSA10.replace(n_chan=3, t_block=100, navg_time=4, n_beams=72),
    "dsa110_width": DSA110.replace(n_chan=2, t_block=64, n_ant_compute=128),
}


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("edge", sorted(VOLTAGE_EDGES))
@pytest.mark.parametrize("mode", gemm.KERNEL_MODES)
def test_voltage_kernel_grid_edges(dev, mode, edge, layout):
    """Every weight mode's voltage kernel at the grid's edges against its
    plain version: equal for the int8 modes, within ``_mode_rtol`` of the
    largest voltage for the float ones; one launch counted."""
    cfg = VOLTAGE_EDGES[edge].replace(input_layout=layout, weight_mode=mode)
    if edge == "dsa110_width":
        assert cfg.a_compute == 128 and cfg.n_beams == 512
    else:
        assert cfg.t_block % 8
    wire = make_random_bytes_block(cfg, seed=23)
    qw = _weights(cfg, dev)
    before = gemm.beamform_voltages.launches_by_mode[mode]
    got = gemm.beamform_voltages(torch.from_numpy(wire).to(dev), qw, cfg)
    torch.cuda.synchronize()
    assert gemm.beamform_voltages.launches_by_mode[mode] == before + 1
    assert tuple(got.shape) == (cfg.n_chan, cfg.t_block, 2, 2 * cfg.n_beams)
    x, tm = gemm._prepare_wire(torch.from_numpy(wire).to(dev), cfg)
    want = gemm.voltages_plain(x, qw.terms, qw.scales, cfg, tm)
    if mode in gemm.FLOAT_MODES:
        assert float((got - want).abs().max()) \
            <= _mode_rtol(mode) * float(want.abs().max())
    else:
        assert torch.equal(got, want)


#: The JAX package's golden bars (its tests/test_gemm.py) per mode.
GOLDEN_BARS = {"int13": 5e-4, "int12": 8e-4, "bf16x2": 2e-4, "f32": 1e-5,
               "bf16": 1e-2}


@pytest.mark.parametrize("mode", NEW_MODES)
def test_mode_kernel_vs_golden(dev, mode):
    """Calibrated noise through each mode's kernel against the float64
    golden model, at the JAX package's bar for the mode (f32 at 1e-5: a
    TF32 product anywhere would miss it by three orders)."""
    cfg = TINY.replace(weight_mode=mode)
    cal = CalTable.random(cfg, seed=11)
    wire = make_noise_block(cfg, rms=2.5, seed=21)
    qw = prepare_weights(cfg, make_weights(cfg, cal=cal, device=dev))
    p = gemm.beamform_power(torch.from_numpy(wire).to(dev), qw, cfg)
    ref = beamform_block_ref(weights_numpy_golden(cfg, cal=cal), wire,
                             cfg.input_layout, cfg.navg_time)
    assert relative_power_error(p.cpu().numpy(), ref) <= GOLDEN_BARS[mode]


@pytest.mark.parametrize("mode", ["int12", "bf16x2"])
def test_mode_stream_cuda_equals_cpu(dev, mode):
    """The streaming loop in another weight mode: the CUDA path's blocks
    against the CPU path's (the plain version), block for block."""
    cfg = DSA10.replace(n_chan=8, t_block=256, weight_mode=mode)
    blocks = [make_random_bytes_block(cfg, seed=s) for s in (1, 2, 3)]
    outs = {}
    qw_dev = prepare_weights(cfg, make_weights(cfg, device=dev))
    for where in ("cpu", dev):
        qw = _to(qw_dev, where)  # the same terms on both devices
        sink = CollectSink()
        stats = StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks, 5),
                                    sink).run()
        assert stats.n_blocks == 5 and stats.dropped == 0
        outs[str(where)] = [b for _, b in sink.outputs]
    for a, b in zip(outs["cpu"], outs[str(dev)]):
        assert relative_power_error(b, a) <= _mode_rtol(mode)


# --------------------------------------------------------------------- #
# Random geometries, and the stream without a sink
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("i", range(10))
def test_random_geometry_kernel_matches_plain(dev, i):
    """The cases of tests/test_torch_fuzz_geometry.py on the card: small,
    ragged shapes (8 beams, navg 2, one span, a_compute 24) through the
    kernels against the plain version and the float64 golden model, power
    (and Stokes on a third of them), both wire forms; and through the
    voltage kernel against its plain version."""
    from dsabeamformer_tpu_torch.ops.reference import beamform_stokes_ref
    from dsabeamformer_tpu_torch.utils.testing import FUZZ_RTOL, random_geometry

    cfg, _ = random_geometry(i)
    cal = CalTable.random(cfg, seed=i)
    wire = make_noise_block(cfg, rms=2.0, seed=i)
    qw = prepare_weights(cfg, make_weights(cfg, cal=cal, device=dev))
    before = gemm.fused_detect.launches_by_mode[(cfg.weight_mode, "base")]
    p = gemm.beamform_power(torch.from_numpy(wire).to(dev), qw, cfg)
    assert gemm.fused_detect.launches_by_mode[(cfg.weight_mode, "base")] \
        == before + 1
    assert tuple(p.shape) == cfg.out_block_shape
    want = gemm.beamform_power(wire, _to(qw, "cpu"), cfg).numpy()
    got = p.cpu().numpy()
    assert np.abs(got - want).max() <= _mode_rtol(cfg.weight_mode) \
        * np.abs(want).max()
    golden = weights_numpy_golden(cfg, cal=cal)
    ref = beamform_block_ref(golden, wire, cfg.input_layout, cfg.navg_time,
                             cfg.navg_freq)
    assert relative_power_error(got, ref) <= FUZZ_RTOL[cfg.weight_mode]
    p_dev = gemm.beamform_power(
        torch.from_numpy(gemm.device_wire_view(wire, cfg)).to(dev), qw, cfg)
    assert torch.equal(p, p_dev)
    # The voltage kernel on the same ragged shapes.
    x, tm = gemm._prepare_wire(torch.from_numpy(wire).to(dev), cfg)
    bv = gemm.beamform_voltages(x, qw, cfg)
    bv_p = gemm.voltages_plain(x, qw.terms, qw.scales, cfg, tm)
    if cfg.weight_mode in gemm.FLOAT_MODES:
        assert float((bv - bv_p).abs().max()) \
            <= _mode_rtol(cfg.weight_mode) * float(bv_p.abs().max())
    else:
        assert torch.equal(bv, bv_p)
    if i % 3 == 0:
        st = gemm.beamform_stokes(torch.from_numpy(wire).to(dev), qw, cfg)
        if cfg.navg_freq == 1:
            assert torch.equal(st[:, :, 0], p)
        st_ref = beamform_stokes_ref(golden, wire, cfg.input_layout,
                                     cfg.navg_time, cfg.navg_freq)
        scale = np.abs(st_ref[:, :, 0]).max()
        assert np.abs(st.cpu().numpy() - st_ref).max() / scale \
            <= FUZZ_RTOL[cfg.weight_mode]


def test_stream_without_a_sink_copies_no_product(dev):
    """No sink: no pinned product buffer is made and no product comes back,
    the incoherent and SK outputs still do, and every block still runs its
    kernel."""
    from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor

    cfg = DSA10.replace(n_chan=8, t_block=256)
    blocks = [make_noise_block(cfg, rms=2.0, seed=s) for s in range(2)]
    qw = _weights(cfg, dev)
    inco = CollectSink()
    bf = StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks, 5),
                             depth=2, incoherent_sink=inco)
    bf.rfi_monitor = RFIMonitor(cfg, interval=2, sample=1)
    bf.warmup()
    before = _launches()
    stats = bf.run()
    assert stats.n_blocks == 5 and stats.dropped == 0
    assert _launches() == before + 5
    assert [s for s, _ in inco.outputs] == list(range(5))
    for slot in bf._slots:
        assert {k[0] for k in slot.host} == {"inco", "sk"}
    with_sink = CollectSink()
    StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks, 5), with_sink,
                        depth=2, incoherent_sink=CollectSink()).run()
    assert len(with_sink.outputs) == 5


# --------------------------------------------------------------------- #
# The dedispersion bank's kernels (csrc/dedisperse.cu) and the pinned ring
# --------------------------------------------------------------------- #

#: (B, F, T_out, n_dm, max shift): odd sizes, partial tiles of every kind.
DD_SHAPES = [(1, 7, 5, 3, 4), (2, 64, 300, 33, 90), (3, 130, 1000, 17, 257),
             (1, 300, 129, 40, 600)]


@pytest.mark.parametrize("shape", DD_SHAPES)
def test_dedisperse_kernels_equal_plain(dev, shape):
    """All three kernels against their plain versions on random data and
    tables: bit for bit (the same float32 adds in the same order)."""
    from dsabeamformer_tpu_torch.ops import dedisperse as dd

    b, f, t_out, n_dm, max_shift = shape
    rng = np.random.default_rng(sum(shape))
    p = torch.from_numpy(rng.normal(size=(b, f, t_out + max_shift)
                                    ).astype(np.float32))
    delays = torch.from_numpy(rng.integers(0, max_shift + 1, (n_dm, f),
                                           dtype=np.int32))
    before = dd.dedisperse_direct.launches
    got = dd.dedisperse_direct(p.to(dev), delays.to(dev), t_out)
    assert dd.dedisperse_direct.launches == before + 1
    assert torch.equal(got.cpu(), dd.dedisperse_direct_plain(p, delays,
                                                            t_out))
    g = max(1, f // 5)
    c = f // g
    pg = p[:, :g * c].reshape(b, g, c, -1).contiguous()
    j = max(1, n_dm // 2)
    intra = torch.from_numpy(rng.integers(0, max_shift // 2 + 1, (g, j, c),
                                          dtype=np.int32))
    t1 = t_out + max_shift // 2
    s = dd.subband_stage1(pg.to(dev), intra.to(dev), t1)
    s_plain = dd.subband_stage1_plain(pg, intra, t1)
    assert torch.equal(s.cpu(), s_plain)
    offsets = torch.from_numpy(rng.integers(0, j * t1 - t_out + 1,
                                            (g, n_dm), dtype=np.int32))
    out = dd.subband_stage2(s, offsets.to(dev), t_out)
    assert torch.equal(out.cpu(), dd.subband_stage2_plain(s_plain, offsets,
                                                          t_out))


def test_dedisperse_kernels_reject_what_they_do_not_take(dev):
    from dsabeamformer_tpu_torch.ops import dedisperse as dd

    p = torch.zeros((1, 4, 64), device=dev)
    d = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        dd.dedisperse_direct(p.double(), d, 8)
    with pytest.raises(ValueError, match="int32"):
        dd.dedisperse_direct(p, d.long(), 8)
    with pytest.raises(ValueError, match="table on"):
        dd.dedisperse_direct(p, d.cpu(), 8)
    with pytest.raises(ValueError, match="channels"):
        dd.dedisperse_direct(p, d[:, :3].contiguous(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        dd.dedisperse_direct(p.transpose(1, 2).contiguous().transpose(1, 2),
                             d, 8)


@pytest.mark.parametrize("method", ["direct", "subband", "conv"])
def test_search_on_card_equals_cpu(dev, method):
    """The whole search, banks on the kernels, equals the CPU's: candidates
    one for one, S/N included; uint8 and float32 windows."""
    from dsabeamformer_tpu_torch.ops import dedisperse as dd

    rng = np.random.default_rng(4)
    freqs = np.linspace(1280.0, 1530.0, 64)
    tsamp = 1.048576e-3
    dms = dd.dm_trial_grid(1280.0, 1530.0, tsamp, dm_max=300.0)
    x = rng.normal(size=(2048, 64)).astype(np.float32)
    shifts = np.rint(dd.dm_delays_s(freqs, 90.0, freqs[-1]) / tsamp
                     ).astype(int)
    for f in range(64):
        x[700 + shifts[f]: 704 + shifts[f], f] += 1.0
    for data in (x, np.clip(x * 20 + 100, 0, 255).astype(np.uint8)):
        kw = dict(threshold=7.0, method=method, n_sub=8, chunk_t=1024)
        cpu = dd.search_spectrogram(data, freqs, tsamp, dms, device="cpu",
                                    **kw)
        card = dd.search_spectrogram(data, freqs, tsamp, dms, device=dev,
                                     **kw)
        assert cpu and card == cpu


@pytest.mark.parametrize("depth", [0, 2])
def test_pinned_ring_route_equals_staged_route(dev, depth):
    """A RingSource on the card (registered slots, H2D straight from them)
    gives the SyntheticSource stream's products bit for bit, registers each
    slot once, releases every slot, and its views are pinned."""
    import uuid

    from dsabeamformer_tpu_torch.ingest import dada
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
    from dsabeamformer_tpu_torch.pipeline import RingSource

    cfg = DSA10.replace(n_chan=8, t_block=256)
    blocks = [make_noise_block(cfg, rms=2.0, seed=s) for s in range(2)]
    qw = _weights(cfg, dev)
    n, nbufs = 7, 3
    ref = CollectSink()
    StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks, n), ref,
                        depth=depth).run()
    name = f"pinned-{uuid.uuid4().hex[:10]}"
    with RingBuffer(name, create=True, nbufs=nbufs,
                    bufsz=cfg.wire_block_bytes) as prod:
        prod.write_header(dada.encode_header(cfg))
        cons = RingBuffer(name)
        src = RingSource(cfg, cons, timeout_s=2.0)
        assert src.pinned and src.n_host_buffers is None
        written = 0

        class Feeding:
            """The producer keeps the ring full between reads."""
            pinned = True
            dropped = skipped = 0

            def read_block(self):
                nonlocal written
                while written < n and \
                        prod.n_written - prod.n_read < nbufs:
                    assert prod.write_block(blocks[written % 2])
                    written += 1
                if written == n:
                    prod.set_eod()
                got = src.read_block()
                if got is not None:
                    assert got[1].is_pinned()
                return got

            def release(self):
                src.release()

        sink = CollectSink()
        bf = StreamingBeamformer(cfg, qw, Feeding(), sink, depth=depth)
        stats = bf.run()
        assert len(src._registered) == nbufs
        assert cons.n_read == n and src.dropped == 0 and src.skipped == 0
        src.close()
        cons.close()
    assert stats.n_blocks == n
    assert [s for s, _ in sink.outputs] == list(range(n))
    for (_, a), (_, b) in zip(sink.outputs, ref.outputs):
        assert np.array_equal(a, b)
