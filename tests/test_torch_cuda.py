"""Card-only tests of the port: the CUDA detect kernel (power and full
Stokes, with its side outputs) and the beam-voltage kernel against their
plain PyTorch versions and the float64 golden model, at small shapes, at
a_compute 8, 16, 24, 32, 64, 96 and 128 (the DSA-110 width) and on the random
geometries of ``utils.testing.random_geometry``, the streaming loop's
CUDA path against its CPU path, and the scale-out on one card (mesh slots
on it against one device, the antenna split against the fused kernel, two
gloo processes sharing it).

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

#: A config whose a_compute (712) the kernels once refused: int8x2's weight
#: tile and one output row pass a block's shared memory from 712, so the
#: detect kernel walks K in slices there.
TOO_WIDE = DSA110.replace(n_chan=4, t_block=64, n_ant=712, n_ant_active=150,
                          n_ant_compute=712)


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
    # a_compute 712, once refused, takes the K loop: one launch, the plain
    # version's integers.
    big = TOO_WIDE
    assert big.a_compute == 712 and gemm.kernel_path(big) == gemm.KLOOP_MMA
    qwb = _weights(big, dev)
    xb = torch.from_numpy(make_noise_block(big, seed=1)).to(dev)
    before = _launches()
    got = gemm.beamform_power(xb, qwb, big)
    assert _launches() == before + 1
    xw, tmw = gemm._prepare_wire(xb, big)
    want = gemm.detect_power_plain(xw, qwb.terms, qwb.scales, big, tmw)[0]
    assert relative_power_error(got.cpu().numpy(), want.cpu().numpy()) \
        <= 1e-5


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
    # An output row whose wire bytes do not fit in shared memory beside the
    # weight tile (once refused) takes the K loop, one m-tile at a time.
    long = DSA110.replace(n_chan=1, t_block=4096, navg_time=4096)
    assert gemm.kernel_path(long) == gemm.KLOOP_MMA
    qwl = _weights(long, dev)
    xl, tml = gemm._prepare_wire(
        torch.from_numpy(make_noise_block(long, seed=1)).to(dev), long)
    got = gemm.fused_detect(xl, qwl.terms, qwl.scales, long, tml)[0]
    want = gemm.detect_power_plain(xl, qwl.terms, qwl.scales, long, tml)[0]
    assert relative_power_error(got.cpu().numpy(), want.cpu().numpy()) \
        <= 1e-5


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
    # a_compute 712, once refused: the voltages (on the staged 32-beam
    # tile) equal the plain version's, and Stokes (the K loop) launches.
    big = TOO_WIDE
    xb = torch.from_numpy(make_noise_block(big, seed=1)).to(dev)
    qwb = _weights(big, dev)
    before = (gemm.beamform_voltages.launches, _launches())
    got = gemm.beamform_voltages(xb, qwb, big)
    xw, tmw = gemm._prepare_wire(xb, big)
    assert torch.equal(got, gemm.voltages_plain(xw, qwb.terms, qwb.scales,
                                                big, tmw))
    assert bool(torch.isfinite(gemm.beamform_stokes(xb, qwb, big)).all())
    assert (gemm.beamform_voltages.launches, _launches()) \
        == (before[0] + 1, before[1] + 1)


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
    cfg = MODE_GEOMS[ac].replace(input_layout=layout, weight_mode=mode)
    assert cfg.a_compute == ac
    _check_detect(dev, cfg, variant)


def _check_detect(dev, cfg, variant):
    """``test_mode_kernels_match_plain``'s checks of one config and
    variant."""
    mode = cfg.weight_mode
    q8, inco, sk, stokes = ALL_VARIANTS[variant]
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


#: Widths off the multiples of 8 and past 128: DSA-10's 10-, 12- and
#: 20-slot wires in auto mode (a_compute 10, 12, 20; int13 rounds 20's 10
#: active antennas to 16; the 10-slot wire's pol y rows start off 4 bytes,
#: so the kernels stage them from byte loads, while 12 and 20 slots keep
#: 4-byte copies), a_compute 160 and 224 (int13's weight tile is 32 beams
#: at 224) and 264, past 255, where int8 and int8x2 multiply X, not 16 X.
WIDTH_GEOMS = {
    10: TINY.replace(n_ant=10, n_ant_active=10),
    12: TINY.replace(n_ant=12, n_ant_active=10, n_beams=40),
    20: TINY.replace(n_ant=20, n_ant_active=10, n_beams=72, navg_time=8),
    160: DSA110.replace(n_chan=2, t_block=128, n_ant=160, n_ant_active=150,
                        n_ant_compute=160, n_beams=100),
    224: DSA110.replace(n_chan=2, t_block=128, n_ant=224, n_ant_active=200,
                        n_ant_compute=224, n_beams=72, navg_time=8),
    264: DSA110.replace(n_chan=2, t_block=128, n_ant=264, n_ant_active=250,
                        n_ant_compute=264, n_beams=72, navg_time=8),
}


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("variant", ["base", "stokes+sk+q8+inco"])
@pytest.mark.parametrize("width", sorted(WIDTH_GEOMS))
@pytest.mark.parametrize("mode", gemm.KERNEL_MODES)
def test_width_kernels_match_plain(dev, mode, width, variant, layout):
    """Every mode's detect kernel (power, and Stokes with every side output)
    and voltage kernel at the widths of ``WIDTH_GEOMS`` against the plain
    versions: detection within ``_mode_rtol`` of the peak (the same
    integers in the int8 modes), incoherent and SK equal, uint8 within a
    count, int8-mode voltages equal, float-mode voltages within
    ``_mode_rtol``."""
    cfg = WIDTH_GEOMS[width].replace(input_layout=layout, weight_mode=mode)
    assert cfg.a_compute == (16 if mode == "int13" and width == 20
                             else width)
    _check_width(dev, cfg, variant)


def _check_width(dev, cfg, variant, path="wgmma"):
    assert gemm.kernel_path(cfg) == path
    mode = cfg.weight_mode
    _check_detect(dev, cfg, variant)
    if variant != "base":
        return
    wire = make_random_bytes_block(cfg, seed=29)
    qw = _weights(cfg, dev)
    got = gemm.beamform_voltages(torch.from_numpy(wire).to(dev), qw, cfg)
    x, tm = gemm._prepare_wire(torch.from_numpy(wire).to(dev), cfg)
    want = gemm.voltages_plain(x, qw.terms, qw.scales, cfg, tm)
    if mode in gemm.FLOAT_MODES:
        assert float((got - want).abs().max()) \
            <= _mode_rtol(mode) * float(want.abs().max())
    else:
        assert torch.equal(got, want)


#: The widest a_compute (a multiple of 8) each mode took at navg 16 before
#: the K loop, whose detect kernel takes the next one.
STAGED_EDGE = {"int8": 1152, "int8x2": 704, "int12": 704, "int13": 384,
               "bf16": 704, "bf16x2": 392, "f32": 272}


def _kloop_cfg(ac, mode, layout):
    """A 2-channel, 64-sample DSA-110 slice contracting ``ac`` antennas
    (2056: 2058 slots, so that pol y's rows start off 4 bytes)."""
    n_ant = ac + 2 if ac == 2056 else ac
    return DSA110.replace(n_chan=2, t_block=64, n_ant=n_ant,
                          n_ant_active=ac - 10, n_ant_compute=ac,
                          n_beams=72, weight_mode=mode, input_layout=layout)


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("variant", ["base", "stokes+sk+q8+inco"])
@pytest.mark.parametrize("width", ["edge+8", 2048, 2056])
@pytest.mark.parametrize("mode", gemm.KERNEL_MODES)
def test_kloop_widths_match_plain(dev, mode, width, variant, layout):
    """Past the staged tile's edge (the widest of each mode plus 8), at 2048
    and past it, every mode's detect kernel takes the K loop, and it and the
    voltage kernel hold ``test_width_kernels_match_plain``'s bars."""
    ac = STAGED_EDGE[mode] + 8 if width == "edge+8" else width
    cfg = _kloop_cfg(ac, mode, layout)
    assert cfg.a_compute == ac
    _check_width(dev, cfg, variant, gemm.KLOOP_MMA)


#: int8x2 and int8 past a_compute 255 on the 32-beam weight tile (at navg
#: 16, int8x2's from a_compute 385, int8's detect tile from 705 and its
#: voltage tile from 737): the narrow tile's kernels whose sub-terms
#: multiply X.
NARROW_X = {"int8x2": 400, "int8": 744}


@pytest.mark.parametrize("variant", ["base", "stokes+sk+q8+inco"])
@pytest.mark.parametrize("mode", sorted(NARROW_X))
def test_narrow_tile_past_255_matches_plain(dev, mode, variant):
    """As ``test_width_kernels_match_plain``, where int8 and int8x2 take
    the 32-beam tile and their products multiply X (product scale 1)."""
    ac = NARROW_X[mode]
    cfg = DSA110.replace(n_chan=2, t_block=64, n_ant=ac,
                         n_ant_active=ac - 10, n_ant_compute=ac,
                         n_beams=72, weight_mode=mode)
    assert gemm._detect_tiles(cfg).beams == 32
    assert gemm._voltage_tiles(cfg).beams == 32
    assert gemm._product_scale(cfg) == 1
    _check_width(dev, cfg, variant)


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


def _sweep(n_dm, n_chan, step):
    """A DM sweep's delay table [n_dm, n_chan]: ``step`` samples a trial at
    the band's bottom, none at its top (a cold-plasma f^-2 curve)."""
    f = np.linspace(1.28, 1.53, n_chan)
    curve = (f ** -2 - f[-1] ** -2) / (f[0] ** -2 - f[-1] ** -2)
    return np.rint(np.arange(n_dm)[:, None] * step * curve[None, :]
                   ).astype(np.int32)


#: The banks' kernel at its edges: (B, n_dm, F, T_out, kind, aligned).
#: n_dm no multiple of the 32-trial tile (nor of a warp's 4), T_out no
#: multiple of the 480-sample tile, F no multiple of the 16-row chunk, and
#: F of one chunk (16, 12, 7 rows; stage 1's groups of 4, 3 and 7
#: channels): the copies of the first chunk are all a block waits for; a
#: DM sweep (the register window), its trials shuffled (not monotone: wide
#: warp spans, per-trial loads), a steep sweep (block spans past 60 on its
#: low channels: both paths), the dsa10c monitor's table (465 trials, 2048
#: channels), rows that start on 16 bytes or not (T_pad % 4, a data pointer
#: off 16 bytes).
BANK_EDGES = [
    (2, 70, 200, 1000, "sweep", True),
    (1, 70, 200, 1000, "sweep", False),
    (2, 130, 37, 577, "shuffled", True),
    (1, 65, 50, 289, "steep", True),
    (1, 9, 17, 300, "steep", False),
    (1, 465, 2048, 600, "dsa10c", True),
    (2, 70, 16, 1000, "sweep", True),
    (1, 33, 7, 481, "shuffled", False),
    (1, 65, 12, 289, "steep", True),
]


@pytest.mark.parametrize("case", BANK_EDGES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_bank_kernels_at_their_edges(dev, case):
    """``dedisperse_direct`` and ``subband_stage1`` (one kernel) against
    their plain versions, bit for bit, where the tiles are partial, the
    tables are not DM sweeps and the rows are not aligned; the share of
    rows the register window served, as ``bank_paths`` states it."""
    from dsabeamformer_tpu_torch.config import DSA10_COMPACT
    from dsabeamformer_tpu_torch.ops import dedisperse as dd

    b, n_dm, f, t_out, kind, aligned = case
    rng = np.random.default_rng(n_dm + f)
    if kind == "dsa10c":
        f_mhz = DSA10_COMPACT.freqs_hz() / 1e6
        tsamp = DSA10_COMPACT.sample_period_s * DSA10_COMPACT.navg_time
        dms = dd.dm_trial_grid(float(f_mhz.min()), float(f_mhz.max()),
                               tsamp, dm_max=100.0)
        delays = dd.delay_table(f_mhz, dms, tsamp)
    else:
        delays = _sweep(n_dm, f, {"sweep": 1.3, "shuffled": 1.3,
                                  "steep": 4.0}[kind])
        if kind == "shuffled":
            delays = delays[rng.permutation(n_dm)]
    assert delays.shape == (n_dm, f)
    window = dd.bank_paths(delays) == dd.WINDOW_PATH
    if kind in ("sweep", "dsa10c"):
        assert window.all()
    elif kind == "shuffled":
        assert not window.all()
    else:
        assert window.any() and not window.all()
    t_pad = t_out + int(delays.max())
    t_pad = -(-t_pad // 4) * 4 + (0 if aligned else 1)
    n = b * f * t_pad
    flat = torch.from_numpy(rng.normal(size=n + 4).astype(np.float32))
    off = 0 if aligned else 1
    p = flat[off:off + n].view(b, f, t_pad)
    d = torch.from_numpy(delays)
    got = dd.dedisperse_direct(p.to(dev) if aligned else
                               flat.to(dev)[off:off + n].view(b, f, t_pad),
                               d.to(dev), t_out)
    assert torch.equal(got.cpu(), dd.dedisperse_direct_plain(p, d, t_out))
    # Stage 1 on the same table cut into groups of channels.
    g = 4 if f % 4 == 0 else 1
    c = f // g
    intra = torch.from_numpy(np.ascontiguousarray(
        delays[:, :g * c].reshape(n_dm, g, c).transpose(1, 0, 2)))
    intra = intra - intra.amin(dim=(1, 2), keepdim=True)
    pg = p[:, :g * c].reshape(b, g, c, t_pad).contiguous()
    s = dd.subband_stage1(pg.to(dev), intra.to(dev), t_out)
    assert torch.equal(s.cpu(), dd.subband_stage1_plain(pg, intra, t_out))


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


#: (B, n_dm, T, widths, k): rows under one scan block, one level, three
#: levels (a full DSA-10 window's 9923 samples), k from 1 to the most;
#: rows past shared memory (their scan in the global scratch), fewer and
#: more than the scratch's blocks.
TOPK_SHAPES = [(2, 3, 11, (1, 2, 4), 4), (1, 5, 300, (1, 3, 8), 1),
               (3, 7, 4100, (1, 2, 4, 8, 16, 32), 4),
               (1, 4, 9923, (1, 2, 4, 8, 16, 32), 8),
               (2, 3, 56787, (1, 2, 4), 4), (1, 1030, 50700, (1, 2), 2)]


@pytest.mark.parametrize("shape", TOPK_SHAPES)
def test_snr_topk_kernel_equals_plain(dev, shape):
    """The normalized rows' scan, top-k and owned peaks against the plain
    version, bit for bit, on integer rows full of ties (the lower start
    first), on continuous rows, and with limits from none to all."""
    from dsabeamformer_tpu_torch.ops import dedisperse as dd

    b, n_dm, t, widths, k = shape
    rng = np.random.default_rng(t)
    limit = rng.integers(-2, t - max(widths) + 2, (len(widths), n_dm))
    limit[0, 0], limit[-1, -1] = 0, t - max(widths) + 1
    for rows in (rng.integers(-3, 4, (b, n_dm, t)).astype(np.float32),
                 rng.normal(size=(b, n_dm, t)).astype(np.float32)):
        norm = torch.from_numpy(rows)
        want = dd.snr_topk_plain(norm, widths, k, limit)
        n0 = dd.snr_topk.launches
        got = dd.snr_topk(norm.to(dev), widths, k, limit)
        assert dd.snr_topk.launches == n0 + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_snr_topk_refuses_a_k_its_kernel_cannot_keep(dev):
    """On the card a k outside 1 to ``TOPK_MAX_K`` is a ValueError, not
    another path, and a monitor that would ask for one is refused when
    built."""
    from dsabeamformer_tpu_torch.ops import dedisperse as dd

    norm = torch.zeros((1, 2, 64), device=dev)
    limit = np.full((1, 2), 64, np.int64)
    n0 = dd.snr_topk.launches
    for k in (0, dd.TOPK_MAX_K + 1):
        with pytest.raises(ValueError, match="peaks"):
            dd.snr_topk(norm, (1,), k, limit)
    assert dd.snr_topk.launches == n0
    freqs = np.linspace(1280.0, 1530.0, 64)
    dms = dd.dm_trial_grid(1280.0, 1530.0, 1e-3, dm_max=100.0)
    with pytest.raises(ValueError, match="peaks"):
        dd.SearchMonitor(freqs, 1e-3, dms, topk=dd.TOPK_MAX_K + 1,
                         device=dev)


#: Raw bank rows the top-k kernel normalizes itself: integer rows in which
#: more than half the values equal the lower median, rows all equal (MAD 0,
#: so sigma 1e-30), negative rows with zeros of both signs (a zero-DM'd
#: window's), and sums of 8-bit counts as a uint8 window's bank holds them.
RAW_ROWS = ("ties", "equal", "signed_zeros", "counts")


def _raw_rows(kind: str, shape: tuple, rng) -> np.ndarray:
    if kind == "ties":
        x = rng.integers(-3, 4, shape).astype(np.float32)
        x[rng.random(shape) < 0.6] = 1.0
        return x
    if kind == "equal":
        return np.broadcast_to(rng.integers(-50, 50, shape[:-1] + (1,)),
                               shape).astype(np.float32)
    if kind == "signed_zeros":
        x = np.round(rng.normal(-0.5, 1.0, shape), 1).astype(np.float32)
        zero = x == 0
        x[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
        return x
    return np.rint(rng.normal(64 * 2048, 64 * 45, shape)).astype(np.float32)


@pytest.mark.parametrize("kind", RAW_ROWS)
@pytest.mark.parametrize("shape", TOPK_SHAPES)
def test_snr_topk_kernel_normalizes_the_raw_bank(dev, shape, kind):
    """On the card ``_snr_topk`` is one ``snr_topk_kernel`` launch on the raw
    bank, counted in ``snr_topk.normalized``, bit-equal to ``_normalize``
    then ``snr_topk_plain`` on the CPU (the rows past shared memory
    included)."""
    from dsabeamformer_tpu_torch.ops import dedisperse as dd

    b, n_dm, t, widths, k = shape
    rng = np.random.default_rng([t, RAW_ROWS.index(kind)])
    limit = rng.integers(-2, t - max(widths) + 2, (len(widths), n_dm))
    limit[0, 0], limit[-1, -1] = 0, t - max(widths) + 1
    bank = torch.from_numpy(_raw_rows(kind, (b, n_dm, t), rng))
    want = dd.snr_topk_plain(dd._normalize(bank), widths, k, limit)
    n0, m0 = dd.snr_topk.launches, dd.snr_topk.normalized
    got = dd._snr_topk(bank.to(dev), widths, k, limit)
    assert (dd.snr_topk.launches, dd.snr_topk.normalized) == (n0 + 1, m0 + 1)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("kind", RAW_ROWS)
@pytest.mark.parametrize("n", [1, 2, 3, 16, 523, 524, 9923, 9924])
def test_median_rows_kernel_equals_the_plain_median(dev, kind, n):
    """The tail fill's medians on the card, ``median_rows_kernel``, equal
    ``_median_last`` on the CPU bit for bit at odd and even lengths."""
    from dsabeamformer_tpu_torch.ops import dedisperse as dd

    x = torch.from_numpy(_raw_rows(kind, (3, 5, n),
                                   np.random.default_rng([n, 7])))
    n0 = dd.median_rows.launches
    got = dd.median_rows(x.to(dev))
    assert dd.median_rows.launches == n0 + 1
    assert torch.equal(got.cpu(), dd._median_last(x))
    # A strided view, as the conv fill takes every step-th sample.
    assert torch.equal(dd.median_rows(x.to(dev)[..., ::3]).cpu(),
                       dd._median_last(x[..., ::3]))


def test_a_monitor_window_on_the_card_takes_no_torch_median(dev,
                                                            monkeypatch):
    """A CUDA ``SearchMonitor`` window calls neither ``_normalize`` nor
    ``kthvalue``: each beam group's normalization is in its top-k launch,
    and the conv fill's medians are ``median_rows``'."""
    from dsabeamformer_tpu_torch.ops import dedisperse as dd

    def refused(*args, **kw):
        raise AssertionError("the card's search took a torch median")

    monkeypatch.setattr(dd, "_normalize", refused)
    monkeypatch.setattr(dd, "_median_last", refused)
    monkeypatch.setattr(torch, "kthvalue", refused)
    monkeypatch.setattr(torch.Tensor, "kthvalue", refused)
    freqs = np.linspace(1280.0, 1530.0, 64)
    tsamp = 1.048576e-3
    dms = dd.dm_trial_grid(1280.0, 1530.0, tsamp, dm_max=100.0)
    mon = dd.SearchMonitor(freqs, tsamp, dms, beam="all", chunk_t=256,
                           beam_batch=3, device=dev)
    rng = np.random.default_rng(5)
    n0, m0 = dd.snr_topk.launches, dd.snr_topk.normalized
    f0 = dd.median_rows.launches
    for seq in range(12):
        block = rng.integers(40, 90, (64, 64, 8)).astype(np.uint8)  # [F, T, B]
        mon.observe(seq, block)
    mon.flush()
    assert mon.searched_windows >= 2
    groups = dd.snr_topk.launches - n0
    assert groups >= 2 * 3 and dd.snr_topk.normalized - m0 == groups
    assert dd.median_rows.launches - f0 == groups


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


def test_paced_ring_delivers_each_block_before_the_next_read(dev, tmp_path):
    """The deployed stream (8-bit .fil, incoherent .dada, RFI monitor that
    excises a carrier mid-stream) from a pinned ring paced at 1x: a pre-roll
    of one block a ring slot (the sink calibrates on block 0, each slot is
    registered at its first read), then one block every 67.1 ms, published
    in the reader's own calls.  Each block is delivered once and in order,
    and each paced block before the next block's read returns, in a wait;
    the products, the scales and the excision are those of the same blocks
    published as fast as the ring takes them."""
    import math
    import time
    import uuid

    from dsabeamformer_tpu_torch.ingest import dada
    from dsabeamformer_tpu_torch.ingest.generator import make_tone_block
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
    from dsabeamformer_tpu_torch.ingest.sigproc import (
        FilterbankSink,
        read_filterbank,
    )
    from dsabeamformer_tpu_torch.models.weights import zap_weights
    from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor
    from dsabeamformer_tpu_torch.pipeline import FileSink, RingSource

    cfg = DSA10.replace(n_chan=16)
    n, nbufs, period = 12, 4, cfg.block_duration_s
    blocks = []
    for s in range(4):
        w = make_noise_block(cfg, rms=2.0, seed=60 + s).reshape(
            cfg.wire_block_shape).copy()
        w[:, 2] = make_tone_block(cfg, chan=2, amplitude=6.0)[:, 2]
        blocks.append(w)

    class Paced:
        """Publishes, in the reader's calls and while a slot is free, the
        pre-roll (blocks 0 .. nbufs - 1) at once and block i at t0 + (i -
        nbufs) * period, t0 being the first call after the pre-roll was
        read; unpaced, every block at once.  Stamps each read's return."""
        pinned = True
        dropped = skipped = 0

        def __init__(self, prod, src, paced):
            self.prod, self.src, self.paced = prod, src, paced
            self.t0, self.i, self.read_at = None, 0, {}

        def _due(self, i):
            if not self.paced or i < nbufs:
                return 0.0
            return math.inf if self.t0 is None else \
                self.t0 + (i - nbufs) * period

        def _publish(self):
            """Seconds to the next block's due time (None: all out)."""
            now = time.perf_counter()
            if self.t0 is None and len(self.read_at) == nbufs:
                self.t0 = now
            while self.i < n and self._due(self.i) <= now and \
                    self.prod.n_written - self.prod.n_read < nbufs:
                assert self.prod.write_block(blocks[self.i % 4])
                self.i += 1
                if self.i == n:
                    self.prod.set_eod()
            return None if self.i == n else \
                max(0.0, min(self._due(self.i) - now, 1.0))

        def _got(self, got):
            if got is not None:
                assert got[0] not in self.read_at and got[1].is_pinned()
                self.read_at[got[0]] = time.perf_counter()
            return got

        def poll_block(self, timeout_s):
            wait = self._publish()
            return self._got(self.src.poll_block(
                timeout_s if wait is None else min(timeout_s, wait)))

        def read_block(self):
            while True:
                wait = self._publish()
                if wait is None:
                    return self._got(self.src.read_block())
                got = self.src.poll_block(0.0)
                if got is not None:
                    return self._got(got)
                time.sleep(wait)

        def release(self):
            self.src.release()

    # The excised table, made ahead: the swap in the retire then takes the
    # loop no part of a period.
    zapped = {(2,): prepare_weights(cfg, zap_weights(
        make_weights(cfg, device=dev), [2], cfg))}
    runs = {}
    for name, paced in (("unpaced", False), ("paced", True)):
        events, delivered = [], []
        qw = prepare_weights(cfg, make_weights(cfg, device=dev))
        fil = FilterbankSink(tmp_path / name, cfg, nbits=8)
        inco = FileSink(tmp_path / f"{name}.dada", cfg, products="incoherent")
        key = f"paced-{uuid.uuid4().hex[:10]}"
        with RingBuffer(key, create=True, nbufs=nbufs,
                        bufsz=cfg.wire_block_bytes) as prod:
            prod.write_header(dada.encode_header(cfg))
            cons = RingBuffer(key)
            src = RingSource(cfg, cons, timeout_s=5.0)
            source = Paced(prod, src, paced)
            bf = StreamingBeamformer(
                cfg, qw, source, fil, depth=2, incoherent_sink=inco,
                flag_ants=(1,), on_block=lambda bs: delivered.append(
                    (bs.seq, time.perf_counter())))

            def on_event(ev, bf=bf):
                events.append((ev, time.perf_counter()))
                if ev["type"] == "excise" and not ev.get("final"):
                    bf.update_weights(zapped[tuple(ev["zapped"])])

            bf.rfi_monitor = RFIMonitor(cfg, interval=2, sample=2,
                                        on_event=on_event)
            bf.warmup()
            stats = bf.run()
            src.close()
            cons.close()
        fil.close()
        inco.close()
        assert stats.n_blocks == n and stats.dropped == 0
        assert [s for s, _ in delivered] == list(range(n))
        if paced:
            why = (delivered, source.read_at, [t for _, t in events])
            for seq, t in delivered[nbufs:-1]:
                assert t < source.read_at[seq + 1], (seq, why)
            assert stats.early_drains >= n - nbufs, why
        runs[name] = [e for e, _ in events], fil.scales, stats.weight_swaps
    assert runs["paced"][0] == runs["unpaced"][0]
    assert [e["type"] for e in runs["paced"][0]] == ["excise"]
    assert runs["paced"][0][0]["new"] == [2]
    assert runs["paced"][2] == runs["unpaced"][2] == 1
    for b in range(cfg.n_beams):
        assert np.array_equal(runs["paced"][1][b], runs["unpaced"][1][b])
        f = f"beam{b:04d}.fil"
        (hp, dp), (hu, du) = (read_filterbank(tmp_path / name / f)
                              for name in ("paced", "unpaced"))
        assert hp == hu and dp.shape[0] == n * cfg.out_block_shape[1]
        assert np.array_equal(dp, du)
    assert (tmp_path / "paced.dada").read_bytes() == \
        (tmp_path / "unpaced.dada").read_bytes()


def test_cli_run_from_file_equals_the_stream(dev, tmp_path, capsys):
    """``dsabf-torch run --device 0`` from a capture file: its .dada power
    product and its incoherent product equal an in-process
    StreamingBeamformer's over the same blocks on the card, byte for byte,
    and its record counts the blocks."""
    import json

    from dsabeamformer_tpu_torch import cli
    from dsabeamformer_tpu_torch.ingest import dada
    from dsabeamformer_tpu_torch.pipeline import FileSink

    cfg = DSA10.replace(n_chan=32, t_block=1024)
    blocks = [make_noise_block(cfg, rms=2.0, seed=s) for s in range(3)]
    cap = tmp_path / "cap.dada"
    dada.write_dada_file(cap, cfg, blocks)
    out, inco = tmp_path / "out.dada", tmp_path / "inco.dada"
    capsys.readouterr()
    assert cli.main(["run", "--config", "dsa10", "--input-file", str(cap),
                     "--output-file", str(out), "--incoherent-file",
                     str(inco), "--flag-ants", "3", "--device", "0"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["blocks"] == 3 and rec["dropped"] == 0
    from dsabeamformer_tpu_torch.models.weights import flag_antennas

    qw = prepare_weights(cfg, flag_antennas(make_weights(cfg, device=dev),
                                            (3,), cfg))
    ref, ref_inco = tmp_path / "ref.dada", tmp_path / "ref_inco.dada"
    sink = FileSink(ref, cfg)
    inco_sink = FileSink(ref_inco, cfg, products="incoherent")
    StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks, 3), sink,
                        incoherent_sink=inco_sink, flag_ants=(3,)).run()
    sink.close()
    inco_sink.close()
    _, got = dada.read_product_file(out)
    _, want = dada.read_product_file(ref)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    _, got = dada.read_product_file(inco)
    _, want = dada.read_product_file(ref_inco)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_cli_weights_and_scans_on_the_card(dev, tmp_path, capsys):
    """``dsabf-torch weights --device 0`` saves the table made on the card
    (byte-equal to ``prepare_weights(make_weights(device=card))``), and
    ``levels`` / ``rfi --per-ant`` read a live ring on the card (the pinned
    route) with the records of ``--device cpu`` over the same blocks."""
    import json
    import os

    from dsabeamformer_tpu_torch import cli
    from dsabeamformer_tpu_torch.ingest import dada
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
    from dsabeamformer_tpu_torch.ops.quantize import load_quant_weights

    path = tmp_path / "w.npz"
    capsys.readouterr()
    assert cli.main(["weights", "--config", "tiny", "--out", str(path),
                     "--device", "0"]) == 0
    got = load_quant_weights(str(path), device="cpu")
    want = prepare_weights(TINY, make_weights(TINY, device=dev))
    for a, b in zip(got.terms, want.terms):
        assert torch.equal(a, b.cpu())
    assert torch.equal(got.scales, want.scales.cpu())

    blocks = [make_noise_block(TINY, rms=2.0, seed=80 + s) for s in range(3)]
    for b in blocks:
        b.reshape(TINY.wire_block_shape)[:, 5] = 0x77
    for cmd in ("levels", "rfi"):
        recs = {}
        for device in ("0", "cpu"):
            key = f"tcardscan{cmd}{device}{os.getpid()}"
            with RingBuffer(key, create=True, nbufs=4,
                            bufsz=TINY.wire_block_bytes) as ring:
                ring.write_header(dada.encode_header(TINY))
                for b in blocks:
                    ring.write_block(b)
                ring.set_eod()
                capsys.readouterr()
                argv = [cmd, "--config", "tiny", "--key", key, "--blocks",
                        "3", "--timeout", "2", "--device", device]
                assert cli.main(argv + (["--per-ant"] if cmd == "rfi"
                                        else [])) == 0
                recs[device] = json.loads(capsys.readouterr().out)
        card, host = recs["0"], recs["cpu"]
        assert card["blocks"] == 3 and set(card) == set(host)
        for k in host:
            if isinstance(host[k], list) and host[k] \
                    and isinstance(host[k][0], float):
                np.testing.assert_allclose(card[k], host[k], rtol=1e-6)
            else:
                assert card[k] == host[k], k
        if cmd == "rfi":
            assert 5 in card["flagged"]


def _write_beam_fils(tmp_path, n_beams=8, t=2048, nf=64, seed=40):
    """Per-beam 32-bit .fil files of one observation: a dispersed pulse
    (DM 90) in beams 3 and 4, a broadband spike in every beam."""
    from dsabeamformer_tpu_torch.config import dm_delays_s
    from dsabeamformer_tpu_torch.ingest.sigproc import _encode_header_dict

    tsamp = 1.048576e-3
    freqs = np.linspace(1280.0, 1530.0, nf)
    shifts = np.rint(dm_delays_s(freqs, 90.0, freqs[-1]) / tsamp).astype(int)
    paths = []
    for b in range(n_beams):
        x = np.random.default_rng(seed + b).normal(size=(t, nf)).astype(
            np.float32)
        if b in (3, 4):
            for f in range(nf):
                x[700 + shifts[f]: 704 + shifts[f], f] += 1.0
        x[300:302] += 3.0
        hdr = {"fch1": 1530.0, "foff": -250.0 / (nf - 1), "nchans": nf,
               "nbits": 32, "nifs": 1, "tsamp": tsamp, "ibeam": b}
        p = tmp_path / f"beam{b:04d}.fil"
        with open(p, "wb") as fh:
            fh.write(_encode_header_dict(hdr))
            fh.write(np.ascontiguousarray(x[:, ::-1]).tobytes())
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("method", ["direct", "subband", "conv"])
def test_cli_search_on_the_card_equals_cpu(dev, tmp_path, capsys, method):
    """``dsabf-torch search --device 0`` over a multi-beam product runs the
    banks' kernels and prints, row for row, what ``--device cpu`` prints
    (coincidence on, and off)."""
    from dsabeamformer_tpu_torch import cli
    from dsabeamformer_tpu_torch.ops import dedisperse as dd

    paths = _write_beam_fils(tmp_path)
    for extra in ([], ["--no-coincidence", "--limit", "500"]):
        rows = {}
        for device in ("0", "cpu"):
            for k in (dd.dedisperse_direct, dd.subband_stage1,
                      dd.subband_stage2):
                k.launches = 0
            capsys.readouterr()
            assert cli.main(["search", *paths, "--dm-max", "300",
                             "--method", method, "--device", device,
                             *extra]) == 0
            rows[device] = [l for l in capsys.readouterr().out.splitlines()
                            if l.strip() and not l.startswith("#")]
            launched = (dd.dedisperse_direct.launches if method == "direct"
                        else dd.subband_stage1.launches)
            assert (launched > 0) == (device == "0")
        assert rows["0"] and rows["0"] == rows["cpu"]


def test_cli_search_joined_rings_on_the_card_equals_cpu(dev, capsys):
    """``search --key k0,k1 --device 0`` over two subband product rings
    (the same seeded blocks as for ``--device cpu``): the same rows."""
    import os

    from dsabeamformer_tpu_torch import cli
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
    from dsabeamformer_tpu_torch.pipeline import RingSink

    cfg = TINY.replace(navg_time=2)
    width = cfg.n_chan // 2
    subs = [cfg.subband(0, width), cfg.subband(width, width)]
    rows = {}
    for device in ("0", "cpu"):
        rng = np.random.default_rng(9)
        keys = [f"tcardjoin{device}{os.getpid()}_{i}" for i in range(2)]
        rings = []
        try:
            for key, sub in zip(keys, subs):
                fo, to, bo = sub.out_block_shape
                ring = RingBuffer(key, create=True, nbufs=8,
                                  bufsz=fo * to * bo * 4)
                rings.append(ring)
                sink = RingSink(ring, sub)
                for seq in range(6):
                    blk = rng.standard_normal((fo, to, bo)).astype(
                        np.float32)
                    if seq == 2:
                        blk[:, 10:14, 5] += 4.0
                    sink.write(seq, blk)
                ring.set_eod()
            capsys.readouterr()
            assert cli.main(["search", "--key", ",".join(keys), "--beam",
                             "all", "--no-coincidence", "--dm-max", "5",
                             "--threshold", "7", "--widths", "1", "2", "4",
                             "--timeout", "2", "--device", device]) == 0
            rows[device] = [l for l in capsys.readouterr().out.splitlines()
                            if l.strip() and not l.startswith("#")]
        finally:
            for r in rings:
                r.destroy()
    assert rows["0"] and rows["0"] == rows["cpu"]


def test_cli_trace_on_the_card(dev, tmp_path, capsys):
    """``dsabf-torch trace --device 0`` traces the card: its rows name the
    detect kernel once a block (a 256-channel DSA-10 block, so that the
    kernel is among the costliest rows)."""
    import json

    from dsabeamformer_tpu_torch import cli

    capsys.readouterr()
    assert cli.main(["trace", "--config", "dsa10", "--set", "n_chan=256",
                     "--blocks", "3", "--out", str(tmp_path), "--device",
                     "0"]) == 0
    rec = json.loads(capsys.readouterr().out)
    kernels = [r for r in rec["ops"] if "detect_mma_kernel" in r["name"]]
    assert kernels and kernels[0]["count"] == 3, rec["ops"]


# ---------- the calibration loop, the lm grids, beampattern, bench ---------- #

def _calibrator(cfg, target, seed=3):
    """tests/test_torch_calsolver.py's corrupted calibrator at beam
    ``target``: (wire, instrumental gains)."""
    rng = np.random.default_rng(seed)
    act = cfg.n_ant_active
    g = np.zeros((cfg.n_ant, cfg.n_chan), np.complex128)
    g[:act] = (1.0 + 0.15 * rng.standard_normal((act, cfg.n_chan))) \
        * np.exp(1.5j * rng.standard_normal((act, cfg.n_chan)))
    wire = make_point_source_block(cfg, cfg.beam_angles_rad()[target],
                                   amplitude=2.5, noise_rms=0.15, seed=seed,
                                   instrumental_gains=g)
    return wire, g


@pytest.mark.parametrize("cfg", [TINY, DSA10_COMPACT.replace(
    n_chan=32, t_block=2048, input_layout="ftpa")], ids=["tiny", "dsa10c_32ch"])
def test_calsolver_on_the_card_equals_cpu(dev, cfg):
    """Gains summed on the card (the wire uploaded as uint8) within 1e-6 of
    the CPU's, relative; the card's table restores the beam."""
    from dsabeamformer_tpu_torch.models.calsolver import solve_gains

    target = cfg.n_beams // 3
    wire, g = _calibrator(cfg, target)
    angle = cfg.beam_angles_rad()[target]
    card = solve_gains(torch.from_numpy(wire).to(dev), cfg, angle,
                       device=dev).gains
    host = solve_gains(wire, cfg, angle, device="cpu").gains
    act = cfg.n_ant_active
    rel = np.abs(card[:act] - host[:act]) / np.abs(host[:act])
    assert rel.max() <= 1e-6 and not np.any(card[act:])
    prod = card[:act] * g[:act]
    assert np.abs(np.angle(prod / prod[0:1])).max() < 0.1
    qw = prepare_weights(cfg, make_weights(cfg, cal=CalTable(gains=card),
                                           device=dev))
    p = gemm.beamform_power(torch.from_numpy(wire).to(dev), qw, cfg)
    assert int(p.sum(dim=(0, 1)).argmax()) == target


def test_cli_calibrate_on_the_card(dev, tmp_path, capsys):
    """``dsabf-torch calibrate --device 0`` prints the record of ``--device
    cpu`` and saves the same table (1e-6)."""
    import json

    from dsabeamformer_tpu_torch import cli
    from dsabeamformer_tpu_torch.ingest import dada

    cfg = TINY
    wire, _ = _calibrator(cfg, 10)
    cap = tmp_path / "cal.dada"
    dada.write_dada_file(cap, cfg, [wire, _calibrator(cfg, 10, seed=4)[0]])
    recs, tables = {}, {}
    for device in ("0", "cpu"):
        out = tmp_path / f"cal{device}.npz"
        capsys.readouterr()
        assert cli.main(["calibrate", "--config", "tiny", "--input-file",
                         str(cap), "--angle",
                         str(np.rad2deg(cfg.beam_angles_rad()[10])), "--out",
                         str(out), "--device", device]) == 0
        recs[device] = json.loads(capsys.readouterr().out)
        tables[device] = CalTable.load(str(out)).gains
    card, host = recs["0"], recs["cpu"]
    assert card["blocks"] == host["blocks"] == 2
    for k in ("n_ant", "n_ant_active", "n_chan"):
        assert card[k] == host[k]
    for k in ("median_amp", "max_phase_rad"):
        assert card[k] == pytest.approx(host[k], rel=1e-6, abs=1e-7)
    act = cfg.n_ant_active
    rel = np.abs(tables["0"][:act] - tables["cpu"][:act]) \
        / np.abs(tables["cpu"][:act])
    assert rel.max() <= 1e-6


@pytest.mark.parametrize("cfg,chan", [
    (DSA10.replace(n_chan=16), None), (DSA10.replace(n_chan=16), 5),
    (DSA110.replace(n_chan=8), None)], ids=["dsa10", "dsa10_chan5", "dsa110"])
def test_beam_response_on_the_card_equals_cpu(dev, cfg, chan):
    """complex128 on the card against the CPU: 1e-9 relative to the
    peak; matched beams on the diagonal."""
    from dsabeamformer_tpu_torch.models.beampattern import beam_response

    sweep = cfg.beam_angles_rad()
    card = beam_response(cfg, sweep, chan=chan, device=dev)
    host = beam_response(cfg, sweep, chan=chan, device="cpu")
    assert relative_power_error(card, host) <= 1e-9
    assert (np.argmax(card, axis=1) == np.arange(cfg.n_beams)).all()


def test_beam_response_lm_on_the_card_equals_cpu(dev):
    from dsabeamformer_tpu_torch.models.arrays import ArrayLayout
    from dsabeamformer_tpu_torch.models.beampattern import beam_response_lm

    cfg = TINY.replace(n_beams=36)
    rng = np.random.default_rng(1)
    ew, ns = np.zeros(cfg.n_ant), np.zeros(cfg.n_ant)
    ew[:6], ns[:6] = rng.uniform(-20, 20, 6), rng.uniform(-20, 20, 6)
    layout = ArrayLayout(positions_m=ew, n_active=6, positions_ns_m=ns)
    grid = np.linspace(-0.01, 0.01, 6)
    ll, mm = np.meshgrid(grid, grid, indexing="ij")
    args = (cfg, ll.ravel(), mm.ravel(), ll.ravel(), mm.ravel())
    card = beam_response_lm(*args, layout=layout, device=dev)
    host = beam_response_lm(*args, layout=layout, device="cpu")
    assert relative_power_error(card, host) <= 1e-9


def _lm_grid(cfg, rows=16, cols=32, half=0.01):
    l, m = np.meshgrid(np.linspace(-half, half, rows),
                       np.linspace(-half, half, cols), indexing="ij")
    assert l.size == cfg.n_beams
    return l.ravel(), m.ravel()


def _layout_2d(cfg, seed=110):
    from dsabeamformer_tpu_torch.models.arrays import ArrayLayout

    rng = np.random.default_rng(seed)
    ew, ns = np.zeros(cfg.n_ant), np.zeros(cfg.n_ant)
    a = cfg.n_ant_active
    ew[:a], ns[:a] = rng.uniform(-300, 300, a), rng.uniform(-300, 300, a)
    return ArrayLayout(positions_m=ew, n_active=a, positions_ns_m=ns)


def test_lm_weights_through_the_detect_kernel(dev):
    """DSA-110 (110 dishes on a 600 m square, a 16 x 32 grid of 512 beams)
    on an 8-channel slice: make_weights_lm on the card within 1e-4 of the
    golden (its phase is float32 on the card: ~30 turns of path at most,
    ~1e-5 rad), a 2-D point source at grid beam 300 through the detect
    kernel within 1e-5 of its plain version, peaking in beam 300."""
    from dsabeamformer_tpu_torch.config import SPEED_OF_LIGHT_M_S
    from dsabeamformer_tpu_torch.ingest.generator import _emit
    from dsabeamformer_tpu_torch.models.weights import (
        make_weights_lm, weights_lm_numpy_golden,
    )

    cfg = DSA110.replace(n_chan=8, t_block=512)
    layout = _layout_2d(cfg)
    l, m = _lm_grid(cfg)
    w = make_weights_lm(cfg, l, m, layout=layout, device=dev)
    assert w.device == dev
    gold = weights_lm_numpy_golden(cfg, l, m, layout=layout)
    assert np.abs(w.to_numpy() - gold).max() <= 1e-4
    target = 300
    rng = np.random.default_rng(7)
    a = cfg.n_ant_active
    steer = np.exp(2j * np.pi * cfg.freqs_hz()[:, None, None]
                   * (layout.positions_m[None, None, :a] * l[target]
                      + layout.ns[None, None, :a] * m[target])
                   / SPEED_OF_LIGHT_M_S)
    sig = 3.0 / np.sqrt(2) * (
        rng.standard_normal((cfg.n_chan, cfg.t_block, cfg.n_pol))
        + 1j * rng.standard_normal((cfg.n_chan, cfg.t_block, cfg.n_pol)))
    v = sig[..., None] * steer[:, :, None, :]
    shape = (cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant)
    re, im = np.zeros(shape), np.zeros(shape)
    re[..., :a] = v.real + rng.normal(0, 0.3, v.shape)
    im[..., :a] = v.imag + rng.normal(0, 0.3, v.shape)
    wire = _emit(cfg, re, im)
    qw = prepare_weights(cfg, w)
    before = _launches()
    got = gemm.beamform_power(torch.from_numpy(wire).to(dev), qw, cfg)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    want = gemm.beamform_power(wire, _to(qw, "cpu"), cfg).numpy()
    got = got.cpu().numpy()
    assert relative_power_error(got, want) <= 1e-5
    assert int(np.argmax(got.sum(axis=(0, 1)))) == target


def test_bench_kernel_record_on_the_card(dev):
    """``bench_kernel`` on the card: the record's keys, a positive time,
    the utilization booked against the card's int8 peak."""
    from dsabeamformer_tpu_torch.utils.bench import bench_kernel

    cfg = DSA10.replace(n_chan=64)
    before = _launches()
    rec = bench_kernel(cfg, n_blocks=4, repeats=2, device=dev)
    assert _launches() == before + 1 + 4 * 2
    assert set(rec) == {"mode", "config", "ms_per_block", "gb_per_s",
                        "realtime_factor", "tc_utilization_issued",
                        "tc_utilization_padded_k"}
    assert rec["mode"] == "kernel" and rec["ms_per_block"] > 0
    assert rec["tc_utilization_issued"] is not None
    assert 0 < rec["tc_utilization_issued"] < 1
    assert rec["tc_utilization_padded_k"] == pytest.approx(
        rec["tc_utilization_issued"] * cfg.n_ant / cfg.a_compute)


# --------------------------------------------------------------------- #
# Scale-out: the channel mesh, the antenna split, processes on one card
# --------------------------------------------------------------------- #

#: The DSA-110 structure (a_compute 128, 512 beams) on 64 channels.
MESH_CFG = DSA110.replace(n_chan=64, t_block=512)


def _mesh_variants():
    return [("base", {}), ("stokes", {}),
            ("sk+q8+inco", dict(incoherent=True, flag_ants=(77,),
                                sk_stats=True, fused_quant8=True))]


@pytest.mark.parametrize("name,kw", _mesh_variants(),
                         ids=[n for n, _ in _mesh_variants()])
def test_mesh_on_the_card_equals_one_device(dev, name, kw):
    """Eight mesh slots on the card: every output byte for byte the
    single-device kernel's (the per-channel arithmetic does not depend on
    the channel count), one detect launch a slot, the band the product's
    own channel sum."""
    from dsabeamformer_tpu_torch.parallel.sharding import (
        make_mesh, shard_weights, sharded_beamformer,
    )

    cfg = MESH_CFG
    mesh = make_mesh(8, devices=[dev] * 8)
    wire = torch.from_numpy(make_random_bytes_block(cfg, seed=3)).to(dev)
    qw_sh = shard_weights(cfg, mesh)
    qw = type(qw_sh[0])(tuple(torch.cat([q.terms[i] for q in qw_sh])
                              for i in range(2)),
                        torch.cat([q.scales for q in qw_sh]))
    stokes = name.startswith("stokes")
    band = not kw.get("fused_quant8")
    step = sharded_beamformer(cfg, mesh, products="stokes" if stokes
                              else "power", with_band_power=band, **kw)
    scales = torch.full((cfg.n_beams,), 0.01, device=dev)
    args = (scales,) if kw.get("fused_quant8") else ()
    before = _launches()
    got = step(wire, qw_sh, *args)
    assert _launches() == before + 8
    got = list(got) if isinstance(got, tuple) else [got]
    detect = gemm.beamform_stokes if stokes else gemm.beamform_power
    single_kw = {k: v for k, v in kw.items() if k != "fused_quant8"}
    if args:
        single_kw["quant8_scales"] = scales
    want = detect(wire, qw, cfg, **single_kw)
    want = list(want) if isinstance(want, tuple) else [want]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if band:
        plane = want[0][:, :, 0] if stokes else want[0]
        torch.testing.assert_close(got[-1], plane.sum(dim=(0, 2)),
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("band", [False, True])
def test_mesh_stream_on_the_card_equals_one_device(dev, band):
    """A mesh stream with a weight update mid-stream (eight slots on the
    card) against the single-device stream of the same blocks: every block
    byte for byte; the bands the blocks' channel sums."""
    from dsabeamformer_tpu_torch.parallel.sharding import make_mesh
    from dsabeamformer_tpu_torch.pipeline import MeshStreamingBeamformer

    cfg = MESH_CFG
    blocks = [make_random_bytes_block(cfg, seed=s) for s in (4, 5)]
    tables = [prepare_weights(cfg, make_weights(cfg, cal=cal, device=dev))
              for cal in (None, CalTable.random(cfg, seed=2))]
    outs, bands = {}, {}
    for name in ("mesh", "single"):
        sink = CollectSink()
        kw = dict(mesh=make_mesh(8, devices=[dev] * 8),
                  with_band_power=band,
                  on_band_power=lambda s, b: bands.__setitem__(s, b)) \
            if name == "mesh" else {}
        klass = MeshStreamingBeamformer if name == "mesh" \
            else StreamingBeamformer
        bf = klass(cfg, tables[0], SyntheticSource(cfg, blocks, 4), sink,
                   **kw)
        bf.on_block = lambda bs, bf=bf: bs.block_idx == 0 and \
            bf.update_weights(tables[1])
        bf.warmup()
        assert bf.run().n_blocks == 4
        outs[name] = sink.outputs
    for (_, a), (_, b) in zip(outs["mesh"], outs["single"]):
        assert np.array_equal(a, b)
    assert relative_power_error(outs["mesh"][3][1], outs["mesh"][1][1]) > 1e-3
    if band:
        assert sorted(bands) == [0, 1, 2, 3]
        for seq, p in outs["mesh"]:
            np.testing.assert_allclose(bands[seq], p.sum(axis=(0, 2)),
                                       rtol=1e-5)


@pytest.mark.parametrize("mode", ["int8x2", "bf16x2", "f32"])
@pytest.mark.parametrize("products", ["power", "stokes"])
def test_tp_on_the_card_matches_the_fused_kernel(dev, mode, products):
    """The antenna split on a (2, 2) mesh of the card: four voltage launches
    a step, the detected product within 1e-5 of the single-device fused
    detect kernel's on the same block (Stokes: of the I plane's peak)."""
    from dsabeamformer_tpu_torch.parallel.tensor import (
        make_tp_mesh, shard_weights_tp, tp_beamformer,
    )

    cfg = DSA110.replace(n_chan=16, t_block=512, weight_mode=mode)
    mesh = make_tp_mesh(2, 2, devices=[dev] * 4)
    wire = torch.from_numpy(make_random_bytes_block(cfg, seed=8)).to(dev)
    before = gemm.beamform_voltages.launches
    got = tp_beamformer(cfg, mesh, products=products)(
        wire, shard_weights_tp(cfg, mesh))
    assert gemm.beamform_voltages.launches == before + 4
    detect = gemm.beamform_stokes if products == "stokes" \
        else gemm.beamform_power
    want = detect(wire, prepare_weights(cfg, make_weights(cfg, device=dev)),
                  cfg)
    if products == "stokes":
        scale = float(want[:, :, 0].abs().max())
        assert float((got - want).abs().max()) / scale <= 1e-5
    else:
        assert relative_power_error(got.cpu().numpy(),
                                    want.cpu().numpy()) <= 1e-5


def test_two_gloo_processes_share_the_card(dev, tmp_path):
    """Two processes of the multi-process stream on the card under gloo,
    two slots each, over the DSA-110 structure (16 channels): each
    process's step and 8-block stream (with its update) byte for byte the
    single-device kernel's channel slice, the all-reduced band the
    full-band sum."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(repo)}
    procs = [subprocess.Popen(
        [sys.executable, str(repo / "tests" / "torch_multihost_worker.py"),
         "--coordinator", f"localhost:{port}", "--world", "2", "--rank",
         str(r), "--slots", "2", "--preset", "dsa110s", "--mode",
         "step+stream", "--out", str(tmp_path), "--device", "cuda:0",
         "--backend", "gloo"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-3000:]
    cfg = DSA110.replace(n_chan=16, n_chan_total=2048, t_block=64,
                         n_beams=64)
    wire = torch.from_numpy(make_noise_block(cfg, rms=2.0, seed=9)).to(dev)
    refs = [gemm.beamform_power(wire, prepare_weights(cfg, make_weights(
        cfg, cal=cal, device=dev)), cfg).cpu().numpy()
        for cal in (None, CalTable.random(cfg, seed=5))]
    for r in range(2):
        res = np.load(tmp_path / f"proc{r}.npz")
        sl = slice(int(res["chan_start"]),
                   int(res["chan_start"] + res["n_chan"]))
        assert np.array_equal(res["step_out"], refs[0][sl])
        np.testing.assert_allclose(res["step_band"],
                                   refs[0].sum(axis=(0, 2)), rtol=1e-5)
        regimes = []
        for p, band in zip(res["stream_out"], res["stream_band"]):
            k = next(i for i, ref in enumerate(refs)
                     if np.array_equal(p, ref[sl]))
            regimes.append(k)
            np.testing.assert_allclose(band, refs[k].sum(axis=(0, 2)),
                                       rtol=1e-5)
        assert regimes == sorted(regimes) and 3 <= regimes.index(1) <= 5


def test_cli_run_mesh_on_the_card_equals_one_device(dev, tmp_path, capsys):
    """``dsabf-torch run --mesh 8 --device 0`` writes the files of ``run
    --device 0`` byte for byte (8-bit .fil, incoherent .dada)."""
    from dsabeamformer_tpu_torch import cli
    from dsabeamformer_tpu_torch.ingest import dada

    cfg = DSA10_COMPACT.replace(n_chan=64, t_block=1024)
    cap = tmp_path / "cap.dada"
    dada.write_dada_file(cap, cfg, [make_noise_block(cfg, rms=2.0, seed=s)
                                    for s in range(3)])
    for name, extra in (("mesh", ["--mesh", "8"]), ("single", [])):
        assert cli.main(["run", "--config", "dsa10c", "--input-file",
                         str(cap), "--fil-dir", str(tmp_path / name),
                         "--fil-bits", "8", "--incoherent-file",
                         str(tmp_path / f"{name}.dada"), "--device", "0"]
                        + extra) == 0
    for f in sorted((tmp_path / "single").iterdir()):
        assert (tmp_path / "mesh" / f.name).read_bytes() == f.read_bytes()
    assert (tmp_path / "mesh.dada").read_bytes() \
        == (tmp_path / "single.dada").read_bytes()
