#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (each passes or raises; any failure exits non-zero with no result):

1. device   -- a CUDA card is required; prints its name and
               ``nvidia-smi --query-gpu=name,power.limit``.
2. build    -- compiles csrc/detect_power.cu with nvcc for sm_90a from the
               checkout and prints ``ptxas -v``.
3. kernel vs plain -- at the full DSA10 preset (and the dsa10c compact
               wire), on one random-bytes block: the CUDA kernel against its
               plain PyTorch version on the same inputs, relative power error
               <= 1e-5 (identical integers; only f32 summation order differs).
4. physics  -- DSA-10 sub-band (128 channels, 512 samples), point source at
               beam 100, tfpa and ftpa: argmax beam 100 and <= 1e-3 against
               the float64 golden model.
5. device-resident rate -- two resident DSA10 blocks, back-to-back kernel
               launches timed with CUDA events, beside the plain version.
6. streamed run -- StreamingBeamformer.run over DSA10 blocks from a
               SyntheticSource (pinned staging, H2D on a copy stream, D2H to a
               checksum sink); the kernel's launch count must equal the block
               count, and block 0 must equal phase 5's output for it.
7. variants -- every kernel variant (uint8 epilogue ``q8``, incoherent sum
               ``inco`` with one antenna flagged, SK accumulators ``sk``, and
               their combinations) against the plain version at full dsa10
               (and q8, inco, sk, sk+q8+inco at dsa10c): f32 product <= 1e-5,
               incoherent and SK equal, the uint8 product byte-equal to the
               rint/clip of the kernel's own f32 product times the scales and
               within 1 count of the plain version's, only where the two f32
               products differ.
8. resident variants -- CUDA-event time of each variant at dsa10, beside
               its bound and its plain version's time.
9. deployed stream -- dsa10, 8 blocks of random bytes with one channel
               overwritten by a constant byte (a carrier, SK 0):
               StreamingBeamformer -> FilterbankSink(nbits=8, scale="auto")
               and an incoherent .dada FileSink, RFIMonitor(interval=2,
               sample=2) whose excise event regenerates the weights on the
               card and swaps them in mid-stream.  Checks the launch pattern
               (block 0 f32 + SK, later blocks uint8, SK every 2nd block),
               exactly one excise event naming the carrier, the carrier
               channel zero in the last block of every .fil, block 1 of
               every .fil equal to the resident uint8 output (transposed,
               channels flipped), the incoherent file, 0 dropped; then
               times one uint8 block into the sink laid out on the host and
               on the device (the same bytes).
10. other deployments -- dsa10c, 6 blocks each: 8-bit .fil + RFI monitor
               without the incoherent file, and a one-beam 32-bit .fil with
               it; between them and phases 6 and 9 every variant is launched
               on a main path.

Each streamed phase sets the launch counts to 0 just before its run and reads
them just after.  The last two lines are a JSON record of the kernel variants
(launches on the main paths, max error against the plain version, times, the
bound) and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import DSA10, DSA10_COMPACT
from dsabeamformer_tpu_torch.ingest.generator import (
    make_point_source_block,
    make_random_bytes_block,
)
from dsabeamformer_tpu_torch.ingest.dada import read_product_file
from dsabeamformer_tpu_torch.ingest.sigproc import (
    FilterbankSink,
    read_filterbank_header,
)
from dsabeamformer_tpu_torch.models.weights import (
    make_weights,
    weights_numpy_golden,
    zap_weights,
)
from dsabeamformer_tpu_torch.ops import _build, gemm
from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
from dsabeamformer_tpu_torch.ops.reference import beamform_block_ref
from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor
from dsabeamformer_tpu_torch.pipeline import (
    FileSink,
    StreamingBeamformer,
    SyntheticSource,
)
from dsabeamformer_tpu_torch.utils.metrics import tensor_core_utilization
from dsabeamformer_tpu_torch.utils.testing import relative_power_error

KERNEL_VS_PLAIN_RTOL = 1e-5  # same integers in both; f32 summation order only
GOLDEN_RTOL = 1e-3           # the accuracy bar against the float64 golden
TARGET_BEAM = 100
N_TIMED = 10                 # back-to-back launches in the resident timing
N_STREAM = 12                # blocks in the streamed run
DEV = torch.device("cuda", 0)


def log(msg: str) -> None:
    print(msg, flush=True)


class ChecksumSink:
    """Keeps a float32 sum of every power block, and whether block 0 equals
    ``first_expected`` bit for bit.

    float32 and not float64: torch's float64-accumulating sum of one DSA-10
    output block (1.07 GB) took 428 ms against 21 ms in float32 on the
    8-core host of an H100 80GB HBM3 machine, and the sink's time counts in
    the streamed rate (so does the one comparison of block 0)."""

    def __init__(self, first_expected: torch.Tensor):
        self.first_expected = first_expected
        self.first_equal = None
        self.sums = []

    def write(self, seq: int, powers: np.ndarray) -> None:
        t = torch.from_numpy(powers)
        self.sums.append((seq, float(t.sum())))
        if seq == 0:
            self.first_equal = torch.equal(t, self.first_expected)


def to_device(cfg, wire_np: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(wire_np.reshape(cfg.device_wire_shape)).to(DEV)


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]}: {name}, "
        f"{torch.cuda.device_count()} visible")
    log(smi)
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    so = _build.build("detect_power")
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    log(_build.build_log("detect_power").strip())


def kernel_vs_plain(cfg, wire_np, qw) -> dict:
    x, time_major = gemm._prepare_wire(to_device(cfg, wire_np), cfg)
    out_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, time_major)[0]
    out_p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg,
                                    time_major)[0]
    torch.cuda.synchronize()
    max_abs = float((out_k - out_p).abs().max())
    finite = bool(torch.isfinite(out_k).all())
    rel = relative_power_error(out_k.cpu().numpy(), out_p.cpu().numpy())
    log(f"[kernel vs plain] {cfg.name} {tuple(out_k.shape)}: relative power "
        f"error {rel:.3e} (tol {KERNEL_VS_PLAIN_RTOL:.0e}), max |diff| "
        f"{max_abs:.6g}, finite {finite}")
    if not finite or rel > KERNEL_VS_PLAIN_RTOL:
        raise RuntimeError(f"kernel disagrees with its plain version at "
                           f"{cfg.name}: {rel:.3e}")
    return {"cfg": cfg.name, "rel_err": rel, "max_abs_err": max_abs}


def phase_physics() -> None:
    cfg = DSA10.replace(n_chan=128, t_block=512)
    angles = cfg.beam_angles_rad()
    wire = make_point_source_block(cfg, angle_rad=angles[TARGET_BEAM],
                                   noise_rms=0.4, seed=7)
    p_ref = beamform_block_ref(weights_numpy_golden(cfg), wire,
                               cfg.input_layout, cfg.navg_time)
    # The ftpa block holds the same voltages, so the golden output is the same.
    for layout, blk in (("tfpa", wire),
                        ("ftpa", np.ascontiguousarray(wire.transpose(1, 0, 2, 3)))):
        c = cfg.replace(input_layout=layout)
        qw = prepare_weights(c, make_weights(c, device=DEV))
        p = gemm.beamform_power(to_device(c, blk), qw, c).cpu().numpy()
        beam = int(np.argmax(p.sum(axis=(0, 1))))
        err = relative_power_error(p, p_ref)
        log(f"[physics] {layout} sub-band {p.shape}: argmax beam {beam} "
            f"(want {TARGET_BEAM}), error vs float64 golden {err:.3e} "
            f"(bar {GOLDEN_RTOL:.0e})")
        if beam != TARGET_BEAM or err > GOLDEN_RTOL or not np.isfinite(p).all():
            raise RuntimeError(f"physics check failed for {layout}")


def time_ms(fn, n: int) -> float:
    """Mean ms per call of ``fn`` over ``n`` back-to-back calls, by CUDA
    events on the current stream."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for i in range(n):
        fn(i)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def phase_resident(cfg, blocks_np, qw, name, smi) -> dict:
    xs = [gemm._prepare_wire(to_device(cfg, b), cfg)[0] for b in blocks_np]
    tm = cfg.input_layout == "tfpa"
    run = lambda i: gemm.fused_detect(xs[i % 2], qw.terms, qw.scales, cfg,
                                      tm)[0]
    for i in range(2):
        run(i)  # warm up
    ms = time_ms(run, N_TIMED)
    plain = lambda i: gemm.detect_power_plain(xs[i % 2], qw.terms, qw.scales,
                                             cfg, tm)[0]
    plain(0)
    plain_ms = time_ms(plain, 2)
    block0 = run(0).cpu()
    macs = cfg.macs_per_block * cfg.n_weight_terms
    util = tensor_core_utilization(macs, ms / 1e3, cfg, name)
    rt = cfg.block_duration_s * 1e3 / ms
    log(f"[resident] {cfg.name} kernel {ms:.3f} ms/block = {rt:.4f}x realtime "
        f"({cfg.block_duration_s * 1e3:.2f} ms of sky), wire "
        f"{cfg.wire_block_bytes / ms / 1e6:.2f} GB/s, int8 tensor-core "
        f"utilization {None if util is None else round(util['issued'], 6)} "
        f"issued ({macs:.4g} MACs/block) on {smi}")
    log(f"[resident] {cfg.name} plain version {plain_ms:.3f} ms/block "
        f"(float32 matmul, TF32 off, 32-channel chunks) = "
        f"{cfg.block_duration_s * 1e3 / plain_ms:.4f}x realtime; "
        f"kernel/plain time {ms / plain_ms:.4f}")
    del xs
    return {"ms": ms, "plain_ms": plain_ms, "block0": block0}


def phase_transfers(cfg, block_np) -> None:
    """One timed pass of each copy the streamed path makes, on its own."""
    pinned = torch.empty(cfg.device_wire_shape, dtype=torch.uint8,
                         pin_memory=True)
    src = torch.from_numpy(block_np.reshape(cfg.device_wire_shape))
    t0 = time.perf_counter()
    pinned.copy_(src)
    host_s = time.perf_counter() - t0
    dev = torch.empty_like(pinned, device=DEV)
    h2d_ms = time_ms(lambda i: dev.copy_(pinned, non_blocking=True), 3)
    out = torch.empty(cfg.out_block_shape, dtype=torch.float32, device=DEV)
    out_host = torch.empty(cfg.out_block_shape, dtype=torch.float32,
                           pin_memory=True)
    d2h_ms = time_ms(lambda i: out_host.copy_(out, non_blocking=True), 3)
    gb = cfg.wire_block_bytes / 1e9
    ob = out.numel() * 4 / 1e9
    log(f"[transfers] {cfg.name} host->pinned {gb / host_s:.2f} GB/s "
        f"({host_s * 1e3:.1f} ms, {torch.get_num_threads()} threads), H2D "
        f"{gb / h2d_ms * 1e3:.2f} GB/s ({h2d_ms:.1f} ms), D2H "
        f"{ob / d2h_ms * 1e3:.2f} GB/s ({d2h_ms:.1f} ms for {ob:.3f} GB); "
        f"1x realtime needs {cfg.realtime_bytes_per_s / 1e9:.2f} GB/s in")


def phase_stream(cfg, blocks_np, qw, block0, smi) -> int:
    sink = ChecksumSink(block0)
    src = SyntheticSource(cfg, blocks_np, n_blocks=N_STREAM)
    bf = StreamingBeamformer(cfg, qw, src, sink, depth=2)
    bf.warmup()
    gemm.fused_detect.launches.clear()      # count the main path's run only
    stats = bf.run()
    launches = gemm.fused_detect.launches["base"]
    if sum(gemm.fused_detect.launches.values()) != launches:
        raise RuntimeError(f"the power-only stream launched other variants: "
                           f"{dict(gemm.fused_detect.launches)}")
    rec = stats.record(cfg)
    log(f"[stream] {json.dumps(rec)}")
    log(f"[stream] {cfg.name} {stats.n_blocks} blocks, depth {bf.depth}, "
        f"{bf.n_slots} pinned staging slots: {rec['realtime_factor']:.4f}x "
        f"realtime incl. host staging, H2D, kernel, D2H and sink "
        f"({stats.wall_s * 1e3 / stats.n_blocks:.2f} ms/block), dropped "
        f"{stats.dropped}, kernel launches {launches} on {smi}")
    if stats.n_blocks != N_STREAM or launches != N_STREAM:
        raise RuntimeError(f"streamed {stats.n_blocks} blocks with {launches} "
                           f"kernel launches, want {N_STREAM}")
    if stats.dropped or [s for s, _ in sink.sums] != list(range(N_STREAM)):
        raise RuntimeError(f"dropped {stats.dropped}, sequence "
                           f"{[s for s, _ in sink.sums]}")
    if not all(np.isfinite(v) for _, v in sink.sums):
        raise RuntimeError("non-finite checksum in the streamed output")
    if not sink.first_equal:
        raise RuntimeError("streamed block 0 differs from the resident run's")
    log(f"[stream] block 0 equals the resident output; checksums "
        f"{[round(v, 1) for _, v in sink.sums[:2]]} ...")
    return launches


#: variant -> (quant8, incoherent, sk), in the kernels line's order.
VARIANTS = {
    "base": (False, False, False),
    "sk": (False, False, True),
    "q8": (True, False, False),
    "sk+q8": (True, False, True),
    "inco": (False, True, False),
    "sk+inco": (False, True, True),
    "q8+inco": (True, True, False),
    "sk+q8+inco": (True, True, True),
}
FLAGGED_ANT = 3              # flagged out of the incoherent sum
CARRIER_CHAN = 1234          # channel overwritten by a constant byte
CARRIER_BYTE = 0x77          # re = im = 7: constant power, SK = 0
N_DEPLOYED = 8               # blocks in the deployed stream
H100_INT8_MACS_PER_S = 1979e12 / 2  # dense int8 peak (1,979 TOP/s)
H100_BYTES_PER_S = 3.35e12          # HBM3


def side_kwargs(cfg, variant, f32_out):
    """fused_detect / detect_power_plain keywords of a variant; the 8-bit
    scales put each beam's median near mid-rail 64, spread so the rails
    engage."""
    q8, inco, sk = VARIANTS[variant]
    scales = None
    if q8:
        rng = np.random.default_rng(7)
        med = float(f32_out[:, ::8, ::8].float().median())
        scales = torch.from_numpy((64.0 / med * rng.uniform(
            0.5, 4.0, cfg.n_beams)).astype(np.float32)).to(DEV)
    return dict(quant8_scales=scales,
                inco_mask=(gemm.incoherent_mask(cfg, (FLAGGED_ANT,))
                           if inco else None),
                sk=sk)


def bound_ms(cfg, variant) -> tuple:
    """Least time of one block on an H100 SXM: the larger of its int8 MACs
    over the dense int8 peak and its bytes (wire slots read, weights read,
    outputs written, each once) over the memory rate."""
    q8, inco, sk = VARIANTS[variant]
    f_out, t_out, b = cfg.out_block_shape
    nbytes = (cfg.t_block * cfg.n_chan * cfg.n_pol * cfg.a_compute
              + cfg.n_weight_terms * cfg.n_chan * cfg.gemm_k * 2 * b
              + cfg.n_chan * cfg.n_weight_terms * 4
              + f_out * t_out * b * (1 if q8 else 4)
              + (b * 4 if q8 else 0)
              + (f_out * t_out * 4 if inco else 0)
              + (cfg.n_chan * 2 * cfg.a_compute * 8 if sk else 0))
    ops_ms = cfg.macs_per_block * cfg.n_weight_terms / H100_INT8_MACS_PER_S * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_variant(cfg, x, tm, qw, variant, f32_k, f32_p) -> dict:
    """One variant's kernel output against its plain version on the same
    inputs; raises on any disagreement.  Returns its max abs error (power
    units for float32, counts for uint8) and the plain version's time."""
    kw = side_kwargs(cfg, variant, f32_k)
    out_k, inco_k, sk_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                                            **kw)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out_p, inco_p, sk_p = gemm.detect_power_plain(x, qw.terms, qw.scales,
                                                  cfg, tm, **kw)
    stop.record()
    torch.cuda.synchronize()
    errs = []
    if kw["quant8_scales"] is not None:
        own = gemm.quantize_u8(f32_k, kw["quant8_scales"])
        if not torch.equal(out_k, own):
            raise RuntimeError(f"{cfg.name} {variant}: fused uint8 differs "
                               f"from the rint/clip of the kernel's float32")
        diff = (out_k.int() - out_p.int()).abs()
        same = f32_k == f32_p
        if int(diff.max()) > 1 or bool(diff[same].any()):
            raise RuntimeError(f"{cfg.name} {variant}: uint8 vs plain "
                               f"differs by {int(diff.max())} counts or "
                               f"where the float32 products agree")
        errs.append(float(diff.max()))
        detail = (f"uint8 == rint/clip(kernel f32 x scale) byte for byte; "
                  f"vs plain: {int((diff > 0).sum())} of {diff.numel()} "
                  f"bytes differ by 1, all where the f32 products differ; "
                  f"{int((out_k == 255).sum())} at the 255 rail")
    else:
        rel = relative_power_error(out_k.cpu().numpy(), out_p.cpu().numpy())
        if rel > KERNEL_VS_PLAIN_RTOL or not bool(torch.isfinite(out_k).all()):
            raise RuntimeError(f"{cfg.name} {variant}: f32 product {rel:.3e}")
        errs.append(float((out_k - out_p).abs().max()))
        detail = f"f32 product relative error {rel:.3e}"
    for what, k, p in (("incoherent", inco_k, inco_p), ("SK", sk_k, sk_p)):
        if (k is None) != (p is None):
            raise RuntimeError(f"{cfg.name} {variant}: {what} missing")
        if k is not None:
            if not torch.equal(k, p):
                raise RuntimeError(f"{cfg.name} {variant}: {what} differs "
                                   f"(max {float((k - p).abs().max())})")
            errs.append(0.0)
            detail += f"; {what} {tuple(k.shape)} equal"
    plain_ms = start.elapsed_time(stop)
    log(f"[variants] {cfg.name} {variant}: {detail}; plain {plain_ms:.1f} ms")
    return {"max_abs_err": max(errs), "plain_ms": plain_ms}


def phase_variants(cfg, wire_np, qw, variants) -> dict:
    """Every variant at full width on one random-bytes block."""
    x, tm = gemm._prepare_wire(to_device(cfg, wire_np), cfg)
    f32_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm)[0]
    f32_p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm)[0]
    out = {v: check_variant(cfg, x, tm, qw, v, f32_k, f32_p)
           for v in variants}
    del x, f32_k, f32_p
    return out


def phase_resident_variants(cfg, blocks_np, qw, plain, smi) -> dict:
    """CUDA-event time of each variant, 10 back-to-back launches on two
    resident blocks."""
    xs = [gemm._prepare_wire(to_device(cfg, b), cfg)[0] for b in blocks_np]
    tm = cfg.input_layout == "tfpa"
    f32 = gemm.fused_detect(xs[0], qw.terms, qw.scales, cfg, tm)[0]
    times = {}
    for variant in VARIANTS:
        kw = side_kwargs(cfg, variant, f32)
        run = lambda i: gemm.fused_detect(xs[i % 2], qw.terms, qw.scales,
                                          cfg, tm, **kw)
        run(0)
        times[variant] = time_ms(run, N_TIMED)
    base = times["base"]
    for variant, ms in times.items():
        bnd, by = bound_ms(cfg, variant)
        log(f"[resident] {cfg.name} +{variant}: {ms:.3f} ms/block "
            f"({ms - base:+.3f} vs base) = "
            f"{cfg.block_duration_s * 1e3 / ms:.4f}x realtime; bound "
            f"{bnd:.3f} ms by {by} ({bnd / ms * 100:.2f}%); plain "
            f"{plain[variant]['plain_ms']:.1f} ms, on {smi}")
    del xs, f32
    return times


def with_carrier(cfg, wire_np) -> np.ndarray:
    """The block with channel CARRIER_CHAN's active antennas overwritten by
    a constant byte: a carrier whose spectral kurtosis is 0 (in place)."""
    w = wire_np.reshape(cfg.wire_block_shape)
    if cfg.input_layout == "tfpa":
        w[:, CARRIER_CHAN, :, :cfg.n_ant_active] = CARRIER_BYTE
    else:
        w[CARRIER_CHAN, :, :, :cfg.n_ant_active] = CARRIER_BYTE
    return wire_np


def read_fil_block(path, cfg, k) -> np.ndarray:
    """Block ``k`` of an 8-bit one-IF .fil file: ``[T', F']`` uint8."""
    _, off = read_filterbank_header(path)
    f_out, t_out, _ = cfg.out_block_shape
    with open(path, "rb") as f:
        f.seek(off + k * t_out * f_out)
        return np.frombuffer(f.read(t_out * f_out), np.uint8).reshape(
            t_out, f_out)


def drive_stream(cfg, blocks_np, n_blocks, tmp, *, fil_bits, fil_beams=None,
                 incoherent, rfi, smi):
    """A deployed-style stream: StreamingBeamformer into a FilterbankSink
    (and an incoherent .dada FileSink, and an RFIMonitor whose excisions
    regenerate the weights on the card and swap them in mid-stream), with
    every launch count set to 0 just before the run and read just after."""
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    fil_dir = tmp / f"{cfg.name}-fil{fil_bits}"
    fil = FilterbankSink(fil_dir, cfg, beams=fil_beams, nbits=fil_bits)
    inco = (FileSink(tmp / f"{cfg.name}-inco.dada", cfg,
                     products="incoherent") if incoherent else None)
    drained = []  # host clock at each block's drain
    bf = StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks_np,
                                                      n_blocks),
                             fil, depth=2, incoherent_sink=inco,
                             flag_ants=(FLAGGED_ANT,) if incoherent else (),
                             on_block=lambda bs: drained.append(
                                 time.perf_counter()))
    events, swaps = [], []

    def excise(ev):
        # The CLI's --rfi-auto glue: regenerate on the card with the grown
        # zap set, then swap in without draining the stream.
        events.append(ev)
        if ev["type"] != "excise" or ev.get("final"):
            return
        w = zap_weights(make_weights(cfg, device=DEV), ev["zapped"], cfg)
        bf.update_weights(prepare_weights(cfg, w))
        swaps.append(len(drained))  # the block being drained (0-based)

    if rfi:
        bf.rfi_monitor = RFIMonitor(cfg, interval=2, sample=2,
                                    on_event=excise)
    bf.warmup()
    gemm.fused_detect.launches.clear()      # count the main path's run only
    stats = bf.run()
    launches = dict(gemm.fused_detect.launches)
    fil.close()
    if inco is not None:
        inco.close()
    rec = stats.record(cfg)
    # Steady state: the loop drains block k right after it enqueued block
    # k + 2, so drain-to-drain intervals from block 1 to block n-3 each
    # hold one whole iteration (one staging + dispatch, one drain + write);
    # block 0 carries the sink's auto-calibration and the startup drain,
    # the last two blocks drain after the loop.
    steady_ms = (drained[n_blocks - 3] - drained[1]) / (n_blocks - 4) * 1e3
    log(f"[deployed] {cfg.name} fil{fil_bits}"
        f"{'+inco' if incoherent else ''}{'+rfi' if rfi else ''}: "
        f"{stats.n_blocks} blocks, {rec['realtime_factor']:.4f}x realtime "
        f"streamed ({stats.wall_s * 1e3 / stats.n_blocks:.2f} ms/block, "
        f"incl. host staging, H2D, kernel, D2H and the sinks' writes; "
        f"steady state {steady_ms:.2f} ms/block = "
        f"{cfg.block_duration_s * 1e3 / steady_ms:.4f}x realtime), "
        f"dropped {stats.dropped}, launches {launches}, events "
        f"{[(e['type'], e.get('new')) for e in events]}, weights swapped "
        f"at the drain of block(s) {swaps} on {smi}")
    if stats.n_blocks != n_blocks or stats.dropped:
        raise RuntimeError(f"streamed {stats.n_blocks} of {n_blocks} blocks, "
                           f"dropped {stats.dropped}")
    return {"qw": qw, "fil": fil, "fil_dir": fil_dir, "events": events,
            "swaps": swaps, "launches": launches, "stats": stats}


def expected_launches(n_blocks, *, q8, incoherent, rfi) -> dict:
    """The kernel variants a deployed stream launches: block 0 in float32
    (the sink's auto-calibration), later blocks in uint8; the SK output on
    the monitor's sampling grid (every 2nd block)."""
    want = collections.Counter()
    for k in range(n_blocks):
        want[gemm.variant_name(q8 and k > 0, incoherent,
                               rfi and k % 2 == 0)] += 1
    return dict(want)


def phase_deployed(cfg, blocks_np, smi) -> dict:
    """The deployed path at full width: 8-bit filterbank from the kernel's
    epilogue, incoherent .dada, RFI monitor with mid-stream excision."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        r = drive_stream(cfg, blocks_np, N_DEPLOYED, tmp, fil_bits=8,
                         incoherent=True, rfi=True, smi=smi)
        want = expected_launches(N_DEPLOYED, q8=True, incoherent=True,
                                 rfi=True)
        if r["launches"] != want:
            raise RuntimeError(f"launch pattern {r['launches']}, want {want}")
        ex = [e for e in r["events"] if e["type"] == "excise"]
        if len(r["events"]) != 1 or len(ex) != 1 \
                or ex[0]["new"] != [CARRIER_CHAN]:
            raise RuntimeError(f"want one excise event naming channel "
                               f"{CARRIER_CHAN}, got {r['events']}")
        # Block 1 (uint8, before the swap) against the resident kernel on
        # the same block with the sink's scales and the starting weights.
        scales = r["fil"].fused_quant8_scales(DEV)
        qw = r["qw"]
        x1 = to_device(cfg, blocks_np[1 % len(blocks_np)])
        res_u8, res_inco = gemm.beamform_power(
            x1, qw, cfg, incoherent=True, flag_ants=(FLAGGED_ANT,),
            quant8_scales=scales)
        expect = res_u8.permute(2, 1, 0).flip(2).cpu().numpy()  # [B, T', F']
        col = cfg.n_chan - 1 - CARRIER_CHAN  # descending channel order
        last = N_DEPLOYED - 1
        for b in range(cfg.n_beams):
            path = r["fil_dir"] / f"beam{b:04d}.fil"
            if not np.array_equal(read_fil_block(path, cfg, 1), expect[b]):
                raise RuntimeError(f"beam {b}: .fil block 1 differs from the "
                                   f"resident uint8 output")
            tail = read_fil_block(path, cfg, last)
            if tail[:, col].any() or not tail.any():
                raise RuntimeError(f"beam {b}: carrier channel not zero (or "
                                   f"the block empty) after the swap")
        _, inco = read_product_file(tmp / f"{cfg.name}-inco.dada")
        if inco.shape != (N_DEPLOYED, *cfg.out_block_shape[:2]) \
                or not np.array_equal(inco[1], res_inco.cpu().numpy()):
            raise RuntimeError("incoherent .dada block 1 differs from the "
                               "resident kernel's")
        phase_sink_layout(cfg, res_u8, tmp, smi)
        log(f"[deployed] {cfg.name}: one excise event on channel "
            f"{CARRIER_CHAN}; .fil block 1 equals the resident uint8 "
            f"output (transposed, channels flipped) for all {cfg.n_beams} "
            f"beams; channel {CARRIER_CHAN} is 0 in block {last} of every "
            f"beam; incoherent .dada {inco.shape} block 1 equal; scales "
            f"median {float(np.median(list(r['fil'].scales.values()))):.6g}")
        del x1, res_u8, res_inco
    return r["launches"]


def phase_sink_layout(cfg, u8_dev, tmp, smi) -> None:
    """One uint8 block into a 256-beam 8-bit FilterbankSink, laid out on
    the host (per-beam strided gathers, as the JAX package's sink does) and
    on the device before the D2H copy (one contiguous slab per beam); the
    files must be equal."""
    host_block = u8_dev.cpu().numpy()
    secs = {}
    for how in ("host", "device"):
        sink = FilterbankSink(tmp / f"layout-{how}", cfg, nbits=8, scale=1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "host":
            sink.write(0, host_block)
        else:
            sink.write_beams(0, sink.device_layout(u8_dev).cpu().numpy())
        secs[how] = time.perf_counter() - t0
        sink.close()
    for b in (0, cfg.n_beams // 2, cfg.n_beams - 1):
        name = f"beam{b:04d}.fil"
        if (tmp / "layout-host" / name).read_bytes() != \
                (tmp / "layout-device" / name).read_bytes():
            raise RuntimeError(f"{name}: host and device layouts differ")
    log(f"[sink] {cfg.name} one uint8 block into {cfg.n_beams} .fil files: "
        f"host layout {secs['host'] * 1e3:.1f} ms, device layout + D2H + "
        f"contiguous writes {secs['device'] * 1e3:.1f} ms, same bytes, on "
        f"{smi}")


def phase_other_deployments(cfg, blocks_np, smi) -> collections.Counter:
    """dsa10c deployments that launch the variants the full one does not:
    8-bit filterbank + RFI monitor without the incoherent file (sk, q8,
    sk+q8), and a 32-bit one-beam filterbank with the incoherent file
    (inco)."""
    total = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for kw in (dict(fil_bits=8, incoherent=False, rfi=True),
                   dict(fil_bits=32, fil_beams=[TARGET_BEAM],
                        incoherent=True, rfi=False)):
            r = drive_stream(cfg, blocks_np, 6, tmp, smi=smi, **kw)
            want = expected_launches(6, q8=kw["fil_bits"] == 8,
                                     incoherent=kw["incoherent"],
                                     rfi=kw["rfi"])
            if r["launches"] != want:
                raise RuntimeError(f"launch pattern {r['launches']}, "
                                   f"want {want}")
            if kw["rfi"] and [e.get("new") for e in r["events"]] \
                    != [[CARRIER_CHAN]]:
                raise RuntimeError(f"events {r['events']}")
            total.update(r["launches"])
    return total


def main() -> None:
    name, smi = phase_device()
    phase_build()

    cfg = DSA10
    t0 = time.perf_counter()
    blocks = [make_random_bytes_block(cfg, seed=s) for s in (0, 1)]
    log(f"[data] two {cfg.name} blocks {cfg.wire_block_shape} "
        f"({cfg.wire_block_bytes / 1e9:.3f} GB each) in "
        f"{time.perf_counter() - t0:.1f} s")
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    cmp_full = kernel_vs_plain(cfg, blocks[0], qw)
    cc = DSA10_COMPACT
    cc_block = make_random_bytes_block(cc, seed=2)
    cc_qw = prepare_weights(cc, make_weights(cc, device=DEV))
    kernel_vs_plain(cc, cc_block, cc_qw)
    phase_physics()
    res = phase_resident(cfg, blocks, qw, name, smi)
    phase_transfers(cfg, blocks[0])
    launches = collections.Counter(
        base=phase_stream(cfg, blocks, qw, res["block0"], smi))

    # The deployed path's variants, kernel against plain, then timed.
    checked = phase_variants(cfg, blocks[0], qw,
                             [v for v in VARIANTS if v != "base"])
    checked["base"] = {"max_abs_err": cmp_full["max_abs_err"],
                       "plain_ms": res["plain_ms"]}
    phase_variants(cc, cc_block, cc_qw, ["q8", "inco", "sk", "sk+q8+inco"])
    times = phase_resident_variants(cfg, blocks, qw, checked, smi)
    times["base"] = res["ms"]
    del qw, cc_qw

    # The deployed streams (each driven with the counts set to 0).
    for b in blocks:
        with_carrier(cfg, b)
    launches.update(phase_deployed(cfg, blocks, smi))
    del blocks
    cc_blocks = [with_carrier(cc, cc_block),
                 with_carrier(cc, make_random_bytes_block(cc, seed=3))]
    launches.update(phase_other_deployments(cc, cc_blocks, smi))
    missing = [v for v in VARIANTS if not launches[v]]
    if missing:
        raise RuntimeError(f"variants never launched on a main path: "
                           f"{missing}")

    kernels = []
    for variant in VARIANTS:
        bnd, by = bound_ms(cfg, variant)
        kernels.append({
            "name": "detect_power" + ("" if variant == "base"
                                      else f"+{variant}"),
            "route": "cuda",
            "source": "dsabeamformer_tpu_torch/csrc/detect_power.cu",
            "replaces": "dsabeamformer_tpu/ops/gemm.py:775",
            "launches": launches[variant],
            "max_abs_err": checked[variant]["max_abs_err"],
            "ms": times[variant],
            "plain_ms": checked[variant]["plain_ms"],
            "bound_ms": bnd,
            "bound_by": by,
            "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
