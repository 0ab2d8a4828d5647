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

The last two lines are a JSON record of the kernels and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import DSA10, DSA10_COMPACT
from dsabeamformer_tpu_torch.ingest.generator import (
    make_point_source_block,
    make_random_bytes_block,
)
from dsabeamformer_tpu_torch.models.weights import make_weights, weights_numpy_golden
from dsabeamformer_tpu_torch.ops import _build, gemm
from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
from dsabeamformer_tpu_torch.ops.reference import beamform_block_ref
from dsabeamformer_tpu_torch.pipeline import StreamingBeamformer, SyntheticSource
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
    out_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, time_major)
    out_p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, time_major)
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
    run = lambda i: gemm.fused_detect(xs[i % 2], qw.terms, qw.scales, cfg, tm)
    for i in range(2):
        run(i)  # warm up
    ms = time_ms(run, N_TIMED)
    plain = lambda i: gemm.detect_power_plain(xs[i % 2], qw.terms, qw.scales,
                                             cfg, tm)
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
    gemm.fused_detect.launches = 0          # count the main path's run only
    stats = bf.run()
    launches = gemm.fused_detect.launches
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
    kernel_vs_plain(cc, make_random_bytes_block(cc, seed=2),
                    prepare_weights(cc, make_weights(cc, device=DEV)))
    phase_physics()
    res = phase_resident(cfg, blocks, qw, name, smi)
    phase_transfers(cfg, blocks[0])
    launches = phase_stream(cfg, blocks, qw, res["block0"], smi)

    log(json.dumps({"kernels": [{
        "name": "detect_power",
        "route": "cuda",
        "source": "dsabeamformer_tpu_torch/csrc/detect_power.cu",
        "replaces": "dsabeamformer_tpu/ops/gemm.py:775",
        "launches": launches,
        "max_abs_err": cmp_full["max_abs_err"],
        "ms": res["ms"],
        "plain_ms": res["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
