#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (each passes or raises; any failure exits non-zero with no result):

1. device   -- a CUDA card is required; prints its name and
               ``nvidia-smi --query-gpu=name,power.limit``.
2. build    -- compiles the two CUDA sources (detect_power, every weight
               mode's detect kernel; beam_voltages, every mode's voltage
               kernel; both on the tensor cores through mma_gemm.cuh) with
               nvcc for sm_90a from the checkout, one nvcc each, started
               together, and prints ``ptxas -v``.
3. kernel vs plain -- at the full DSA10 preset (and the dsa10c compact
               wire), on one random-bytes block: the CUDA kernel against its
               plain PyTorch version on the same inputs, relative power error
               <= 1e-5 (identical integers; only f32 summation order differs).
4. physics  -- DSA-10 sub-band (128 channels, 512 samples), point source at
               beam 100, tfpa and ftpa: argmax beam 100 and <= 1e-3 against
               the float64 golden model.
5. device-resident rate -- two resident DSA10 blocks, back-to-back kernel
               launches timed with CUDA events, beside the plain version; the
               int8x2 kernel must take less than ``DSA10_BASE_LIMIT_MS``.
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
11. stokes variants -- the 8 Stokes variants of the detect kernel (``stokes``
               and its q8 / inco / sk combinations) against the plain
               version at full dsa10 on one random-bytes block: each plane
               <= 1e-5 of the I-plane peak, the I plane equal to the power
               kernel's output to the bit, incoherent and SK equal, uint8
               byte-equal to the rint/clip of the kernel's own float32 times
               the scales plus the Q/U/V offset and within 1 count of the
               plain version's, only where the float32 values differ.
12. stokes physics -- the sub-band point source at beam 100, tfpa and ftpa:
               the I plane's argmax is beam 100, each plane <= 1e-3 of the I
               peak against the float64 golden; with the Y-pol bytes zeroed,
               Q == I and U == V == 0 exactly.
13. resident stokes -- CUDA-event time of each Stokes variant at dsa10.
14. stokes deployed -- dsa10, 6 blocks with the carrier channel:
               StreamingBeamformer(products="stokes") -> 8-bit 4-IF
               FilterbankSink for 64 beams (beam 100 among them), incoherent
               .dada, RFIMonitor(interval=2, sample=2) with the excise-and-
               swap handler; checks the launch pattern, one excise event,
               nifs 4, ``__quv_offset__`` 128, block 1 of every file equal to
               the resident uint8 Stokes output laid out, the carrier's
               I = 0 and Q/U/V = 128 after the swap, 0 dropped.
15. stokes deployments -- dsa10c, 6 blocks each: 8-bit Stokes .fil + RFI
               monitor, a one-beam 32-bit Stokes .fil with the incoherent
               file, and one without: every Stokes variant is launched on a
               main path.
16. voltages -- the 128-channel dsa10 sub-band at full per-channel width
               (t_block 8192, tfpa) through beamform_voltages, the unfused
               validation path: the kernel equal to its plain version to the
               bit, its voltages detected and averaged within 1e-5 of
               beamform_power, their Stokes parameters within 1e-5 of the I
               peak of beamform_stokes; timed beside its bound and the store
               ceiling (CUDA-event time of ``zero_()`` on the same 4.3 GB
               output tensor: what the byte bound is worth in practice).
17. (no phase: ``bound_ms`` bounds every weight mode, f32 by the lesser of
               its two routes, and phases 23-28 measure the modes other
               than int8x2.)

DSA-110 (a_compute 128: 110 active antennas in 128 slots, 512 beams): eight
k32 steps a sub-term in the tensor-core detect and voltage kernels:

18. dsa110 kernel vs plain -- one random-bytes block at the full DSA110
               preset: base, sk+q8+inco, stokes, stokes+sk+q8+inco against
               the plain version (antenna 77 flagged: the mask's third
               word), with the bars of phases 7 and 11.
19. dsa110 physics -- a 128-channel, 512-sample sub-band point source at
               beam 300, tfpa and ftpa: argmax and <= 1e-3 against the
               float64 golden, power and Stokes (and the pure-X case).
20. dsa110 resident -- CUDA-event times of those four variants on two
               resident full-band blocks, beside their bounds and plain times.
21. dsa110 streams -- the per-GPU deployment DSA110.subband(0, 256): a plain
               power and a plain Stokes stream (6 blocks each, checksum
               sink, block 0 equal to the resident output); the deployed
               stream (8 blocks with a carrier in channel 210: 8-bit .fil
               for all 512 beams, incoherent .dada with antenna 77 flagged,
               RFIMonitor(interval=2, sample=2) with the excise-and-swap
               handler), checked as phase 9; and the deployed Stokes stream
               (6 blocks, 64 beams of 8-bit 4-IF .fil), checked as phase 14.
22. dsa110 voltages -- a 128-channel DSA-110 sub-band (t_block 4096) through
               beamform_voltages, checked and timed as phase 16 (the other
               six modes' in phase 27).

The weight modes int8, int12, int13, bf16, bf16x2 and f32
(``cfg.weight_mode``; int8x2 is the mode of every phase above), at full dsa10
width, int13 at its own a_compute 16.  One tensor-core kernel runs them all:
wgmma s8 for the int8 modes, wgmma bf16 into float32 sums for the float ones
(f32 as three exact bf16 parts of each weight):

23. modes   -- per mode, on one full block: all 16 variants against the
               plain version (float32 <= 1e-5 of the peak; the Stokes I
               plane equal to the power output; uint8 byte-equal to the
               rint/clip of the kernel's own float32 and within 1 count of
               the plain version's; incoherent and SK equal), then the
               CUDA-event time of base, sk+q8+inco, stokes and
               stokes+sk+q8+inco on two resident blocks beside its bound
               (f32: the lesser of fmaf on the CUDA cores and three bf16
               passes; each route's bound on the ``[modes]`` line) and the
               issued share of the operand type's tensor-core peak (f32
               counted as three bf16 passes).  Each float mode's base time
               must be under ``FLOAT_BASE_LIMIT_MS``.
    f32 split -- the f32 split control, at dsa10 and dsa110 width: on a
               block where each voltage meets one product (one antenna, its
               im nibbles 0, one sample an output), the f32 kernel within
               ``F32_SPLIT_RTOL`` of its plain version, and bf16x2's kernel
               on the first two of the three bf16 parts of each weight
               outside it: the third part reaches the product.
24. modes physics -- per mode, the 128-channel sub-band: the point source's
               argmax at beam 100 (error against the float64 golden within
               the mode's point-source bar, f32 1e-4), and a calibrated noise
               block
               within the JAX package's bar for the mode (int13 5e-4, int12
               8e-4, int8 2e-2, bf16x2 2e-4, bf16 1e-2, f32 1e-5: a TF32
               product anywhere would miss f32's by three orders).
25. modes stream -- StreamingBeamformer with DSA10.replace(weight_mode=m):
               int12 power-only (6 blocks), int13 deployed (6 blocks: 8-bit
               .fil x256, incoherent .dada, the RFI monitor excising the
               carrier, so the weights are re-quantized in int13 mid-stream),
               int8, bf16x2, bf16 and f32 power-only (3 blocks each); 0 dropped,
               launches counted per mode; a mode never launched on a stream
               fails the run.
26. modes voltages -- per mode the 128-channel sub-band through
               beamform_voltages: equal to the plain version for int12 and
               int13, within 1e-5 of the largest voltage for the float modes;
               the fused products within 1e-5 of the detected voltages.
27. dsa110 modes -- int8, int12, int13 (a_compute 112), bf16, bf16x2 and
               f32 (on its 32-beam tile) at full DSA-110 width: base,
               sk+q8+inco, stokes, stokes+sk+q8+inco against plain and
               timed; bf16's base must be under
               ``FLOAT_BASE_LIMIT_MS``; then the f32 split control; and
               each mode's voltages on the 128-channel DSA-110 sub-band,
               checked and timed as phase 16.
28. dsa110 mode streams -- DSA110.subband(0, 256) power-only in int12 (6
               blocks), int13 (4), int8, bf16, bf16x2 and f32 (3: start-up
               included, not a steady rate).

Widths and shapes off the presets (the tensor-core kernel walks K in steps of
32 bytes and pads what does not fill one):

29. widths  -- a_compute 24, 40 and 112 on a 128-channel sub-band, int8x2,
               int13, bf16x2 and f32, base and stokes+sk+q8+inco, tfpa and
               ftpa, kernel
               against plain with the bars of phases 7 and 11; a_compute 24
               in all seven modes through the detect and the voltage kernels;
               and the ten random geometries of
               ``utils.testing.random_geometry`` (8-32 antennas, 8-32 beams,
               navg_time 2-16, one to three windows, both layouts, five
               modes) against the plain version and the float64 golden,
               and through the voltage kernel against its plain version.

The ring ingest and the live search (PR 10 of the port):

30. ring    -- reads ``shutil.disk_usage("/dev/shm")`` and takes the widest of
               dsa10, dsa10c, ``DSA110.subband(0, 256)`` (else a dsa10c
               channel subband) whose depth + 2 slots fit, and logs which and
               why.  A capture process (``multiprocessing`` spawn) creates the
               ring with the port's ``RingBuffer``, commits the stream header
               and writes the two blocks in turn, waiting for room; the
               power-only stream (12 blocks) and the deployed stream (8:
               8-bit .fil of every beam, incoherent .dada, the RFI monitor
               excising the carrier) read it through ``RingSource`` on the
               pinned route (slots registered with ``cudaHostRegister``, H2D
               straight from the slot) and must equal the same blocks through
               ``SyntheticSource`` (word sums of every product block and
               blocks 0-1 bit for bit; every file byte for byte), with 0
               dropped and 0 skipped; each route's ms/block, the time spent
               waiting for the producer, and the producer's copy rate are
               logged; a third run paced at 1x real time reports its drops.
31. search  -- a second capture process (started after phase 6, so that it
               makes its block while the card is busy) writes the
               ``make_dispersed_pulse_block`` block (DM 50 towards beam 100,
               carrier included) ten times into a dsa10c ring; the deployed
               stream reads it with a ``SearchMonitor`` attached (method conv,
               trials to DM 100, chunk 4096, a 32-beam set holding beam 100,
               coincidence on): the pulse must be found in beam 100, within
               one trial of DM 50 and within the widest boxcar of its arrival;
               then the offline search (method direct) of four beams' .fil
               files must find it too; then each dedispersion kernel against
               its plain version on the monitor's first window (bit-equal),
               timed over 10 launches, with its bound.

Each streamed phase, and the voltage paths, set the launch counts to 0 just
before their run and read them just after.  The last two lines are a JSON
record of the kernels (launches on the main paths, max error against the
plain version, times, the bound, and for the detect rows the instruction
their products run on under ``mma``, ``wgmma`` for every mode; the DSA-110
rows carry ``[dsa110]``, the
rows of phases 23-28 their mode, as ``detect_power[int12]``, with their
variants under ``variants``; each voltage row its store ceiling under
``store_ceiling_ms``) and ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import json
import multiprocessing
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import DSA10, DSA10_COMPACT, DSA110
from dsabeamformer_tpu_torch.ingest import dada
from dsabeamformer_tpu_torch.ingest.generator import (
    make_dispersed_pulse_block,
    make_noise_block,
    make_point_source_block,
    make_random_bytes_block,
)
from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
from dsabeamformer_tpu_torch.ingest.dada import read_product_file
from dsabeamformer_tpu_torch.ingest.sigproc import (
    FilterbankSink,
    read_filterbank_header,
)
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import (
    make_weights,
    weights_numpy_golden,
    zap_weights,
)
from dsabeamformer_tpu_torch.ops import _build, gemm
from dsabeamformer_tpu_torch.ops.dedisperse import (
    DEFAULT_WIDTHS,
    KERNEL_SOURCE as DEDISPERSE_SOURCE,
    SearchMonitor,
    _bank,
    _cluster,
    _conv_auto_n_sub,
    _conv_plan,
    _padded_columns,
    _snr_topk,
    _table,
    _threshold_points,
    dedisperse_direct,
    dedisperse_direct_plain,
    dm_trial_grid,
    search_spectrograms,
    subband_stage1,
    subband_stage1_plain,
    subband_stage2,
    subband_stage2_plain,
)
from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
from dsabeamformer_tpu_torch.ops.reference import (
    beamform_block_ref,
    beamform_stokes_ref,
)
from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor
from dsabeamformer_tpu_torch.pipeline import (
    FileSink,
    RingSource,
    StreamingBeamformer,
    SyntheticSource,
)
from dsabeamformer_tpu_torch.utils.metrics import tensor_core_utilization
from dsabeamformer_tpu_torch.utils.testing import (
    F32_SPLIT_RTOL,
    FUZZ_RTOL,
    one_product_block,
    random_geometry,
    relative_power_error,
)

KERNEL_VS_PLAIN_RTOL = 1e-5  # same integers in both; f32 summation order only
GOLDEN_RTOL = 1e-3           # the accuracy bar against the float64 golden
TARGET_BEAM = 100
N_TIMED = 10                 # back-to-back launches in the resident timing
N_STREAM = 12                # blocks in the streamed run
#: The int8x2 detect kernel at full dsa10 width must be faster than this:
#: half of the 37.49 ms its dp4a predecessor took on an H100 80GB HBM3 at
#: 700 W (kernel times moved <= 1.4 % between runs and machines).
DSA10_BASE_LIMIT_MS = 18.7
#: The float modes' detect kernel (base variant, resident) must be faster
#: than this: a quarter of the time of its fmaf predecessor on an H100 80GB
#: HBM3 at 700 W (88.183 / 155.374 / 88.247 ms at dsa10, 615.772 ms for
#: bf16 at dsa110).
FLOAT_BASE_LIMIT_MS = {("dsa10", "bf16"): 22.0, ("dsa10", "bf16x2"): 38.8,
                       ("dsa10", "f32"): 22.1, ("dsa110", "bf16"): 154.0}
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


KERNEL_SOURCES = gemm.KERNEL_SOURCES + (DEDISPERSE_SOURCE,)


def phase_build() -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        libs = list(ex.map(_build.build, KERNEL_SOURCES))
    log(f"[build] {[so.name for so in libs]} in "
        f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for name in KERNEL_SOURCES:
        text = _build.build_log(name)
        log(text.strip())
        regs = [int(w.split()[0]) for w in text.split("Used ")[1:]]
        spills = sum("0 bytes spill stores, 0 bytes spill loads" not in ln
                     for ln in text.splitlines() if "spill" in ln)
        log(f"[build] {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, {spills} with spills")


def tag(cfg) -> str:
    """The configuration's name, with its weight mode where that is not the
    default."""
    return cfg.name if cfg.weight_mode == "int8x2" \
        else f"{cfg.name}[{cfg.weight_mode}]"


def relative_power_error_on_card(p, p_ref) -> float:
    """``utils.testing.relative_power_error`` of two tensors on the card, in
    float64 there (the host takes seconds for a 1 GB block)."""
    scale = float(p_ref.abs().max())
    worst = 0.0
    for a, b in zip(p.split(64), p_ref.split(64)):
        b = b.double()
        denom = torch.clamp_min(b.abs(), 1e-3 * scale)
        worst = max(worst, float(((a.double() - b).abs() / denom).max()))
    return worst


def kernel_vs_plain(cfg, wire_np, qw) -> dict:
    x, time_major = gemm._prepare_wire(to_device(cfg, wire_np), cfg)
    out_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, time_major)[0]
    out_p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg,
                                    time_major)[0]
    torch.cuda.synchronize()
    max_abs = float((out_k - out_p).abs().max())
    finite = bool(torch.isfinite(out_k).all())
    rel = relative_power_error_on_card(out_k, out_p)
    log(f"[kernel vs plain] {cfg.name} {tuple(out_k.shape)}: relative power "
        f"error {rel:.3e} (tol {KERNEL_VS_PLAIN_RTOL:.0e}), max |diff| "
        f"{max_abs:.6g}, finite {finite}")
    if not finite or rel > KERNEL_VS_PLAIN_RTOL:
        raise RuntimeError(f"kernel disagrees with its plain version at "
                           f"{cfg.name}: {rel:.3e}")
    return {"cfg": cfg.name, "rel_err": rel, "max_abs_err": max_abs}


def phase_physics(cfg=DSA10.replace(n_chan=128, t_block=512),
                  target=TARGET_BEAM, bar=GOLDEN_RTOL) -> None:
    """A sub-band point source at beam ``target``, tfpa and ftpa, against
    the float64 golden model."""
    angles = cfg.beam_angles_rad()
    wire = make_point_source_block(cfg, angle_rad=angles[target],
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
        log(f"[physics] {tag(cfg)} {layout} sub-band {p.shape}: argmax beam "
            f"{beam} (want {target}), error vs float64 golden {err:.3e} "
            f"(bar {bar:.0e})")
        if beam != target or err > bar or not np.isfinite(p).all():
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
    if cfg.name == "dsa10" and cfg.weight_mode == "int8x2" \
            and ms >= DSA10_BASE_LIMIT_MS:
        raise RuntimeError(f"the int8x2 detect kernel took {ms:.3f} ms at "
                           f"dsa10, not below {DSA10_BASE_LIMIT_MS} ms")
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


def clear_launches() -> None:
    """Every launch count of the detect kernels to 0."""
    gemm.fused_detect.launches.clear()
    gemm.fused_detect.launches_by_mode.clear()


def phase_stream(cfg, blocks_np, qw, block0, smi, n_blocks=N_STREAM,
                 products="power") -> int:
    """StreamingBeamformer over ``n_blocks`` blocks into the checksum sink:
    only the product's plain variant (``base`` or ``stokes``) launches,
    once per block, and block 0 equals ``block0`` (the resident kernel's
    output for it)."""
    sink = ChecksumSink(block0)
    src = SyntheticSource(cfg, blocks_np, n_blocks=n_blocks)
    bf = StreamingBeamformer(cfg, qw, src, sink, depth=2, products=products)
    bf.warmup()
    clear_launches()                        # count the main path's run only
    stats = bf.run()
    variant = "stokes" if products == "stokes" else "base"
    launches = gemm.fused_detect.launches_by_mode[(cfg.weight_mode, variant)]
    if sum(gemm.fused_detect.launches.values()) != launches:
        raise RuntimeError(f"the {products} stream launched other variants "
                           f"or modes: "
                           f"{dict(gemm.fused_detect.launches_by_mode)}")
    rec = stats.record(cfg)
    log(f"[stream] {json.dumps(rec)}")
    short = n_blocks <= 4  # start-up is a large share of the wall time
    log(f"[stream] {tag(cfg)} {products} {stats.n_blocks} blocks, depth "
        f"{bf.depth}, {bf.n_slots} pinned staging slots: "
        f"{rec['realtime_factor']:.4f}x realtime incl. host staging, H2D, "
        f"kernel, D2H and sink ({stats.wall_s * 1e3 / stats.n_blocks:.2f} "
        f"ms/block{', start-up included: not a steady rate' if short else ''}"
        f"), dropped {stats.dropped}, kernel launches {launches} on {smi}")
    if stats.n_blocks != n_blocks or launches != n_blocks:
        raise RuntimeError(f"streamed {stats.n_blocks} blocks with {launches} "
                           f"kernel launches, want {n_blocks}")
    if stats.dropped or [s for s, _ in sink.sums] != list(range(n_blocks)):
        raise RuntimeError(f"dropped {stats.dropped}, sequence "
                           f"{[s for s, _ in sink.sums]}")
    if not all(np.isfinite(v) for _, v in sink.sums):
        raise RuntimeError("non-finite checksum in the streamed output")
    if not sink.first_equal:
        raise RuntimeError("streamed block 0 differs from the resident run's")
    log(f"[stream] block 0 equals the resident output; checksums "
        f"{[round(v, 1) for _, v in sink.sums[:2]]} ...")
    return launches


#: power variant -> (quant8, incoherent, sk), in the kernels line's order.
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
#: Stokes variant -> (quant8, incoherent, sk): "stokes", "stokes+sk", ...
STOKES_VARIANTS = {gemm.variant_name(*flags, stokes=True): flags
                   for flags in VARIANTS.values()}
ALL_VARIANTS = {**VARIANTS, **STOKES_VARIANTS}
FLAGGED_ANT = 3              # flagged out of the incoherent sum (DSA-10)
FLAGGED_ANT_WIDE = 77        # DSA-110: a bit in the mask's third word
CARRIER_CHAN = 1234          # channel overwritten by a constant byte
CARRIER_BYTE = 0x77          # re = im = 7: constant power, SK = 0
N_DEPLOYED = 8               # blocks in the deployed stream
H100_INT8_MACS_PER_S = 1979e12 / 2  # dense int8 peak (1,979 TOP/s)
H100_BF16_MACS_PER_S = 989e12 / 2   # dense bf16 peak (989 TFLOP/s)
H100_F32_MACS_PER_S = 67e12 / 2     # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12          # HBM3


def flagged_ant(cfg) -> int:
    """The antenna flagged out of the incoherent sum: 77 where it is active
    (DSA-110; the mask's upper words), else 3."""
    return FLAGGED_ANT_WIDE if cfg.n_ant_active > FLAGGED_ANT_WIDE \
        else FLAGGED_ANT


def carrier_chan(cfg) -> int:
    """The carrier channel: 1234 of a full band, 1234 mod n_chan of a
    sub-band (210 of 256)."""
    return CARRIER_CHAN % cfg.n_chan


def side_kwargs(cfg, variant, f32_out):
    """fused_detect / detect_power_plain keywords of a variant; the 8-bit
    scales put each beam's median (of the power or Stokes-I plane) near
    mid-rail 64, spread so the rails engage."""
    q8, inco, sk = ALL_VARIANTS[variant]
    stokes = variant in STOKES_VARIANTS
    scales = None
    if q8:
        rng = np.random.default_rng(7)
        plane = f32_out[:, :, 0] if stokes else f32_out
        med = float(plane[:, ::8, ::8].float().median())
        scales = torch.from_numpy((64.0 / med * rng.uniform(
            0.5, 4.0, cfg.n_beams)).astype(np.float32)).to(DEV)
    return dict(quant8_scales=scales,
                inco_mask=(gemm.incoherent_mask(cfg, (flagged_ant(cfg),))
                           if inco else None),
                sk=sk, stokes=stokes)


#: Peak MAC rate for the operand type of each weight mode, and the bytes of
#: one element of its terms.
MODE_PEAK_MACS_PER_S = {
    "int8": H100_INT8_MACS_PER_S, "int8x2": H100_INT8_MACS_PER_S,
    "int12": H100_INT8_MACS_PER_S, "int13": H100_INT8_MACS_PER_S,
    "bf16": H100_BF16_MACS_PER_S, "bf16x2": H100_BF16_MACS_PER_S,
    "f32": H100_F32_MACS_PER_S}
TERM_ITEM_BYTES = {"bf16": 2, "bf16x2": 2, "f32": 4}


def weight_bytes(cfg) -> int:
    """Bytes of the weight terms and scales of ``cfg`` (each read once)."""
    return (cfg.n_weight_terms * cfg.n_chan * cfg.gemm_k * 2 * cfg.n_beams
            * TERM_ITEM_BYTES.get(cfg.weight_mode, 1)
            + cfg.n_chan * cfg.n_weight_terms * 4)


def route_ms(cfg) -> dict:
    """The block's MACs (``cfg.macs_per_block`` per term: the JAX package's
    contraction length for the mode, whatever implements it) over the peak
    of each route the mode's products can take, ms: the dense int8 or
    bfloat16 tensor-core peak for its operand type; for f32 both float32
    on the CUDA cores (``fmaf``) and three bf16 passes on the tensor cores
    (each weight split into three bf16 that sum to it, the detect kernel's
    route)."""
    macs = cfg.macs_per_block * cfg.n_weight_terms
    if cfg.weight_mode == "f32":
        return {"fmaf": macs / H100_F32_MACS_PER_S * 1e3,
                "3 bf16 passes":
                    gemm.F32_PARTS * macs / H100_BF16_MACS_PER_S * 1e3}
    return {"tensor cores":
            macs / MODE_PEAK_MACS_PER_S[cfg.weight_mode] * 1e3}


def ops_ms(cfg) -> float:
    """The least time of the block's MACs: the fastest of ``route_ms``."""
    return min(route_ms(cfg).values())


def routes_text(cfg) -> str:
    """Each route's operations bound, for the log."""
    return ", ".join(f"{k} {v:.3f} ms" for k, v in route_ms(cfg).items())


def bound_ms(cfg, variant) -> tuple:
    """Least time of one block on an H100 SXM in ``cfg.weight_mode``: the
    larger of its MACs over the peak for the operand type (``ops_ms``) and
    its bytes (wire slots read, weights read, outputs written, each once)
    over the memory rate."""
    q8, inco, sk = ALL_VARIANTS[variant]
    planes = 4 if variant in STOKES_VARIANTS else 1
    f_out, t_out, b = cfg.out_block_shape
    nbytes = (cfg.t_block * cfg.n_chan * cfg.n_pol * cfg.a_compute
              + weight_bytes(cfg)
              + f_out * t_out * planes * b * (1 if q8 else 4)
              + (b * 4 if q8 else 0)
              + (f_out * t_out * 4 if inco else 0)
              + (cfg.n_chan * 2 * cfg.a_compute * 8 if sk else 0))
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return (ops_ms(cfg), "operations") if ops_ms(cfg) >= bytes_ms \
        else (bytes_ms, "bytes")


def check_variant(cfg, x, tm, qw, variant, f32_k, f32_p) -> dict:
    """One variant's kernel output against its plain version on the same
    inputs; raises on any disagreement.  Returns its max abs error (power
    units for float32, counts for uint8) and the plain version's time.
    Stokes planes are held against the I-plane peak."""
    kw = side_kwargs(cfg, variant, f32_k)
    stokes = kw["stokes"]
    out_k, inco_k, sk_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                                            **kw)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out_p, inco_p, sk_p = gemm.detect_power_plain(x, qw.terms, qw.scales,
                                                  cfg, tm, **kw)
    stop.record()
    torch.cuda.synchronize()
    if kw["quant8_scales"] is not None:
        offsets = gemm.stokes_offsets(DEV) if stokes else None
        if not torch.equal(out_k, gemm.quantize_u8(f32_k, kw["quant8_scales"],
                                                   offsets)):
            raise RuntimeError(f"{tag(cfg)} {variant}: fused uint8 differs "
                               f"from the rint/clip of the kernel's float32")
        diff = (out_k.int() - out_p.int()).abs()
        same = f32_k == f32_p
        if int(diff.max()) > 1 or bool(((diff > 0) & same).any()):
            raise RuntimeError(f"{cfg.name} {variant}: uint8 vs plain "
                               f"differs by {int(diff.max())} counts or "
                               f"where the float32 products agree")
        err = float(diff.max())
        detail = (f"uint8 == rint/clip(kernel f32 x scale"
                  f"{' + [0,128,128,128]' if stokes else ''}) byte for byte; "
                  f"vs plain: {int((diff > 0).sum())} of {diff.numel()} "
                  f"bytes differ by 1, all where the f32 products differ; "
                  f"{int((out_k == 255).sum())} at the 255 rail")
        if stokes:
            detail += (f"; Q/U/V mean "
                       f"{float(out_k[:, :, 1:].float().mean()):.2f}")
        del diff, same
    else:
        if stokes:
            errs = plane_errors(out_k, out_p)
            bad = max(errs) > KERNEL_VS_PLAIN_RTOL
            detail = ("per-plane max error / I peak " + " ".join(
                f"{n}={e:.2e}" for n, e in zip("IQUV", errs)))
        else:
            rel = relative_power_error_on_card(out_k, out_p)
            bad = rel > KERNEL_VS_PLAIN_RTOL
            detail = f"f32 product relative error {rel:.3e}"
        if bad or not bool(torch.isfinite(out_k).all()):
            raise RuntimeError(f"{cfg.name} {variant}: {detail}")
        err = float((out_k - out_p).abs().max())
    for what, k, p in (("incoherent", inco_k, inco_p), ("SK", sk_k, sk_p)):
        if (k is None) != (p is None):
            raise RuntimeError(f"{cfg.name} {variant}: {what} missing")
        if k is not None:
            if not torch.equal(k, p):
                raise RuntimeError(f"{cfg.name} {variant}: {what} differs "
                                   f"(max {float((k - p).abs().max())})")
            detail += f"; {what} {tuple(k.shape)} equal"
    plain_ms = start.elapsed_time(stop)
    log(f"[{'stokes ' if stokes else ''}variants] {tag(cfg)} {variant}: "
        f"{detail}; plain {plain_ms:.1f} ms")
    return {"max_abs_err": err, "plain_ms": plain_ms}


def phase_variants(cfg, wire_np, qw, variants) -> dict:
    """Every variant at full width on one random-bytes block.  For the
    Stokes variants, the I plane must equal the power kernel's output."""
    x, tm = gemm._prepare_wire(to_device(cfg, wire_np), cfg)
    stokes = variants[0] in STOKES_VARIANTS
    f32_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                              stokes=stokes)[0]
    if stokes:
        power_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm)[0]
        if not torch.equal(f32_k[:, :, 0], power_k):
            raise RuntimeError("Stokes I plane differs from the power "
                               "kernel's output")
        log(f"[stokes variants] {tag(cfg)} {tuple(f32_k.shape)}: the I plane "
            f"equals the power kernel's output bit for bit")
        del power_k
    f32_p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm,
                                    stokes=stokes)[0]
    out = {v: check_variant(cfg, x, tm, qw, v, f32_k, f32_p)
           for v in variants}
    del x, f32_k, f32_p
    return out


def issued_share(cfg, ms) -> str:
    """The MACs the kernel issues per second over the dense tensor-core peak
    for the mode's operand type, as a percentage; f32's are three bf16
    passes against the bf16 peak."""
    macs = cfg.macs_per_block * cfg.n_weight_terms
    if cfg.weight_mode == "f32":
        macs *= gemm.F32_PARTS
        cfg = cfg.replace(weight_mode="bf16")
    util = tensor_core_utilization(macs, ms / 1e3, cfg,
                                   torch.cuda.get_device_name(0))
    return "n/a" if util is None else f"{util['issued'] * 100:.2f}%"


def phase_resident_variants(cfg, blocks_np, qw, plain, smi,
                            variants=VARIANTS, n=N_TIMED) -> dict:
    """CUDA-event time of each variant, ``n`` back-to-back launches on two
    resident blocks."""
    xs = [gemm._prepare_wire(to_device(cfg, b), cfg)[0] for b in blocks_np]
    tm = cfg.input_layout == "tfpa"
    f32 = {}  # product (stokes?) -> its float32 output, for the 8-bit scales
    times = {}
    for variant in variants:
        stokes = variant in STOKES_VARIANTS
        if stokes not in f32:
            f32[stokes] = gemm.fused_detect(xs[0], qw.terms, qw.scales, cfg,
                                            tm, stokes=stokes)[0]
        kw = side_kwargs(cfg, variant, f32[stokes])
        run = lambda i: gemm.fused_detect(xs[i % 2], qw.terms, qw.scales,
                                          cfg, tm, **kw)
        run(0)
        times[variant] = time_ms(run, n)
    base = next(iter(times.values()))
    for variant, ms in times.items():
        bnd, by = bound_ms(cfg, variant)
        log(f"[resident] {tag(cfg)} +{variant}: {ms:.3f} ms/block "
            f"({ms - base:+.3f} vs {next(iter(times))}) = "
            f"{cfg.block_duration_s * 1e3 / ms:.4f}x realtime; bound "
            f"{bnd:.3f} ms by {by} ({bnd / ms * 100:.2f}%); issued share of "
            f"the tensor-core peak {issued_share(cfg, ms)}; plain "
            f"{plain[variant]['plain_ms']:.1f} ms, on {smi}")
    del xs, f32
    return times


def with_carrier(cfg, wire_np) -> np.ndarray:
    """The block with channel carrier_chan(cfg)'s active antennas
    overwritten by a constant byte: a carrier whose spectral kurtosis is 0
    (in place)."""
    w = wire_np.reshape(cfg.wire_block_shape)
    c = carrier_chan(cfg)
    if cfg.input_layout == "tfpa":
        w[:, c, :, :cfg.n_ant_active] = CARRIER_BYTE
    else:
        w[c, :, :, :cfg.n_ant_active] = CARRIER_BYTE
    return wire_np


def read_fil_block(path, cfg, k, nifs=1) -> np.ndarray:
    """Block ``k`` of an 8-bit .fil file: ``[T', F']`` uint8 (one IF) or
    ``[T', nifs, F']``."""
    _, off = read_filterbank_header(path)
    f_out, t_out, _ = cfg.out_block_shape
    n = t_out * nifs * f_out
    with open(path, "rb") as f:
        f.seek(off + k * n)
        blk = np.frombuffer(f.read(n), np.uint8)
    return blk.reshape((t_out, f_out) if nifs == 1 else (t_out, nifs, f_out))


def drive_stream(cfg, blocks_np, n_blocks, tmp, *, fil_bits, fil_beams=None,
                 incoherent, rfi, smi, products="power"):
    """A deployed-style stream of ``products`` (power or Stokes):
    StreamingBeamformer into a FilterbankSink (and an incoherent .dada
    FileSink, and an RFIMonitor whose excisions regenerate the weights on
    the card and swap them in mid-stream), with every launch count set to 0
    just before the run and read just after."""
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    run = f"{cfg.name}-{products}-fil{fil_bits}"
    fil_dir = tmp / run
    fil = FilterbankSink(fil_dir, cfg, beams=fil_beams, nbits=fil_bits,
                         products=products)
    inco = (FileSink(tmp / f"{run}-inco.dada", cfg,
                     products="incoherent") if incoherent else None)
    drained = []  # host clock at each block's drain
    bf = StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks_np,
                                                      n_blocks),
                             fil, depth=2, products=products,
                             incoherent_sink=inco,
                             flag_ants=(flagged_ant(cfg),) if incoherent
                             else (),
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
    clear_launches()                        # count the main path's run only
    stats = bf.run()
    launches = dict(gemm.fused_detect.launches)
    if set(gemm.fused_detect.launches_by_mode) != {
            (cfg.weight_mode, v) for v in launches}:
        raise RuntimeError(f"the stream launched another mode's kernels: "
                           f"{dict(gemm.fused_detect.launches_by_mode)}")
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
    log(f"[{'stokes ' if products == 'stokes' else ''}deployed] "
        f"{tag(cfg)} fil{fil_bits}"
        f"{'' if fil_beams is None else f' ({len(fil_beams)} beams)'}"
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
            "swaps": swaps, "launches": launches, "stats": stats,
            "inco_path": tmp / f"{run}-inco.dada", "steady_ms": steady_ms}


def expected_launches(n_blocks, *, q8, incoherent, rfi,
                      stokes=False) -> dict:
    """The kernel variants a deployed stream launches: block 0 in float32
    (the sink's auto-calibration), later blocks in uint8; the SK output on
    the monitor's sampling grid (every 2nd block)."""
    want = collections.Counter()
    for k in range(n_blocks):
        want[gemm.variant_name(q8 and k > 0, incoherent,
                               rfi and k % 2 == 0, stokes)] += 1
    return dict(want)


def phase_deployed(cfg, blocks_np, smi, n_blocks=N_DEPLOYED,
                   time_sink=True) -> dict:
    """The deployed path at full width: 8-bit filterbank from the kernel's
    epilogue, incoherent .dada, RFI monitor with mid-stream excision."""
    carrier, flag = carrier_chan(cfg), flagged_ant(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        r = drive_stream(cfg, blocks_np, n_blocks, tmp, fil_bits=8,
                         incoherent=True, rfi=True, smi=smi)
        want = expected_launches(n_blocks, q8=True, incoherent=True,
                                 rfi=True)
        if r["launches"] != want:
            raise RuntimeError(f"launch pattern {r['launches']}, want {want}")
        ex = [e for e in r["events"] if e["type"] == "excise"]
        if len(r["events"]) != 1 or len(ex) != 1 \
                or ex[0]["new"] != [carrier]:
            raise RuntimeError(f"want one excise event naming channel "
                               f"{carrier}, got {r['events']}")
        # Block 1 (uint8, before the swap) against the resident kernel on
        # the same block with the sink's scales and the starting weights.
        scales = r["fil"].fused_quant8_scales(DEV)
        qw = r["qw"]
        x1 = to_device(cfg, blocks_np[1 % len(blocks_np)])
        res_u8, res_inco = gemm.beamform_power(
            x1, qw, cfg, incoherent=True, flag_ants=(flag,),
            quant8_scales=scales)
        expect = res_u8.permute(2, 1, 0).flip(2).cpu().numpy()  # [B, T', F']
        col = cfg.n_chan - 1 - carrier  # descending channel order
        last = n_blocks - 1
        if last < r["swaps"][0] + 3:
            raise RuntimeError(f"the swap at drain {r['swaps']} leaves no "
                               f"block with the new weights")
        for b in range(cfg.n_beams):
            path = r["fil_dir"] / f"beam{b:04d}.fil"
            if not np.array_equal(read_fil_block(path, cfg, 1), expect[b]):
                raise RuntimeError(f"beam {b}: .fil block 1 differs from the "
                                   f"resident uint8 output")
            tail = read_fil_block(path, cfg, last)
            if tail[:, col].any() or not tail.any():
                raise RuntimeError(f"beam {b}: carrier channel not zero (or "
                                   f"the block empty) after the swap")
        _, inco = read_product_file(r["inco_path"])
        if inco.shape != (n_blocks, *cfg.out_block_shape[:2]) \
                or not np.array_equal(inco[1], res_inco.cpu().numpy()):
            raise RuntimeError("incoherent .dada block 1 differs from the "
                               "resident kernel's")
        if time_sink:
            phase_sink_layout(cfg, res_u8, tmp, smi)
        log(f"[deployed] {tag(cfg)}: one excise event on channel "
            f"{carrier}; .fil block 1 equals the resident uint8 "
            f"output (transposed, channels flipped) for all {cfg.n_beams} "
            f"beams; channel {carrier} is 0 in block {last} of every "
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


# --------------------------------------------------------------------- #
# Full Stokes
# --------------------------------------------------------------------- #

N_STOKES_DEPLOYED = 6        # blocks in the Stokes deployed stream
STOKES_FIL_BEAMS = list(range(TARGET_BEAM - 32, TARGET_BEAM + 32))  # 64
QUV_OFFSET = 128


def plane_errors(got, want) -> list:
    """Max abs error of each Stokes plane over the I-plane peak (float64
    on the card)."""
    peak = float(want[:, :, 0].abs().max())
    return [float((got[:, :, k].double() - want[:, :, k].double())
                  .abs().max()) / peak for k in range(4)]


def phase_stokes_physics(cfg=DSA10.replace(n_chan=128, t_block=512),
                         target=TARGET_BEAM) -> None:
    """The sub-band point source through the Stokes kernel, against the
    float64 golden model; then the pure-X case."""
    wire = make_point_source_block(cfg, angle_rad=cfg.beam_angles_rad()[
        target], noise_rms=0.4, seed=7)
    ref = torch.from_numpy(beamform_stokes_ref(
        weights_numpy_golden(cfg), wire, cfg.input_layout, cfg.navg_time))
    for layout, blk in (("tfpa", wire),
                        ("ftpa", np.ascontiguousarray(wire.transpose(1, 0, 2, 3)))):
        c = cfg.replace(input_layout=layout)
        qw = prepare_weights(c, make_weights(c, device=DEV))
        st = gemm.beamform_stokes(to_device(c, blk), qw, c).cpu()
        beam = int(st[:, :, 0].sum(dim=(0, 1)).argmax())
        errs = plane_errors(st, ref)
        log(f"[stokes physics] {cfg.name} {layout} sub-band "
            f"{tuple(st.shape)}: I argmax beam {beam} (want {target}), "
            f"per-plane error / I peak vs "
            f"float64 golden " + " ".join(f"{n}={e:.3e}" for n, e in
                                          zip("IQUV", errs))
            + f" (bar {GOLDEN_RTOL:.0e})")
        if beam != target or max(errs) > GOLDEN_RTOL \
                or not bool(torch.isfinite(st).all()):
            raise RuntimeError(f"Stokes physics check failed for {layout}")
        # Pure X: zero the Y-pol bytes (pol is dim 2 of both 4-D forms).
        x_only = blk.copy()
        x_only[:, :, 1] = 0
        st = gemm.beamform_stokes(to_device(c, x_only), qw, c)
        if float(st[:, :, 0].max()) <= 0 \
                or not torch.equal(st[:, :, 1], st[:, :, 0]) \
                or bool(st[:, :, 2:].any()):
            raise RuntimeError(f"pure-X case: want Q == I and U == V == 0 "
                               f"exactly ({layout})")
        log(f"[stokes physics] {cfg.name} {layout} Y-pol bytes zeroed: "
            f"Q == I and U == V == 0 exactly")


def phase_stokes_deployed(cfg, blocks_np, smi) -> dict:
    """The full-Stokes deployed path at full width: 8-bit 4-IF filterbank
    for 64 beams from the kernel's epilogue, incoherent .dada, RFI monitor
    with mid-stream excision."""
    carrier, flag = carrier_chan(cfg), flagged_ant(cfg)
    n = N_STOKES_DEPLOYED
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        r = drive_stream(cfg, blocks_np, n, tmp, fil_bits=8,
                         fil_beams=STOKES_FIL_BEAMS, incoherent=True,
                         rfi=True, smi=smi, products="stokes")
        want = expected_launches(n, q8=True, incoherent=True, rfi=True,
                                 stokes=True)
        if r["launches"] != want:
            raise RuntimeError(f"launch pattern {r['launches']}, want {want}")
        ex = [e for e in r["events"] if e["type"] == "excise"]
        if len(r["events"]) != 1 or len(ex) != 1 \
                or ex[0]["new"] != [carrier]:
            raise RuntimeError(f"want one excise event naming channel "
                               f"{carrier}, got {r['events']}")
        side = json.loads((r["fil_dir"] / "scales.json").read_text())
        if side.get("__quv_offset__") != QUV_OFFSET:
            raise RuntimeError(f"scales.json __quv_offset__ "
                               f"{side.get('__quv_offset__')}")
        # Block 1 (uint8, before the swap) against the resident kernel on
        # the same block with the sink's scales and the starting weights.
        fil = r["fil"]
        x1 = to_device(cfg, blocks_np[1 % len(blocks_np)])
        res_u8, res_inco = gemm.beamform_stokes(
            x1, r["qw"], cfg, incoherent=True, flag_ants=(flag,),
            quant8_scales=fil.fused_quant8_scales(DEV))
        expect = fil.device_layout(res_u8).cpu().numpy()  # [64, T', 4, F']
        col = cfg.n_chan - 1 - carrier  # descending channel order
        last = n - 1
        if last < r["swaps"][0] + 3:
            raise RuntimeError(f"the swap at drain {r['swaps']} leaves no "
                               f"block with the new weights")
        for i, b in enumerate(STOKES_FIL_BEAMS):
            path = r["fil_dir"] / f"beam{b:04d}.fil"
            if read_filterbank_header(path)[0]["nifs"] != 4:
                raise RuntimeError(f"{path.name}: nifs is not 4")
            if not np.array_equal(read_fil_block(path, cfg, 1, 4), expect[i]):
                raise RuntimeError(f"beam {b}: .fil block 1 differs from the "
                                   f"resident uint8 Stokes output")
            tail = read_fil_block(path, cfg, last, 4)
            if tail[:, 0, col].any() or (tail[:, 1:, col] != QUV_OFFSET).any() \
                    or not tail[:, 0].any():
                raise RuntimeError(f"beam {b}: carrier channel not I = 0, "
                                   f"Q/U/V = {QUV_OFFSET} after the swap")
        _, inco = read_product_file(r["inco_path"])
        if inco.shape != (n, *cfg.out_block_shape[:2]) \
                or not np.array_equal(inco[1], res_inco.cpu().numpy()):
            raise RuntimeError("incoherent .dada block 1 differs from the "
                               "resident kernel's")
        stats = r["stats"]
        log(f"[stokes deployed] {cfg.name}: one excise event on channel "
            f"{carrier}; {len(STOKES_FIL_BEAMS)} 4-IF .fil files (nifs "
            f"4, __quv_offset__ {side['__quv_offset__']}), block 1 equal to "
            f"the resident uint8 Stokes output laid out; carrier I = 0, "
            f"Q/U/V = {QUV_OFFSET} in block {last}; incoherent .dada "
            f"{inco.shape} block 1 equal; dropped {stats.dropped}; steady "
            f"state {r['steady_ms']:.2f} ms/block = "
            f"{cfg.block_duration_s * 1e3 / r['steady_ms']:.4f}x realtime "
            f"on {smi}")
        del x1, res_u8, res_inco
    return r["launches"]


# --------------------------------------------------------------------- #
# Beam voltages (the unfused validation path)
# --------------------------------------------------------------------- #

VOLTAGE_CHANNELS = 128


def voltage_bound_ms(cfg) -> tuple:
    """Least time of one beamform_voltages call on an H100 SXM: bytes (wire
    slots and weights read, the float32 voltages written) over the memory
    rate against the MACs over the peak for the mode's operand type."""
    nbytes = (cfg.t_block * cfg.n_chan * cfg.n_pol * cfg.a_compute
              + weight_bytes(cfg)
              + cfg.n_chan * cfg.t_block * cfg.n_pol * 2 * cfg.n_beams * 4)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return (ops_ms(cfg), "operations") if ops_ms(cfg) >= bytes_ms \
        else (bytes_ms, "bytes")


def detect_voltages(bv, cfg) -> tuple:
    """Power and Stokes of float32 voltages ``[F, T, P, 2B]``, summed over
    navg_time, in float64 on the card, 16 channels at a time."""
    b, navg = cfg.n_beams, cfg.navg_time
    f_all, t = bv.shape[:2]
    power = torch.empty((f_all, t // navg, b), dtype=torch.float64, device=DEV)
    stokes = torch.empty((f_all, t // navg, 4, b), dtype=torch.float64,
                         device=DEV)
    for f0 in range(0, f_all, 16):
        v = bv[f0:f0 + 16].double()
        xr, xi, yr, yi = (v[:, :, 0, :b], v[:, :, 0, b:], v[:, :, 1, :b],
                          v[:, :, 1, b:])
        px, py = xr * xr + xi * xi, yr * yr + yi * yi
        planes = torch.stack([px + py, px - py, 2 * (xr * yr + xi * yi),
                              2 * (xi * yr - xr * yi)], dim=2)
        fc = planes.shape[0]
        stokes[f0:f0 + fc] = planes.reshape(fc, t // navg, navg, 4, b).sum(2)
        power[f0:f0 + fc] = stokes[f0:f0 + fc, :, 0]
    return power, stokes


def phase_voltages(smi, cfg=DSA10.replace(n_chan=VOLTAGE_CHANNELS)) -> dict:
    """The unfused validation path on a 128-channel sub-band at full
    per-channel width: the kernel against its plain version and against
    the fused power and Stokes kernels; then timed."""
    wire = make_random_bytes_block(cfg, seed=5)
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    x = to_device(cfg, wire)
    gemm.beamform_voltages.launches = 0     # count the path's own call only
    gemm.beamform_voltages.launches_by_mode.clear()
    bv = gemm.beamform_voltages(x, qw, cfg)
    launches = gemm.beamform_voltages.launches_by_mode[cfg.weight_mode]
    xk, tm = gemm._prepare_wire(x, cfg)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    bv_p = gemm.voltages_plain(xk, qw.terms, qw.scales, cfg, tm)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    max_abs = float((bv - bv_p).abs().max())
    if cfg.weight_mode in gemm.FLOAT_MODES:
        # The K-sum of float32 products in another order than the library
        # GEMM's: held to 1e-5 of the largest voltage.
        limit = KERNEL_VS_PLAIN_RTOL * float(bv_p.abs().max())
        how = f"within {max_abs:.3g} of its plain version (limit {limit:.3g})"
    else:
        limit = 0.0
        how = "== plain bit for bit"
    if max_abs > limit:
        raise RuntimeError(f"voltage kernel differs from its plain version "
                           f"(max {max_abs}, limit {limit})")
    del bv_p
    power_u, stokes_u = detect_voltages(bv, cfg)
    p_fused = gemm.beamform_power(x, qw, cfg).double()
    s_fused = gemm.beamform_stokes(x, qw, cfg).double()
    rel = float((p_fused - power_u).norm() / power_u.norm())
    errs = plane_errors(s_fused, stokes_u)
    log(f"[voltages] {tag(cfg)} sub-band {tuple(bv.shape)} "
        f"({bv.numel() * 4 / 1e9:.3f} GB): kernel {how}; "
        f"fused power vs detected voltages {rel:.3e} (tol 1e-05); fused "
        f"Stokes vs Stokes of the voltages / I peak "
        + " ".join(f"{n}={e:.2e}" for n, e in zip("IQUV", errs)))
    if rel > 1e-5 or max(errs) > 1e-5 or not bool(torch.isfinite(bv).all()):
        raise RuntimeError("fused vs unfused check failed")
    del power_u, stokes_u, p_fused, s_fused, bv
    run = lambda i: gemm.beamform_voltages(x, qw, cfg)
    bv = run(0)
    ms = time_ms(run, N_TIMED)
    bv.zero_()
    ceiling_ms = time_ms(lambda i: bv.zero_(), N_TIMED)
    del bv
    bnd, by = voltage_bound_ms(cfg)
    tiles = gemm._voltage_tiles(cfg)
    log(f"[voltages] {tag(cfg)} sub-band kernel {ms:.3f} ms per call "
        f"({cfg.n_chan} channels x {cfg.t_block} samples; tile "
        f"{tiles.beams} beams, {tiles.groups} warpgroups of {tiles.rows} "
        f"m-tiles), bound {bnd:.3f} ms by {by} ({bnd / ms * 100:.2f}%), "
        f"plain {plain_ms:.1f} ms, launches on the validation path "
        f"{launches}, on {smi}")
    log(f"[voltages] {tag(cfg)} store ceiling: zero_() of the same "
        f"{cfg.n_chan * cfg.t_block * cfg.n_pol * 2 * cfg.n_beams * 4 / 1e9:.3f}"
        f" GB output {ceiling_ms:.3f} ms "
        f"({bnd / ceiling_ms * 100:.2f}% of the byte bound's rate); kernel / "
        f"ceiling {ms / ceiling_ms:.3f}")
    if launches != 1:
        raise RuntimeError(f"voltage path launched {launches} kernels")
    return {"launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "store_ceiling_ms": ceiling_ms}


#: dsa10c deployments, per product, that launch the variants the full
#: dsa10 one does not.
OTHER_DEPLOYMENTS = {
    # 8-bit filterbank + RFI monitor without the incoherent file (sk, q8,
    # sk+q8), and a one-beam 32-bit filterbank with it (inco).
    "power": (dict(fil_bits=8, incoherent=False, rfi=True),
              dict(fil_bits=32, fil_beams=[TARGET_BEAM], incoherent=True,
                   rfi=False)),
    # The same for 64 beams of 8-bit 4-IF files, and a one-beam 32-bit
    # Stokes file without the incoherent file (stokes).
    "stokes": (dict(fil_bits=8, fil_beams=STOKES_FIL_BEAMS, incoherent=False,
                    rfi=True),
               dict(fil_bits=32, fil_beams=[TARGET_BEAM], incoherent=True,
                    rfi=False),
               dict(fil_bits=32, fil_beams=[TARGET_BEAM], incoherent=False,
                    rfi=False)),
}


def phase_other_deployments(cfg, blocks_np, smi,
                            products="power") -> collections.Counter:
    """The dsa10c deployments of ``OTHER_DEPLOYMENTS[products]``, 6 blocks
    each, with their launch patterns and excise events checked."""
    total = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        for i, kw in enumerate(OTHER_DEPLOYMENTS[products]):
            r = drive_stream(cfg, blocks_np, 6, Path(tmp) / f"run{i}",
                             smi=smi, products=products, **kw)
            want = expected_launches(6, q8=kw["fil_bits"] == 8,
                                     incoherent=kw["incoherent"],
                                     rfi=kw["rfi"],
                                     stokes=products == "stokes")
            if r["launches"] != want:
                raise RuntimeError(f"launch pattern {r['launches']}, "
                                   f"want {want}")
            if kw["rfi"] and [e.get("new") for e in r["events"]] \
                    != [[carrier_chan(cfg)]]:
                raise RuntimeError(f"events {r['events']}")
            total.update(r["launches"])
    return total


# --------------------------------------------------------------------- #
# DSA-110 (a_compute 128, 512 beams)
# --------------------------------------------------------------------- #

#: DSA-110 variants held against the plain version at full band, timed, and
#: reported as kernel rows of their own: the products and the deployed ones.
DSA110_VARIANTS = ("base", "sk+q8+inco", "stokes", "stokes+sk+q8+inco")
DSA110_TARGET = 300          # the point source's beam, of 512
N_DSA110_STREAM = 6          # blocks in each plain sub-band stream
#: The per-GPU deployment: one `dsabf run --subband i/8` process per card.
DSA110_SUBBAND = DSA110.subband(0, 256)


def phase_dsa110(smi) -> dict:
    """DSA-110 (a_compute 128): the kernel variants against the
    plain version on a full-band block (antenna 77 flagged), the sub-band
    point source, resident full-band times; then the per-GPU deployment
    (``DSA110.subband(0, 256)``): the plain power and Stokes streams, the
    deployed power stream (8-bit .fil for all 512 beams, incoherent .dada,
    RFI monitor) and the deployed Stokes stream; and the voltage path on a
    128-channel sub-band.  Each stream runs with the counts set to 0."""
    cfg = DSA110
    t0 = time.perf_counter()
    blocks = [make_random_bytes_block(cfg, seed=s) for s in (10, 11)]
    log(f"[data] two {cfg.name} blocks {cfg.wire_block_shape} "
        f"({cfg.wire_block_bytes / 1e9:.3f} GB each) in "
        f"{time.perf_counter() - t0:.1f} s; kernel path "
        f"{gemm.kernel_path(cfg)} (a_compute {cfg.a_compute})")
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    checked = {}
    for stokes in (False, True):
        checked.update(phase_variants(cfg, blocks[0], qw, [
            v for v in DSA110_VARIANTS if (v in STOKES_VARIANTS) == stokes]))
    physics_cfg = DSA110.replace(n_chan=VOLTAGE_CHANNELS, t_block=512)
    phase_physics(physics_cfg, DSA110_TARGET)
    phase_stokes_physics(physics_cfg, DSA110_TARGET)
    times = phase_resident_variants(cfg, blocks, qw, checked, smi,
                                    DSA110_VARIANTS)
    del qw

    sub = DSA110_SUBBAND
    sub_blocks = [make_random_bytes_block(sub, seed=s) for s in (12, 13)]
    phase_transfers(sub, sub_blocks[0])
    modes = phase_dsa110_modes(blocks, sub_blocks, smi)
    del blocks
    qs = prepare_weights(sub, make_weights(sub, device=DEV))
    launches = collections.Counter()
    for products in ("power", "stokes"):
        detect = gemm.beamform_stokes if products == "stokes" \
            else gemm.beamform_power
        block0 = detect(to_device(sub, sub_blocks[0]), qs, sub).cpu()
        launches["stokes" if products == "stokes" else "base"] += \
            phase_stream(sub, sub_blocks, qs, block0, smi, N_DSA110_STREAM,
                         products)
        del block0
    del qs
    for b in sub_blocks:
        with_carrier(sub, b)
    launches.update(phase_deployed(sub, sub_blocks, smi))
    launches.update(phase_stokes_deployed(sub, sub_blocks, smi))
    missing = [v for v in DSA110_VARIANTS if not launches[v]]
    if missing:
        raise RuntimeError(f"DSA-110 variants never launched on a main path: "
                           f"{missing}")
    volt = phase_voltages(smi, DSA110.replace(n_chan=VOLTAGE_CHANNELS))
    return {"checked": checked, "times": times, "launches": launches,
            "volt": volt, "modes": modes}


# --------------------------------------------------------------------- #
# The weight modes int12, int13, bf16, bf16x2, f32
# --------------------------------------------------------------------- #

NEW_MODES = ("int8", "int12", "int13", "bf16", "bf16x2", "f32")
#: Variants timed in every new mode and, at DSA-110 width, held against the
#: plain version (at dsa10 every mode is held to all 16).
MODE_VARIANTS = ("base", "sk+q8+inco", "stokes", "stokes+sk+q8+inco")
N_MODE_TIMED = 4             # back-to-back launches in the modes' timings
#: Calibrated noise against the float64 golden: the JAX package's bar for
#: each mode (its tests/test_gemm.py).
NOISE_BARS = {"int13": 5e-4, "int12": 8e-4, "bf16x2": 2e-4, "f32": 1e-5,
              "bf16": 1e-2, "int8": 2e-2}
#: The point source against the golden: a coherent source amplifies weight
#: error into the -30 dB sidelobe bins, so the 12- and 13-bit modes get the
#: JAX package's point-source bar (1e-2), bf16 (8 bits) five times that,
#: int8 (8 bits of the channel's largest weight, not of each weight) 2e-1;
#: f32's float32 K-sums of a coherent source leave 1.4e-5 in the floored
#: bins (a TF32 product would leave 1e-2 or more).
POINT_BARS = {"int13": 1e-2, "int12": 1e-2, "bf16x2": GOLDEN_RTOL,
              "f32": 1e-4, "bf16": 5e-2, "int8": 2e-1}
#: mode -> blocks of its dsa10 stream (int13: the deployed stream).
MODE_STREAM_BLOCKS = {"int8": 3, "int12": 6, "int13": 6, "bf16x2": 3,
                      "bf16": 3, "f32": 3}
#: mode -> (variants checked and timed at full DSA-110 width, blocks of its
#: DSA110.subband(0, 256) power-only stream).
DSA110_MODES = {"int8": (MODE_VARIANTS, 3),
                "int12": (MODE_VARIANTS, 6),
                "int13": (MODE_VARIANTS, 4),
                "bf16": (MODE_VARIANTS, 3),
                "bf16x2": (MODE_VARIANTS, 3),
                "f32": (MODE_VARIANTS, 3)}


def check_and_time(cfg, blocks_np, smi, variants, n, check=None) -> tuple:
    """The variants ``check`` (default: ``variants``) of ``cfg`` against the
    plain version on blocks_np[0], then the resident times of ``variants``:
    ``(checked, times)``."""
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    checked = {}
    for stokes in (False, True):
        family = [v for v in (check or variants)
                  if (v in STOKES_VARIANTS) == stokes]
        if family:
            checked.update(phase_variants(cfg, blocks_np[0], qw, family))
    times = phase_resident_variants(cfg, blocks_np, qw, checked, smi,
                                    variants, n)
    return checked, times


def phase_mode_physics(mode) -> None:
    """The sub-band point source (argmax, the mode's point-source bar) and a
    calibrated noise block (the JAX package's bar for the mode) against the
    float64 golden model."""
    cfg = DSA10.replace(n_chan=128, t_block=512, weight_mode=mode)
    phase_physics(cfg, TARGET_BEAM, POINT_BARS[mode])
    cal = CalTable.random(cfg, seed=11)
    wire = make_noise_block(cfg, rms=2.5, seed=21)
    qw = prepare_weights(cfg, make_weights(cfg, cal=cal, device=DEV))
    p = gemm.beamform_power(to_device(cfg, wire), qw, cfg).cpu().numpy()
    ref = beamform_block_ref(weights_numpy_golden(cfg, cal=cal), wire,
                             cfg.input_layout, cfg.navg_time)
    err = relative_power_error(p, ref)
    log(f"[modes physics] {tag(cfg)} calibrated noise sub-band {p.shape}: "
        f"error vs float64 golden {err:.3e} (bar {NOISE_BARS[mode]:.0e})")
    if err > NOISE_BARS[mode] or not np.isfinite(p).all():
        raise RuntimeError(f"{mode}: noise block misses its golden bar")


def check_base_limit(cfg, ms) -> None:
    """A float mode's base time against ``FLOAT_BASE_LIMIT_MS``."""
    limit = FLOAT_BASE_LIMIT_MS.get((cfg.name, cfg.weight_mode))
    if limit is None:
        return
    log(f"[limit] {tag(cfg)} base {ms:.3f} ms/block, limit {limit} ms (a "
        f"quarter of its fmaf predecessor's)")
    if ms >= limit:
        raise RuntimeError(f"{tag(cfg)}: the detect kernel took {ms:.3f} ms, "
                           f"not below {limit} ms")


def phase_f32_split(cfg, smi, n_chan=VOLTAGE_CHANNELS, t_block=2048) -> dict:
    """The f32 split control on an ``n_chan``-channel sub-band of ``cfg``:
    on a block where each voltage meets one product (``one_product_block``,
    one sample an output), the f32 kernel within ``F32_SPLIT_RTOL`` of its
    plain version, and bf16x2's kernel on the first two of the three bf16
    parts of each weight outside it."""
    c = cfg.replace(weight_mode="f32", n_chan=n_chan, t_block=t_block,
                    navg_time=1)
    qw = prepare_weights(c, make_weights(c, device=DEV))
    x, tm = gemm._prepare_wire(to_device(c, one_product_block(c, seed=31)),
                               c)
    got = gemm.fused_detect(x, qw.terms, qw.scales, c, tm)[0]
    want = gemm.detect_power_plain(x, qw.terms, qw.scales, c, tm)[0]
    w1, w2, _ = gemm._split_f32(qw.terms[0])
    control = gemm.fused_detect(
        x, (w1, w2), torch.ones((c.n_chan, 2), device=DEV),
        c.replace(weight_mode="bf16x2"), tm)[0]
    torch.cuda.synchronize()
    err = relative_power_error_on_card(got, want)
    err2 = relative_power_error_on_card(control, want)
    tiles = gemm._detect_tiles(c)
    log(f"[f32 split] {tag(cfg)} one-product sub-band {tuple(got.shape)} "
        f"({tiles.beams}-beam tile): f32 kernel vs plain {err:.3e} (bar "
        f"{F32_SPLIT_RTOL:.0e}); bf16x2's kernel on the first two bf16 "
        f"parts {err2:.3e} (must exceed the bar), on {smi}")
    if err > F32_SPLIT_RTOL or err2 <= F32_SPLIT_RTOL \
            or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{tag(cfg)}: the f32 split control failed "
                           f"({err:.3e}, control {err2:.3e})")
    return {"err": err, "control_err": err2}


def plain_stream(cfg, blocks_np, n_blocks, smi) -> collections.Counter:
    """A power-only stream of ``cfg`` into the checksum sink; its launches
    per variant."""
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    block0 = gemm.beamform_power(to_device(cfg, blocks_np[0]), qw, cfg).cpu()
    return collections.Counter(
        base=phase_stream(cfg, blocks_np, qw, block0, smi, n_blocks))


def phase_modes(blocks_np, smi) -> dict:
    """Phases 23-26 at full dsa10 width; ``blocks_np`` carry the carrier
    channel.  mode -> its checks, times, stream launches and voltage row."""
    out = {}
    for mode in NEW_MODES:
        cfg = DSA10.replace(weight_mode=mode)
        log_mode(cfg, "modes")
        checked, times = check_and_time(
            cfg, blocks_np, smi, MODE_VARIANTS, N_MODE_TIMED,
            check=tuple(ALL_VARIANTS))
        check_base_limit(cfg, times["base"])
        if mode == "f32":
            phase_f32_split(cfg, smi)
        phase_mode_physics(mode)
        n = MODE_STREAM_BLOCKS[mode]
        if mode == "int13":
            launches = collections.Counter(
                phase_deployed(cfg, blocks_np, smi, n, time_sink=False))
        else:
            launches = plain_stream(cfg, blocks_np, n, smi)
        if not launches:
            raise RuntimeError(f"mode {mode} never launched on a stream")
        volt = phase_voltages(smi, cfg.replace(n_chan=VOLTAGE_CHANNELS))
        out[mode] = {"cfg": cfg, "checked": checked, "times": times,
                     "launches": launches, "volt": volt}
    return out


def log_mode(cfg, phase) -> None:
    """A mode's kernel: its path, source, tile and each route's bound."""
    tiles = gemm._detect_tiles(cfg)
    log(f"[{phase}] {tag(cfg)}: a_compute {cfg.a_compute}, K {cfg.gemm_k}, "
        f"kernel path {gemm.kernel_path(cfg)}, source "
        f"{gemm.kernel_library(cfg, 'detect_power')}.cu, tile {tiles.beams} "
        f"beams, {tiles.groups} warpgroups of {tiles.rows} rows; operations "
        f"bound by route: {routes_text(cfg)}")


def phase_dsa110_modes(blocks_np, sub_blocks_np, smi) -> dict:
    """Phases 27-28: the modes of ``DSA110_MODES`` at full DSA-110 width
    (kernel against plain, resident times), as power-only streams of the
    per-GPU sub-band, and through the voltage path on a 128-channel
    sub-band."""
    out = {}
    for mode, (variants, n_stream) in DSA110_MODES.items():
        cfg = DSA110.replace(weight_mode=mode)
        log_mode(cfg, "dsa110 modes")
        checked, times = check_and_time(cfg, blocks_np, smi, variants, 3)
        check_base_limit(cfg, times["base"])
        if mode == "f32":
            phase_f32_split(cfg, smi)
        sub = DSA110_SUBBAND.replace(weight_mode=mode)
        launches = plain_stream(sub, sub_blocks_np, n_stream, smi)
        volt = phase_voltages(smi, cfg.replace(n_chan=VOLTAGE_CHANNELS))
        out[mode] = {"cfg": cfg, "checked": checked, "times": times,
                     "launches": launches, "volt": volt}
    return out


#: Phase 29: a_compute off the presets' 16, 32 and 128; the int8 modes of
#: one and of four sub-terms, the bf16 modes of two and of three (f32's
#: split; its 32-beam tile at 112); the products' plain and fully loaded
#: variants.
WIDTHS = (24, 40, 112)
WIDTH_MODES = ("int8x2", "int13", "bf16x2", "f32")
WIDTH_VARIANTS = ("base", "stokes+sk+q8+inco")
N_GEOMETRIES = 10


def width_cfg(ac, n_chan=VOLTAGE_CHANNELS, **kw):
    """A DSA-110 sub-band contracting exactly ``ac`` antennas, two of its
    slots inactive."""
    return DSA110.replace(name=f"dsa110-ac{ac}", n_chan=n_chan,
                          n_ant_active=ac - 2, n_ant_compute=ac, **kw)


def phase_widths() -> None:
    """Phase 29 (see the module's text)."""
    for ac in WIDTHS:
        for mode in WIDTH_MODES:
            for layout in ("tfpa", "ftpa"):
                cfg = width_cfg(ac, weight_mode=mode, input_layout=layout)
                if cfg.a_compute != ac:
                    raise RuntimeError(f"a_compute {cfg.a_compute}, want {ac}")
                wire = make_random_bytes_block(cfg, seed=ac)
                qw = prepare_weights(cfg, make_weights(
                    cfg, cal=CalTable.random(cfg, seed=ac), device=DEV))
                for v in WIDTH_VARIANTS:
                    phase_variants(cfg, wire, qw, [v])
    # a_compute 24 in every mode, detect and voltages, on a 16-channel slice
    # (its voltages are 0.5 GB).
    for mode in gemm.KERNEL_MODES:
        cfg = width_cfg(24, n_chan=16, weight_mode=mode)
        wire = make_random_bytes_block(cfg, seed=24)
        qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
        x, tm = gemm._prepare_wire(to_device(cfg, wire), cfg)
        out_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm)[0]
        out_p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm)[0]
        rel = relative_power_error_on_card(out_k, out_p)
        bv = gemm.beamform_voltages(x, qw, cfg)
        bv_p = gemm.voltages_plain(x, qw.terms, qw.scales, cfg, tm)
        torch.cuda.synchronize()
        verr = float((bv - bv_p).abs().max()) / float(bv_p.abs().max())
        vlim = KERNEL_VS_PLAIN_RTOL if mode in gemm.FLOAT_MODES else 0.0
        log(f"[widths] {tag(cfg)} a_compute 24: detect relative error "
            f"{rel:.3e} (tol {KERNEL_VS_PLAIN_RTOL:.0e}), voltages max error / "
            f"peak {verr:.3e} (limit {vlim:.0e})")
        if rel > KERNEL_VS_PLAIN_RTOL or verr > vlim \
                or not bool(torch.isfinite(out_k).all()):
            raise RuntimeError(f"a_compute 24 in {mode}: kernel disagrees "
                               f"with its plain version")
    for i in range(N_GEOMETRIES):
        cfg, _ = random_geometry(i)
        cal = CalTable.random(cfg, seed=i)
        wire = make_noise_block(cfg, rms=2.0, seed=i)
        qw = prepare_weights(cfg, make_weights(cfg, cal=cal, device=DEV))
        x, tm = gemm._prepare_wire(to_device(cfg, wire), cfg)
        peak_err = []
        for stokes in (False, True):
            k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                                  stokes=stokes)[0]
            p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm,
                                        stokes=stokes)[0]
            peak_err.append(float((k - p).abs().max()) / float(p.abs().max()))
        got = gemm.beamform_power(x, qw, cfg).cpu().numpy()
        ref = beamform_block_ref(weights_numpy_golden(cfg, cal=cal), wire,
                                 cfg.input_layout, cfg.navg_time,
                                 cfg.navg_freq)
        err = relative_power_error(got, ref)
        bv = gemm.beamform_voltages(x, qw, cfg)
        bv_p = gemm.voltages_plain(x, qw.terms, qw.scales, cfg, tm)
        peak_err.append(float((bv - bv_p).abs().max())
                        / float(bv_p.abs().max()))
        if cfg.weight_mode not in gemm.FLOAT_MODES and peak_err[2]:
            raise RuntimeError(f"random geometry {i}: voltages differ from "
                               f"the plain version")
        log(f"[widths] {cfg.name} {cfg.weight_mode} {cfg.input_layout} "
            f"A={cfg.n_ant}/{cfg.n_ant_active} a_compute {cfg.a_compute} "
            f"B={cfg.n_beams} F={cfg.n_chan} T={cfg.t_block} navg "
            f"{cfg.navg_time}x{cfg.navg_freq}: kernel vs plain / peak "
            f"{peak_err[0]:.2e} (Stokes {peak_err[1]:.2e}, voltages "
            f"{peak_err[2]:.2e}, tol "
            f"{KERNEL_VS_PLAIN_RTOL:.0e}), vs float64 golden {err:.3e} (bar "
            f"{FUZZ_RTOL[cfg.weight_mode]:.0e})")
        if max(peak_err) > KERNEL_VS_PLAIN_RTOL \
                or err > FUZZ_RTOL[cfg.weight_mode] \
                or got.shape != cfg.out_block_shape:
            raise RuntimeError(f"random geometry {i} failed")


# --------------------------------------------------------------------- #
# [ring] and [search]: the shared-memory ring in, candidates out
# --------------------------------------------------------------------- #

RING_DEPTH = 2               # the streams' depth; a ring holds depth+2 slots
N_RING = 12                  # blocks in each ring power-only stream
N_RING_DEPLOYED = 8          # blocks in each ring deployed stream
SHM = "/dev/shm"
DD_KERNELS = (dedisperse_direct, subband_stage1, subband_stage2)
#: The live search drill: a dispersed pulse at DM 50 towards beam 100, in
#: every block, searched to DM 100 over a 32-beam set (every 8th beam from
#: 4, so the beam pattern's main lobe covers a few of them: coincidence
#: keeps it) with the reference CLI's --search-* defaults.
SEARCH_DM = 50.0
SEARCH_DM_MAX = 100.0
SEARCH_BEAM = TARGET_BEAM
SEARCH_SET = list(range(4, 256, 8))
SEARCH_AMPLITUDE = 0.3
SEARCH_T0 = 1024             # wire samples: output sample 64 of each block
SEARCH_CHUNK = 4096
N_SEARCH = 10
#: The offline search (method "direct") of the written .fil files: the
#: pulse's beam and its three nearest set members.
OFFLINE_BEAMS = [SEARCH_BEAM - 8, SEARCH_BEAM, SEARCH_BEAM + 8,
                 SEARCH_BEAM + 16]
#: An add issues at the FMA rate: 67 TFLOP/s counts an FMA as two.
H100_F32_ADDS_PER_S = 67e12 / 2


def ring_need(cfg) -> int:
    """/dev/shm bytes of a ring of depth + 2 slots of ``cfg`` blocks."""
    return (RING_DEPTH + 2) * cfg.wire_block_bytes + 2 * 4096


def choose_ring_cfg(free: int, cands) -> tuple:
    """The first of ``cands`` whose ring fits in ``free`` bytes, else the
    widest power-of-two channel subband of dsa10c that does; with the
    reason."""
    for c in cands:
        if ring_need(c) <= free:
            return c, (f"{tag(c)} ({c.wire_block_bytes / 1e9:.3f} GB a "
                       f"block) is the widest whose {RING_DEPTH + 2} slots "
                       f"fit ({ring_need(c) / 1e9:.3f} GB)")
    n = DSA10_COMPACT.n_chan
    while n > 1 and ring_need(DSA10_COMPACT.subband(0, n)) > free:
        n //= 2
    c = DSA10_COMPACT.subband(0, n)
    return c, (f"none of {[tag(x) for x in cands]} fits; dsa10c's "
               f"{n}-channel subband ({c.wire_block_bytes / 1e6:.1f} MB a "
               f"block) does ({ring_need(c) / 1e9:.3f} GB)")


def shm_free() -> tuple:
    du = shutil.disk_usage(SHM)
    return du.total, du.free


def ring_producer(name, cfg, kind, runs, ready, go, done, results):
    """The capture process (spawned): makes its blocks, creates the ring,
    writes the stream header, then for each ``(n_blocks, rate_factor,
    copy)`` of ``runs`` writes the blocks in turn: free-running runs wait
    for a free slot (nothing dropped), a paced run (rate_factor 1.0 = real
    time) writes each block when due and drops it if the ring is full.

    ``copy`` runs copy each block into its slot (4 threads) and report the
    rate.  The others commit the slot as it stands: with 4 slots and 2
    blocks in turn (or 1) every slot already holds the block due in it
    since the first fill, as a capture card's DMA would have put it there at
    no cost to the host, so the consumer runs at its own pace.  The last
    run ends with end of data."""
    torch.set_num_threads(4)
    if kind == "random":
        blocks = [with_carrier(cfg, make_random_bytes_block(cfg, seed=s))
                  for s in (0, 1)]
    else:
        blocks = [with_carrier(cfg, make_dispersed_pulse_block(
            cfg, SEARCH_DM, angle_rad=float(cfg.beam_angles_rad()[SEARCH_BEAM]),
            t0_sample=SEARCH_T0, amplitude=SEARCH_AMPLITUDE, seed=7))]
    srcs = [torch.from_numpy(b.reshape(-1)) for b in blocks]
    n = cfg.wire_block_bytes
    if (RING_DEPTH + 2) % len(blocks):
        raise ValueError("every slot must hold one block in turn")
    ring = RingBuffer(name, create=True, nbufs=RING_DEPTH + 2, bufsz=n)
    try:
        ring.write_header(dada.encode_header(cfg))
        k = 0
        for r, (n_blocks, rate_factor, copy) in enumerate(runs):
            copy_s = wait_s = first_fill_s = 0.0
            if rate_factor:
                go.wait(timeout=600)
                t0 = time.perf_counter()
            for i in range(n_blocks):
                src = srcs[k % len(srcs)]
                k += 1
                if rate_factor:
                    due = t0 + i * cfg.block_duration_s / rate_factor
                    time.sleep(max(0.0, due - time.perf_counter()))
                    addr = ring.open_write()
                    if addr is None:
                        # Full: write_block counts the drop (or writes the
                        # block, if a slot was freed in between).
                        ring.write_block(blocks[(k - 1) % len(blocks)])
                        continue
                else:
                    if (addr := ring.open_write()) is None:
                        # The ring is full: the consumer may start (its
                        # first blocks were written ahead, and the slots'
                        # pages touched, before it measures anything).
                        ready.set()
                    t = time.perf_counter()
                    while addr is None:
                        time.sleep(0.0002)
                        addr = ring.open_write()
                    wait_s += time.perf_counter() - t
                first_fill = k <= RING_DEPTH + 2
                if copy or first_fill:
                    t = time.perf_counter()
                    view = np.ctypeslib.as_array(
                        (ctypes.c_uint8 * n).from_address(addr))
                    torch.from_numpy(view).copy_(src)
                    if first_fill:  # the first touch of the slots' pages
                        first_fill_s += time.perf_counter() - t
                    else:
                        copy_s += time.perf_counter() - t
                ring.commit_write()
            ready.set()
            results.put({"run": r, "blocks": n_blocks, "copy_s": copy_s,
                         "wait_s": wait_s, "dropped": ring.dropped,
                         "first_fill_s": first_fill_s})
        ring.set_eod()
        done.wait(timeout=1800)
    finally:
        ring.destroy()


class Producer:
    """A spawned ``ring_producer`` and its events; ``finish`` stops it and
    returns its per-run reports."""

    def __init__(self, cfg, kind, runs):
        ctx = multiprocessing.get_context("spawn")
        self.name = f"chipsmoke-{kind}-{os.getpid()}"
        self.ready, self.go, self.done = ctx.Event(), ctx.Event(), ctx.Event()
        self.results = ctx.Queue()
        self.proc = ctx.Process(target=ring_producer, args=(
            self.name, cfg, kind, runs, self.ready, self.go, self.done,
            self.results), daemon=True)
        self.proc.start()
        self.n_runs = len(runs)

    def attach(self, timeout=900) -> RingBuffer:
        """The consumer's handle, once the producer has made its blocks and
        committed the header (raises if it died first)."""
        deadline = time.monotonic() + timeout
        while not self.ready.wait(1.0):
            if not self.proc.is_alive() or time.monotonic() > deadline:
                raise RuntimeError(
                    f"ring producer {self.name} not ready (exit code "
                    f"{self.proc.exitcode})")
        return RingBuffer(self.name)

    def stop(self) -> None:
        """After a failure: end the producer and unlink its ring."""
        self.proc.terminate()
        self.proc.join(timeout=60)
        try:
            RingBuffer(self.name).destroy()
        except OSError:
            pass

    def finish(self) -> list:
        self.done.set()
        reports = [self.results.get(timeout=600) for _ in range(self.n_runs)]
        self.proc.join(timeout=120)
        if self.proc.is_alive():
            self.proc.terminate()
            raise RuntimeError(f"ring producer {self.name} did not exit")
        if self.proc.exitcode:
            raise RuntimeError(f"ring producer exit code {self.proc.exitcode}")
        return reports


class TimedSource:
    """A source wrapper that counts the host time spent in ``read_block``
    (waiting for the producer, and first-sight slot registration)."""

    def __init__(self, src):
        self.src = src
        self.pinned = getattr(src, "pinned", False)
        self.n_host_buffers = getattr(src, "n_host_buffers", None)
        self.read_s = 0.0

    def read_block(self):
        t = time.perf_counter()
        got = self.src.read_block()
        self.read_s += time.perf_counter() - t
        return got

    def release(self):
        self.src.release()

    @property
    def dropped(self):
        return self.src.dropped

    @property
    def skipped(self):
        return self.src.skipped


class FingerprintSink:
    """Per block the wrapping sum of the product's bytes taken as 64-bit
    words (a one-bit difference changes it), and full copies of the first
    ``keep`` blocks."""

    def __init__(self, keep=2):
        self.sums, self.first, self.keep = [], {}, keep

    def write(self, seq, powers):
        t = torch.from_numpy(powers)
        self.sums.append(int(t.view(torch.int64).sum()))
        if len(self.first) < self.keep:
            self.first[len(self.first)] = t.clone()


def steady_ms(drained, n) -> float:
    """Mean drain-to-drain interval from block 1 to n-3 (each holds one
    whole iteration of the loop; block 0 carries start-up, the last two
    drain after the loop)."""
    return (drained[n - 3] - drained[1]) / (n - 4) * 1e3


def ring_stream(cfg, qw, src, sink, **kw):
    """A depth-2 stream from ``src`` and the list the host clock of each
    block's drain is appended to."""
    drained = []
    bf = StreamingBeamformer(cfg, qw, src, sink, depth=RING_DEPTH,
                             on_block=lambda bs: drained.append(
                                 time.perf_counter()), **kw)
    return bf, drained


def phase_ring(blocks_np, smi) -> None:
    """The ring ingest at the widest configuration /dev/shm holds: a
    capture process writes the blocks; the power-only stream and the
    deployed stream read them through RingSource on the pinned route and
    must equal the same blocks through SyntheticSource; then a run paced at
    1x real time reports its drops."""
    total, free = shm_free()
    cfg, why = choose_ring_cfg(free, [DSA10, DSA10_COMPACT,
                                      DSA110.subband(0, 256)])
    log(f"[ring] {SHM}: {total / 1e9:.3f} GB, {free / 1e9:.3f} GB free; "
        f"{why}: ring phase at {tag(cfg)}")
    prod = Producer(cfg, "random", [
        (N_RING, None, True), (N_RING, None, False),
        (N_RING_DEPLOYED, None, False), (N_RING, 1.0, False)])
    if cfg != DSA10:
        blocks_np = [with_carrier(cfg, make_random_bytes_block(cfg, seed=s))
                     for s in (0, 1)]
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    ring = prod.attach()
    src = RingSource(cfg, ring, timeout_s=60.0)
    ok = False
    try:
        res = {}
        # Power-only: synthetic (staged route), then the ring (pinned route)
        # with the producer copying each block in, then with it committing
        # the slots in place (the consumer's own pace).
        routes = ("staged", "pinned, copying producer", "pinned")
        for route in routes:
            s = TimedSource(SyntheticSource(cfg, blocks_np, N_RING)
                            if route == "staged" else src)
            sink = FingerprintSink()
            bf, drained = ring_stream(cfg, qw, s, sink)
            bf.warmup()
            clear_launches()
            stats = bf.run(max_blocks=N_RING)
            launches = dict(gemm.fused_detect.launches)
            res[route] = (sink, stats, steady_ms(drained, N_RING))
            log(f"[ring] {tag(cfg)} power-only {route}: {stats.n_blocks} "
                f"blocks, {stats.wall_s * 1e3 / stats.n_blocks:.2f} "
                f"ms/block, steady {res[route][2]:.2f} ms/block = "
                f"{cfg.block_duration_s * 1e3 / res[route][2]:.4f}x "
                f"realtime, in read_block {s.read_s * 1e3 / N_RING:.2f} "
                f"ms/block (waiting for the producer, registering a slot "
                f"at first sight), dropped {stats.dropped} skipped "
                f"{stats.skipped}, launches {launches} on {smi}")
            if launches != {"base": N_RING}:
                raise RuntimeError(f"the {route} stream launched {launches}")
        a = res["staged"][0]
        for route in routes[1:]:
            b, st = res[route][0], res[route][1]
            if a.sums != b.sums or any(
                    not torch.equal(a.first[i], b.first[i]) for i in a.first):
                raise RuntimeError(f"ring power-only products ({route}) "
                                   f"differ from the SyntheticSource "
                                   f"stream's")
            if st.dropped or st.skipped or st.n_blocks != N_RING:
                raise RuntimeError(f"ring stream ({route}) dropped "
                                   f"{st.dropped}, skipped {st.skipped}, "
                                   f"{st.n_blocks} blocks")
        log(f"[ring] power-only products equal (wrapping sums of the 64-bit "
            f"words of all {N_RING} blocks, blocks 0-1 bit for bit); "
            f"registered slots {len(src._registered)}; steady ms/block "
            + ", ".join(f"{r} {res[r][2]:.2f}" for r in routes))
        # Deployed: 8-bit .fil x all beams, incoherent .dada, RFI monitor.
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            digests, steady = {}, {}
            for route in ("staged", "pinned"):
                s = TimedSource(SyntheticSource(cfg, blocks_np,
                                                N_RING_DEPLOYED)
                                if route == "staged" else src)
                r = deployed_ring_stream(cfg, s, tmp / route, smi, route)
                digests[route], steady[route] = r
            if digests["staged"] != digests["pinned"]:
                bad = [k for k in digests["staged"]
                       if digests["staged"][k] != digests["pinned"].get(k)]
                raise RuntimeError(f"ring deployed files differ from the "
                                   f"SyntheticSource stream's: {bad[:5]}")
            log(f"[ring] deployed files equal byte for byte "
                f"({len(digests['pinned'])} files); pinned/staged steady "
                f"ms/block {steady['pinned']:.2f} / {steady['staged']:.2f}")
        # Paced at 1x real time: the producer commits each block when due.
        sink = FingerprintSink(keep=0)
        s = TimedSource(src)
        bf, drained = ring_stream(cfg, qw, s, sink)
        bf.warmup()
        prod.go.set()
        stats = bf.run()  # to the producer's end of data
        log(f"[ring] {tag(cfg)} paced at 1x real time "
            f"({cfg.block_duration_s * 1e3:.2f} ms a block): read "
            f"{stats.n_blocks} of {N_RING} blocks, dropped {stats.dropped}, "
            f"skipped {stats.skipped}, {stats.wall_s * 1e3 / max(1, stats.n_blocks):.2f} "
            f"ms/block")
        ok = True
    finally:
        src.close()
        ring.close()
        if not ok:
            prod.stop()
    reports = prod.finish()
    rep = reports[0]
    nb = rep["blocks"] - (RING_DEPTH + 2)
    log(f"[ring] producer's write rate (run 0, copying): "
        f"{nb * cfg.wire_block_bytes / 1e9 / rep['copy_s']:.2f} GB/s = "
        f"{rep['copy_s'] * 1e3 / nb:.1f} ms a block (4 threads; the first "
        f"fill of the {RING_DEPTH + 2} slots, the first touch of their "
        f"pages, took {rep['first_fill_s'] * 1e3:.0f} ms and is not "
        f"counted); 1x real time needs "
        f"{cfg.realtime_bytes_per_s / 1e9:.2f} GB/s; it waited "
        f"{rep['wait_s']:.2f} s for free slots")
    log(f"[ring] producer paced run: dropped {reports[3]['dropped']} in all")


def deployed_ring_stream(cfg, src, fil_dir, smi, route) -> tuple:
    """The deployed stream (8-bit .fil of every beam, incoherent .dada, RFI
    monitor excising the carrier) from ``src``; returns the sha256 of every
    file it wrote and the steady ms/block."""
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    fil = FilterbankSink(fil_dir, cfg, nbits=8)
    inco = FileSink(fil_dir / "inco.dada", cfg, products="incoherent")
    bf, drained = ring_stream(cfg, qw, src, fil, incoherent_sink=inco,
                              flag_ants=(flagged_ant(cfg),))
    events = []

    def excise(ev):
        events.append(ev)
        if ev["type"] == "excise" and not ev.get("final"):
            w = zap_weights(make_weights(cfg, device=DEV), ev["zapped"], cfg)
            bf.update_weights(prepare_weights(cfg, w))

    bf.rfi_monitor = RFIMonitor(cfg, interval=2, sample=2, on_event=excise)
    bf.warmup()
    clear_launches()
    stats = bf.run(max_blocks=N_RING_DEPLOYED)
    launches = dict(gemm.fused_detect.launches)
    fil.close()
    inco.close()
    ms = steady_ms(drained, N_RING_DEPLOYED)
    log(f"[ring] {tag(cfg)} deployed {route}: {stats.n_blocks} blocks, "
        f"steady {ms:.2f} ms/block = {cfg.block_duration_s * 1e3 / ms:.4f}x "
        f"realtime, read_block {src.read_s * 1e3 / N_RING_DEPLOYED:.2f} "
        f"ms/block, dropped {stats.dropped} skipped {stats.skipped}, "
        f"events {[(e['type'], e.get('new')) for e in events]}, launches "
        f"{launches} on {smi}")
    want = expected_launches(N_RING_DEPLOYED, q8=True, incoherent=True,
                             rfi=True)
    if launches != want or stats.dropped or stats.skipped \
            or stats.n_blocks != N_RING_DEPLOYED:
        raise RuntimeError(f"deployed {route}: launches {launches} (want "
                           f"{want}), dropped {stats.dropped}, skipped "
                           f"{stats.skipped}, {stats.n_blocks} blocks")
    ex = [e for e in events if e["type"] == "excise"]
    if len(ex) != 1 or ex[0]["new"] != [carrier_chan(cfg)]:
        raise RuntimeError(f"want one excise of channel {carrier_chan(cfg)}, "
                           f"got {events}")
    digests = {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
               for p in sorted(fil_dir.iterdir())}
    return digests, ms


def expected_pulses(cfg, n_blocks) -> list:
    """Output-sample start times of the drill's pulses, one a block."""
    t_out = cfg.out_block_shape[1]
    return [k * t_out + SEARCH_T0 // cfg.navg_time for k in range(n_blocks)]


def check_pulse(cands, cfg, dms, beam, what) -> list:
    """The candidates at the injected pulse: beam ``beam``, DM within one
    trial of SEARCH_DM, time within the widest boxcar of an arrival."""
    step = dms[1] - dms[0]
    want = expected_pulses(cfg, N_SEARCH)
    hits = [c for c in cands if c.beam == beam
            and abs(c.dm - SEARCH_DM) <= step
            and min(abs(c.t_samp - t) for t in want) <= max(DEFAULT_WIDTHS)]
    if not hits:
        raise RuntimeError(f"{what}: the pulse (DM {SEARCH_DM}, beam {beam}, "
                           f"t {want}) was not found; strongest "
                           f"{[c.row() for c in sorted(cands, key=lambda c: -c.snr)[:8]]}")
    return hits


def phase_search(prod, cfg, why, smi) -> tuple:
    """The live single-pulse search at dsa10c width: the deployed stream
    (8-bit .fil x256, incoherent .dada, RFI monitor excising the carrier)
    of the dispersed-pulse block from the ring, a SearchMonitor (method
    conv, DM to 100, chunk 4096, the 32-beam set, coincidence on) fed at
    drain; then the offline search (method direct) of four beams' .fil
    files; then each bank kernel against its plain version on the
    monitor's first window, timed."""
    log(f"[search] {why}: search phase at {tag(cfg)}")
    f_mhz = cfg.freqs_hz() / 1e6
    tsamp = cfg.sample_period_s * cfg.navg_time
    dms = dm_trial_grid(float(f_mhz.min()), float(f_mhz.max()), tsamp,
                        dm_max=SEARCH_DM_MAX)
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    ring = prod.attach()
    src = RingSource(cfg, ring, timeout_s=120.0)
    windows = []
    ok = False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            fil = FilterbankSink(tmp / "fil", cfg, nbits=8)
            inco = FileSink(tmp / "inco.dada", cfg, products="incoherent")
            bf = StreamingBeamformer(cfg, qw, src, fil, depth=RING_DEPTH,
                                     incoherent_sink=inco,
                                     flag_ants=(flagged_ant(cfg),))
            events = []

            def excise(ev):
                events.append(ev)
                if ev["type"] == "excise" and not ev.get("final"):
                    w = zap_weights(make_weights(cfg, device=DEV),
                                    ev["zapped"], cfg)
                    bf.update_weights(prepare_weights(cfg, w))

            bf.rfi_monitor = RFIMonitor(cfg, interval=2, sample=2,
                                        on_event=excise)
            mon = SearchMonitor(f_mhz, tsamp, dms, beam=SEARCH_SET,
                                chunk_t=SEARCH_CHUNK, method="conv",
                                device=DEV)
            search_window = mon._search_window

            window_s = []

            def keep_first(window, own):
                if not windows:
                    windows.append(np.array(window))
                t = time.perf_counter()
                found = search_window(window, own)
                window_s.append(time.perf_counter() - t)
                return found

            mon._search_window = keep_first
            bf.search_monitor = mon
            bf.warmup()
            clear_launches()
            for k in DD_KERNELS:
                k.launches = 0
            t0 = time.perf_counter()
            stats = bf.run(max_blocks=N_SEARCH)
            wall = time.perf_counter() - t0
            live = {k.__name__: k.launches for k in DD_KERNELS}
            fil.close()
            inco.close()
            log(f"[search] {tag(cfg)} deployed stream from the ring with the "
                f"live search: {stats.n_blocks} blocks in {wall:.2f} s "
                f"({wall * 1e3 / stats.n_blocks:.2f} ms/block incl. "
                f"{mon.searched_windows} search windows), dropped "
                f"{stats.dropped} skipped {stats.skipped}, RFI events "
                f"{[(e['type'], e.get('new')) for e in events]}, "
                f"{len(dms)} DM trials to {dms[-1]:.3f}, max delay "
                f"{int(mon.delays.max())} samples, conv n_sub "
                f"{_conv_auto_n_sub(mon.delays)}, detect launches "
                f"{dict(gemm.fused_detect.launches)}, bank launches {live}, "
                f"{len(mon.candidates)} candidates, {mon.rfi_rejected} "
                f"clusters rejected as RFI on {smi}")
            log(f"[search] window search times {[round(w * 1e3, 1) for w in window_s]} "
                f"ms (host window, upload, bank, normalization, top-k, "
                f"clustering, coincidence)")
            if stats.n_blocks != N_SEARCH or stats.dropped or stats.skipped:
                raise RuntimeError(f"search stream: {stats.n_blocks} blocks, "
                                   f"dropped {stats.dropped}")
            hits = check_pulse(mon.candidates, cfg, dms, SEARCH_BEAM,
                               "live search")
            best = max(hits, key=lambda c: c.snr)
            log(f"[search] live: the pulse found {len(hits)} time(s) in beam "
                f"{SEARCH_BEAM} at DM {best.dm:.3f} (injected {SEARCH_DM}, "
                f"step {dms[1] - dms[0]:.4f}), t {best.t_samp} "
                f"(arrivals {expected_pulses(cfg, N_SEARCH)[:4]} ...), "
                f"S/N {best.snr:.2f}, width {best.width}; beams with "
                f"candidates {sorted({c.beam for c in mon.candidates})}")
            # Offline: dsabf-search's default bank on the written files.
            spectra = [(b, read_fil_block_all(tmp / "fil" / f"beam{b:04d}.fil",
                                              cfg, N_SEARCH))
                       for b in OFFLINE_BEAMS]
            DD_KERNELS[0].launches = 0
            by_beam = search_spectrograms(spectra, f_mhz, tsamp, dms,
                                          method="direct", device=DEV)
            live["dedisperse_direct"] = DD_KERNELS[0].launches
            off = check_pulse([c for cs in by_beam.values() for c in cs],
                              cfg, dms, SEARCH_BEAM, "offline search")
            log(f"[search] offline (method direct, beams {OFFLINE_BEAMS}): "
                f"the pulse found {len(off)} time(s) in beam {SEARCH_BEAM}, "
                f"best S/N {max(c.snr for c in off):.2f}; direct launches "
                f"{live['dedisperse_direct']}")
        ok = True
    finally:
        src.close()
        ring.close()
        if not ok:
            prod.stop()
    prod.finish()
    missing = [k for k, v in live.items() if not v]
    if missing:
        raise RuntimeError(f"bank kernels never launched on a main path: "
                           f"{missing}")
    return live, phase_bank_kernels(windows[0], mon, smi)


def read_fil_block_all(path, cfg, n_blocks) -> np.ndarray:
    """An 8-bit .fil file's data as ascending-frequency ``[T, F]``."""
    _, off = read_filterbank_header(path)
    f_out, t_out, _ = cfg.out_block_shape
    data = np.fromfile(path, np.uint8, offset=off)
    return data.reshape(n_blocks * t_out, f_out)[:, ::-1]


def bank_bound(adds, nbytes) -> tuple:
    ops, mem = adds / H100_F32_ADDS_PER_S * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def phase_bank_kernels(window, mon, smi) -> dict:
    """Each bank kernel against its plain version on the monitor's first
    window (the 32 beams), max abs error (bit-equal expected: the same adds
    in the same order), 10 timed launches, the plain version once, and the
    bound: the adds over the FP32 rate and the bytes (every input read
    once, the output written once) over the memory rate."""
    b, t, f = window.shape
    delays = mon.delays
    n_dm = delays.shape[0]
    fill = np.median(window[:, ::max(1, t // 512)], axis=1).astype(np.float32)
    out = {}
    # direct
    p = _padded_columns(window, fill, t + int(delays.max()), 0, DEV)
    dt = torch.from_numpy(delays).to(DEV)
    k = dedisperse_direct(p, dt, t)
    plain_t0 = time.perf_counter()
    kp = dedisperse_direct_plain(p, dt, t)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - plain_t0) * 1e3
    err = float((k - kp).abs().max())
    ms = time_ms(lambda i: dedisperse_direct(p, dt, t), N_TIMED)
    adds = b * n_dm * f * t
    nbytes = p.numel() * 4 + dt.numel() * 4 + k.numel() * 4
    out["dedisperse_direct"] = (err, ms, plain_ms, *bank_bound(adds, nbytes),
                                (b, f, t, n_dm), ":156")
    del p, k, kp
    # the conv plan's two stages
    intra_c, inter, rep_of, pad_f = _conv_plan(delays, _conv_auto_n_sub(delays),
                                               1)
    g, j, c = intra_c.shape
    t1 = t + int(inter.max())
    t_pad = t1 + int(intra_c.max())
    p = _padded_columns(window, fill, t_pad, pad_f, DEV).view(b, g, c, t_pad)
    it = torch.from_numpy(intra_c).to(DEV)
    s = subband_stage1(p, it, t1)
    plain_t0 = time.perf_counter()
    sp = subband_stage1_plain(p, it, t1)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - plain_t0) * 1e3
    err = float((s - sp).abs().max())
    ms = time_ms(lambda i: subband_stage1(p, it, t1), N_TIMED)
    adds = b * g * j * c * t1
    nbytes = p.numel() * 4 + it.numel() * 4 + s.numel() * 4
    out["subband_stage1"] = (err, ms, plain_ms, *bank_bound(adds, nbytes),
                             (b, g, c, t_pad, j, t1), ":179")
    offsets = _table(rep_of[None, :] * t1 + inter.T, DEV)
    o = subband_stage2(s, offsets, t)
    plain_t0 = time.perf_counter()
    op = subband_stage2_plain(s, offsets, t)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - plain_t0) * 1e3
    err2 = float((o - op).abs().max())
    ms2 = time_ms(lambda i: subband_stage2(s, offsets, t), N_TIMED)
    adds = b * n_dm * g * t
    nbytes = s.numel() * 4 + offsets.numel() * 4 + o.numel() * 4
    out["subband_stage2"] = (err2, ms2, plain_ms, *bank_bound(adds, nbytes),
                             (b, g, j, t1, n_dm, t), ":179")
    del p, s, sp, o, op
    search_window_breakdown(window, mon, smi)
    for name, (err, ms, plain_ms, bnd, by, shape, _) in out.items():
        log(f"[search kernels] {name} {shape}: max abs err vs plain {err!r}, "
            f"{ms:.3f} ms over {N_TIMED} launches, plain {plain_ms:.1f} ms, "
            f"bound {bnd:.3f} ms by {by} ({bnd / ms:.1%} of it) on {smi}")
        if err != 0.0:
            raise RuntimeError(f"{name} differs from its plain version by "
                               f"{err!r} (the same adds in the same order "
                               f"must be bit-equal)")
    return out


def search_window_breakdown(window, mon, smi) -> None:
    """Where one window's search time goes (the monitor's steps on its first
    window, host clock, each step synchronized): the conv bank (the window's
    upload, its padding on the card, both stages), the normalization and
    top-k, the host's thresholding and clustering per beam."""
    times = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    bank, valid_len = _bank("conv", window, mon.delays, mon.n_sub, DEV)
    torch.cuda.synchronize()
    times["bank"] = time.perf_counter() - t
    t = time.perf_counter()
    k = min(mon.topk, bank.shape[2] - mon.max_w + 1)
    snr, idx = _snr_topk(bank, mon.widths, k)
    times["snr_topk"] = time.perf_counter() - t
    t = time.perf_counter()
    n_points = 0
    for bi in range(window.shape[0]):
        pts = _threshold_points(snr[bi], idx[bi], mon.widths, valid_len,
                                SEARCH_CHUNK, 0, mon.threshold)
        n_points += len(pts)
        _cluster(pts, mon.dms, mon.tsamp_s, mon.band_span, mon.dm_link)
    times["cluster"] = time.perf_counter() - t
    log(f"[search window] {list(window.shape)} float32 window: "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in times.items())
        + f" ({n_points} points above threshold clustered) on {smi}")


def bank_rows(live, checked) -> list:
    """The kernels line's rows of the three dedispersion kernels."""
    return [{
        "name": name,
        "route": "cuda",
        "source": "dsabeamformer_tpu_torch/csrc/dedisperse.cu",
        "replaces": f"dsabeamformer_tpu/ops/dedisperse.py{line}",
        "launches": live[name],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": None,
        "shape": list(shape),
    } for name, (err, ms, plain_ms, bnd, by, shape, line) in checked.items()]


def mode_rows(res, suffix="") -> list:
    """The kernels line's rows of the newer modes: per mode one row of its
    detect kernel (the base variant's numbers; ``launches`` counts every
    variant its stream launched; each checked variant under ``variants``)
    and, where the voltage path ran, one of its voltage kernel."""
    rows = []
    for mode, r in res.items():
        cfg = r["cfg"]
        bnd, by = bound_ms(cfg, "base")
        variants = {}
        for v, chk in r["checked"].items():
            vb, vby = bound_ms(cfg, v)
            variants[v] = {"launches": r["launches"][v],
                           "max_abs_err": chk["max_abs_err"],
                           "ms": r["times"].get(v), "plain_ms": chk["plain_ms"],
                           "bound_ms": vb, "bound_by": vby}
        src = gemm.kernel_library(cfg, "detect_power")
        rows.append({
            "name": f"detect_power[{mode}]{suffix}",
            "route": "cuda",
            "mma": gemm.kernel_path(cfg),
            "source": f"dsabeamformer_tpu_torch/csrc/{src}.cu",
            "replaces": "dsabeamformer_tpu/ops/gemm.py:775",
            "launches": sum(r["launches"].values()),
            "max_abs_err": r["checked"]["base"]["max_abs_err"],
            "ms": r["times"]["base"],
            "plain_ms": r["checked"]["base"]["plain_ms"],
            "bound_ms": bnd,
            "bound_by": by,
            "library_ms": None,
            "variants": variants,
            "stream_launches": dict(r["launches"]),
        })
        if "volt" in r:
            src = gemm.kernel_library(cfg, "beam_voltages")
            rows.append({
                "name": f"beam_voltages[{mode}]{suffix}",
                "route": "cuda",
                "source": f"dsabeamformer_tpu_torch/csrc/{src}.cu",
                "replaces": "dsabeamformer_tpu/ops/gemm.py:932",
                **{k: r["volt"][k] for k in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "store_ceiling_ms")},
                "library_ms": None,
            })
    return rows


def kernel_rows(cfg, variants, launches, checked, times, volt,
                suffix="") -> list:
    """The kernels line's rows of one configuration: each detect variant
    (times at ``cfg``, launches on the main paths), then the voltage
    kernel."""
    rows = []
    for variant in variants:
        bnd, by = bound_ms(cfg, variant)
        rows.append({
            "name": "detect_power" + ("" if variant == "base"
                                      else f"+{variant}") + suffix,
            "route": "cuda",
            "mma": gemm.kernel_path(cfg),
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
    rows.append({
        "name": "beam_voltages" + suffix,
        "route": "cuda",
        "source": "dsabeamformer_tpu_torch/csrc/beam_voltages.cu",
        "replaces": "dsabeamformer_tpu/ops/gemm.py:932",
        **{k: volt[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "store_ceiling_ms")},
        "library_ms": None,
    })
    return rows


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
    # The search drill's capture process makes its dsa10c pulse block while
    # the phases below keep the card busy (half of /dev/shm is its to take).
    search_cfg, search_why = choose_ring_cfg(shm_free()[1] // 2,
                                             [DSA10_COMPACT])
    search_prod = Producer(search_cfg, "pulse", [(N_SEARCH, None, False)])

    # The deployed path's variants, kernel against plain, then timed.
    checked = phase_variants(cfg, blocks[0], qw,
                             [v for v in VARIANTS if v != "base"])
    checked["base"] = {"max_abs_err": cmp_full["max_abs_err"],
                       "plain_ms": res["plain_ms"]}
    phase_variants(cc, cc_block, cc_qw, ["q8", "inco", "sk", "sk+q8+inco"])
    times = phase_resident_variants(cfg, blocks, qw, checked, smi)
    times["base"] = res["ms"]

    # The full-Stokes variants, kernel against plain, physics, then timed.
    checked.update(phase_variants(cfg, blocks[0], qw,
                                  list(STOKES_VARIANTS)))
    phase_stokes_physics()
    times.update(phase_resident_variants(cfg, blocks, qw, checked, smi,
                                         STOKES_VARIANTS))
    del qw, cc_qw

    # The deployed streams (each driven with the counts set to 0).
    for b in blocks:
        with_carrier(cfg, b)
    launches.update(phase_deployed(cfg, blocks, smi))
    launches.update(phase_stokes_deployed(cfg, blocks, smi))
    # The ring ingest (its streams driven with the counts set to 0).
    phase_ring(blocks, smi)
    # The other weight modes on the same two blocks (carrier included).
    modes = phase_modes(blocks, smi)
    del blocks
    cc_blocks = [with_carrier(cc, cc_block),
                 with_carrier(cc, make_random_bytes_block(cc, seed=3))]
    launches.update(phase_other_deployments(cc, cc_blocks, smi))
    launches.update(phase_other_deployments(cc, cc_blocks, smi, "stokes"))
    del cc_blocks
    # Bytes to candidates: the live search from the ring, the offline
    # search, and the bank kernels against their plain versions.
    bank_live, bank_checked = phase_search(search_prod, search_cfg,
                                           search_why, smi)
    missing = [v for v in ALL_VARIANTS if not launches[v]]
    if missing:
        raise RuntimeError(f"variants never launched on a main path: "
                           f"{missing}")

    # The unfused validation path (driven with its count set to 0).
    volt = phase_voltages(smi)

    # DSA-110.
    d110 = phase_dsa110(smi)

    # Widths and shapes off the presets.
    phase_widths()

    kernels = kernel_rows(cfg, ALL_VARIANTS, launches, checked, times, volt)
    kernels += kernel_rows(DSA110, DSA110_VARIANTS, d110["launches"],
                           d110["checked"], d110["times"], d110["volt"],
                           "[dsa110]")
    kernels += mode_rows(modes) + mode_rows(d110["modes"], "[dsa110]")
    kernels += bank_rows(bank_live, bank_checked)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
