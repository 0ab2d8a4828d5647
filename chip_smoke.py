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
               together (on a thread, while phase 32's first capture
               process makes its blocks), and prints ``ptxas -v``.
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
               and through the voltage kernel against its plain version;
               then DSA-10's wire of 10, 12 and 20 slots
               in auto mode (a_compute 10, 12, 20; the 10 slots' rows
               start off 4 bytes) and a_compute 160, 224 and 264 (past
               255 int8 and int8x2 multiply X), every mode, a 16-channel
               slice of 1024 samples: the detect (power) and the voltage
               kernels against plain (int8-mode voltages equal), then
               stokes+sk+q8+inco with the bars of phase 11.
29b. K loop -- past the staged tile (each mode's widest a_compute whose
               whole weight tile fitted beside an output row at navg 16,
               plus 8; 2048; 2056 on 2058 slots), every mode on a 4-channel
               DSA-110 slice: the detect kernel's K loop (and the voltage
               kernel's, where its tile does not fit either) against plain
               as above; then int8x2 and bf16x2 at a_compute 2048: a
               3-block power stream and one voltage call with their launch
               counts from 0, each kernel timed beside its bound and its
               plain version (the kernels line's ``[kloop,...]`` rows).

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
               timed over 10 launches, with its bound, its share of it and
               the share of (warp, channel)s its register window serves; and
               stage 1's library yardstick, one float32 grouped one-hot
               ``conv1d`` (TF32 off), timed over 3 launches; then, at the
               dsa10_frb cell's shapes (256 beams to DM 1000, 4637 trials,
               9923-sample windows) on seeded noise counts, stage 1 and
               stage 2 on one stage-1 chunk of beams and ``snr_topk`` on
               one beam group sized as the cell sizes it, each bit-equal to
               its plain version and timed beside its bound (the top-k's
               launches counted from 0 on the live stream).  Between the
               offline search and the kernels, ``dsabf-torch`` on the same
               products (subprocesses, ``--device 0``): ``search`` of the
               four offline beams' .fil files (coincidence off), its .cand
               rows one for one with the in-process offline search over the
               grid the CLI derives from the .fil headers; ``search`` of the
               32-beam set's files with coincidence on (the arrivals it
               keeps logged beside the live monitor's); ``search inco.dada
               --stream --beam incoherent``; ``fold --dm 50`` of the pulse
               beam at one block's period (its peak within one bin of the
               arrival phase); ``waterfall --cand`` of the first search's
               brightest row (the PGM's size as printed).

The port's CLI, ``dsabf-torch`` (each command a subprocess on the card):

32. cli     -- (run first, while this process holds little host memory)
               the deployed dsa10c configuration from a ring: ``simulate
               --pulse-dm 50`` (8 blocks: the pulse block, then 3 distinct
               noise blocks in turn; a ring that holds them all; started
               beside phase 2) and, once the kernels are built, ``run --device 0
               --fil-dir --fil-bits 8 --incoherent-file --rfi-auto
               --search-dm-max 100`` (32 beams, every 8th from 7,
               coincidence off), its record and per-block times logged (the
               operating point), the pulse found in beam 127 within a DM
               trial of 50, no candidate away from it at S/N 20 or more,
               and every .fil and the incoherent file byte-equal to an
               in-process stream over the sequence numbers the run
               received; ``selftest --device 0`` and ``info``; then
               ``launch --subbands 8 --devices
               0,0,0,0,0,0,0,0`` over eight ``simulate --config dsa110
               --subband i/8`` rings (each its own noise rms, 2 distinct
               blocks in turn, 6 blocks, 32-bit .fil of every beam),
               ``splice`` of beams 0, 100, 300 and 511 against one
               in-process full-band dsa110 run over the same blocks
               (bit-equal expected, 1e-5 at worst); between the two, the
               joined live search: two capture rings hold the channel
               halves of 4 dsa10c blocks (the pulse block and the noise
               blocks above), ``launch --subbands 2 --devices 0,0
               --output-key`` beamforms them into two product rings and
               ``search --key <prod>0,<prod>1`` (32 beams, coincidence off)
               reads them as they are written: 0 dropped, its .cand rows
               one for one with an in-process full-band power stream's
               SearchMonitor of the CLI's parameters, the pulse in beam 127
               within a DM trial of 50; last, ``trace --config dsa10
               --blocks 3``: the detect kernel 3 times in its rows, the
               kernels' busy share of the traced window logged.

The calibration loop, the (l, m) beam grids, the beam pattern and bench
(each path's detect launches counted from 0 and booked to the base row of its
configuration's a_compute):

33. calibrate -- full dsa10c width: one calibrator block at beam 100 (the
               JAX package's corrupted instrument: gains 1 +- 0.15 in
               amplitude and 1.5 rad in phase per antenna and channel, a
               source of amplitude 2.5 in noise of rms 0.15) drawn on the
               card and written to a .dada; ``dsabf-torch calibrate
               --device 0`` solves it, and ``solve_gains`` solves the same
               bytes on the card (timed, upload included) and on the CPU:
               the tables within 1e-6 of the CPU's, the phases within 0.1
               rad of the injected inverse; through make_weights(cal=) and
               the detect kernel the target beam peaks, at >= 0.8x the
               exact inverse's power and >= 1.5x the uncorrected.
34. lm      -- DSA110.subband(0, 256), its 110 dishes on a seeded 600 m
               square, a 16 x 32 (l, m) grid of the 512 beams:
               make_weights_lm on the card within 1e-4 of the golden (its
               phase is float32 there); a 2-D point source at grid beam 300
               drawn on the card through the detect kernel within 1e-5 of
               its plain version and peaking there; a 128-channel,
               512-sample cut within 1e-3 of the float64 golden.
35. beampattern -- beam_response at full dsa110 and dsa10 and
               beam_response_lm at full dsa110 (the [lm] layout and grid) on
               the card in complex128, timed: each swept source peaks in its
               matched beam, single channels within 1e-9 of the CPU's, the
               central beam's half-power width within 0.7-1.3 of
               beam_fwhm_rad; then ``dsabf-torch beampattern --config dsa10
               --device 0``: a PNG, or, on a host without matplotlib, exit 2
               with one line naming it (logged as a render not run).
36. bench   -- ``dsabf-torch bench --config dsa10`` (kernel mode, 16
               blocks: within 5% of phase 5's int8x2 time) and ``bench
               --config dsa10c --bench-mode stream`` (16 blocks, 0 dropped),
               both records printed; ``bench_kernel`` at dsa10c in this
               process counts the launches.
37. mesh    -- inside phase 18 (dsa110), on its two full-band blocks: 8
               slots of the card, each the per-GPU subband, byte-equal to
               the single-device detect kernel in base, Stokes and
               +sk+q8+inco (the band within 1e-5 of the product's channel
               sum), the step timed with its shard copies and gather; a
               4-block ``MeshStreamingBeamformer`` stream (the calibrated
               table from block 2) equal to the single-device stream; and,
               beside phases 10 and 15, ``run --config dsa10c --mesh 8
               --device 0`` and ``run --device 0`` on a 3-block capture,
               their files byte-equal.
38. tp      -- inside phase 18: ``DSA110.subband(0, 256)`` on a (2, 2)
               mesh in int8x2, bf16x2 and f32, power and Stokes: 4 voltage
               launches a step, within 1e-5 of the fused detect kernel.
39. multihost -- beside phase 29 (widths): 2 processes under gloo sharing
               the card, 2 slots each, over full dsa110, each making its
               own subband's bytes; 4 blocks, the calibrated table from
               block 2; byte-equal (fingerprints) to the single-device
               product's channel slices, the all-reduced band within 1e-5
               of the full band's sum.

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

Every process the script starts ends before it does, on success or failure:
the script reaps its descendants at any depth (``launch``'s children run in
sessions of their own and pass to it if ``launch`` ends first), ends with
SIGTERM through the same sweep, stops the ``multiprocessing`` resource
tracker its capture processes started, and fails if any other process was
still running when its work was done.
"""

from __future__ import annotations

import collections
import ctypes
import gc
import hashlib
import json
import multiprocessing
import multiprocessing.resource_tracker
import multiprocessing.util
import os
import shutil
import signal
import socket
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import (
    DSA10,
    DSA10_COMPACT,
    DSA110,
    SPEED_OF_LIGHT_M_S,
)
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
from dsabeamformer_tpu_torch.models.arrays import ArrayLayout, array_for
from dsabeamformer_tpu_torch.models.beampattern import (
    beam_fwhm_rad,
    beam_response,
    beam_response_lm,
)
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.calsolver import solve_gains
from dsabeamformer_tpu_torch.models.weights import (
    make_weights,
    make_weights_lm,
    weights_lm_numpy_golden,
    weights_numpy_golden,
    zap_weights,
)
from dsabeamformer_tpu_torch.ops import _build, gemm
from dsabeamformer_tpu_torch.ops.dedisperse import (
    DEFAULT_WIDTHS,
    KERNEL_SOURCE as DEDISPERSE_SOURCE,
    SearchMonitor,
    _bank,
    _beam_group,
    _cluster,
    _conv_auto_n_sub,
    _conv_plan,
    _fill,
    _limits,
    _median_last,
    _normalize,
    _snr_topk,
    _stage1_beams,
    _table,
    _threshold_points,
    _valid_len,
    _window_columns,
    dedisperse_direct,
    dedisperse_direct_plain,
    dm_trial_grid,
    median_rows,
    read_candidates,
    search_spectrograms,
    snr_topk,
    snr_topk_plain,
    subband_stage1,
    subband_stage1_plain,
    subband_stage2,
    subband_stage2_plain,
    bank_paths,
)
from dsabeamformer_tpu_torch.ops.packing import pack_4r4i
from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
from dsabeamformer_tpu_torch.ops.reference import (
    beamform_block_ref,
    beamform_stokes_ref,
)
from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor
from dsabeamformer_tpu_torch.parallel.multihost import (
    MultihostMeshStreamingBeamformer,
    host_subbands,
    initialize_multihost,
    my_subband,
)
from dsabeamformer_tpu_torch.parallel.sharding import (
    make_mesh,
    place_weights,
    sharded_beamformer,
    sharded_wire_sharding,
)
from dsabeamformer_tpu_torch.parallel.tensor import (
    make_tp_mesh,
    shard_weights_tp,
    tp_beamformer,
)
from dsabeamformer_tpu_torch.pipeline import (
    FileSink,
    MeshStreamingBeamformer,
    RingSource,
    StreamingBeamformer,
    SyntheticSource,
)
from dsabeamformer_tpu_torch.utils.bench import bench_kernel
from dsabeamformer_tpu_torch.utils.hostenv import process_rss_mb
from dsabeamformer_tpu_torch.utils.metrics import tensor_core_utilization
from dsabeamformer_tpu_torch.utils.profiling import trace_events
from dsabeamformer_tpu_torch.utils.quicklook import (
    load_dynamic_spectra,
    load_dynamic_spectrum,
)
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
N_LIBRARY_TIMED = 3          # launches of a library call timed beside one
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


def random_blocks(cfg, seeds) -> list:
    """``make_random_bytes_block`` of each seed, made on two threads
    (NumPy's generator runs without the GIL): the same bytes."""
    with ThreadPoolExecutor(max_workers=2) as maker:
        return list(maker.map(
            lambda s: make_random_bytes_block(cfg, seed=s), seeds))


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


#: Host threads for the float64 golden references: NumPy's einsum runs
#: without the GIL on one core each, while the card runs other checks.
GOLDEN_POOL = ThreadPoolExecutor(max_workers=2)
_GOLDEN: dict = {}


def golden(kind, cfg, target=TARGET_BEAM):
    """Future of ``make_golden(kind, cfg, target)``, started at the first
    call for a geometry and shared by every later one: the references do
    not depend on the weight mode or the layout (the ftpa block holds the
    same voltages), so each is made once per run."""
    key = (kind, cfg.replace(weight_mode="int8x2", input_layout="tfpa"),
           target)
    if key not in _GOLDEN:
        _GOLDEN[key] = GOLDEN_POOL.submit(make_golden, *key)
    return _GOLDEN[key]


def make_golden(kind, cfg, target) -> tuple:
    """``(wire, reference, table)``: the sub-band point source at beam
    ``target`` (seed 7, noise rms 0.4) against the float64 golden model,
    its power (``point``) or its four Stokes parameters (``stokes``), with
    unity gains; or a noise block (seed 21, rms 2.5) through
    ``CalTable.random(seed=11)`` (``noise``)."""
    if kind == "noise":
        cal = CalTable.random(cfg, seed=11)
        wire = make_noise_block(cfg, rms=2.5, seed=21)
        return wire, active_ref(beamform_block_ref, weights_numpy_golden(
            cfg, cal=cal), wire, cfg), cal
    wire = make_point_source_block(cfg, angle_rad=cfg.beam_angles_rad()[
        target], noise_rms=0.4, seed=7)
    ref = beamform_stokes_ref if kind == "stokes" else beamform_block_ref
    return wire, active_ref(ref, weights_numpy_golden(cfg), wire, cfg), None


def active_ref(ref, weights, wire, cfg):
    """``ref`` (``beamform_block_ref`` / ``beamform_stokes_ref``) over the
    active antennas alone: the padded slots' weights and bytes are zero, so
    they add nothing but time (54 of DSA-10's 64 slots)."""
    a = cfg.n_ant_active
    return ref(weights[..., :a], wire[..., :a], cfg.input_layout,
               cfg.navg_time)


def phase_physics(cfg=DSA10.replace(n_chan=128, t_block=512),
                  target=TARGET_BEAM, bar=GOLDEN_RTOL) -> None:
    """A sub-band point source at beam ``target``, tfpa and ftpa, against
    the float64 golden model."""
    wire, p_ref, _ = golden("point", cfg, target).result()
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
    wire, ref, _ = golden("stokes", cfg, target).result()
    ref = torch.from_numpy(ref)
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
    blocks = random_blocks(cfg, (10, 11))
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
    log(f"[dsa110] variants, physics and times in "
        f"{time.perf_counter() - t0:.1f} s")
    # The channel mesh of the card's slots on the same blocks.
    log(f"[dsa110] {host_memory()}")
    scaleout = phase_mesh(blocks, scaleout_tables(cfg), times["base"], smi)

    sub = DSA110_SUBBAND
    sub_blocks = [make_random_bytes_block(sub, seed=s) for s in (12, 13)]
    phase_transfers(sub, sub_blocks[0])
    tp = phase_tp(sub_blocks[0], smi)
    modes = phase_dsa110_modes(blocks, sub_blocks, smi)
    del blocks
    log(f"[dsa110] modes done at {time.perf_counter() - t0:.1f} s")
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
            "volt": volt, "modes": modes, "scaleout": scaleout, "tp": tp}


# --------------------------------------------------------------------- #
# Scale-out: the channel mesh, the antenna split, processes on one card
# --------------------------------------------------------------------- #

MESH_SLOTS = 8               # DSA-110's eight 256-channel subbands
#: The mesh step's variants, each held to the single-device kernel byte for
#: byte (the first two with band power, which turns the uint8 epilogue off).
MESH_VARIANTS = ("base", "stokes", "sk+q8+inco")
N_MESH_TIMED = 4             # back-to-back calls in the mesh's timings
N_MESH_STREAM = 4            # blocks of the mesh stream
MESH_CAL_SEED = 7            # the calibration of the table swapped in
BAND_RTOL = 1e-5             # the band against the product's channel sum
TP_SHAPE = (2, 2)            # (channel groups, antenna groups)
TP_MODES = ("int8x2", "bf16x2", "f32")
TP_RTOL = 1e-5               # against the single-device fused kernel
MULTIHOST_PROCS = 2          # processes sharing the card under gloo
MULTIHOST_SLOTS = 2          # mesh slots of each process
#: The 8-bit .fil scale of the ``run --mesh`` comparison: fixed (the [cli]
#: drill covers the auto scale), so the uint8 epilogue runs from block 0;
#: a random-bytes dsa10c beam's power is ~1.4e4, so counts sit near 64.
MESH_CLI_FIL_SCALE = 0.005


def scaleout_tables(cfg=DSA110) -> list:
    """The two full-band tables of the scale-out streams: unity, then the
    calibration swapped in mid-stream (each process makes them alike: the
    card makes the same bytes every time)."""
    return [prepare_weights(cfg, make_weights(cfg, cal=cal, device=DEV))
            for cal in (None, CalTable.random(cfg, seed=MESH_CAL_SEED))]


class BandSink(FingerprintSink):
    """A FingerprintSink that also keeps each block's band: its sum over
    channels and beams."""

    def __init__(self):
        super().__init__(keep=1)
        self.bands = []

    def write(self, seq, powers):
        super().write(seq, powers)
        self.bands.append(torch.from_numpy(powers).sum(dim=(0, 2)))


def band_close(got, want) -> bool:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return bool(((got - want).abs() <= BAND_RTOL * want.abs()).all())


def phase_mesh(blocks_np, tables, single_ms, smi) -> int:
    """[mesh]: full ``dsa110`` on 8 slots of the card, each slot the
    deployment's per-GPU subband (``DSA110.subband(k*256, 256)``): the mesh
    step of each of ``MESH_VARIANTS`` against the single-device kernel on
    the same block, byte for byte, and the band against the product's own
    channel sum; the step, its shard copies and its gather timed beside the
    single-device kernel; then a 4-block ``MeshStreamingBeamformer`` stream
    (band power on, the calibrated table swapped in at the drain of block
    0, so from block 2) against the single-device stream of the same
    blocks.  Returns the detect launches of the mesh stream."""
    cfg = DSA110
    t0 = time.perf_counter()
    mesh = make_mesh(MESH_SLOTS, devices=[DEV] * MESH_SLOTS)
    local = cfg.replace(n_chan=cfg.n_chan // MESH_SLOTS)
    qw = tables[0]
    qw_sh = place_weights(qw, mesh)
    split = sharded_wire_sharding(cfg, mesh)
    x = to_device(cfg, blocks_np[0])
    f32 = gemm.beamform_power(x, qw, cfg)
    for variant in MESH_VARIANTS:
        q8, inco, sk = ALL_VARIANTS[variant]
        stokes = variant in STOKES_VARIANTS or variant == "stokes"
        kw = side_kwargs(cfg, variant, f32)
        step = sharded_beamformer(
            cfg, mesh, products="stokes" if stokes else "power",
            incoherent=inco, flag_ants=(flagged_ant(cfg),) if inco else (),
            sk_stats=sk, fused_quant8=q8, with_band_power=not q8)
        args = (kw["quant8_scales"],) if q8 else ()
        got = step(x, qw_sh, *args)
        got = list(got) if isinstance(got, tuple) else [got]
        detect = gemm.beamform_stokes if stokes else gemm.beamform_power
        want = detect(x, qw, cfg, incoherent=inco,
                      flag_ants=(flagged_ant(cfg),) if inco else (),
                      sk_stats=sk, quant8_scales=kw["quant8_scales"])
        want = list(want) if isinstance(want, tuple) else [want]
        equal = [torch.equal(g, w) for g, w in zip(got, want)]
        band_ok = True
        if not q8:
            plane = want[0][:, :, 0] if stokes else want[0]
            band_ok = band_close(got[-1], plane.sum(dim=(0, 2)))
        log(f"[mesh] {cfg.name} {variant} on {MESH_SLOTS} slots of "
            f"{local.n_chan} channels: outputs "
            f"{[tuple(g.shape) for g in got]} equal the single-device "
            f"kernel's {equal}" + ("" if q8 else
                                   f"; band within {BAND_RTOL} of the "
                                   f"product's channel sum {band_ok}"))
        if not all(equal) or not band_ok:
            raise RuntimeError(f"[mesh] {variant}: mesh differs from one "
                               f"device")
        del got, want
    del f32
    step = sharded_beamformer(cfg, mesh)
    shards = split.put(x)
    outs = [gemm.beamform_power(s, q, local) for s, q in zip(shards, qw_sh)]
    mesh_ms = time_ms(lambda i: step(x, qw_sh), N_MESH_TIMED)
    split_ms = time_ms(lambda i: split.put(x), N_MESH_TIMED)
    kernels_ms = time_ms(lambda i: [gemm.beamform_power(s, q, local)
                                    for s, q in zip(shards, qw_sh)],
                         N_MESH_TIMED)
    gather_ms = time_ms(lambda i: torch.cat(outs), N_MESH_TIMED)
    del shards, outs
    log(f"[mesh] {cfg.name} step on {MESH_SLOTS} slots {mesh_ms:.3f} "
        f"ms/block against the single-device kernel's {single_ms:.3f} "
        f"(x{mesh_ms / single_ms:.3f}): the {MESH_SLOTS} kernels "
        f"{kernels_ms:.3f} ms, the shard copies {split_ms:.3f} ms "
        f"({cfg.wire_block_bytes / 1e9:.3f} GB), the gather "
        f"{gather_ms:.3f} ms ({np.prod(cfg.out_block_shape) * 4 / 1e9:.3f} "
        f"GB) on {smi}")
    del x

    runs = {}
    for name in ("mesh", "single"):
        sink = BandSink()
        bands = {}
        kw = dict(mesh=mesh, with_band_power=True,
                  on_band_power=lambda seq, band: bands.__setitem__(
                      seq, band)) if name == "mesh" else {}
        klass = MeshStreamingBeamformer if name == "mesh" \
            else StreamingBeamformer
        bf = klass(cfg, tables[0], SyntheticSource(cfg, blocks_np,
                                                   N_MESH_STREAM), sink,
                   depth=1, **kw)
        bf.on_block = lambda bs, bf=bf: bs.block_idx == 0 and \
            bf.update_weights(tables[1])
        bf.warmup()
        clear_launches()
        stats = bf.run()
        bf.on_block = None  # its closure holds the stream: free both now
        launches = sum(gemm.fused_detect.launches.values())
        runs[name] = sink, bands, launches
        log(f"[mesh] {name} stream: {stats.n_blocks} blocks, "
            f"{stats.wall_s * 1e3 / stats.n_blocks:.2f} ms/block (4 blocks "
            f"from host memory, start-up included: not a steady rate), "
            f"detect launches {launches}")
        if stats.n_blocks != N_MESH_STREAM or stats.dropped:
            raise RuntimeError(f"[mesh] {name} stream: {stats.n_blocks} "
                               f"blocks, {stats.dropped} dropped")
        del bf
    (m_sink, m_bands, m_n), (s_sink, _, s_n) = runs["mesh"], runs["single"]
    same = m_sink.sums == s_sink.sums \
        and torch.equal(m_sink.first[0], s_sink.first[0])
    swapped = m_sink.sums[2] != m_sink.sums[0]
    bands_ok = sorted(m_bands) == list(range(N_MESH_STREAM)) and all(
        band_close(m_bands[k], s_sink.bands[k]) for k in m_bands)
    log(f"[mesh] mesh stream equals the single-device stream block for "
        f"block {same} (fingerprints, block 0 whole); the swapped table "
        f"ran from block 2 {swapped}; bands within {BAND_RTOL} of the "
        f"single-device blocks' sums {bands_ok}; launches {m_n} (mesh) / "
        f"{s_n} (one device) in {time.perf_counter() - t0:.1f} s")
    if not (same and swapped and bands_ok) \
            or m_n != N_MESH_STREAM * MESH_SLOTS or s_n != N_MESH_STREAM:
        raise RuntimeError("[mesh] the mesh stream differs from one device")
    torch.cuda.empty_cache()
    return m_n


def start_mesh_cli(cc_blocks, tmp) -> dict:
    """[mesh] ``dsabf-torch run --config dsa10c --mesh 8 --device 0`` and
    ``run --device 0`` started at once on a 3-block capture (8-bit .fil of
    256 beams at ``MESH_CLI_FIL_SCALE``, the incoherent .dada,
    ``--rfi-auto`` excising the carrier); ``finish_mesh_cli`` compares
    their files."""
    # The two processes share the card with this one: its cached blocks go
    # back to the device first.
    torch.cuda.empty_cache()
    cap = tmp / "cap.raw"
    with open(cap, "wb") as f:
        for k in (0, 1, 0):
            f.write(cc_blocks[k].tobytes())
    procs = {}
    try:
        for name, extra in (("mesh", ["--mesh", str(MESH_SLOTS)]),
                            ("single", [])):
            procs[name] = start_cli(
                ["run", "--config", "dsa10c", "--input-file", str(cap),
                 "--fil-dir", str(tmp / name), "--fil-bits", "8",
                 "--fil-scale", str(MESH_CLI_FIL_SCALE),
                 "--incoherent-file", str(tmp / f"{name}.dada"),
                 "--rfi-auto", "--device", "0"] + extra,
                tmp / f"{name}.log")
    except BaseException:
        stop_all(list(procs.values()))
        raise
    return {"procs": procs, "tmp": tmp, "t0": time.perf_counter()}


def finish_mesh_cli(run, smi) -> None:
    """The same files, byte for byte, from ``run --mesh`` and ``run``."""
    procs, tmp = run["procs"], run["tmp"]
    try:
        recs = {name: json.loads(finish_cli(
            p, f"run ({name})", tmp / f"{name}.log").strip().splitlines()[-1])
            for name, p in procs.items()}
    finally:
        stop_all(list(procs.values()))
    logs = {name: (tmp / f"{name}.log").read_text() for name in procs}
    n, bad, nbytes = files_equal(tmp / "mesh", tmp / "single")
    inco_same = (tmp / "mesh.dada").read_bytes() \
        == (tmp / "single.dada").read_bytes()
    rfi = [sum("[dsabf] rfi" in ln for ln in logs[k].splitlines())
           for k in ("mesh", "single")]
    log(f"[mesh] cli: run --config dsa10c --mesh {MESH_SLOTS} --device 0 "
        f"and run --device 0 on 3 blocks: {n} .fil files, {bad} differ "
        f"({nbytes} bytes); incoherent .dada equal {inco_same}; rfi lines "
        f"{rfi}; records {recs['mesh']['blocks']} / "
        f"{recs['single']['blocks']} blocks, {recs['mesh']['wall_s']:.2f} / "
        f"{recs['single']['wall_s']:.2f} s (beside the other deployments) "
        f"in {time.perf_counter() - run['t0']:.1f} s on {smi}")
    if bad or not inco_same or rfi[0] != rfi[1] or not rfi[0] \
            or f"mesh: {MESH_SLOTS} device(s)" not in logs["mesh"] \
            or recs["mesh"]["blocks"] != 3 or recs["single"]["blocks"] != 3:
        raise RuntimeError("[mesh] run --mesh differs from run")


def phase_tp(sub_block, smi) -> collections.Counter:
    """[tp]: the per-GPU subband ``DSA110.subband(0, 256)`` on a (2, 2)
    mesh of the card in each of ``TP_MODES``, power and Stokes: the
    voltage kernel on every slot (4 launches a step), the partial voltages
    summed over the antenna axis, detected; held within 1e-5 of the
    single-device fused detect kernel on the same block (Stokes: of the I
    plane's peak), timed.  Returns the voltage launches by mode."""
    t0 = time.perf_counter()
    n_slots = TP_SHAPE[0] * TP_SHAPE[1]
    mesh = make_tp_mesh(*TP_SHAPE, devices=[DEV] * n_slots)
    launches = collections.Counter()
    for mode in TP_MODES:
        cfg = DSA110_SUBBAND.replace(weight_mode=mode)
        x = to_device(cfg, sub_block)
        qw_tp = shard_weights_tp(cfg, mesh)
        qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
        for products in ("power", "stokes"):
            step = tp_beamformer(cfg, mesh, products=products)
            gemm.beamform_voltages.launches_by_mode.clear()
            got = step(x, qw_tp)
            n = gemm.beamform_voltages.launches_by_mode[mode]
            launches[mode] += n
            if products == "stokes":
                want = gemm.beamform_stokes(x, qw, cfg)
                err = max(plane_errors(got, want))
            else:
                want = gemm.beamform_power(x, qw, cfg)
                err = relative_power_error_on_card(got, want)
            del got, want
            ms = time_ms(lambda i: step(x, qw_tp), 2)
            log(f"[tp] {tag(cfg)} subband of {cfg.n_chan} channels "
                f"{products} on a {TP_SHAPE} mesh: "
                f"{n} voltage launches, {ms:.3f} ms a step, against the "
                f"fused kernel {err:.3e} (limit {TP_RTOL}) on {smi}")
            if n != n_slots or not err <= TP_RTOL:
                raise RuntimeError(f"[tp] {mode} {products}: {n} launches, "
                                   f"error {err}")
        del qw_tp, qw, x
    log(f"[tp] done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches


def multihost_seed(k, r) -> int:
    """Seed of process ``r``'s subband of block ``k`` in [multihost]: each
    process makes only its own subband's bytes."""
    return 1100 + 10 * k + r


def host_memory() -> str:
    """This process's resident set, the pinned memory PyTorch holds for it
    and the machine's available memory."""
    avail = next(int(ln.split()[1]) for ln in open("/proc/meminfo")
                 if ln.startswith("MemAvailable:"))
    pinned = {k: v for k, v in torch.cuda.memory.host_memory_stats().items()
              if k.endswith("bytes.current")}
    return (f"host RSS {process_rss_mb() / 1024:.1f} GiB (pinned memory "
            f"stats {pinned}), available {avail / 2**20:.1f} GiB")


def multihost_child(rank, port, go, results) -> None:
    """One process of [multihost]: makes its CUDA context, joins the gloo
    group and waits for ``go``; then makes its own subband of the two
    blocks, streams them through ``MultihostMeshStreamingBeamformer`` on
    its own slots of the card, 4 blocks, the calibrated table from block
    2, band power on; puts its blocks' fingerprints, bands and detect
    launches on ``results``."""
    import traceback

    try:
        torch.zeros(1, device=DEV)
        initialize_multihost(f"localhost:{port}", MULTIHOST_PROCS, rank,
                             backend="gloo")
        try:
            if not go.wait(timeout=2 * CLI_TIMEOUT):
                raise RuntimeError("no go from the parent")
            t0 = time.perf_counter()
            steps = {}
            cfg = DSA110
            sub = my_subband(cfg)
            sub_cfg = sub.config(cfg)
            blocks = [make_random_bytes_block(sub_cfg,
                                              seed=multihost_seed(k, rank))
                      for k in range(2)]
            steps["blocks"] = time.perf_counter() - t0
            tables = scaleout_tables(cfg)
            steps["tables"] = time.perf_counter() - t0
            mesh = make_mesh(MULTIHOST_SLOTS, devices=[DEV] * MULTIHOST_SLOTS)
            sink, bands = FingerprintSink(keep=0), {}
            bf = MultihostMeshStreamingBeamformer(
                cfg, tables[0], SyntheticSource(sub_cfg, blocks,
                                                N_MESH_STREAM), sink,
                mesh=mesh, depth=1, with_band_power=True,
                on_band_power=lambda seq, band: bands.__setitem__(
                    seq, band.tolist()))
            bf.on_block = lambda bs: bs.block_idx == 0 and \
                bf.update_weights(tables[1])
            bf.warmup()
            steps["warmup"] = time.perf_counter() - t0
            clear_launches()
            stats = bf.run()
            steps["stream"] = time.perf_counter() - t0
            results.put({
                "rank": rank, "sub": [sub.chan_start, sub.n_chan],
                "sums": sink.sums, "bands": bands, "blocks": stats.n_blocks,
                "launches": sum(gemm.fused_detect.launches.values()),
                "ms": stats.wall_s * 1e3 / max(stats.n_blocks, 1),
                "steps": {k: round(v, 1) for k, v in steps.items()},
                "memory": host_memory(), "error": None})
        finally:
            torch.distributed.destroy_process_group()
    except Exception:
        results.put({"rank": rank, "error": traceback.format_exc()})


def spawn_multihost() -> dict:
    """[multihost], spawned: 2 processes that import this script, make
    their CUDA contexts and join their gloo group while the phases before
    run, touching nothing else of the card until ``start_multihost``."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    go, results = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=multihost_child,
                         args=(r, port, go, results), daemon=True)
             for r in range(MULTIHOST_PROCS)]
    for p in procs:
        p.start()
    return {"procs": procs, "go": go, "results": results}


def start_multihost(run, smi) -> dict:
    """[multihost], started: 2 processes sharing the card under gloo, 2
    slots each, over full ``dsa110`` (1024 channels a process, 512 a
    slot), each making only its own subband's bytes of two blocks
    (``multihost_seed``), 4 blocks, the calibrated table from block 2.
    While they run (and the phase after this one), a thread here makes the
    full-band blocks of the references (the subbands side by side);
    ``finish_multihost`` makes the single-device products and holds the
    processes to them."""
    cfg = DSA110
    log(f"[multihost] before the processes go: {host_memory()}")
    # The pinned buffers the streams above left go back to the host, and
    # the card's cached blocks to the card: three processes share both now
    # (torch 2.11 names the pinned cache's call so; a build without it
    # keeps its cache).
    gc.collect()
    empty_pinned = getattr(torch._C, "_host_emptyCache", None)
    if empty_pinned is not None:
        empty_pinned()
    torch.cuda.empty_cache()
    log(f"[multihost] after the caches are emptied: {host_memory()}")
    run = {**run, "t0": time.perf_counter(), "smi": smi}
    run["go"].set()
    subs = host_subbands(cfg, MULTIHOST_PROCS)
    axis = 1 if cfg.input_layout == "tfpa" else 0
    run["maker"] = ThreadPoolExecutor(max_workers=1)
    run["blocks"] = [run["maker"].submit(lambda k=k: np.concatenate(
        [make_random_bytes_block(s.config(cfg), seed=multihost_seed(
            k, s.host_index)) for s in subs], axis=axis)) for k in range(2)]
    return run


def finish_multihost(run) -> int:
    """[multihost], finished: each process's blocks held, byte for byte
    (fingerprints), to the channel slice of the single-device product, and
    its all-reduced bands to the full band's sums.  Returns the processes'
    detect launches."""
    cfg = DSA110
    procs = run["procs"]
    subs = host_subbands(cfg, MULTIHOST_PROCS)
    try:
        # The references: the single-device product of each (block, table),
        # its subbands' fingerprints and its band.
        refs = {}
        tables = scaleout_tables(cfg)
        for k, block in enumerate(run["blocks"]):
            x = to_device(cfg, block.result())
            for w, qw in enumerate(tables):
                p = gemm.beamform_power(x, qw, cfg)
                refs[k, w] = ([int(p[s.chan_start:s.chan_start
                                     + s.n_chan].view(torch.int64).sum())
                               for s in subs], p.sum(dim=(0, 2)).cpu())
                del p
            del x
        del tables
        got = sorted((run["results"].get(timeout=CLI_TIMEOUT)
                      for _ in procs), key=lambda r: r["rank"])
    finally:
        run["maker"].shutdown(cancel_futures=True)
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    errors = [r["error"] for r in got if r["error"]]
    if errors or any(p.exitcode for p in procs):
        raise RuntimeError(f"[multihost] a process failed (exit codes "
                           f"{[p.exitcode for p in procs]}):\n"
                           + "\n".join(errors))
    launches = 0
    for r in got:
        # Blocks 0, 1, 0, 1; the calibrated table from block 2.
        want = [refs[seq % 2, int(seq >= 2)] for seq in range(N_MESH_STREAM)]
        same = r["sums"] == [fp[r["rank"]] for fp, _ in want]
        bands_ok = sorted(r["bands"]) == list(range(N_MESH_STREAM)) and all(
            band_close(r["bands"][seq], want[seq][1])
            for seq in range(N_MESH_STREAM))
        log(f"[multihost] process {r['rank']} (channels {r['sub'][0]}.."
            f"{r['sub'][0] + r['sub'][1] - 1}, {MULTIHOST_SLOTS} slots): "
            f"{r['blocks']} blocks, {r['ms']:.2f} ms/block (start-up "
            f"included, beside [widths]), equal to the single-device "
            f"slices {same}, all-reduced bands within {BAND_RTOL} of the "
            f"full band's {bands_ok}, detect launches {r['launches']}; "
            f"seconds from go to its blocks, tables, warmup and stream's "
            f"end {r['steps']}; {r['memory']}")
        if not (same and bands_ok) or r["blocks"] != N_MESH_STREAM \
                or r["launches"] != N_MESH_STREAM * MULTIHOST_SLOTS:
            raise RuntimeError(f"[multihost] process {r['rank']} differs")
        launches += r["launches"]
    log(f"[multihost] {MULTIHOST_PROCS} gloo processes x {MULTIHOST_SLOTS} "
        f"slots on one card: {time.perf_counter() - run['t0']:.1f} s from "
        f"go (their blocks, weights and warmup included; spawned, with "
        f"their CUDA contexts and gloo group, before [dsa110]) on "
        f"{run['smi']}")
    return launches


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
    wire, ref, cal = golden("noise", cfg).result()
    qw = prepare_weights(cfg, make_weights(cfg, cal=cal, device=DEV))
    p = gemm.beamform_power(to_device(cfg, wire), qw, cfg).cpu().numpy()
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
        t0 = time.perf_counter()
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
        log(f"[modes] {tag(cfg)} in {time.perf_counter() - t0:.1f} s")
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
#: DSA-10's wire in auto mode (10, 12 and 20 slots: a_compute 10, 12, 20,
#: int13's 20 rounded to 16; the 10 slots' pol y rows off 4 bytes) and past
#: the DSA-110 width (160, 224; 264, where int8 and int8x2 multiply X, not
#: 16 X): every mode, power and Stokes with every side output and voltages
#: against plain, on a 16-channel slice of 1024 samples.
NEW_WIDTHS = (10, 12, 20, 160, 224, 264)
#: Past the staged tile: each mode's widest a_compute whose whole weight
#: tile fitted beside an output row at navg 16, plus 8; 2048; and 2056
#: (2058 slots, so that pol y's rows start off 4 bytes): the detect kernel
#: walks K in slices there (``gemm.KLOOP_MMA``), and so does the voltage
#: kernel where its tile does not fit either.  A 4-channel DSA-110 slice.
STAGED_EDGE = {"int8": 1152, "int8x2": 704, "int12": 704, "int13": 384,
               "bf16": 704, "bf16x2": 392, "f32": 272}
KLOOP_CHANNELS = 4
#: The K-loop rows of the kernels line: int8x2 and bf16x2 at a_compute 2048
#: on that slice, timed.
KLOOP_TIMED = ("int8x2", "bf16x2")


def width_cfg(ac, n_chan=VOLTAGE_CHANNELS, **kw):
    """A DSA-110 sub-band contracting exactly ``ac`` antennas, two of its
    slots inactive."""
    return DSA110.replace(name=f"dsa110-ac{ac}", n_chan=n_chan,
                          n_ant=max(DSA110.n_ant, ac), n_ant_active=ac - 2,
                          n_ant_compute=ac, **kw)


def new_width_cfg(ac, mode, layout):
    """``NEW_WIDTHS``' configs: a DSA-10 wire of ``ac`` slots (10 active)
    in auto mode, or a DSA-110 slice contracting ``ac``."""
    if ac > 20:
        return width_cfg(ac, n_chan=16, t_block=1024, weight_mode=mode,
                         input_layout=layout)
    return DSA10.replace(name=f"dsa10-slots{ac}", n_chan=16, t_block=1024,
                         n_ant=ac, n_ant_active=10, weight_mode=mode,
                         input_layout=layout)


def check_detect_and_voltages(cfg, seed) -> tuple:
    """The detect (power) and voltage kernels against their plain versions
    on one random-bytes block: (detect relative error, voltages max error /
    peak); raises past KERNEL_VS_PLAIN_RTOL, or for any voltage error of an
    int8 mode (the same integers times the same scale)."""
    wire = make_random_bytes_block(cfg, seed=seed)
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    x, tm = gemm._prepare_wire(to_device(cfg, wire), cfg)
    out_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm)[0]
    out_p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm)[0]
    rel = relative_power_error_on_card(out_k, out_p)
    bv = gemm.beamform_voltages(x, qw, cfg)
    bv_p = gemm.voltages_plain(x, qw.terms, qw.scales, cfg, tm)
    torch.cuda.synchronize()
    verr = float((bv - bv_p).abs().max()) / float(bv_p.abs().max())
    vlim = KERNEL_VS_PLAIN_RTOL if cfg.weight_mode in gemm.FLOAT_MODES else 0.0
    if rel > KERNEL_VS_PLAIN_RTOL or verr > vlim \
            or not bool(torch.isfinite(out_k).all()):
        raise RuntimeError(f"{tag(cfg)} a_compute {cfg.a_compute}: kernel "
                           f"disagrees with its plain version (detect "
                           f"{rel:.3e}, voltages {verr:.3e})")
    return rel, verr, vlim


def kloop_cfg(ac, mode, layout="tfpa"):
    """``STAGED_EDGE``'s widths: a ``KLOOP_CHANNELS``-channel DSA-110 slice
    (``width_cfg``) contracting ``ac`` antennas."""
    cfg = width_cfg(ac, n_chan=KLOOP_CHANNELS, weight_mode=mode,
                    input_layout=layout)
    return cfg.replace(n_ant=ac + 2) if ac == 2056 else cfg


N_KLOOP_STREAM = 3           # blocks of each K-loop stream


def phase_kloop(smi) -> list:
    """Phase 29b: the K loop in every mode against plain (detect power and
    voltages, then stokes+sk+q8+inco); then for ``KLOOP_TIMED`` at
    a_compute 2048 a power stream of ``N_KLOOP_STREAM`` blocks and one
    voltage call, their launches counted from 0, and both kernels timed:
    the kernels-line rows."""
    volt_kloop = 0
    for i, mode in enumerate(gemm.KERNEL_MODES):
        for ac in (STAGED_EDGE[mode] + 8, 2048, 2056):
            cfg = kloop_cfg(ac, mode, ("tfpa", "ftpa")[i % 2])
            if gemm.kernel_path(cfg) != gemm.KLOOP_MMA \
                    or cfg.a_compute != ac:
                raise RuntimeError(f"{tag(cfg)} a_compute {ac}: path "
                                   f"{gemm.kernel_path(cfg)}")
            rel, verr, vlim = check_detect_and_voltages(cfg, ac)
            vpath = gemm.kernel_path(cfg, "voltage")
            volt_kloop += vpath == gemm.KLOOP_MMA
            tiles = gemm._detect_tiles(cfg)
            log(f"[widths] K loop {tag(cfg)} {cfg.input_layout} n_ant "
                f"{cfg.n_ant} a_compute {ac} ({tiles.slices} slices of "
                f"{tiles.beams} beams x 256 K bytes a sub-term; voltages "
                f"{vpath}): detect relative error {rel:.3e} (tol "
                f"{KERNEL_VS_PLAIN_RTOL:.0e}), voltages max error / peak "
                f"{verr:.3e} (limit {vlim:.0e})")
            wire = make_random_bytes_block(cfg, seed=ac + 1)
            qw = prepare_weights(cfg, make_weights(
                cfg, cal=CalTable.random(cfg, seed=ac), device=DEV))
            phase_variants(cfg, wire, qw, ["stokes+sk+q8+inco"])
    log(f"[widths] K loop: the voltage kernel took it at {volt_kloop} of "
        f"{3 * len(gemm.KERNEL_MODES)} widths")
    rows = []
    for mode in KLOOP_TIMED:
        cfg = kloop_cfg(2048, mode)
        if gemm.kernel_path(cfg, "voltage") != gemm.KLOOP_MMA:
            raise RuntimeError(f"{tag(cfg)}: voltages not on the K loop")
        block = make_random_bytes_block(cfg, seed=7)
        qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
        bf = StreamingBeamformer(cfg, qw, SyntheticSource(
            cfg, [block], N_KLOOP_STREAM))
        bf.warmup()
        clear_launches()
        gemm.beamform_voltages.launches = 0
        stats = bf.run(max_blocks=N_KLOOP_STREAM)
        wire = to_device(cfg, block)
        x, tm = gemm._prepare_wire(wire, cfg)
        gemm.beamform_voltages(x, qw, cfg)
        launches = {"detect": sum(gemm.fused_detect.launches.values()),
                    "voltages": gemm.beamform_voltages.launches}
        if launches != {"detect": N_KLOOP_STREAM, "voltages": 1} \
                or stats.n_blocks != N_KLOOP_STREAM:
            raise RuntimeError(f"{tag(cfg)} K-loop stream: {launches}, "
                               f"{stats.n_blocks} blocks")
        k_ms = time_ms(lambda i: gemm.fused_detect(x, qw.terms, qw.scales,
                                                   cfg, tm), N_MODE_TIMED)
        p_ms = time_ms(lambda i: gemm.detect_power_plain(
            x, qw.terms, qw.scales, cfg, tm), 1)
        out_k = gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm)[0]
        out_p = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm)[0]
        bnd, by = bound_ms(cfg, "base")
        v_ms = time_ms(lambda i: gemm.beamform_voltages(x, qw, cfg),
                       N_MODE_TIMED)
        vp_ms = time_ms(lambda i: gemm.voltages_plain(
            x, qw.terms, qw.scales, cfg, tm), 1)
        bv = gemm.beamform_voltages(x, qw, cfg)
        bv_p = gemm.voltages_plain(x, qw.terms, qw.scales, cfg, tm)
        vb, vby = voltage_bound_ms(cfg)
        torch.cuda.synchronize()
        log(f"[widths] K loop timed {tag(cfg)} a_compute 2048 "
            f"({cfg.n_chan} channels x {cfg.t_block} samples x "
            f"{cfg.n_beams} beams): detect {k_ms:.3f} ms (bound {bnd:.3f} "
            f"ms by {by}, plain {p_ms:.1f} ms), voltages {v_ms:.3f} ms "
            f"(bound {vb:.3f} ms by {vby}, plain {vp_ms:.1f} ms) on {smi}")
        rows.append({
            "name": f"detect_power[kloop,{mode}]", "route": "cuda",
            "mma": gemm.KLOOP_MMA,
            "source": "dsabeamformer_tpu_torch/csrc/detect_power.cu",
            "replaces": "dsabeamformer_tpu/ops/gemm.py:775",
            "launches": launches["detect"],
            "max_abs_err": float((out_k - out_p).abs().max()),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "a_compute": 2048})
        rows.append({
            "name": f"beam_voltages[kloop,{mode}]", "route": "cuda",
            "source": "dsabeamformer_tpu_torch/csrc/beam_voltages.cu",
            "replaces": "dsabeamformer_tpu/ops/gemm.py:932",
            "launches": launches["voltages"],
            "max_abs_err": float((bv - bv_p).abs().max()),
            "ms": v_ms, "plain_ms": vp_ms, "bound_ms": vb, "bound_by": vby,
            "library_ms": None, "a_compute": 2048})
        del x, wire, bv, bv_p, bf
    return rows


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
        rel, verr, vlim = check_detect_and_voltages(cfg, 24)
        log(f"[widths] {tag(cfg)} a_compute 24: detect relative error "
            f"{rel:.3e} (tol {KERNEL_VS_PLAIN_RTOL:.0e}), voltages max error / "
            f"peak {verr:.3e} (limit {vlim:.0e})")
    # DSA-10's slots and past the DSA-110 width, every mode: power and
    # voltages, then Stokes with every side output.
    for ac in NEW_WIDTHS:
        for i, mode in enumerate(gemm.KERNEL_MODES):
            cfg = new_width_cfg(ac, mode, ("tfpa", "ftpa")[i % 2])
            want = 16 if mode == "int13" and ac == 20 else ac
            if cfg.a_compute != want:
                raise RuntimeError(f"a_compute {cfg.a_compute}, want {want}")
            tiles = gemm._detect_tiles(cfg)
            rel, verr, vlim = check_detect_and_voltages(cfg, ac)
            log(f"[widths] {tag(cfg)} {cfg.input_layout} n_ant {cfg.n_ant} "
                f"a_compute {cfg.a_compute} (tile {tiles.beams} beams x "
                f"{tiles.groups} warpgroups): detect relative error "
                f"{rel:.3e} (tol {KERNEL_VS_PLAIN_RTOL:.0e}), voltages max "
                f"error / peak {verr:.3e} (limit {vlim:.0e})")
            wire = make_random_bytes_block(cfg, seed=ac + 1)
            qw = prepare_weights(cfg, make_weights(
                cfg, cal=CalTable.random(cfg, seed=ac), device=DEV))
            phase_variants(cfg, wire, qw, ["stokes+sk+q8+inco"])
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
N_RING = 8                   # blocks in each ring power-only stream (12
                             # before the scale-out phases: their time)
N_RING_DEPLOYED = 8          # blocks in each ring deployed stream
SHM = "/dev/shm"
DD_KERNELS = (dedisperse_direct, subband_stage1, subband_stage2, snr_topk,
              median_rows)
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
#: Candidates of the CLI against the in-process search: S/N within this
#: (the same bank on the same inputs: bit-equal expected).
SNR_RTOL = 1e-5
#: Phase bins of the drill's fold (one block's period is 512 samples).
FOLD_BINS = 64
#: An add issues at the FMA rate: 67 TFLOP/s counts an FMA as two.
H100_F32_ADDS_PER_S = 67e12 / 2
#: The dsa10_frb cell's search (beambench/configs/dsa10_frb.json): all 256
#: DSA-10 beams to DM 1000 at the default tolerance (4637 trials) in
#: 4096-sample windows of 9923 samples, beside the dsa10 stream's own
#: device memory (14.1 GB: beambench's dsa10.stream memory_peak_bytes), so
#: that the beam group sized here is the size the cell searches.
CELL_DM_MAX = 1000.0
CELL_STREAM_BYTES = 14.1e9
#: Beams of the cell's group the plain top-k takes at a time (its
#: temporaries are ~8 banks' worth).
PLAIN_TOPK_BEAMS = 4


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
            start = mon._start

            def keep_first(own):
                pending = start(own)
                if not windows:
                    windows.append(mon._concat()[..., :pending.n].clone())
                return pending

            mon._start = keep_first
            bf.search_monitor = mon
            bf.warmup()
            clear_launches()
            for k in DD_KERNELS:
                k.launches = 0
            snr_topk.normalized = 0
            t0 = time.perf_counter()
            stats = bf.run(max_blocks=N_SEARCH)
            wall = time.perf_counter() - t0
            live = {k.__name__: k.launches for k in DD_KERNELS}
            live["snr_topk.normalized"] = snr_topk.normalized
            if snr_topk.normalized != snr_topk.launches:
                raise RuntimeError(f"live search: {snr_topk.launches} top-k "
                                   f"launches, {snr_topk.normalized} of them "
                                   f"normalizing (every one should)")
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
            log(f"[search] {stats.search_s * 1e3 / max(1, mon.searched_windows):.1f} "
                f"ms of the loop's time in the monitor a window (the window "
                f"on the card: append, banks, normalization, top-k, "
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
            # Offline: dsabf-torch search's default bank on the written
            # files, over the grid the CLI derives from their headers.
            paths = [fil_path(tmp, b) for b in OFFLINE_BEAMS]
            f_fil, tsamp_fil, dms_fil = fil_grid(paths[0])
            log(f"[search] the .fil headers' grid: {len(dms_fil)} trials to "
                f"{dms_fil[-1]:.3f}, band {f_fil[0]:.6f}-{f_fil[-1]:.6f} MHz, "
                f"tsamp {tsamp_fil!r} s; the monitor's: {len(dms)} trials, "
                f"{f_mhz.min():.6f}-{f_mhz.max():.6f} MHz, tsamp {tsamp!r} s")
            spectra = [pair for path in paths
                       for pair in load_dynamic_spectra(path)[1]]
            DD_KERNELS[0].launches = 0
            by_beam = search_spectrograms(spectra, f_fil, tsamp_fil, dms_fil,
                                          method="direct", device=DEV)
            live["dedisperse_direct"] = DD_KERNELS[0].launches
            offline = sorted((c for cs in by_beam.values() for c in cs),
                             key=lambda c: -c.snr)
            off = check_pulse(offline, cfg, dms_fil, SEARCH_BEAM,
                              "offline search")
            log(f"[search] offline (method direct, beams {OFFLINE_BEAMS}): "
                f"the pulse found {len(off)} time(s) in beam {SEARCH_BEAM}, "
                f"best S/N {max(c.snr for c in off):.2f}; direct launches "
                f"{live['dedisperse_direct']}")
            search_cli(tmp, cfg, offline, dms_fil,
                       arrivals_found(mon.candidates, cfg, dms, SEARCH_BEAM),
                       smi)
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


def fil_path(tmp, beam) -> Path:
    return tmp / "fil" / f"beam{beam:04d}.fil"


def fil_grid(path) -> tuple:
    """The channel frequencies, cadence and DM trials that ``dsabf-torch
    search --dm-max SEARCH_DM_MAX`` derives from a .fil file's header."""
    meta, x = load_dynamic_spectrum(path)
    freqs = np.linspace(meta["f_lo_mhz"], meta["f_hi_mhz"], x.shape[1])
    dms = dm_trial_grid(meta["f_lo_mhz"], meta["f_hi_mhz"], meta["tsamp_s"],
                        dm_max=SEARCH_DM_MAX)
    return freqs, meta["tsamp_s"], dms


def same_candidates(got, want, what) -> float:
    """A .cand file's rows against in-process candidates, one for one:
    every column equal, S/N (printed to 0.01) within ``SNR_RTOL`` + 0.01.
    Returns the largest S/N difference."""
    if len(got) != len(want):
        raise RuntimeError(f"{what}: {len(got)} candidates, the reference "
                           f"{len(want)}: {[c.row() for c in got[:6]]} vs "
                           f"{[c.row() for c in want[:6]]}")
    worst = 0.0
    for g, w in zip(got, want):
        gr, wr = g.row().split(), w.row().split()
        diff = abs(g.snr - w.snr)
        worst = max(worst, diff)
        if gr[1:] != wr[1:] or diff > SNR_RTOL * abs(w.snr) + 0.01:
            raise RuntimeError(f"{what}: {g.row()} differs from the "
                               f"reference's {w.row()}")
    return worst


def arrivals_found(cands, cfg, dms, beam) -> list:
    """The drill's arrivals (block indices) with a candidate in ``beam``
    within one DM trial of SEARCH_DM and the widest boxcar of the arrival."""
    step = dms[1] - dms[0]
    want = expected_pulses(cfg, N_SEARCH)
    return sorted({k for c in cands for k, t in enumerate(want)
                   if c.beam == beam and abs(c.dm - SEARCH_DM) <= step
                   and abs(c.t_samp - t) <= max(DEFAULT_WIDTHS)})


def search_cli(tmp, cfg, offline, dms, live_kept, smi) -> None:
    """``dsabf-torch`` on the drill's products, each a subprocess on the
    card: ``search`` of the offline beams' .fil files against the in-process
    search (``offline``, the same grid and parameters); ``search`` of the
    32-beam set with coincidence on; ``search inco.dada --stream``; ``fold``
    at one block's period and ``waterfall --cand`` of the pulse beam.  All
    but the waterfall (which reads the first search's .cand) run at once."""
    t0 = time.perf_counter()
    beam_fil = str(fil_path(tmp, SEARCH_BEAM))
    cand, cand32 = tmp / "offline.cand", tmp / "set.cand"
    jobs = {
        "offline": ["search", *[str(fil_path(tmp, b)) for b in OFFLINE_BEAMS],
                    "--dm-max", str(SEARCH_DM_MAX), "--no-coincidence",
                    "--cand", str(cand), "--device", "0"],
        "set": ["search", *[str(fil_path(tmp, b)) for b in SEARCH_SET],
                "--dm-max", str(SEARCH_DM_MAX), "--cand", str(cand32),
                "--device", "0"],
        "stream": ["search", str(tmp / "inco.dada"), "--stream", "--beam",
                   "incoherent", "--dm-max", str(SEARCH_DM_MAX), "--device",
                   "0"],
        "fold": ["fold", beam_fil, "--dm", str(SEARCH_DM), "--period",
                 repr(cfg.block_duration_s), "--bins", str(FOLD_BINS)],
    }
    procs, outs, walls = {}, {}, {}
    try:
        for name, args in jobs.items():
            procs[name] = (start_cli(args, tmp / f"{name}.log"),
                           time.perf_counter())
        for name, (proc, start) in procs.items():
            outs[name] = finish_cli(proc, name, tmp / f"{name}.log")
            walls[name] = time.perf_counter() - start
            if name == "offline":
                args = ["waterfall", beam_fil, "--cand", str(cand), "--idx",
                        "0", "--out", str(tmp / "x.pgm")]
                start = time.perf_counter()
                outs["waterfall"] = run_cli(args, "waterfall",
                                            tmp / "waterfall.log")
                walls["waterfall"] = time.perf_counter() - start
    finally:
        stop_all([p for p, _ in procs.values()])
    errs = {name: (tmp / f"{name}.log").read_text() for name in outs}

    def summary(name) -> str:
        return " | ".join(l for l in errs[name].splitlines()
                          if l.startswith(("# ", "[dsabf] search on")))

    _, got = read_candidates(cand)
    worst = same_candidates(got, offline, "[search] cli offline")
    log(f"[search] cli: dsabf-torch search of beams {OFFLINE_BEAMS}' .fil "
        f"files --device 0 in {walls['offline']:.1f} s: {len(got)} "
        f".cand rows equal to the in-process search's one for one (S/N "
        f"within {worst:.3f}, bar {SNR_RTOL:.0e} + 0.01 of the printed "
        f"value); {summary('offline')} on "
        f"{smi}")
    check_pulse(got, cfg, dms, SEARCH_BEAM, "[search] cli offline")
    _, got32 = read_candidates(cand32)
    kept = arrivals_found(got32, cfg, dms, SEARCH_BEAM)
    log(f"[search] cli: search of the {len(SEARCH_SET)}-beam set with "
        f"coincidence on in {walls['set']:.1f} s: {len(got32)} candidates, "
        f"arrivals kept in beam {SEARCH_BEAM}: {len(kept)} of {N_SEARCH} "
        f"{kept} (the live monitor, coincidence per window: "
        f"{len(live_kept)} {live_kept}); {summary('set')}")
    log(f"[search] cli: search inco.dada --stream --beam incoherent in "
        f"{walls['stream']:.1f} s: {summary('stream')}; rows "
        f"{[l for l in outs['stream'].splitlines() if not l.startswith('#')][:4]}")
    wrote = [l for l in errs["waterfall"].splitlines()
             if l.startswith("# wrote")]
    h, w = map(int, wrote[0].rsplit("(", 1)[1].rstrip(")").split("x"))
    head = (tmp / "x.pgm").read_bytes()[:32]
    log(f"[search] cli: waterfall --cand offline.cand --idx 0 in "
        f"{walls['waterfall']:.1f} s: "
        f"{[l for l in errs['waterfall'].splitlines() if l.startswith('#')]}"
        f"; {outs['waterfall'].splitlines()[0]}")
    if not head.startswith(f"P5\n{w} {h}\n255\n".encode()):
        raise RuntimeError(f"[search] waterfall's PGM header {head!r} is not "
                           f"the printed {h}x{w}")
    fold = json.loads(outs["fold"].strip().splitlines()[-1])
    phase = (SEARCH_T0 // cfg.navg_time) / cfg.out_block_shape[1]
    log(f"[search] cli: fold --dm {SEARCH_DM:g} at one block "
        f"({cfg.block_duration_s!r} s) in {walls['fold']:.1f} s: "
        f"{json.dumps(fold)}; the pulse's arrival phase {phase:.4f}")
    if abs(fold["peak_phase"] - phase) > 1.0 / FOLD_BINS:
        raise RuntimeError(f"[search] fold's peak phase {fold['peak_phase']}"
                           f" is not within 1/{FOLD_BINS} of {phase}")
    log(f"[search] cli steps {time.perf_counter() - t0:.1f} s")


def bank_bound(adds, nbytes) -> tuple:
    ops, mem = adds / H100_F32_ADDS_PER_S * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def phase_bank_kernels(window, mon, smi) -> dict:
    """Each bank kernel against its plain version on the monitor's first
    window (the 32 beams), then the two stages and the top-k at the
    dsa10_frb cell's shapes (``phase_cell_kernels``): max abs error
    (bit-equal expected: the same adds in the same order), 10 timed
    launches, the plain version once, and the bound: the adds over the
    FP32 rate and the bytes (every input read once, the output written
    once) over the memory rate."""
    b, f, t = window.shape
    delays = mon.delays
    n_dm = delays.shape[0]
    fill = _fill(window, max(1, t // 512), False)
    out = {}
    # direct
    p = _window_columns(window, fill, t + int(delays.max()), 0)
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
                                (b, f, t, n_dm), ":156", None,
                                float((bank_paths(delays) == 0).mean()))
    del p, k, kp
    out.update(stage_checks(window, fill, delays, "", smi, library=True))
    search_window_breakdown(window, mon, smi)
    out.update(phase_cell_kernels(smi))
    for name, (err, ms, plain_ms, bnd, by, shape, _, lib_ms, served) \
            in out.items():
        log(f"[search kernels] {name} {shape}: max abs err vs plain {err!r}, "
            f"{ms:.3f} ms over {N_TIMED} launches, plain {plain_ms:.1f} ms, "
            f"library {'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, "
            f"bound {bnd:.3f} ms by {by} ({bnd / ms:.1%} of it)"
            + ("" if served is None else
               f", register window on {served:.1%} of (warp, row)s")
            + f" on {smi}")
        if err != 0.0:
            raise RuntimeError(f"{name} differs from its plain version by "
                               f"{err!r} (the same adds in the same order "
                               f"must be bit-equal)")
    return out


def stage_checks(window, fill, delays, suffix, smi, library) -> dict:
    """The conv plan's two stages of the ``[B, F, T]`` window against their
    plain versions, timed, as ``phase_bank_kernels``' entries named with
    ``suffix``; ``library``: time the one-call cuDNN stage 1 beside."""
    b, f, t = window.shape
    n_dm = delays.shape[0]
    intra_c, inter, rep_of, pad_f = _conv_plan(delays, _conv_auto_n_sub(delays),
                                               1)
    g, j, c = intra_c.shape
    t1 = t + int(inter.max())
    t_pad = t1 + int(intra_c.max())
    p = _window_columns(window, fill, t_pad, pad_f).view(b, g, c, -1)
    it = torch.from_numpy(intra_c).to(DEV)
    s = subband_stage1(p, it, t1)
    plain_t0 = time.perf_counter()
    sp = subband_stage1_plain(p, it, t1)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - plain_t0) * 1e3
    err = float((s - sp).abs().max())
    del sp
    ms = time_ms(lambda i: subband_stage1(p, it, t1), N_TIMED)
    adds = b * g * j * c * t1
    nbytes = p.numel() * 4 + it.numel() * 4 + s.numel() * 4
    lib_ms = None
    if library:
        lib_ms, lib_err = stage1_conv1d(p, intra_c, t1, s)
        log(f"[search kernels] subband_stage1's library call: one float32 "
            f"grouped conv1d with a one-hot weight [{g * j}, {c}, "
            f"{int(intra_c.max()) + 1}] (cuDNN, TF32 off), {lib_ms:.3f} ms, "
            f"max abs error vs the kernel {lib_err!r} (its own sum order) "
            f"on {smi}")
    served = np.mean([(bank_paths(intra_c[gg]) == 0).mean()
                      for gg in range(g)])
    out = {"subband_stage1" + suffix: (
        err, ms, plain_ms, *bank_bound(adds, nbytes),
        (b, g, c, t_pad, j, t1), ":179", lib_ms, float(served))}
    del p
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
    out["subband_stage2" + suffix] = (
        err2, ms2, plain_ms, *bank_bound(adds, nbytes),
        (b, g, j, t1, n_dm, t), ":179", None, None)
    del s, o, op
    return out


def _gap(a, b) -> float:
    """The largest |a - b|, 0 where the two are equal (-inf alike)."""
    return float(torch.where(a == b, 0.0, (a.double() - b.double()).abs())
                 .max())


def phase_cell_kernels(smi) -> dict:
    """The dsa10_frb cell's search kernels at its own shapes, on seeded
    noise counts: stage 1 and stage 2 of its plan on one stage-1 chunk of
    beams (``_stage1_beams``), and ``snr_topk`` on the raw bank of one beam
    group of its window sized as the cell sizes it (``_beam_group``, less
    the dsa10 stream's memory), normalizing it as ``_snr_topk`` does on the
    card, and ``median_rows`` on that group's fill subsample as ``_fill``
    takes it; each against its plain version (the top-k's: ``_normalize``,
    on torch's ``kthvalue``, then ``snr_topk_plain``; the fill's:
    ``_median_last``, timed alike), bit-equal expected, timed as
    ``phase_bank_kernels``' entries.  The top-k on the raw bank is
    also timed against the route it replaced, ``_normalize`` then the
    kernel on the normalized rows."""
    mon = SearchMonitor.for_stream(DSA10, CELL_DM_MAX, beam="all",
                                   device=DEV)
    b, f = DSA10.n_beams, DSA10.n_chan // DSA10.navg_freq
    t, n_dm, widths = mon.window_t, len(mon.dms), mon.widths
    g = _beam_group(b, f, t, mon.delays, mon.method, mon.n_sub, DEV,
                    reserve=CELL_STREAM_BYTES + b * f * (t + 2 * mon.chunk_t))
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(21)
    window = (torch.randn((g, f, t), generator=gen, device=DEV) * 8 + 64
              ).round_().clamp_(0, 255).to(torch.uint8)
    n1 = _stage1_beams(_conv_plan(mon.delays, _conv_auto_n_sub(mon.delays),
                                  1), t)
    out = stage_checks(window[:n1], _fill(window[:n1], max(1, t // 512),
                                          False),
                       mon.delays, " [dsa10_frb]", smi, library=False)
    xs = window[..., ::max(1, t // 512)].float()
    med = median_rows(xs)
    err = _gap(med, _median_last(xs))
    ms = time_ms(lambda i: median_rows(xs), N_TIMED)
    plain_ms = time_ms(lambda i: _median_last(xs), N_TIMED)
    out["median_rows [dsa10_frb]"] = (
        err, ms, plain_ms, *bank_bound(0, 4 * (xs.numel() + med.numel())),
        tuple(xs.shape), ":380", None, None)
    del xs, med
    bank = _bank(mon.method, window, mon.delays, mon.n_sub, False)
    del window
    k = min(mon.topk, t - mon.max_w + 1)
    limit = _limits(_valid_len(mon.delays, t), widths, mon.chunk_t)
    got = _snr_topk(bank, widths, k, limit)
    norm = _normalize(bank)
    torch.cuda.synchronize()
    plain_t0 = time.perf_counter()
    parts = [snr_topk_plain(norm[i:i + PLAIN_TOPK_BEAMS], widths, k, limit)
             for i in range(0, g, PLAIN_TOPK_BEAMS)]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - plain_t0) * 1e3
    want = [torch.cat(x) for x in zip(*parts)]
    del parts, norm
    err = max(_gap(a, w) for a, w in zip(got, want))
    del got, want
    ms = time_ms(lambda i: _snr_topk(bank, widths, k, limit), N_TIMED)
    old_ms = time_ms(lambda i: snr_topk(_normalize(bank), widths, k, limit),
                     N_TIMED)
    adds = g * n_dm * (t + sum(t - w + 1 for w in widths))
    nbytes = 4 * g * n_dm * t + g * n_dm * len(widths) * (16 * k + 8)
    out["snr_topk"] = (err, ms, plain_ms, *bank_bound(adds, nbytes),
                       (g, n_dm, t, len(widths), k), ":626", None, None)
    log(f"[search kernels] dsa10_frb shapes: a beam group of {g} of {b} "
        f"beams at {n_dm} trials x {t} samples (as the cell sizes it beside "
        f"{CELL_STREAM_BYTES / 1e9:.1f} GB of stream), stage 1 on {n1} beams; "
        f"snr_topk on the raw bank (the kernel normalizes) {ms:.3f} ms, the "
        f"replaced route (_normalize, then the kernel) {old_ms:.3f} ms; "
        f"device peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB on "
        f"{smi}")
    del bank
    return out


def stage1_conv1d(p, intra_c, t1, s_kernel) -> tuple:
    """The one PyTorch call that computes stage 1 (the reference's
    ``_conv_bank_jit`` formulation, JAX dedisperse.py:235): a float32
    grouped ``conv1d`` of the ``[B, G * C, T_pad]`` columns with a one-hot
    weight ``[G * J, C, max shift + 1]``, cuDNN's TF32 off; timed over a
    few launches (it is the yardstick, not the port's).  Returns (ms, max
    abs error against the kernel's stage 1)."""
    b, g, c, t_pad = p.shape
    j = intra_c.shape[1]
    taps = int(intra_c.max()) + 1
    w = torch.zeros((g * j, c, taps), dtype=torch.float32, device=DEV)
    gi, ji, ci = np.meshgrid(np.arange(g), np.arange(j), np.arange(c),
                             indexing="ij")
    w[torch.from_numpy((gi * j + ji).ravel()).to(DEV),
      torch.from_numpy(ci.ravel()).to(DEV),
      torch.from_numpy(intra_c.ravel().astype(np.int64)).to(DEV)] = 1.0
    x = p.view(b, g * c, t_pad)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv = torch.nn.functional.conv1d(x, w, groups=g)[..., :t1]
        ms = time_ms(lambda i: torch.nn.functional.conv1d(x, w, groups=g),
                     N_LIBRARY_TIMED)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    err = float((conv.view(b, g, j, t1) - s_kernel).abs().max())
    del w, conv
    return ms, err


def search_window_breakdown(window, mon, smi) -> None:
    """Where one window's search time goes (the monitor's steps on its first
    window, host clock, each step synchronized): the conv bank (the window's
    upload, its padding on the card, both stages), the normalization and
    top-k, the host's thresholding and clustering per beam."""
    times = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    bank = _bank("conv", window, mon.delays, mon.n_sub, False)
    torch.cuda.synchronize()
    times["bank"] = time.perf_counter() - t
    t = time.perf_counter()
    k = min(mon.topk, bank.shape[2] - mon.max_w + 1)
    limit = _limits(_valid_len(mon.delays, bank.shape[2]), mon.widths,
                    SEARCH_CHUNK)
    snr, idx, _peak = _snr_topk(bank, mon.widths, k, limit)
    points = _threshold_points(snr, idx, mon.widths, limit, 0,
                               mon.threshold)
    times["snr_topk"] = time.perf_counter() - t
    t = time.perf_counter()
    n_points = 0
    for pts in points:
        n_points += len(pts)
        _cluster(pts, mon.dms, mon.tsamp_s, mon.band_span, mon.dm_link)
    times["cluster"] = time.perf_counter() - t
    log(f"[search window] {list(window.shape)} {window.dtype} window: "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in times.items())
        + f" ({n_points} points above threshold clustered) on {smi}")


# --------------------------------------------------------------------- #
# [cli]: the port's CLI (dsabf-torch) as subprocesses on the card
# --------------------------------------------------------------------- #

REPO = Path(__file__).resolve().parent
CLI = [sys.executable, "-m", "dsabeamformer_tpu_torch.cli"]
#: Blocks of the dsa10c run, and the slots of its ring: simulate never
#: waits for a slot (a full ring drops the block) and the run's block 0
#: carries the 8-bit sink's auto-calibration, so a ring of 4 slots loses
#: most of a short run (8 of 12 blocks on an H100); this one holds it all.
#: Eight blocks: one search window of 4096 samples, then the flush.
N_CLI = 8
#: Distinct noise blocks its producer cycles after the pulse block (so the
#: byte-equality below sees a block dropped, repeated or out of order).
CLI_DISTINCT = 3
#: simulate's pulse (amplitude 6, noise rms 2, block 0) comes from angle 0,
#: between beams 127 and 128; the search takes every 8th beam from 7, and
#: keeps what fires in many beams (so strong a pulse lights the sidelobes
#: of all 32, which coincidence would reject).
CLI_BEAM = 127
CLI_SEARCH_BEAMS = list(range(7, 256, 8))
CLI_PULSE_T0 = 1024          # wire samples: output sample 64 of block 0
#: Output samples around the pulse its candidates may fall in (its width
#: and the DM trials' residual sweep); outside them every candidate is
#: noise, whose S/N must stay below CLI_NOISE_SNR.  A monitor that read
#: the auto-calibrating first block as float32 powers among the later
#: blocks' 8-bit counts put noise at S/N ~8000 here.
CLI_PULSE_SPAN = 64
CLI_NOISE_SNR = 20.0
N_LAUNCH = 8                 # dsa110 subbands, children, producers
#: Blocks of each launch child, and the slots of each producer's ring:
#: simulate never waits for a slot (a full ring drops the block), and a
#: producer's first blocks are written before its child has warmed up and
#: attached, so each ring holds the whole run (8 x 6 x 268 MB of /dev/shm).
N_LAUNCH_BLOCKS = 6
#: Distinct noise blocks each launch producer cycles, and producer i's noise
#: rms (each ring its own bytes: a child that read another's ring, or a
#: block out of order within one, changes the spliced product).
LAUNCH_DISTINCT = 2
#: Producers making their blocks at once (each on two threads, ~11 GB of
#: host memory on the way).
LAUNCH_MAKING = 2


def launch_rms(i) -> float:
    return 2.0 + 0.125 * i


SPLICE_BEAMS = (0, 100, 300, 511)
#: Blocks of the joined live search (the pulse block, then the noise pool),
#: and its search's window: dsabf-torch search's --chunk default.
N_JOIN = 4
CLI_SEARCH_CHUNK = 16384
#: Block steps of the trace.
N_TRACE = 3
CLI_TIMEOUT = 900            # s: any one subprocess


def cli_env() -> dict:
    return {**os.environ, "PYTHONPATH": str(REPO)}


def run_cli(args, what, log_path=None) -> str:
    """One ``dsabf-torch`` command to its end; its stdout, or raise with
    its stderr's tail."""
    proc = subprocess.run(CLI + args, cwd=REPO, env=cli_env(),
                          capture_output=True, text=True,
                          timeout=CLI_TIMEOUT)
    if log_path is not None:
        Path(log_path).write_text(proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"[cli] {what}: exit {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return proc.stdout


def start_cli(args, log_path) -> subprocess.Popen:
    """A ``dsabf-torch`` command in the background, stderr to log_path."""
    return subprocess.Popen(CLI + args, cwd=REPO, env=cli_env(),
                            stdout=subprocess.PIPE,
                            stderr=open(log_path, "w"), text=True)


def finish_cli(proc, what, log_path) -> str:
    out, _ = proc.communicate(timeout=CLI_TIMEOUT)
    if proc.returncode:
        raise RuntimeError(f"[cli] {what}: exit {proc.returncode}\n"
                           f"{out[-2000:]}{Path(log_path).read_text()[-4000:]}")
    return out


def stop_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


#: prctl(2): orphaned descendants are re-parented to the calling process.
PR_SET_CHILD_SUBREAPER = 36


def adopt_descendants() -> None:
    """Make this process the reaper of every process it starts, at any
    depth: a child that ends before its own children hands them to this
    process instead of init, where ``stop_descendants`` finds them.  SIGTERM
    ends the script through the same ``finally`` as a failure does."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0):
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")
    signal.signal(signal.SIGTERM, lambda signum, _: sys.exit(128 + signum))
    # The last of multiprocessing's exit steps, after its semaphores are
    # unlinked and its daemonic children joined.
    multiprocessing.util.Finalize(None, stop_tracker, exitpriority=-1)


def stop_tracker() -> None:
    """Stop the multiprocessing resource tracker (the capture processes'
    events start it) and wait for it: it ends when its pipe closes, and
    on Pythons that do not stop it at exit it would outlive this process."""
    tracker = multiprocessing.resource_tracker._resource_tracker
    if hasattr(tracker, "_stop"):
        tracker._stop()
    elif tracker._fd is not None:
        os.close(tracker._fd)
        tracker._fd = None
        os.waitpid(tracker._pid, 0)


def child_processes() -> dict:
    """This process's children, zombies left out: pid -> command line."""
    me, kids = os.getpid(), {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
            cmd = (d / "cmdline").read_bytes()
        except OSError:
            continue
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if int(ppid) == me and state != "Z":
            kids[int(d.name)] = cmd.replace(b"\0", b" ").decode(
                errors="replace").strip()
    return kids


def reap() -> None:
    """Collect every child that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if not pid:
            return


def signal_process(pid, sig) -> None:
    try:
        os.kill(pid, sig)
    except ProcessLookupError:
        pass


def stop_descendants(grace_s=30.0) -> dict:
    """End and reap every process this one still has, the resource tracker
    (``stop_tracker``'s) apart: each child or adopted orphan gets SIGTERM,
    and after ``grace_s`` SIGKILL.  Returns them: pid -> command line."""
    tracker = multiprocessing.resource_tracker._resource_tracker._pid
    stray = {}
    deadline = time.monotonic() + grace_s
    while True:
        reap()
        kids = {pid: cmd for pid, cmd in child_processes().items()
                if pid != tracker}
        if not kids:
            return stray
        for pid, cmd in kids.items():
            if pid not in stray:
                stray[pid] = cmd
                signal_process(pid, signal.SIGTERM)
        if time.monotonic() > deadline:
            for pid in kids:
                signal_process(pid, signal.SIGKILL)
        time.sleep(0.05)


class SeqSource:
    """The given ``(seq, block)`` pairs, in order (an in-process stream that
    sees the blocks another run received)."""

    def __init__(self, items):
        self._items = list(items)
        self.dropped = self.skipped = 0

    def read_block(self):
        return self._items.pop(0) if self._items else None


def files_equal(a_dir, b_dir) -> tuple:
    """(files, files that differ, differing bytes) of two directories'
    same-named files."""
    names = sorted(p.name for p in Path(a_dir).iterdir())
    if names != sorted(p.name for p in Path(b_dir).iterdir()):
        raise RuntimeError(f"[cli] {a_dir} and {b_dir} hold other files")
    bad = nbytes = 0
    for n in names:
        a = np.fromfile(Path(a_dir) / n, np.uint8)
        b = np.fromfile(Path(b_dir) / n, np.uint8)
        if a.shape != b.shape:
            bad, nbytes = bad + 1, nbytes + max(a.size, b.size)
        elif not np.array_equal(a, b):
            bad, nbytes = bad + 1, nbytes + int((a != b).sum())
    return len(names), bad, nbytes


def cli_dsa10c(tmp, smi, build) -> tuple:
    """The deployed dsa10c configuration run by ``dsabf-torch run`` from a
    capture ring fed by ``dsabf-torch simulate`` (a dispersed pulse at DM 50
    towards beam ``CLI_BEAM`` in block 0), against the same blocks through
    an in-process StreamingBeamformer with the same sinks and monitors.
    ``run`` starts once ``build`` (the kernels' build) is done: a process
    that found no library would build its own; the ring holds every block,
    so none waits for it.  Returns the blocks: the pulse block and the
    noise pool."""
    from dsabeamformer_tpu_torch.ingest.sigproc import _avg_freqs_mhz
    from dsabeamformer_tpu_torch.ops.dedisperse import read_candidates

    cfg = DSA10_COMPACT
    key = f"clidsa10c{os.getpid()}"
    beams = ",".join(map(str, CLI_SEARCH_BEAMS))
    fil, inco = tmp / "fil", tmp / "inco.dada"
    stats_path, cand = tmp / "stats.jsonl", tmp / "live.cand"
    procs = []
    try:
        procs.append(start_cli(
            ["simulate", "--config", "dsa10c", "--key", key, "--pulse-dm",
             str(SEARCH_DM), "--pulse-t0", str(CLI_PULSE_T0), "--blocks",
             str(N_CLI), "--distinct", str(CLI_DISTINCT), "--nbufs",
             str(N_CLI), "--linger", "120"], tmp / "simulate.log"))
        build.result()
        procs.append(start_cli(
            ["run", "--config", "dsa10c", "--key", key, "--device", "0",
             "--fil-dir", str(fil), "--fil-bits", "8", "--incoherent-file",
             str(inco), "--rfi-auto", "--search-dm-max",
             str(SEARCH_DM_MAX), "--search-beam", beams,
             "--search-no-coincidence", "--search-cand",
             str(cand), "--blocks", str(N_CLI), "--stats-file",
             str(stats_path), "--timeout", "600"], tmp / "run.log"))
        # The reference's blocks, simulate's block_at(i), made here on two
        # threads (the pulse first, as simulate makes them) while the two
        # processes run (this process holds little else: the phase runs
        # first).
        with ThreadPoolExecutor(max_workers=2) as maker:
            pulse = maker.submit(
                make_dispersed_pulse_block, cfg, SEARCH_DM, angle_rad=0.0,
                t0_sample=CLI_PULSE_T0, width_samples=16, noise_rms=2.0,
                seed=1234)
            pool = [maker.submit(make_noise_block, cfg, rms=2.0, seed=s)
                    for s in range(CLI_DISTINCT)]
            pulse, pool = pulse.result(), [f.result() for f in pool]
        run_out = finish_cli(procs[1], "run dsa10c", tmp / "run.log")
        sim_out = finish_cli(procs[0], "simulate dsa10c",
                             tmp / "simulate.log")
    finally:
        stop_all(procs)
    rec = json.loads(run_out.strip().splitlines()[-1])
    sim = json.loads(sim_out.strip().splitlines()[-1])
    seqs = [json.loads(line)["seq"] for line in open(stats_path)]
    walls = [json.loads(line)["wall_s"] for line in open(stats_path)]
    log(f"[cli] dsabf-torch run --config dsa10c from ring {key} (8-bit .fil "
        f"x{cfg.n_beams}, incoherent .dada, --rfi-auto, live search to DM "
        f"{SEARCH_DM_MAX:g} on beams {beams}): "
        f"{run_out.strip().splitlines()[-1]}; simulate {json.dumps(sim)}; "
        f"sequence numbers received {seqs}, each block's wall_s {walls} "
        f"on {smi}")
    rate = rec.get("realtime_factor")
    log(f"[cli] dsa10c operating point: {rec['blocks']} blocks, dropped "
        f"{rec['dropped']}, skipped {rec['skipped']}, wall {rec['wall_s']} s,"
        f" realtime factor {rate} ({cfg.block_duration_s * 1e3:.2f} ms of "
        f"sky a block)")
    if rec["blocks"] != len(seqs) or not seqs:
        raise RuntimeError(f"[cli] dsa10c: {rec['blocks']} blocks, stats "
                           f"file {seqs}")
    if rec["dropped"] or sim["dropped"]:
        log(f"[cli] dsa10c: the ring dropped {rec['dropped']} (run) / "
            f"{sim['dropped']} (simulate) blocks; the reference sees the "
            f"{len(seqs)} received")
    run_err = (tmp / "run.log").read_text()
    log(f"[cli] run's stderr (last lines): "
        f"{' | '.join(run_err.strip().splitlines()[-6:])}")

    # The pulse, from the candidate file the run wrote at exit.
    _, cands = read_candidates(cand)
    f_avg = _avg_freqs_mhz(cfg)
    tsamp = cfg.sample_period_s * cfg.navg_time
    dms = dm_trial_grid(float(f_avg.min()), float(f_avg.max()), tsamp,
                        dm_max=SEARCH_DM_MAX)
    t_out = CLI_PULSE_T0 // cfg.navg_time
    hits = [c for c in cands if c.beam == CLI_BEAM
            and abs(c.dm - SEARCH_DM) <= dms[1] - dms[0]
            and abs(c.t_samp - t_out) <= max(DEFAULT_WIDTHS)]
    if not hits:
        raise RuntimeError(f"[cli] the pulse (DM {SEARCH_DM}, beam "
                           f"{CLI_BEAM}, t {t_out}) is not among the run's "
                           f"{len(cands)} candidates: "
                           f"{[c.row() for c in cands[:8]]}")
    best = max(hits, key=lambda c: c.snr)
    top = max(cands, key=lambda c: c.snr)
    noise = [c.snr for c in cands if abs(c.t_samp - t_out) > CLI_PULSE_SPAN]
    log(f"[cli] live search: the pulse found in beam {CLI_BEAM} at DM "
        f"{best.dm:.3f} (injected {SEARCH_DM}), t {best.t_samp} (injected "
        f"{t_out}), S/N {best.snr:.2f}; {len(cands)} candidates in "
        f"{len({c.beam for c in cands})} beams, the strongest in beam "
        f"{top.beam} (S/N {top.snr:.2f}); {len(noise)} more than "
        f"{CLI_PULSE_SPAN} samples from the pulse, S/N at most "
        f"{max(noise, default=0.0):.2f} (bar {CLI_NOISE_SNR:g})")
    if max(noise, default=0.0) >= CLI_NOISE_SNR:
        raise RuntimeError(f"[cli] dsa10c: noise candidates reach S/N "
                           f"{max(noise):.2f}: "
                           f"{[c.row() for c in cands if c.snr in noise][:8]}")

    # The same blocks through an in-process stream with the same sinks and
    # monitors.
    ref = tmp / "ref"
    ref.mkdir()
    blocks = {s: pulse if s == 0 else pool[s % CLI_DISTINCT] for s in seqs}
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    fil_ref = FilterbankSink(ref / "fil", cfg, nbits=8)
    inco_ref = FileSink(ref / "inco.dada", cfg, products="incoherent",
                        extra_header={})
    bf = StreamingBeamformer(cfg, qw, SeqSource((s, blocks[s]) for s in seqs),
                             fil_ref, depth=RING_DEPTH,
                             incoherent_sink=inco_ref)
    events = []

    def excise(ev):
        events.append(ev)
        if ev["type"] == "excise" and not ev.get("final"):
            w = zap_weights(make_weights(cfg, device=DEV), ev["zapped"], cfg)
            bf.update_weights(prepare_weights(cfg, w))

    bf.rfi_monitor = RFIMonitor(cfg, on_event=excise)
    mon = SearchMonitor(f_avg, tsamp, dms, beam=CLI_SEARCH_BEAMS,
                        chunk_t=SEARCH_CHUNK, method="conv",
                        coincidence=False, device=DEV)
    bf.search_monitor = mon
    bf.warmup()
    clear_launches()
    stats = bf.run()
    launches = dict(gemm.fused_detect.launches)
    fil_ref.close()
    inco_ref.close()
    mon.flush()
    n, bad, nbytes = files_equal(fil, ref / "fil")
    inco_same = inco.read_bytes() == (ref / "inco.dada").read_bytes()
    log(f"[cli] in-process reference over sequence numbers {seqs}: "
        f"{stats.n_blocks} blocks, launches {launches}, RFI events "
        f"{[(e['type'], e.get('new')) for e in events]}, "
        f"{len(mon.candidates)} candidates (the run's: {len(cands)}); .fil "
        f"files: {n}, {bad} differ ({nbytes} bytes); incoherent product "
        f"{'byte-equal' if inco_same else 'DIFFERS'}")
    if bad or not inco_same or stats.n_blocks != len(seqs):
        raise RuntimeError(f"[cli] dsa10c: the CLI's products differ from "
                           f"the in-process stream's ({bad} of {n} .fil "
                           f"files, {nbytes} bytes; incoherent equal: "
                           f"{inco_same})")
    return pulse, pool


def cli_joined(tmp, smi, pulse, pool) -> None:
    """The reference deployment's search topology on one card: two capture
    rings hold the channel halves of ``N_JOIN`` dsa10c blocks (the pulse
    block, then ``cli_dsa10c``'s noise blocks), ``dsabf-torch launch
    --subbands 2 --devices 0,0`` beamforms them into two product rings, and
    ``dsabf-torch search --key <prod>0,<prod>1`` searches the joined band
    while they are written; against one in-process full-band power stream
    over the same blocks with a SearchMonitor of the CLI's parameters."""
    cfg = DSA10_COMPACT
    n_sub = 2
    width = cfg.n_chan // n_sub
    subs = [cfg.subband(i * width, width) for i in range(n_sub)]
    axis = 1 if cfg.input_layout == "tfpa" else 0
    full = [pulse] + [pool[k % CLI_DISTINCT] for k in range(1, N_JOIN)]
    cap, prod = f"clijcap{os.getpid()}x", f"clijprod{os.getpid()}x"
    out_bytes = int(np.prod(subs[0].out_block_shape)) * 4
    free = shm_free()[1]
    need_in = n_sub * (N_JOIN * subs[0].wire_block_bytes + 2 * 4096)
    nbufs = min(N_JOIN, (free - need_in) // (n_sub * (out_bytes + 4096)))
    log(f"[cli] joined: /dev/shm has {free / 1e9:.2f} GB free; capture rings "
        f"{n_sub} x {N_JOIN} x {subs[0].wire_block_bytes / 1e6:.1f} MB, "
        f"product rings {n_sub} x {nbufs} x {out_bytes / 1e6:.1f} MB")
    if nbufs < 2:
        raise RuntimeError(f"[cli] joined: /dev/shm ({free} B free) holds "
                           f"no two product slots a subband")
    beams = ",".join(map(str, CLI_SEARCH_BEAMS))
    cand = tmp / "joined.cand"
    rings, procs = [], []
    try:
        for i, sub in enumerate(subs):
            ring = RingBuffer(f"{cap}{i}", create=True, nbufs=N_JOIN,
                              bufsz=sub.wire_block_bytes)
            rings.append(ring)
            ring.write_header(dada.encode_header(sub))
            for blk in full:
                part = np.take(blk, np.arange(i * width, (i + 1) * width),
                               axis=axis)
                if not ring.write_block(part):
                    raise RuntimeError(f"[cli] joined: capture ring {i} full")
            ring.set_eod()
        t0 = time.perf_counter()
        procs.append(start_cli(
            ["launch", "--subbands", str(n_sub), "--devices",
             ",".join(["0"] * n_sub), "--", "--config", "dsa10c", "--key",
             cap + "{i}", "--output-key", prod + "{i}", "--nbufs",
             str(nbufs), "--blocks", str(N_JOIN), "--timeout", "600"],
            tmp / "launch.log"))
        procs.append(start_cli(
            ["search", "--key", f"{prod}0,{prod}1", "--beam", beams,
             "--no-coincidence", "--dm-max", str(SEARCH_DM_MAX), "--cand",
             str(cand), "--timeout", "300", "--device", "0"],
            tmp / "search.log"))
        rep_out = finish_cli(procs[0], "launch dsa10c x2", tmp / "launch.log")
        finish_cli(procs[1], "search --key joined", tmp / "search.log")
        wall = time.perf_counter() - t0
    finally:
        stop_all(procs)
        for ring in rings:
            ring.destroy()
        for i in range(n_sub):
            try:
                RingBuffer(f"{prod}{i}", connect_timeout_s=1).destroy()
            except OSError:
                pass
    report = json.loads(rep_out.strip().splitlines()[-1])
    launch_err = (tmp / "launch.log").read_text()
    search_err = (tmp / "search.log").read_text()
    head = [l for l in search_err.splitlines()
            if l.startswith(("# ring", "[dsabf] search:",
                             "[dsabf] search on"))]
    skews = sum(int(l.rsplit(", ", 1)[1].split()[0]) for l in head
                if l.endswith("join skew(s)"))
    log(f"[cli] joined live search: launch --subbands {n_sub} --devices "
        f"0,0 (dsa10c, {N_JOIN} blocks a child from its capture ring, "
        f"--output-key, {nbufs} product slots) and search --key "
        f"{prod}0,{prod}1 together in {wall:.1f} s: {json.dumps(report)}; "
        f"{' | '.join(head)}; {skews} join skew(s) on {smi}")
    drops = [l for l in launch_err.splitlines()
             if "output ring dropped" in l]
    if not report["ok"] or drops or any(
            r["blocks"] != N_JOIN or r["dropped"] for r in report["subbands"]):
        raise RuntimeError(f"[cli] joined: {report} {drops}")
    meta, got = read_candidates(cand)
    freqs = np.linspace(meta["f_lo_mhz"], meta["f_hi_mhz"],
                        cfg.out_block_shape[0])
    dms = dm_trial_grid(meta["f_lo_mhz"], meta["f_hi_mhz"], meta["tsamp_s"],
                        dm_max=SEARCH_DM_MAX)
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    mon = SearchMonitor(freqs, meta["tsamp_s"], dms, beam=CLI_SEARCH_BEAMS,
                        chunk_t=CLI_SEARCH_CHUNK, method="direct",
                        coincidence=False, device=DEV)
    bf = StreamingBeamformer(cfg, qw, SyntheticSource(cfg, full, N_JOIN),
                             None, depth=RING_DEPTH)
    bf.search_monitor = mon
    bf.warmup()
    stats = bf.run()
    mon.flush()
    want = sorted(mon.candidates, key=lambda c: -c.snr)
    worst = same_candidates(got, want, "[cli] joined")
    t_out = CLI_PULSE_T0 // cfg.navg_time
    hits = [c for c in got if c.beam == CLI_BEAM
            and abs(c.dm - SEARCH_DM) <= dms[1] - dms[0]
            and abs(c.t_samp - t_out) <= max(DEFAULT_WIDTHS)]
    log(f"[cli] joined: {len(got)} candidates equal to the in-process "
        f"full-band monitor's one for one ({stats.n_blocks} blocks, S/N "
        f"within {worst:.3f}, bar {SNR_RTOL:.0e} + 0.01); the pulse in beam "
        f"{CLI_BEAM}: {[c.row() for c in hits[:2]]}")
    if not hits:
        raise RuntimeError(f"[cli] joined: the pulse (DM {SEARCH_DM}, beam "
                           f"{CLI_BEAM}, t {t_out}) is not among "
                           f"{[c.row() for c in got[:8]]}")


def cli_trace(tmp, smi) -> dict:
    """``dsabf-torch trace --config dsa10 --blocks 3 --device 0``: its rows
    must name the detect kernel 3 times; the kernels' summed time over the
    traced window (the device's busy share) read from its trace file."""
    out = run_cli(["trace", "--config", "dsa10", "--blocks",
                   str(N_TRACE), "--out", str(tmp / "trace"), "--device",
                   "0"], "trace", tmp / "trace.log")
    rec = json.loads(out)
    det = [r for r in rec["ops"] if "detect_mma_kernel" in r["name"]]
    if not det or det[0]["count"] != N_TRACE:
        raise RuntimeError(f"[cli] trace: no detect kernel row of count "
                           f"{N_TRACE}: {rec['ops']}")
    events = trace_events(tmp / "trace")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    span = (max(e["ts"] + e.get("dur", 0) for e in events)
            - min(e["ts"] for e in events))
    k_span = (max(e["ts"] + e["dur"] for e in kernels)
              - min(e["ts"] for e in kernels))
    busy = sum(e["dur"] for e in kernels)
    res = {"detect_ms": det[0]["total_ms"] / N_TRACE,
           "busy_ms": busy / 1e3, "span_ms": span / 1e3,
           "kernel_span_ms": k_span / 1e3}
    log(f"[cli] dsabf-torch trace --config dsa10 --blocks {N_TRACE} "
        f"--device 0: rows {[(r['name'][:48], r['count'], r['total_ms']) for r in rec['ops']]}")
    log(f"[cli] trace: the detect kernel {det[0]['count']} x, mean "
        f"{res['detect_ms']:.3f} ms; {len(kernels)} kernels, "
        f"{res['busy_ms']:.3f} ms busy over the traced window's "
        f"{res['span_ms']:.3f} ms ({busy / span:.1%}), over the kernels' own "
        f"span {res['kernel_span_ms']:.3f} ms ({busy / k_span:.1%}) on {smi}")
    return res


def cli_launch(tmp, smi) -> None:
    """The DSA-110 per-GPU deployment on one card: ``N_LAUNCH``
    ``dsabf-torch simulate --subband i/8`` producers, ``dsabf-torch launch
    --subbands 8 --devices 0,...,0`` over their rings (32-bit .fil of every
    beam), ``dsabf-torch splice`` of ``SPLICE_BEAMS``, against one
    in-process full-band run over the same blocks."""
    from dsabeamformer_tpu_torch.ingest.sigproc import read_filterbank

    cfg = DSA110
    width = cfg.n_chan // N_LAUNCH
    prefix = f"clicap{os.getpid()}x"
    procs = []
    # The reference's subband blocks, simulate's block_at(j) of each
    # producer, made on threads (numpy's generator and ufuncs run without
    # the GIL) while the children and producers run.
    pool = ThreadPoolExecutor(max_workers=4)
    parts = {(i, j): pool.submit(make_noise_block,
                                 cfg.subband(i * width, width),
                                 rms=launch_rms(i), seed=j)
             for i in range(N_LAUNCH) for j in range(LAUNCH_DISTINCT)}
    try:
        def wait_ring(k) -> None:
            deadline = time.perf_counter() + CLI_TIMEOUT
            while not (Path(SHM) / f"dsaring-{prefix}{k}").exists() \
                    and procs[1 + k].poll() is None:
                if time.perf_counter() > deadline:
                    raise RuntimeError(f"[cli] simulate {k}/8 made no ring")
                time.sleep(0.2)

        # The children warm up and wait for their rings; at most
        # LAUNCH_MAKING producers make their blocks at a time (eight at once
        # would take ~45 GB of host memory on the way): each starts once the
        # one LAUNCH_MAKING - 1 before it has created its ring.
        launch = start_cli(
            ["launch", "--subbands", str(N_LAUNCH), "--devices",
             ",".join(["0"] * N_LAUNCH), "--", "--config", "dsa110",
             "--key", prefix + "{i}", "--fil-dir", str(tmp / "fil{i}"),
             "--fil-bits", "32", "--blocks", str(N_LAUNCH_BLOCKS),
             "--timeout", "600"], tmp / "launch.log")
        procs.append(launch)
        for i in range(N_LAUNCH):
            procs.append(start_cli(
                ["simulate", "--config", "dsa110", "--subband",
                 f"{i}/{N_LAUNCH}", "--key", f"{prefix}{i}", "--blocks",
                 str(N_LAUNCH_BLOCKS), "--distinct", str(LAUNCH_DISTINCT),
                 "--rms", str(launch_rms(i)), "--nbufs",
                 str(N_LAUNCH_BLOCKS), "--linger", "120"],
                tmp / f"simulate{i}.log"))
            if i >= LAUNCH_MAKING - 1:
                wait_ring(i - LAUNCH_MAKING + 1)
        for k in range(max(0, N_LAUNCH - LAUNCH_MAKING + 1), N_LAUNCH):
            wait_ring(k)
        rep_out = finish_cli(launch, "launch dsa110", tmp / "launch.log")
        for i in range(N_LAUNCH):
            finish_cli(procs[1 + i], f"simulate dsa110 {i}/8",
                       tmp / f"simulate{i}.log")
        axis = 1 if cfg.input_layout == "tfpa" else 0
        full = [np.concatenate([parts.pop((i, j)).result()
                                for i in range(N_LAUNCH)], axis=axis)
                for j in range(LAUNCH_DISTINCT)]
    finally:
        stop_all(procs)
        pool.shutdown(cancel_futures=True)
    report = json.loads(rep_out.strip().splitlines()[-1])
    log(f"[cli] dsabf-torch launch --subbands {N_LAUNCH} --devices "
        f"{','.join(['0'] * N_LAUNCH)} (dsa110, {N_LAUNCH_BLOCKS} blocks a "
        f"child from its ring, 32-bit .fil x{cfg.n_beams}): "
        f"{json.dumps(report)} on {smi}")
    if not report["ok"] or any(r["blocks"] != N_LAUNCH_BLOCKS
                               or r["dropped"] for r in report["subbands"]):
        raise RuntimeError(f"[cli] launch: {report}")
    merged = tmp / "merged"
    merged.mkdir()
    splices = {}
    try:
        for b in SPLICE_BEAMS:
            files = [str(tmp / f"fil{i}" / f"beam{b:04d}.fil")
                     for i in range(N_LAUNCH)]
            splices[b] = start_cli(["splice", *files, "--out",
                                    str(merged / f"beam{b:04d}.fil")],
                                   tmp / f"splice{b}.log")
        for b, proc in splices.items():
            out = finish_cli(proc, f"splice {b}", tmp / f"splice{b}.log")
            if b == SPLICE_BEAMS[0]:
                log(f"[cli] splice beam {b}: {out.strip()}")
    finally:
        stop_all(list(splices.values()))
    qw = prepare_weights(cfg, make_weights(cfg, device=DEV))
    ref = FilterbankSink(tmp / "ref", cfg, beams=list(SPLICE_BEAMS),
                         nbits=32)
    bf = StreamingBeamformer(cfg, qw, SyntheticSource(cfg, full,
                                                      N_LAUNCH_BLOCKS), ref,
                             depth=RING_DEPTH)
    bf.warmup()
    clear_launches()
    stats = bf.run()
    launches = dict(gemm.fused_detect.launches)
    ref.close()
    worst = 0.0
    equal = 0
    for b in SPLICE_BEAMS:
        hm, dm = read_filterbank(merged / f"beam{b:04d}.fil")
        hr, dr = read_filterbank(tmp / "ref" / f"beam{b:04d}.fil")
        if {k: v for k, v in hm.items() if k != "tstart"} \
                != {k: v for k, v in hr.items() if k != "tstart"} \
                or dm.shape != dr.shape:
            raise RuntimeError(f"[cli] beam {b}: spliced header or shape "
                               f"{dm.shape} differs from the full band's "
                               f"{dr.shape}")
        equal += bool(np.array_equal(dm, dr))
        worst = max(worst, float(np.abs(dm.astype(np.float64) - dr).max()
                                 / np.abs(dr).max()))
    log(f"[cli] spliced beams {SPLICE_BEAMS} against one in-process "
        f"full-band {tag(cfg)} run ({stats.n_blocks} blocks, launches "
        f"{launches}): {equal} of {len(SPLICE_BEAMS)} bit-equal, max error "
        f"/ peak {worst:.3e} (bar {KERNEL_VS_PLAIN_RTOL:.0e})")
    if worst > KERNEL_VS_PLAIN_RTOL or stats.n_blocks != N_LAUNCH_BLOCKS:
        raise RuntimeError(f"[cli] the spliced launch products differ from "
                           f"the full band's by {worst:.3e}")


def phase_cli(smi, build) -> dict:
    """Phase 32: the deployed dsa10c from a ring (``cli_dsa10c``, whose
    capture process makes its blocks while ``build``, the future of phase
    2, runs), ``dsabf-torch selftest`` and ``info`` on ``cuda:0``, the
    joined live search over two subband product rings (``cli_joined``), the
    DSA-110 launch (``cli_launch``) and a trace (``cli_trace``, returned),
    each command a subprocess."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        blocks = cli_dsa10c(Path(tmp), smi, build)
    log(f"[cli] cli_dsa10c done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [start_cli(["selftest", "--device", "0"],
                           Path(tmp) / "selftest.log"),
                 start_cli(["info", "--config", "dsa10c"],
                           Path(tmp) / "info.log")]
        try:
            out = finish_cli(procs[0], "selftest", Path(tmp) / "selftest.log")
            info = finish_cli(procs[1], "info", Path(tmp) / "info.log")
        finally:
            stop_all(procs)
    rec = json.loads(out)
    log(f"[cli] dsabf-torch selftest --device 0: {out.strip()}")
    if not rec["ok"] or rec["backend"] != "cuda":
        raise RuntimeError(f"[cli] selftest: {rec}")
    out = info
    log(f"[cli] dsabf-torch info --config dsa10c: {out.strip()}")
    if json.loads(out)["backend"] != "cuda":
        raise RuntimeError(f"[cli] info: {out}")
    with tempfile.TemporaryDirectory() as tmp:
        cli_joined(Path(tmp), smi, *blocks)
    del blocks
    log(f"[cli] cli_joined done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        cli_launch(Path(tmp), smi)
    log(f"[cli] cli_launch done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        trace = cli_trace(Path(tmp), smi)
    # The in-process references' pinned staging, back to the system.
    torch.cuda.empty_cache()
    getattr(torch._C, "_host_emptyCache", lambda: None)()
    log(f"[cli] phase {time.perf_counter() - t0:.1f} s")
    return trace


# --------------------------------------------------------------------- #
# The calibration loop, the (l, m) beam grids, the beam pattern, bench
# --------------------------------------------------------------------- #

#: [calibrate]: the calibrator's beam, and the seed of its instrument and
#: draws.  The JAX package's tests/test_calsolver.py::_corrupted_calibrator:
#: gains of amplitude 1 +- 0.15 and phase sigma 1.5 rad per (antenna,
#: channel), a source of amplitude 2.5, receiver noise of rms 0.15.
CAL_TARGET = TARGET_BEAM
CAL_SEED = 3
#: Its bars (the JAX package's): solved phases within 0.1 rad of the
#: injected inverse; the target's power at least 0.8x that through the exact
#: inverse gains and 1.5x the uncorrected; the card's table within 1e-6 of
#: the CPU's, relative.
CAL_PHASE_BAR = 0.1
CAL_GAIN_RTOL = 1e-6
#: [lm]: the per-GPU DSA-110 process's configuration, its 110 dishes on a
#: seeded 600 m square, a 16 x 32 (l, m) grid of its 512 beams over +-0.01,
#: and the grid beam of the 2-D point source.
LM_CFG = DSA110_SUBBAND
LM_GRID = (16, 32)
LM_HALF = 0.01
LM_EXTENT_M = 300.0
LM_TARGET = 300
LM_SEED = 110
#: make_weights_lm on the card against the golden: its phase is float32
#: there, ~30 turns of path at most on this layout (~1e-5 rad).
LM_WEIGHTS_ATOL = 1e-4
#: The golden power error's cut (the NumPy reference at the full subband
#: would take minutes): 128 channels x 512 samples, as [physics].
LM_CUT = LM_CFG.replace(n_chan=VOLTAGE_CHANNELS, t_block=512)
#: [beampattern]: card against CPU (complex128 both), relative to the peak;
#: the channels compared; the FWHM's bar (tests/test_beampattern.py).
PATTERN_RTOL = 1e-9
PATTERN_FWHM_BAR = (0.7, 1.3)
#: [bench]: the kernel record against [resident]'s int8x2 time.
BENCH_BLOCKS = 16
BENCH_RTOL = 0.05


def point_source_on_card(cfg, path_m, amplitude, noise_rms, seed,
                         gains=None) -> torch.Tensor:
    """A point source plus receiver noise drawn on the card (torch's
    generator, seeded): the model of ``make_point_source_block`` (a complex
    Gaussian signal per channel, sample and pol, the geometric phase ``+2 pi
    f path_a / c`` for each active antenna's path length ``path_m [a]``,
    then ``gains [n_ant, n_chan]``, then noise, rounded and packed), its
    draws and not its bytes.  The wire in ``cfg.input_layout``, on the
    card."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    act = cfg.n_ant_active
    f = torch.as_tensor(cfg.freqs_hz(), dtype=torch.float64,
                        device=DEV)[:, None]
    turns = f * torch.as_tensor(path_m, dtype=torch.float64,
                                device=DEV)[None, :] / SPEED_OF_LIGHT_M_S
    phase = 2.0 * np.pi * (turns - torch.round(turns))
    steer = torch.polar(torch.ones_like(phase), phase)      # [F, a]
    if gains is not None:
        steer = steer * torch.as_tensor(np.asarray(gains)[:act].T,
                                        dtype=torch.complex128, device=DEV)
    steer = steer.to(torch.complex64)
    shape = (cfg.n_chan, cfg.t_block, cfg.n_pol)
    sig = torch.complex(torch.randn(shape, generator=gen, device=DEV),
                        torch.randn(shape, generator=gen, device=DEV))
    sig *= amplitude / np.sqrt(2.0)
    wire = torch.zeros(shape + (cfg.n_ant,), dtype=torch.uint8, device=DEV)
    for f0 in range(0, cfg.n_chan, 64):
        v = sig[f0:f0 + 64, :, :, None] * steer[f0:f0 + 64, None, None, :]
        re = v.real + noise_rms * torch.randn(v.shape, generator=gen,
                                              device=DEV)
        im = v.imag + noise_rms * torch.randn(v.shape, generator=gen,
                                              device=DEV)
        wire[f0:f0 + 64, ..., :act] = pack_4r4i(torch.round(re),
                                                torch.round(im))
    if cfg.input_layout == "tfpa":
        wire = wire.permute(1, 0, 2, 3).contiguous()
    return wire


def calibrator_gains(cfg, seed=CAL_SEED) -> np.ndarray:
    """``_corrupted_calibrator``'s instrument: ``[n_ant, n_chan]``
    complex128, zero on the padded slots."""
    rng = np.random.default_rng(seed)
    act = cfg.n_ant_active
    g = np.zeros((cfg.n_ant, cfg.n_chan), np.complex128)
    amp = 1.0 + 0.15 * rng.standard_normal((act, cfg.n_chan))
    ph = 1.5 * rng.standard_normal((act, cfg.n_chan))
    g[:act] = amp * np.exp(1j * ph)
    return g


def gains_rel_err(got, want, act) -> float:
    return float(np.max(np.abs(got[:act] - want[:act]) / np.abs(want[:act])))


def phase_calibrate(tmp, smi) -> int:
    """Phase 33: the calibration loop at full dsa10c width.  One calibrator
    block (beam ``CAL_TARGET``, the corrupted instrument) drawn on the card
    and written to a .dada; ``dsabf-torch calibrate --device 0`` solves it;
    the port's ``solve_gains`` solves the same bytes on the card (upload
    included) and on the CPU; then the table goes through ``make_weights(
    cal=)`` -> ``prepare_weights`` -> ``beamform_power`` (the detect kernel,
    counted from 0) beside the uncorrected weights and the exact inverse.
    Returns the detect kernel's launches."""
    cfg = DSA10_COMPACT
    act = cfg.n_ant_active
    angle = float(cfg.beam_angles_rad()[CAL_TARGET])
    g = calibrator_gains(cfg)
    t0 = time.perf_counter()
    x = array_for(cfg).positions_m[:act]
    wire = point_source_on_card(cfg, x * np.sin(angle), amplitude=2.5,
                                noise_rms=0.15, seed=CAL_SEED, gains=g)
    wire_np = wire.cpu().numpy()
    cap = tmp / "cal.dada"
    dada.write_dada_file(cap, cfg, [wire_np])
    log(f"[calibrate] {cfg.name} calibrator block {tuple(wire.shape)} at beam "
        f"{CAL_TARGET} ({np.rad2deg(angle):.6f} deg) drawn on the card and "
        f"written in {time.perf_counter() - t0:.1f} s")
    table = tmp / "cal.npz"
    t0 = time.perf_counter()
    proc = start_cli(["calibrate", "--config", cfg.name, "--input-file",
                      str(cap), "--angle", repr(float(np.rad2deg(angle))),
                      "--out", str(table), "--device", "0"],
                     tmp / "calibrate.log")
    try:
        # The CPU's solve of the same bytes, while the CLI's runs.
        t1 = time.perf_counter()
        host = solve_gains(wire_np, cfg, angle, device="cpu").gains
        host_s = time.perf_counter() - t1
        out = finish_cli(proc, "calibrate", tmp / "calibrate.log")
    finally:
        stop_all([proc])
    cli_s = time.perf_counter() - t0
    rec = json.loads(out.strip().splitlines()[-1])
    cli_gains = CalTable.load(str(table)).gains
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = solve_gains(torch.from_numpy(wire_np), cfg, angle,
                       device=DEV).gains
    card_s = time.perf_counter() - t0
    err_card = gains_rel_err(card, host, act)
    err_cli = gains_rel_err(cli_gains, host, act)
    prod = cli_gains[:act] * g[:act]
    phase_err = float(np.abs(np.angle(prod / prod[0:1])).max())
    log(f"[calibrate] dsabf-torch calibrate --config {cfg.name} --device 0: "
        f"{out.strip()} in {cli_s:.1f} s (process start included, the "
        f"CPU's solve beside it); solve_gains on the card {card_s:.3f} s "
        f"(upload of the {wire_np.nbytes / 1e9:.3f} GB block included), on "
        f"the CPU {host_s:.1f} s ({torch.get_num_threads()} threads), on "
        f"{smi}")
    log(f"[calibrate] card table vs CPU {err_card:.3e}, the CLI's vs CPU "
        f"{err_cli:.3e} (bar {CAL_GAIN_RTOL:.0e}, relative); solved phases "
        f"against the injected inverse: max {phase_err:.4f} rad over {act} "
        f"antennas x {cfg.n_chan} channels (bar {CAL_PHASE_BAR})")
    if max(err_card, err_cli) > CAL_GAIN_RTOL or phase_err >= CAL_PHASE_BAR \
            or rec["blocks"] != 1 or rec["n_chan"] != cfg.n_chan:
        raise RuntimeError(f"[calibrate] the solved table misses its bars: "
                           f"{err_card:.3e} / {err_cli:.3e} / {phase_err}")
    exact = np.zeros((cfg.n_ant, cfg.n_chan), np.complex64)
    exact[:act] = (1.0 / g[:act]).astype(np.complex64)
    clear_launches()
    powers = {}
    for what, cal in (("uncorrected", None), ("solved", CalTable(cli_gains)),
                      ("exact inverse", CalTable(exact))):
        qw = prepare_weights(cfg, make_weights(cfg, cal=cal, device=DEV))
        powers[what] = gemm.beamform_power(wire, qw, cfg).sum(
            dim=(0, 1)).double().cpu().numpy()
    launches = sum(gemm.fused_detect.launches.values())
    peak = int(np.argmax(powers["solved"]))
    t = {k: float(v[CAL_TARGET]) for k, v in powers.items()}
    log(f"[calibrate] through the detect kernel ({launches} launches): peak "
        f"beam {peak} (want {CAL_TARGET}); target power solved / exact "
        f"inverse {t['solved'] / t['exact inverse']:.4f} (bar >= 0.8), "
        f"solved / uncorrected {t['solved'] / t['uncorrected']:.3f} (bar >= "
        f"1.5)")
    if peak != CAL_TARGET or t["solved"] < 0.8 * t["exact inverse"] \
            or t["solved"] < 1.5 * t["uncorrected"] or launches != 3:
        raise RuntimeError(f"[calibrate] the solved table does not restore "
                           f"the beam: peak {peak}, {t}, launches {launches}")
    return launches


def layout_2d(cfg, seed=LM_SEED) -> ArrayLayout:
    """The active dishes uniform on a ``2 LM_EXTENT_M`` square (seeded)."""
    rng = np.random.default_rng(seed)
    a = cfg.n_ant_active
    ew, ns = np.zeros(cfg.n_ant), np.zeros(cfg.n_ant)
    ew[:a] = rng.uniform(-LM_EXTENT_M, LM_EXTENT_M, a)
    ns[:a] = rng.uniform(-LM_EXTENT_M, LM_EXTENT_M, a)
    return ArrayLayout(positions_m=ew, n_active=a, positions_ns_m=ns)


def lm_grid() -> tuple:
    """The (l, m) grid, flattened row-major: ``LM_GRID[0]`` l by
    ``LM_GRID[1]`` m."""
    ll, mm = np.meshgrid(np.linspace(-LM_HALF, LM_HALF, LM_GRID[0]),
                         np.linspace(-LM_HALF, LM_HALF, LM_GRID[1]),
                         indexing="ij")
    return ll.ravel(), mm.ravel()


def lm_path(cfg, layout, l0, m0) -> np.ndarray:
    a = cfg.n_ant_active
    return layout.positions_m[:a] * l0 + layout.ns[:a] * m0


def start_lm_golden():
    """The [lm] cut's point source (drawn on the card, to the host) and the
    future of its float64 golden power: ``(wire, future)``."""
    layout = layout_2d(LM_CUT)
    l, m = lm_grid()
    wire = point_source_on_card(
        LM_CUT, lm_path(LM_CUT, layout, l[LM_TARGET], m[LM_TARGET]),
        amplitude=3.0, noise_rms=0.4, seed=LM_SEED + 1).cpu().numpy()
    gold = weights_lm_numpy_golden(LM_CUT, l, m, layout=layout)
    return wire, GOLDEN_POOL.submit(active_ref, beamform_block_ref, gold,
                                    wire, LM_CUT)


def phase_lm(lm_golden, smi) -> int:
    """Phase 34: the (l, m) beam grid at the per-GPU DSA-110 process's
    width: ``make_weights_lm`` on the card against
    ``weights_lm_numpy_golden``, then a 2-D point source at grid beam
    ``LM_TARGET`` drawn on the card through ``prepare_weights`` ->
    ``beamform_power`` (the detect kernel, counted from 0) against its plain
    version on the same inputs, and the cut's against the float64 golden.
    Returns the detect kernel's launches."""
    cfg = LM_CFG
    layout = layout_2d(cfg)
    l, m = lm_grid()
    t0 = time.perf_counter()
    w = make_weights_lm(cfg, l, m, layout=layout, device=DEV)
    torch.cuda.synchronize()
    w_s = time.perf_counter() - t0
    werr = float(np.abs(w.to_numpy() - weights_lm_numpy_golden(
        cfg, l, m, layout=layout)).max())
    log(f"[lm] {cfg.name} subband (256 channels), {cfg.n_ant_active} dishes "
        f"on a {2 * LM_EXTENT_M:g} m square, a {LM_GRID[0]} x {LM_GRID[1]} "
        f"(l, m) grid over +-{LM_HALF}: make_weights_lm on the card "
        f"{w_s * 1e3:.1f} ms, max |w - golden| {werr:.2e} (bar "
        f"{LM_WEIGHTS_ATOL:.0e})")
    if werr > LM_WEIGHTS_ATOL:
        raise RuntimeError(f"[lm] weights {werr:.3e} from the golden")
    qw = prepare_weights(cfg, w)
    wire = point_source_on_card(
        cfg, lm_path(cfg, layout, l[LM_TARGET], m[LM_TARGET]),
        amplitude=3.0, noise_rms=0.4, seed=LM_SEED)
    clear_launches()
    p = gemm.beamform_power(wire, qw, cfg)
    launches = sum(gemm.fused_detect.launches.values())
    x, tm = gemm._prepare_wire(wire, cfg)
    plain = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm)[0]
    rel = relative_power_error_on_card(p, plain)
    peak = int(p.sum(dim=(0, 1)).argmax())
    # The cut, against the float64 golden.
    wire_cut, fut = lm_golden
    qc = prepare_weights(LM_CUT, make_weights_lm(LM_CUT, l, m,
                                                 layout=layout_2d(LM_CUT),
                                                 device=DEV))
    pc = gemm.beamform_power(to_device(LM_CUT, wire_cut), qc,
                             LM_CUT).cpu().numpy()
    gerr = relative_power_error(pc, fut.result())
    peak_cut = int(np.argmax(pc.sum(axis=(0, 1))))
    log(f"[lm] 2-D point source at grid beam {LM_TARGET} (l "
        f"{l[LM_TARGET]:+.5f}, m {m[LM_TARGET]:+.5f}) through the detect "
        f"kernel ({launches} launch): {tuple(p.shape)}, vs plain {rel:.3e} "
        f"(bar {KERNEL_VS_PLAIN_RTOL:.0e}), peak beam {peak}; the "
        f"{LM_CUT.n_chan}-channel x {LM_CUT.t_block}-sample cut vs the "
        f"float64 golden {gerr:.3e} (bar {GOLDEN_RTOL:.0e}), peak beam "
        f"{peak_cut}, on {smi}")
    if rel > KERNEL_VS_PLAIN_RTOL or peak != LM_TARGET or launches != 1 \
            or gerr > GOLDEN_RTOL or peak_cut != LM_TARGET \
            or not bool(torch.isfinite(p).all()):
        raise RuntimeError(f"[lm] failed: plain {rel:.3e}, peak {peak}, "
                           f"golden {gerr:.3e}, cut peak {peak_cut}")
    return launches


def pattern_checks(cfg, what, respond, sweep_n, chans) -> None:
    """``respond(chan, device)`` -> ``[S, B]``: on the card over the band
    (timed), matched beams on the diagonal; a few single channels against
    the CPU's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp = respond(None, DEV)
    secs = time.perf_counter() - t0
    diag_ok = bool((np.argmax(resp, axis=1) == np.arange(sweep_n)).all())
    diag_err = float(np.abs(np.diag(resp) - 1.0).max())
    worst = max(relative_power_error(respond(c, DEV), respond(c, "cpu"))
                for c in chans)
    log(f"[beampattern] {what}: {resp.shape} on the card in {secs:.3f} s; "
        f"matched beams on the diagonal {diag_ok} (max |diag - 1| "
        f"{diag_err:.2e}); channels {list(chans)} card vs CPU {worst:.3e} "
        f"(bar {PATTERN_RTOL:.0e})")
    if not diag_ok or diag_err > 1e-6 or worst > PATTERN_RTOL:
        raise RuntimeError(f"[beampattern] {what} failed")


def phase_beampattern(tmp, smi) -> None:
    """Phase 35: ``beam_response`` at full dsa110 and dsa10, and
    ``beam_response_lm`` at full dsa110 on [lm]'s layout and grid, on the
    card (complex128): matched beams on the diagonal, single channels
    against the CPU, the central beam's half-power width against
    ``beam_fwhm_rad``; and, beside them, ``dsabf-torch beampattern
    --config dsa10``."""
    png = tmp / "beams.png"
    proc = subprocess.Popen(CLI + ["beampattern", "--config", "dsa10",
                                   "--out", str(png), "--device", "0"],
                            cwd=REPO, env=cli_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        phase_beampattern_checks()
        stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT)
    finally:
        stop_all([proc])
    err = stderr.strip().splitlines()
    if proc.returncode == 2 and len(err) == 1 and "matplotlib" in err[0] \
            and not png.exists():
        log(f"[beampattern] dsabf-torch beampattern --config dsa10 --device "
            f"0: exit 2, {err[0]!r}; render: not run on this host (no "
            f"matplotlib)")
    elif proc.returncode == 0 and png.exists() \
            and png.read_bytes()[:4] == b"\x89PNG":
        log(f"[beampattern] dsabf-torch beampattern --config dsa10 --device "
            f"0: {stdout.strip()}; render: a {png.stat().st_size}-byte PNG")
    else:
        raise RuntimeError(f"[beampattern] the CLI: exit {proc.returncode}\n"
                           f"{stdout[-2000:]}{stderr[-4000:]}")


def phase_beampattern_checks() -> None:
    """[beampattern]'s in-process checks on the card."""
    for cfg in (DSA110, DSA10):
        chans = (0, cfg.n_chan // 2, cfg.n_chan - 1)
        angles = cfg.beam_angles_rad()
        pattern_checks(cfg, f"beam_response {cfg.name} ({cfg.n_chan} "
                       f"channels, {cfg.n_ant_active} dishes, sweep at the "
                       f"{cfg.n_beams} beam angles)",
                       lambda c, d, cfg=cfg, a=angles: beam_response(
                           cfg, a, chan=c, device=d), cfg.n_beams, chans)
        b = cfg.n_beams // 2
        est = beam_fwhm_rad(cfg)
        sweep = angles[b] + np.linspace(-3, 3, 601) * est
        resp = beam_response(cfg, sweep, device=DEV)[:, b]
        above = sweep[resp >= 0.5 * resp.max()]
        ratio = float((above.max() - above.min()) / est)
        log(f"[beampattern] {cfg.name} beam {b}: half-power width "
            f"{above.max() - above.min():.4e} rad over 601 sweep points, "
            f"beam_fwhm_rad {est:.4e}, ratio {ratio:.3f} (bar "
            f"{PATTERN_FWHM_BAR})")
        if not PATTERN_FWHM_BAR[0] < ratio < PATTERN_FWHM_BAR[1]:
            raise RuntimeError(f"[beampattern] {cfg.name}: FWHM ratio {ratio}")
    cfg = DSA110
    layout = layout_2d(cfg)
    l, m = lm_grid()
    pattern_checks(cfg, f"beam_response_lm {cfg.name} (the [lm] layout and "
                   f"grid, swept over the grid)",
                   lambda c, d: beam_response_lm(cfg, l, m, l, m,
                                                 layout=layout, chan=c,
                                                 device=d),
                   cfg.n_beams, (0, cfg.n_chan - 1))


def phase_bench(resident_ms, smi) -> int:
    """Phase 36: ``dsabf-torch bench --config dsa10`` (kernel mode) held to
    [resident]'s int8x2 time, and ``bench --config dsa10c --bench-mode
    stream`` (16 blocks, 0 dropped); then ``bench_kernel`` at dsa10c in this
    process with the counts from 0.  Returns its detect launches."""
    recs = {}
    for cfg, mode in ((DSA10, "kernel"), (DSA10_COMPACT, "stream")):
        t0 = time.perf_counter()
        out = run_cli(["bench", "--config", cfg.name, "--bench-mode", mode,
                       "--blocks", str(BENCH_BLOCKS), "--device", "0"],
                      f"bench {cfg.name} {mode}")
        recs[mode] = json.loads(out.strip().splitlines()[-1])
        log(f"[bench] dsabf-torch bench --config {cfg.name} --bench-mode "
            f"{mode} --blocks {BENCH_BLOCKS} --device 0 "
            f"({time.perf_counter() - t0:.1f} s, process start included): "
            f"{json.dumps(recs[mode])} on {smi}")
    k, st = recs["kernel"], recs["stream"]
    ratio = k["ms_per_block"] / resident_ms
    log(f"[bench] kernel record {k['ms_per_block']:.3f} ms/block against "
        f"[resident]'s int8x2 {resident_ms:.3f} ms: {ratio:.4f} (bar 1 +- "
        f"{BENCH_RTOL}); stream {st['blocks']} blocks, dropped "
        f"{st['dropped']}, {st['realtime_factor']:.4f}x realtime")
    if abs(ratio - 1.0) > BENCH_RTOL or k["tc_utilization_issued"] is None \
            or st["blocks"] != BENCH_BLOCKS or st["dropped"]:
        raise RuntimeError(f"[bench] records off their bars: {recs}")
    clear_launches()
    rec = bench_kernel(DSA10_COMPACT, n_blocks=BENCH_BLOCKS, device=DEV)
    launches = sum(gemm.fused_detect.launches.values())
    log(f"[bench] bench_kernel(dsa10c) in this process: {json.dumps(rec)}; "
        f"detect launches {launches} (1 warm-up + {BENCH_BLOCKS} x 3)")
    if launches != 1 + 3 * BENCH_BLOCKS:
        raise RuntimeError(f"[bench] {launches} launches")
    return launches


def bank_rows(live, checked) -> list:
    """The kernels line's rows of the dedispersion kernels and the top-k
    (``launches``: the live search's; a ``[dsa10_frb]`` row is its kernel
    at that cell's shapes)."""
    return [{
        "name": name,
        "route": "cuda",
        "source": "dsabeamformer_tpu_torch/csrc/dedisperse.cu",
        "replaces": f"dsabeamformer_tpu/ops/dedisperse.py{line}",
        "launches": live[name.split()[0]],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": lib_ms,
        "shape": list(shape),
    } for name, (err, ms, plain_ms, bnd, by, shape, line, lib_ms, _)
        in checked.items()]


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


def main() -> tuple:
    """Every phase; the card's name and the kernels line's rows."""
    t_start = time.perf_counter()

    def mark(what) -> None:
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")

    name, smi = phase_device()
    # The kernels build on a thread of their own, beside the first capture
    # process of [cli] (``cli_dsa10c`` starts no kernel user before it).
    build_pool = ThreadPoolExecutor(max_workers=1)
    build = build_pool.submit(phase_build)
    # The float64 golden references are made once each, on host threads
    # (``golden``): the first one phase 4 needs while the CLI's processes
    # run, the others once phase 6 has timed the host's copies.
    physics_dsa10 = DSA10.replace(n_chan=128, t_block=512)
    golden("point", physics_dsa10)
    # The port's CLI as a deployment runs it, each command a process of its
    # own: first, while this process holds little host memory.
    trace = phase_cli(smi, build)
    build_pool.shutdown()
    mark("cli")

    cfg = DSA10
    t0 = time.perf_counter()
    blocks = random_blocks(cfg, (0, 1))
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
    log(f"[cli] trace's detect kernel at dsa10, mean of {N_TRACE}: "
        f"{trace['detect_ms']:.3f} ms (profiler); [resident] int8x2 "
        f"{res['ms']:.3f} ms (CUDA events, {N_TIMED} launches) on {smi}")
    phase_transfers(cfg, blocks[0])
    launches = collections.Counter(
        base=phase_stream(cfg, blocks, qw, res["block0"], smi))
    # The search drill's capture process makes its dsa10c pulse block while
    # the phases below keep the card busy (half of /dev/shm is its to take).
    search_cfg, search_why = choose_ring_cfg(shm_free()[1] // 2,
                                             [DSA10_COMPACT])
    search_prod = Producer(search_cfg, "pulse", [(N_SEARCH, None, False)])
    mark("main path (phases 3-6)")
    for kind in ("stokes", "noise"):
        golden(kind, physics_dsa10)
    for kind in ("point", "stokes"):
        golden(kind, DSA110.replace(n_chan=VOLTAGE_CHANNELS, t_block=512),
               DSA110_TARGET)
    lm_golden = start_lm_golden()

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
    mark("variants and Stokes (phases 7-13)")

    # The deployed streams (each driven with the counts set to 0).
    for b in blocks:
        with_carrier(cfg, b)
    launches.update(phase_deployed(cfg, blocks, smi))
    launches.update(phase_stokes_deployed(cfg, blocks, smi))
    # The ring ingest (its streams driven with the counts set to 0).
    mark("deployed streams (phases 9, 14)")
    phase_ring(blocks, smi)
    mark("ring")
    # The other weight modes on the same two blocks (carrier included).
    modes = phase_modes(blocks, smi)
    mark("modes (phases 23-26)")
    del blocks
    cc_blocks = [with_carrier(cc, cc_block),
                 with_carrier(cc, make_random_bytes_block(cc, seed=3))]
    with tempfile.TemporaryDirectory() as tmp:
        # run --mesh against run, two processes beside these streams.
        mesh_cli = start_mesh_cli(cc_blocks, Path(tmp))
        launches.update(phase_other_deployments(cc, cc_blocks, smi))
        launches.update(phase_other_deployments(cc, cc_blocks, smi,
                                                "stokes"))
        finish_mesh_cli(mesh_cli, smi)
    del cc_blocks
    # Bytes to candidates: the live search from the ring, the offline
    # search, and the bank kernels against their plain versions.
    mark("other deployments (phases 10, 15)")
    bank_live, bank_checked = phase_search(search_prod, search_cfg,
                                           search_why, smi)
    mark("search")
    missing = [v for v in ALL_VARIANTS if not launches[v]]
    if missing:
        raise RuntimeError(f"variants never launched on a main path: "
                           f"{missing}")

    # The unfused validation path (driven with its count set to 0).
    volt = phase_voltages(smi)
    mark("voltages")

    # DSA-110, while [multihost]'s processes start.
    multihost = spawn_multihost()
    d110 = phase_dsa110(smi)
    mark("dsa110 (phases 18-22, 27-28)")

    # Two processes sharing the card run beside the widths and shapes off
    # the presets (their streams counted from 0 there), then the K loop.
    multihost = start_multihost(multihost, smi)
    phase_widths()
    d110["scaleout"] += finish_multihost(multihost)
    mark("widths and multihost")
    kloop = phase_kloop(smi)
    mark("K loop")

    # The calibration loop, the (l, m) grids, the beam pattern and bench:
    # each path's detect launches counted from 0, booked to the base row of
    # its configuration's a_compute.
    with tempfile.TemporaryDirectory() as tmp:
        cal_n = phase_calibrate(Path(tmp), smi)
        mark("calibrate")
        phase_beampattern(Path(tmp), smi)
        mark("beampattern")
    lm_n = phase_lm(lm_golden, smi)
    mark("lm")
    bench_n = phase_bench(res["ms"], smi)
    mark("bench")
    launches["base"] += cal_n + bench_n
    d110["launches"]["base"] += lm_n + d110["scaleout"]
    log(f"[slice] detect launches: calibrate {cal_n}, bench {bench_n} (the "
        f"dsa10 base row), lm {lm_n}, the mesh and multihost streams "
        f"{d110['scaleout']} (the [dsa110] base row)")
    for mode, n in d110["tp"].items():
        row = d110["volt"] if mode == "int8x2" else d110["modes"][mode]["volt"]
        row["launches"] += n
    log(f"[slice] voltage launches of [tp] (the [dsa110] voltage rows): "
        f"{dict(d110['tp'])}")

    kernels = kernel_rows(cfg, ALL_VARIANTS, launches, checked, times, volt)
    kernels += kernel_rows(DSA110, DSA110_VARIANTS, d110["launches"],
                           d110["checked"], d110["times"], d110["volt"],
                           "[dsa110]")
    kernels += mode_rows(modes) + mode_rows(d110["modes"], "[dsa110]")
    kernels += bank_rows(bank_live, bank_checked) + kloop
    return name, kernels


if __name__ == "__main__":
    adopt_descendants()
    try:
        name, kernels = main()
    finally:
        stray = stop_descendants()
        log(f"[procs] every process the script started has ended; still "
            f"running when its work was done, then stopped: {stray or 'none'}")
    if stray:
        sys.exit(f"chip_smoke: {len(stray)} processes outlived their step")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
