"""Time the detect kernel, the voltage kernel or the dedispersion bank's
kernels alone on one NVIDIA GPU: the quick loop for work on a kernel's
design, beside ``chip_smoke.py``'s full check.

    python3 -m dsabeamformer_tpu_torch.utils.time_detect \\
        [--kernel detect|voltages|bank] [--presets dsa10 dsa110] \\
        [--modes int8x2 bf16 bf16x2 f32 ...] [--variants base stokes] \\
        [--launches 4] [--nvcc-flag=-O2 ...] \\
        [--a-compute 10 264 edge 2048] [--channels 64]

``--kernel detect`` (the default), per (preset, weight mode, variant): the
weight tile, warpgroups and span the kernel takes (``gemm._detect_tiles``),
one launch held against the plain PyTorch version on the same block
(relative to the peak), then the mean CUDA-event time of ``--launches``
back-to-back launches on a resident random-bytes block, with the card's
name and power limit, and the launch's bound (the larger of its MACs over
the card's dense peak for the mode's operand type, f32 the lesser of
float32 on the CUDA cores and three bf16 passes, and its bytes over the
memory rate).  ``--a-compute`` times the preset contracting each given
number of antennas instead (``edge``: the first multiple of 8 past the
widest whose whole weight tile the detect kernel stages, where it takes the
K loop), on ``--channels`` channels.  ``--kernel voltages``, per (preset,
weight mode):
the same for ``beamform_voltages`` on the preset's 128-channel sub-band
(the tile from ``gemm._voltage_tiles``; the int8 modes must equal the plain
version bit for bit), and once per preset the store ceiling: a plain
``zero_()`` of the same 4.3 GB output tensor.  ``--kernel bank``: the
three dedispersion kernels (``ops/dedisperse.py``) on the live search's
window at ``dsa10c`` (``[search kernels]`` in ``chip_smoke.py``: 32 beams,
4708 samples, 2048 channels, 465 trials to DM 100, the conv plan's 16
groups and 102 coarse trials) filled with random floats on the card: each
held against its plain version (bit for bit), then timed, with its share
of the add bound (33.5e12 float32 adds a second).  ``--nvcc-flag``
adds a flag to the build of every CUDA source, for a build option of the
sources as they stand.  A design alternative is timed from an edited copy
of the sources (``python3 -m ...`` run from that copy's root) in the same
call as the tree's, and only the winner is committed: no alternative stays
in the sources behind a switch.  Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import DSA10, DSA10_COMPACT, DSA110
from dsabeamformer_tpu_torch.ingest.generator import make_random_bytes_block
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops import _build, gemm
from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
from dsabeamformer_tpu_torch.utils.metrics import peak_macs_per_s

PRESETS = {"dsa10": DSA10, "dsa10c": DSA10_COMPACT, "dsa110": DSA110}
#: Channels of the voltage kernel's sub-band (chip_smoke.py's
#: VOLTAGE_CHANNELS): its output is 4.3 GB at either preset.
VOLTAGE_CHANNELS = 128
#: Float32 outside the tensor cores (NVIDIA's H100 SXM data sheet, 67
#: TFLOP/s, an FMA two), and the HBM3 rate: chip_smoke.py's bounds.
F32_MACS_PER_S = 67e12 / 2
BYTES_PER_S = 3.35e12


def bound_ms(cfg, stokes: bool, device_kind: str) -> tuple:
    """(ms, "operations" or "bytes"): the least time of one detect launch
    of ``cfg`` on the card named ``device_kind``, as chip_smoke.py's
    ``bound_ms`` counts it for the base and the Stokes variant."""
    macs = cfg.macs_per_block * cfg.n_weight_terms
    if cfg.weight_mode == "f32":
        ops = min(macs / F32_MACS_PER_S,
                  gemm.F32_PARTS * macs / peak_macs_per_s(device_kind,
                                                          "bf16"))
    else:
        ops = macs / peak_macs_per_s(device_kind, cfg.weight_mode)
    item = {"bf16": 2, "bf16x2": 2, "f32": 4}.get(cfg.weight_mode, 1)
    f_out, t_out, b = cfg.out_block_shape
    nbytes = (cfg.t_block * cfg.n_chan * cfg.n_pol * cfg.a_compute
              + cfg.n_weight_terms * cfg.n_chan * (cfg.gemm_k * 2 * b * item
                                                   + 4)
              + f_out * t_out * (4 if stokes else 1) * b * 4)
    ops_ms, bytes_ms = ops * 1e3, nbytes / BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def width_cfg(cfg, a_compute):
    """``cfg`` contracting ``a_compute`` antennas (``"edge"``: the first
    multiple of 8 past the widest whose whole weight tile the detect kernel
    stages), at least two slots inactive."""
    if a_compute == "edge":
        ac = 8
        while gemm.kernel_path(width_cfg(cfg, ac)) == gemm.DETECT_MMA:
            ac += 8
        return width_cfg(cfg, ac)
    ac = int(a_compute)
    return cfg.replace(n_ant=max(cfg.n_ant, ac),
                       n_ant_active=min(cfg.n_ant_active, ac - 2),
                       n_ant_compute=ac)


def _events_ms(fn, launches: int) -> float:
    """Mean CUDA-event ms of ``launches`` back-to-back calls of ``fn``."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(launches):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / launches


def time_detect(cfg, variant: str, launches: int, device) -> tuple:
    """``(ms per launch, max error / peak against the plain version)`` of
    ``variant`` (``"base"`` or ``"stokes"``) of ``cfg``'s detect kernel."""
    qw = prepare_weights(cfg, make_weights(cfg, device=device))
    wire = torch.from_numpy(gemm.device_wire_view(
        make_random_bytes_block(cfg, seed=1), cfg)).to(device)
    x, tm = gemm._prepare_wire(wire, cfg)
    stokes = variant == "stokes"
    run = lambda: gemm.fused_detect(x, qw.terms, qw.scales, cfg, tm,
                                    stokes=stokes)[0]
    out = run()
    want = gemm.detect_power_plain(x, qw.terms, qw.scales, cfg, tm,
                                   stokes=stokes)[0]
    err = float((out - want).abs().max()) / float(want.abs().max())
    del want
    return _events_ms(run, launches), err


def time_voltages(cfg, launches: int, device) -> tuple:
    """``(ms per launch, max error / peak against the plain version, store
    ceiling ms)`` of ``cfg``'s voltage kernel; raises where an int8 mode
    differs from the plain version at all."""
    qw = prepare_weights(cfg, make_weights(cfg, device=device))
    wire = torch.from_numpy(gemm.device_wire_view(
        make_random_bytes_block(cfg, seed=1), cfg)).to(device)
    out = gemm.beamform_voltages(wire, qw, cfg)
    x, tm = gemm._prepare_wire(wire, cfg)
    want = gemm.voltages_plain(x, qw.terms, qw.scales, cfg, tm)
    err = float((out - want).abs().max()) / float(want.abs().max())
    if cfg.weight_mode not in gemm.FLOAT_MODES and err:
        raise RuntimeError(f"{cfg.weight_mode} voltages differ from plain")
    del want
    ms = _events_ms(lambda: gemm.beamform_voltages(wire, qw, cfg), launches)
    out.zero_()  # warm up: the first pass costs more
    ceiling = _events_ms(out.zero_, launches)
    return ms, err, ceiling


#: The live search's first window at dsa10c: samples (its chunk, 4096, and
#: the overlap: the largest delay and the widest boxcar), beams, DM range.
BANK_WINDOW_T = 4708
BANK_BEAMS = 32
BANK_DM_MAX = 100.0
#: float32 adds a second of an H100 SXM outside the tensor cores.
F32_ADDS_PER_S = 33.5e12


def time_bank(launches: int, device) -> None:
    """Each dedispersion kernel on the dsa10c window (see the module's
    text): bit-equal to its plain version or raise, then its CUDA-event
    time and its share of the add bound, printed."""
    from dsabeamformer_tpu_torch.ops import dedisperse as dd

    cfg = DSA10_COMPACT
    f_mhz = cfg.freqs_hz() / 1e6
    tsamp = cfg.sample_period_s * cfg.navg_time
    dms = dd.dm_trial_grid(float(f_mhz.min()), float(f_mhz.max()), tsamp,
                           dm_max=BANK_DM_MAX)
    delays = dd.delay_table(f_mhz, dms, tsamp)
    b, t, f = BANK_BEAMS, BANK_WINDOW_T, cfg.n_chan
    gen = torch.Generator(device=device).manual_seed(0)
    t_pad = -(-(t + int(delays.max())) // 4) * 4
    p = torch.randn((b, f, t_pad), generator=gen, device=device)
    dt = torch.from_numpy(delays).to(device)
    intra, inter, rep_of, pad_f = dd._conv_plan(
        delays, dd._conv_auto_n_sub(delays), 1)
    g, j, c = intra.shape
    t1 = t + int(inter.max())
    t_pad1 = -(-(t1 + int(intra.max())) // 4) * 4
    p1 = torch.randn((b, g, c, t_pad1), generator=gen, device=device)
    it = torch.from_numpy(intra).to(device)
    offsets = torch.from_numpy(np.ascontiguousarray(
        rep_of[None, :] * t1 + inter.T, np.int32)).to(device)
    s1 = dd.subband_stage1(p1, it, t1)
    cases = [
        ("dedisperse_direct", lambda: dd.dedisperse_direct(p, dt, t),
         lambda: dd.dedisperse_direct_plain(p, dt, t), b * len(dms) * f * t),
        ("subband_stage1", lambda: dd.subband_stage1(p1, it, t1),
         lambda: dd.subband_stage1_plain(p1, it, t1), b * g * j * c * t1),
        ("subband_stage2", lambda: dd.subband_stage2(s1, offsets, t),
         lambda: dd.subband_stage2_plain(s1, offsets, t),
         b * len(dms) * g * t),
    ]
    for name, run, plain, adds in cases:
        got = run()
        err = float((got - plain()).abs().max())
        if err != 0.0:
            raise RuntimeError(f"{name} differs from its plain version by "
                               f"{err!r}")
        del got
        ms = _events_ms(run, launches)
        bound = adds / F32_ADDS_PER_S * 1e3
        print(f"bank {name}: {ms:.3f} ms, bit-equal to plain, add bound "
              f"{bound:.3f} ms ({bound / ms:.1%} of it)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="detect",
                    choices=["detect", "voltages", "bank"])
    ap.add_argument("--presets", nargs="+", default=["dsa10", "dsa110"],
                    choices=sorted(PRESETS))
    ap.add_argument("--modes", nargs="+", default=["int8x2"],
                    choices=gemm.KERNEL_MODES)
    ap.add_argument("--variants", nargs="+", default=["base", "stokes"],
                    choices=["base", "stokes"])
    ap.add_argument("--launches", type=int, default=4)
    ap.add_argument("--nvcc-flag", action="append", default=[])
    ap.add_argument("--a-compute", nargs="+", default=[None],
                    help="antennas to contract (a number, or edge)")
    ap.add_argument("--channels", type=int,
                    help="channels (default: the preset's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_detect: needs an NVIDIA GPU")
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + tuple(args.nvcc_flag)
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    if args.kernel == "bank":
        time_bank(args.launches, device)
        return
    if args.kernel == "voltages":
        for preset in args.presets:
            for mode in args.modes:
                cfg = PRESETS[preset].replace(weight_mode=mode,
                                              n_chan=VOLTAGE_CHANNELS)
                tiles = gemm._voltage_tiles(cfg)
                ms, err, ceiling = time_voltages(cfg, args.launches, device)
                print(f"{preset} {mode} a_compute {cfg.a_compute} voltages "
                      f"{cfg.n_chan} channels x {cfg.t_block} samples: "
                      f"{ms:.3f} ms, store ceiling (zero_ of the output) "
                      f"{ceiling:.3f} ms, max error / peak vs plain "
                      f"{err:.2e}; tile {tiles.beams} beams, {tiles.groups} "
                      f"warpgroups of {tiles.rows} m-tiles, {tiles.smem} B "
                      f"of shared memory; flags {args.nvcc_flag}",
                      flush=True)
        return
    for preset in args.presets:
        for mode in args.modes:
            for ac in args.a_compute:
                cfg = PRESETS[preset].replace(weight_mode=mode)
                if args.channels:
                    cfg = cfg.replace(n_chan=args.channels)
                if ac is not None:
                    cfg = width_cfg(cfg, ac)
                for variant in args.variants:
                    stokes = variant == "stokes"
                    tiles = gemm._detect_tiles(cfg, stokes)
                    ms, err = time_detect(cfg, variant, args.launches, device)
                    bnd, by = bound_ms(cfg, stokes, kind)
                    print(f"{preset} {mode} a_compute {cfg.a_compute} "
                          f"{variant} ({cfg.n_chan} channels, "
                          f"{gemm.kernel_path(cfg)}): {ms:.3f} ms/block, "
                          f"bound {bnd:.3f} ms by {by}, max error / peak vs "
                          f"plain {err:.2e}; tile {tiles.beams} beams, "
                          f"{tiles.groups} warpgroups of {tiles.rows} rows, "
                          f"{tiles.slices} K slices, {tiles.smem} B of "
                          f"shared memory; flags {args.nvcc_flag}",
                          flush=True)


if __name__ == "__main__":
    main()
