"""Time the detect kernel or the voltage kernel alone on one NVIDIA GPU: the
quick loop for work on a kernel's design, beside ``chip_smoke.py``'s full
check.

    python3 -m dsabeamformer_tpu_torch.utils.time_detect \\
        [--kernel detect|voltages] [--presets dsa10 dsa110] \\
        [--modes int8x2 bf16 bf16x2 f32 ...] [--variants base stokes] \\
        [--launches 4] [--nvcc-flag=-O2 ...]

``--kernel detect`` (the default), per (preset, weight mode, variant): the
weight tile, warpgroups and span the kernel takes (``gemm._detect_tiles``),
one launch held against the plain PyTorch version on the same block
(relative to the peak), then the mean CUDA-event time of ``--launches``
back-to-back launches on a resident random-bytes block, with the card's
name and power limit.  ``--kernel voltages``, per (preset, weight mode):
the same for ``beamform_voltages`` on the preset's 128-channel sub-band
(the tile from ``gemm._voltage_tiles``; the int8 modes must equal the plain
version bit for bit), and once per preset the store ceiling: a plain
``zero_()`` of the same 4.3 GB output tensor.  ``--nvcc-flag``
adds a flag to the build of every CUDA source, for a build option of the
sources as they stand.  A design alternative is timed from an edited copy
of the sources (``python3 -m ...`` run from that copy's root) in the same
call as the tree's, and only the winner is committed: no alternative stays
in the sources behind a switch.  Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from dsabeamformer_tpu_torch.config import DSA10, DSA10_COMPACT, DSA110
from dsabeamformer_tpu_torch.ingest.generator import make_random_bytes_block
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops import _build, gemm
from dsabeamformer_tpu_torch.ops.quantize import prepare_weights

PRESETS = {"dsa10": DSA10, "dsa10c": DSA10_COMPACT, "dsa110": DSA110}
#: Channels of the voltage kernel's sub-band (chip_smoke.py's
#: VOLTAGE_CHANNELS): its output is 4.3 GB at either preset.
VOLTAGE_CHANNELS = 128


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="detect",
                    choices=["detect", "voltages"])
    ap.add_argument("--presets", nargs="+", default=["dsa10", "dsa110"],
                    choices=sorted(PRESETS))
    ap.add_argument("--modes", nargs="+", default=["int8x2"],
                    choices=gemm.KERNEL_MODES)
    ap.add_argument("--variants", nargs="+", default=["base", "stokes"],
                    choices=["base", "stokes"])
    ap.add_argument("--launches", type=int, default=4)
    ap.add_argument("--nvcc-flag", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_detect: needs an NVIDIA GPU")
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + tuple(args.nvcc_flag)
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
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
            cfg = PRESETS[preset].replace(weight_mode=mode)
            for variant in args.variants:
                tiles = gemm._detect_tiles(cfg, variant == "stokes")
                ms, err = time_detect(cfg, variant, args.launches, device)
                print(f"{preset} {mode} a_compute {cfg.a_compute} {variant}: "
                      f"{ms:.3f} ms/block, max error / peak vs plain "
                      f"{err:.2e}; tile {tiles.beams} beams, {tiles.groups} "
                      f"warpgroups of {tiles.rows} rows, {tiles.smem} B of "
                      f"shared memory; flags {args.nvcc_flag}", flush=True)


if __name__ == "__main__":
    main()
