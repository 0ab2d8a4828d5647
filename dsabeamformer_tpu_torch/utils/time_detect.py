"""Time the detect kernel alone on one NVIDIA GPU: the quick loop for work on
a kernel's design, beside ``chip_smoke.py``'s full check.

    python3 -m dsabeamformer_tpu_torch.utils.time_detect \\
        [--presets dsa10 dsa110] [--modes int8x2 int8 int12 int13] \\
        [--variants base stokes] [--launches 4] [--nvcc-flag=-DNAME ...]

Per (preset, weight mode, variant): one launch held against the plain
PyTorch version on the same block (relative to the peak), then the mean
CUDA-event time of ``--launches`` back-to-back launches on a resident
random-bytes block, with the card's name and power limit.  ``--nvcc-flag``
adds a flag to the build of every CUDA source, so that two builds of a
source under change (an ablation behind ``#ifdef``) can be timed in one run.
Needs a card; imports no JAX.
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
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(launches):
        run()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / launches, err


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    for preset in args.presets:
        for mode in args.modes:
            cfg = PRESETS[preset].replace(weight_mode=mode)
            for variant in args.variants:
                ms, err = time_detect(cfg, variant, args.launches, device)
                print(f"{preset} {mode} a_compute {cfg.a_compute} {variant}: "
                      f"{ms:.3f} ms/block, max error / peak vs plain "
                      f"{err:.2e}, flags {args.nvcc_flag}", flush=True)


if __name__ == "__main__":
    main()
