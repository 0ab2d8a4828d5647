"""The readings a cell's correctness limits are set from, several seeds in
one process (the set-up is long).

    python3 -m beambench.control --workload <cell> --seeds 1,2,3 [--seconds 5] [--program]

Each seed runs the cell as ``beambench.run`` does, with a short window at
the cell's own load, and prints one JSON line: the seed, whether it ran the
control, ``correct`` and the numbers compared beside their limits.  By
default it runs the control: the program's own path in the nearest
precision below the configuration's (``program.LOWER_MODE``: int8 weights
for int8x2), and the incoherent sums and SK accumulators of the reference
rounded to bfloat16 in the program's place; every seed has to come out not
correct.  ``--program`` runs the program as configured (the lower
readings).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from beambench import run

    p = argparse.ArgumentParser(prog="python3 -m beambench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--program", action="store_true",
                   help="run the program as configured, not the control")
    args = p.parse_args(argv)
    bench = run.benchmark()
    cell = run.cell_entry(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("beambench.control: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.make_run(cell, args.seconds, seed, False, "cuda:0",
                         control=not args.program)
        result, _notes = run.execute(r, bench)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": r.control, "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
