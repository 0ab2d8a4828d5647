"""One run of one cell of ``BENCHMARK.json``.

    python3 -m beambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set up (the card, the port's kernel, the inputs from the seed, the weights,
the warm-up), measure the window, free the program's state, hold what it
produced against the reference, and print one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also close standard error.

Exits non-zero with no result when the run has fewer cards than the cell
asks for, and when a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
#: Top-level module names no run may load: JAX and the JAX package (the
#: port's own name begins with the latter's, so names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "dsabeamformer_tpu")
def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(CHECKOUT / "BENCHMARK.json")


def config_spec(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic_mix(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def cell_entry(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"beambench: no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str) -> tuple:
    """``(end_to_end, per_layer)`` entries this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if ("workloads" in m and cell in m["workloads"])
             or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def reader(package: str, name: str):
    return importlib.import_module(f"beambench.{package}.{name.split('.')[0]}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class ForbiddenModules(RuntimeError):
    pass


def execute(r, bench: dict) -> tuple:
    """Run the cell -> ``(result, notes)``."""
    import torch
    from beambench import check

    check.product_modules(r.config, r.mix)
    kind = importlib.import_module(f"beambench.kinds.{r.mix['kind']}")
    out = kind.run(r)
    if found := forbidden_modules():
        raise ForbiddenModules(", ".join(found))
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.compare(r.config, r.mix, r.seed, out, r.device,
                           control=r.control)
    e2e, layer = cell_metrics(bench, r.cell)
    metrics = {}
    for m in (layer if r.trace else e2e):
        value = reader("layer_metrics" if r.trace else "e2e_metrics",
                       m["name"]).read(r, out)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if r.device.type == "cuda" else "cpu",
              "kind": r.device_kind, "count": r.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": check.passed(checks), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if r.trace:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result, out.notes


def make_run(cell: dict, seconds: float, seed: int, trace: bool, device,
             control: bool = False):
    import torch
    from beambench.core import Run

    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    r = Run(cell=cell["name"], config=config_spec(cell["config"]),
            mix=traffic_mix(cell["traffic"]), seed=seed,
            seconds=seconds, trace=trace, device=dev,
            t_process=T_PROCESS, control=control, device_kind=kind,
            chips=int(cell["chips"]))
    return r


def report(result: dict, notes: dict) -> None:
    for key, value in notes.items():
        print(f"beambench: {key} {value}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"beambench check: {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m beambench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = benchmark()
    cell = cell_entry(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"beambench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count="
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    r = make_run(cell, args.seconds, args.seed, bool(args.trace), "cuda:0")
    try:
        result, notes = execute(r, bench)
    except ForbiddenModules as e:
        print(f"beambench: modules of JAX or the JAX package are loaded: {e}",
              file=sys.stderr)
        return 4
    if found := forbidden_modules():
        print(f"beambench: modules of JAX or the JAX package are loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 4
    report(result, notes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
