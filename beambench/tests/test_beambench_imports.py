"""No run loads JAX or the JAX package, and the reference loads nothing of
the port.  Module names are compared whole, by their top-level part: the
port's name begins with the JAX package's."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from beambench import run

REPO = run.CHECKOUT
PROBE = """
import json, sys, time, torch
from beambench import run
from beambench.core import Run
cfg = json.load(open(sys.argv[1]))
for traffic, cell in (("ring_saturated", "dsa10.stream"),
                      ("resident", "dsa10.resident")):
    r = Run(cell=cell, config=cfg, mix=run.traffic_mix(traffic), seed=3,
            seconds=0.2, trace=False, device=torch.device("cpu"),
            t_process=time.perf_counter())
    run.execute(r, run.benchmark())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_a_run_loads_no_jax_and_no_jax_package():
    tiny = Path(__file__).parent / "data" / "tiny.json"
    out = subprocess.run([sys.executable, "-c", PROBE, str(tiny)], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "dsabeamformer_tpu_torch" in top
    assert not top & set(run.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, json, beambench.reference.beamform,"
         " beambench.inputs; print(json.dumps(sorted({m.split('.')[0] for m "
         "in sys.modules})))"], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=120, check=True)
    top = set(json.loads(out.stdout))
    assert "dsabeamformer_tpu_torch" not in top
    assert not top & set(run.FORBIDDEN)
    for path in (REPO / "beambench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "dsabeamformer_tpu_torch", *run.FORBIDDEN), (path, name)


def test_the_check_of_loaded_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dsabeamformer_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert run.forbidden_modules() == ["jaxlib"]


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    """Without a CUDA device, or in a directory with only BENCHMARK.json and
    the benchmark's files, the command exits non-zero and prints nothing
    on standard output."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "beambench", tmp_path / "beambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for cwd in (REPO, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "beambench.run", "--workload",
             "dsa10.stream", "--seed", str(2**31 + 99), "--seconds", "1",
             "--trace", "0"], cwd=cwd, env=env, capture_output=True,
            text=True, timeout=120)
        assert out.returncode != 0 and out.stdout == ""
