"""On the card: one short traced run of each cell through the benchmark's
command, correct, with its result line's keys in place."""

import json
import os
import subprocess
import sys

import pytest
import torch

from beambench import run


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in run.benchmark()
                                  ["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    env = dict(os.environ, PYTHONPATH=str(run.CHECKOUT))
    out = subprocess.run(
        [sys.executable, "-m", "beambench.run", "--workload", cell, "--seed",
         str(2**31 + 4242), "--seconds", "3", "--trace", "1"],
        cwd=run.CHECKOUT, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert list(result)[-1] == "checks"
