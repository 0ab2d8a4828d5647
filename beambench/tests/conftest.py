"""Shared fixtures of the harness's CPU tests: the ``tiny`` configuration
(the port's TINY preset with a band narrow enough that a block lasts
10 ms) and a run of a cell on the CPU, the look for a card skipped."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from beambench import run
from beambench.core import Run

TINY = Path(__file__).parent / "data" / "tiny.json"

#: A cell of BENCHMARK.json for each traffic mix, run with the tiny config.
CELL_OF_MIX = {"ring_saturated": "dsa10.stream",
               "ring_realtime": "dsa10.realtime",
               "resident": "dsa10.resident"}


@pytest.fixture
def tiny() -> dict:
    return json.loads(TINY.read_text())


def cpu_run(config: dict, traffic: str, seed: int = 2**31 + 7,
            seconds: float = 0.4, control: bool = False) -> tuple:
    """``(result, notes)`` of one run of ``traffic`` on the CPU."""
    r = Run(cell=CELL_OF_MIX[traffic], config=config,
            mix=run.traffic_mix(traffic), seed=seed, seconds=seconds,
            trace=False, device=torch.device("cpu"),
            t_process=time.perf_counter(), control=control)
    return run.execute(r, run.benchmark())
