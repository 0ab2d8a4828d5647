"""The control comes out not correct, the program correct, in every kind:
the tiny configuration on the CPU (the port's plain path)."""

import pytest

from beambench.tests.conftest import cpu_run

MIXES = ("ring_saturated", "ring_realtime", "resident")


@pytest.mark.parametrize("traffic", MIXES)
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
def test_control_is_not_correct(tiny, traffic, seed):
    result, _ = cpu_run(tiny, traffic, seed=seed, control=True)
    assert result["correct"] is False
    checks = result["checks"]
    for name in ("power_err", "inco_err", "sk_err"):
        assert checks[name]["value"] > checks[name]["limit"], name


@pytest.mark.parametrize("traffic", MIXES)
def test_program_is_correct(tiny, traffic):
    result, _ = cpu_run(tiny, traffic)
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["compared"]["value"] >= 1
    assert list(result)[-1] == "checks"
