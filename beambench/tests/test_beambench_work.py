"""The work counts of both configurations, and the least times they give
at the H100's published peaks."""

import pytest

from beambench import peaks, run, work


@pytest.mark.parametrize("name, macs, nbytes, least_ms", [
    ("dsa10", 3.436e11, 0.608e9, 0.347),
    ("dsa10_sub256", 4.295e10, 0.0761e9, 0.0434),
])
def test_counts(name, macs, nbytes, least_ms):
    obs = run.config_spec(name)["obs"]
    assert work.real_macs(obs) == pytest.approx(macs, rel=1e-3)
    assert work.bytes_moved(obs) == pytest.approx(nbytes, rel=3e-3)
    t, bound = work.least_time_s(obs, peaks.peak_for("NVIDIA H100 80GB HBM3"))
    assert bound == "ops"
    assert t * 1e3 == pytest.approx(least_ms, rel=2e-3)


def test_counts_are_of_active_antennas_not_the_padded_contraction():
    obs = run.config_spec("dsa10")["obs"]
    assert work.complex_macs(obs) == 2048 * 8192 * 2 * 256 * 10
    assert work.complex_macs(dict(obs, n_ant=128)) == work.complex_macs(obs)


def test_peaks():
    assert peaks.peak_for("NVIDIA H100 80GB HBM3")["int8_macs_per_s"] == 989.5e12
    assert peaks.peak_for("NVIDIA H100 PCIe")["bytes_per_s"] == 2.0e12
    assert peaks.peak_for("cpu") is None
