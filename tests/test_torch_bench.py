"""``utils/bench.py`` and ``dsabf-torch bench`` against the JAX package's
on the CPU at ``tiny``: the same records (the port's utilization under its
``tc_`` names, the JAX package's ``mxu_`` ones), their arithmetic, and
``info``'s ratio between the two accountings.  Times and rates are each
package's own and are not compared."""

import json

import numpy as np
import pytest

from dsabeamformer_tpu import cli as jcli
from dsabeamformer_tpu_torch import cli as pcli
from dsabeamformer_tpu_torch.config import TINY
from dsabeamformer_tpu_torch.utils.bench import (
    bench_kernel,
    bench_stream,
    run_benchmark,
)

#: A tensor-core peak for the CPU (MAC/s), read by both packages.
PEAK = "1e12"


def _renamed(keys) -> set:
    """The JAX record's keys under the port's names."""
    return {k.replace("mxu_", "tc_") for k in keys}


def _main(which, argv, capsys):
    capsys.readouterr()
    rc = which.main(argv)
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert rc == 0 and len(lines) == 1, out
    return json.loads(lines[0])


@pytest.mark.parametrize("mode", ["kernel", "stream"])
def test_run_benchmark_on_the_cpu(mode):
    rec = run_benchmark(TINY, n_blocks=4, mode=mode, device="cpu")
    assert rec["mode"] == mode and rec["config"] == "tiny"
    assert rec["ms_per_block"] > 0
    assert rec["tc_utilization_issued"] is None  # no peak for the CPU
    if mode == "kernel":
        s = rec["ms_per_block"] / 1e3
        assert rec["realtime_factor"] == pytest.approx(
            TINY.block_duration_s / s)
        assert rec["gb_per_s"] == pytest.approx(TINY.wire_block_bytes / s
                                                / 1e9)
    else:
        assert rec["blocks"] == 4 and rec["dropped"] == 0
        assert rec["bytes"] == 4 * TINY.wire_block_bytes
        assert rec["ms_per_block"] == pytest.approx(rec["wall_s"] / 4 * 1e3)


def test_bench_utilization_with_a_peak(monkeypatch):
    """With a peak, issued = MACs / time / peak and padded_k = issued *
    n_ant / a_compute, in both modes."""
    monkeypatch.setenv("DSABF_PEAK_INT8_MACS", PEAK)
    cfg = TINY.replace(n_ant_compute=8)
    macs = cfg.macs_per_block * cfg.n_weight_terms
    rec = bench_kernel(cfg, n_blocks=2, repeats=1, device="cpu")
    issued = macs / (rec["ms_per_block"] / 1e3) / float(PEAK)
    assert rec["tc_utilization_issued"] == pytest.approx(issued)
    assert rec["tc_utilization_padded_k"] == pytest.approx(2.0 * issued)
    rec = bench_stream(cfg, n_blocks=2, device="cpu")
    assert rec["tc_utilization_padded_k"] == pytest.approx(
        2.0 * rec["tc_utilization_issued"])


@pytest.mark.parametrize("mode", ["kernel", "stream"])
def test_cli_bench_record_matches_jax(capsys, mode):
    """One JSON line each; the port's keys are the JAX record's with
    ``tc_`` for ``mxu_`` (the stream record also names the device, as
    ``run``'s does); the static fields equal."""
    argv = ["bench", "--config", "tiny", "--blocks", "2"]
    if mode == "stream":
        argv += ["--bench-mode", "stream"]
    j = _main(jcli, argv, capsys)
    p = _main(pcli, argv + ["--device", "cpu"], capsys)
    extra = {"device"} if mode == "stream" else set()
    assert set(p) == _renamed(j) | extra
    assert p["mode"] == j["mode"] == mode
    for k in ("config", "blocks", "bytes", "dropped", "skipped"):
        assert p.get(k) == j.get(k), k
    if mode == "stream":
        assert p["device"] == "cpu"


def test_info_ratio_converts_the_bench_accountings(capsys, monkeypatch):
    """``info``'s ``tc_padded_k_over_issued`` (the JAX package's
    ``mxu_padded_k_over_issued``) is bench's padded_k / issued on the same
    config."""
    monkeypatch.setenv("DSABF_PEAK_INT8_MACS", PEAK)
    cfg_args = ["--config", "tiny", "--set", "n_ant_compute=8"]
    info = _main(pcli, ["info"] + cfg_args, capsys)
    jinfo = _main(jcli, ["info"] + cfg_args, capsys)
    assert info["tc_padded_k_over_issued"] \
        == jinfo["mxu_padded_k_over_issued"] == 2.0
    assert _renamed(jinfo) - {"backend", "devices"} <= set(info)
    rec = _main(pcli, ["bench", "--blocks", "2", "--device", "cpu"]
                + cfg_args, capsys)
    assert rec["tc_utilization_issued"] > 0
    assert rec["tc_utilization_padded_k"] / rec["tc_utilization_issued"] \
        == pytest.approx(info["tc_padded_k_over_issued"])
    # At the presets, the ratio is n_ant / a_compute.
    for preset in ("dsa10", "dsa10c", "dsa110"):
        got = _main(pcli, ["info", "--config", preset], capsys)
        want = _main(jcli, ["info", "--config", preset], capsys)
        assert got["tc_padded_k_over_issued"] \
            == want["mxu_padded_k_over_issued"]
    assert np.isclose(got["tc_padded_k_over_issued"], 1.0)
