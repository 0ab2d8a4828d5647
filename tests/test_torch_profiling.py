"""The port's profiler (``utils/profiling.py`` on ``torch.profiler``),
``dsabf-torch trace`` and ``hostenv.process_rss_mb`` against the JAX
package's on the CPU: the traced block step names its annotated
``beamform_power`` region, the summary has the JAX rows' keys and sums a
trace file as the JAX summarizer does, the CLI prints the JSON record that
``dsabf trace`` prints, and the resident-memory reading agrees."""

import gzip
import json
import os

import pytest
import torch

from dsabeamformer_tpu import cli as jcli
from dsabeamformer_tpu.utils import hostenv as jhostenv
from dsabeamformer_tpu.utils import profiling as jprof
from dsabeamformer_tpu_torch import cli as pcli
from dsabeamformer_tpu_torch.config import TINY
from dsabeamformer_tpu_torch.utils import hostenv, profiling
from test_torch_cli import _main

ROW_KEYS = {"name", "count", "total_ms"}


def test_profile_block_step_on_cpu(tmp_path):
    rows = profiling.profile_block_step(TINY, n_blocks=2,
                                        log_dir=tmp_path, device="cpu")
    assert rows and all(set(r) == ROW_KEYS for r in rows)
    region = [r for r in rows if r["name"] == "beamform_power"]
    assert region and region[0]["count"] == 2
    assert list(tmp_path.glob("*.trace.json.gz"))
    assert rows == profiling.summarize_trace(tmp_path)


def test_trace_and_annotate_record_a_region(tmp_path):
    with profiling.trace(tmp_path, "cpu") as d:
        for _ in range(3):
            with profiling.annotate("step"):
                torch.ones(64).sum()
    assert d == str(tmp_path)
    names = [e["name"] for e in profiling.trace_events(tmp_path)]
    assert names.count("step") == 3
    assert {r["name"]: r["count"] for r in profiling.summarize_trace(
        tmp_path, top=100)}["step"] == 3


@pytest.mark.parametrize("top", [1, 3, 12])
def test_summarize_trace_equals_jax(tmp_path, top):
    """One trace file, both summarizers: the same rows (the newest file
    under the directory, complete events only, microseconds to ms)."""
    events = [{"ph": "X", "name": f"op{i % 5}", "dur": 10.0 * (i + 1),
               "ts": i} for i in range(23)]
    events += [{"ph": "i", "name": "marker", "ts": 3},
               {"ph": "X", "name": "nodur", "ts": 4}]
    old = tmp_path / "old.trace.json.gz"
    old.write_bytes(gzip.compress(json.dumps(
        {"traceEvents": events[:2]}).encode()))
    os.utime(old, (1e9, 1e9))
    new = tmp_path / "sub" / "new.trace.json.gz"
    new.parent.mkdir()
    new.write_bytes(gzip.compress(json.dumps(
        {"traceEvents": events}).encode()))
    got = profiling.summarize_trace(tmp_path, top=top)
    assert got == jprof.summarize_trace(tmp_path, top=top)
    assert len(got) == min(top, 6) and got[0]["name"] == "op2"


def test_summarize_trace_without_a_trace(tmp_path):
    for mod in (profiling, jprof):
        with pytest.raises(FileNotFoundError, match="no .trace.json.gz"):
            mod.summarize_trace(tmp_path)


def test_cli_trace_equals_jax_record(tmp_path, capsys):
    """``dsabf-torch trace --device cpu`` prints the record ``dsabf trace``
    prints: the same keys, the same blocks and log directory, op rows of
    the same keys, one of them the annotated block step."""
    recs = {}
    for which, extra in ((jcli, []), (pcli, ["--device", "cpu"])):
        out_dir = tmp_path / which.__name__
        rc, out, _ = _main(which, ["trace", "--config", "tiny", "--blocks",
                                   "2", "--out", str(out_dir), *extra],
                           capsys)
        assert rc == 0
        recs[which] = json.loads(out.strip())
    j, p = recs[jcli], recs[pcli]
    assert set(p) == set(j) == {"log_dir", "blocks", "ops"}
    assert p["blocks"] == j["blocks"] == 2
    assert p["log_dir"] == str(tmp_path / pcli.__name__)
    assert p["ops"] and all(set(r) == ROW_KEYS for r in p["ops"])
    assert all(set(r) == ROW_KEYS for r in j["ops"])
    assert any(r["name"] == "beamform_power" and r["count"] == 2
               for r in p["ops"])


def test_process_rss_mb_equals_jax():
    a = hostenv.process_rss_mb()
    b = jhostenv.process_rss_mb()
    assert a > 0 and abs(a - b) <= 2.0
    assert hostenv.__all__ == ["process_rss_mb"]


def test_profile_block_step_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        profiling.profile_block_step(TINY, n_blocks=1, log_dir=tmp_path)
