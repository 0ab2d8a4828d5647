"""The live search's product on the CPU: ``dsa10_frb`` under
``ring_search`` is a pairing the check accepts; a run of the tiny
configuration with a search block streams through the port's monitor and
is correct; the reference held against itself reads no gap, and its own
sums in bfloat16, the control, fail ``search_snr_err``."""

import copy
import time

import pytest
import torch

from beambench import check, run
from beambench.core import Run
from beambench.products import search

CELL = "dsa10_frb.search_stream"
#: A search of the tiny configuration moved to 100 MHz, where its 51-kHz
#: band sweeps 17 samples of 2.5 ms at DM 100: windows of 32 owned samples
#: (8 blocks of 4).
TINY_SEARCH = {"beams": "all", "dm_min": 0.0, "dm_max": 100.0,
               "dm_tol": 1.25, "widths": [1, 2, 4], "threshold": 7.0,
               "chunk_t": 32, "topk": 4, "method": "conv",
               "coincidence": True, "coincidence_frac": 0.25}


@pytest.fixture
def tiny_frb(tiny) -> dict:
    spec = copy.deepcopy(tiny)
    spec["obs"]["f_start_hz"] = 1e8
    spec["reduced"].append("f_start_hz")
    f = search.ref_search.freqs_mhz(spec["obs"])
    ts = search.ref_search.tsamp_s(spec["obs"])
    spec["search"] = dict(TINY_SEARCH, n_trials=len(
        search.ref_search.dm_grid(f, ts, TINY_SEARCH["dm_max"], 1.25)))
    spec["checks"].update(run.config_spec("dsa10_frb")["checks"])
    return spec


def _run(spec, control=False, seed=2**31 + 41) -> Run:
    return Run(cell=CELL, config=spec, mix=run.traffic_mix("ring_search"),
               seed=seed, seconds=0.4, trace=False,
               device=torch.device("cpu"), t_process=time.perf_counter(),
               control=control)


def test_the_deployment_s_pairing_is_accepted():
    mods = check.product_modules(run.config_spec("dsa10_frb"),
                                 run.traffic_mix("ring_search"))
    assert mods["search"] is search
    assert set(search.NUMBERS) <= set(run.config_spec("dsa10_frb")["checks"])


def test_a_run_searches_every_beam_and_is_correct(tiny_frb):
    result, notes = run.execute(_run(tiny_frb), run.benchmark())
    checks = result["checks"]
    assert result["correct"] is True, checks
    assert checks["compared"]["value"] >= 1
    assert checks["search_windows_missed"]["value"] == 0
    # Eight channels a sum: a count rounded the other way moves a peak by
    # ~0.04 sigma here (~0.002 at 2048 channels).
    assert 0 <= checks["search_snr_err"]["value"] \
        <= checks["search_snr_err"]["limit"]


def test_the_reference_against_itself_reads_no_gap(tiny_frb, monkeypatch):
    """The control with its sums kept in float64: the reference's own peaks
    and candidates in the program's place read no gap."""
    bank = search.ref_search.bank
    monkeypatch.setattr(search.ref_search, "bank",
                        lambda x, eff, dtype=torch.float64: bank(x, eff))
    result, _ = run.execute(_run(tiny_frb, control=True), run.benchmark())
    assert result["checks"]["search_snr_err"]["value"] == 0.0
    assert result["checks"]["search_cand_faults"]["value"] == 0


def test_the_bfloat16_control_fails_the_gap(tiny_frb):
    result, _ = run.execute(_run(tiny_frb, control=True), run.benchmark())
    c = result["checks"]["search_snr_err"]
    assert result["correct"] is False
    assert c["value"] > c["limit"]


def test_the_first_window_is_rebuilt_on_a_beam_of_every_group():
    """Of the first window one row of every beam group (its first, its last
    or one between, each drawn in some runs); of one more window, drawn
    from the seed, ``BEAMS`` rows; of any other, none."""

    class Window:
        beams, group = list(range(48)), 7

    records = []
    for i in range(5):
        records.append({"window": Window(), "index": i, "of": records})
    seen, second = set(), set()
    for seed in range(2**31 + 1, 2**31 + 41):
        ctx = type("Ctx", (), {"seed": seed})()
        rows = search._compared(ctx, records[0])
        groups = [r // Window.group for r in rows]
        assert groups == list(range(-(-48 // Window.group)))
        seen.update(r % Window.group for r in rows if r < 42)
        chosen = [r["index"] for r in records[1:]
                  if search._compared(ctx, r) is not None]
        assert len(chosen) == 1
        assert len(search._compared(ctx, records[chosen[0]])) == search.BEAMS
        second.update(chosen)
    assert {0, Window.group - 1} <= seen and len(seen) > 2
    assert second == {1, 2, 3, 4}
