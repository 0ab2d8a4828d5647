"""A product that exists only as a module under ``beambench.products``,
registered here and named by no harness file: the ring kind attaches it to
the loop and keeps its sampled data, the check holds its number to the
configuration's limit and decides ``correct`` by it, and a limit that
nothing returns, or a number with no limit, stops the run at start-up."""

import copy
import math
import sys
import time
import types

import numpy as np
import pytest
import torch

from beambench import check, run
from beambench.core import Run
from beambench.kinds import resident, ring
from beambench.tests.conftest import CELL_OF_MIX

NAME = "beam_probe"
BEAM = 5


class _Monitor:
    """A stand-in for the search monitor: the loop selects one beam of each
    block on the device and hands it over at the drain; the sampled blocks'
    ``[T', F']`` counts are kept, with ``alter`` added to one of them."""

    wants_beams = True
    _labels = None
    beam = BEAM

    def __init__(self, keep, alter):
        self.keep, self.alter = set(keep), alter
        self.kept: dict = {}

    def select_beams(self, powers):
        return powers[..., BEAM].t().contiguous()

    def observe_selected(self, seq, sel, inco=None):
        if seq in self.keep:
            got = np.array(sel)
            got.flat[got.size // 2] += self.alter
            self.kept[seq] = got

    def flush(self):
        pass


def _probe_module(alter=0, numbers=("probe_err",)):
    mod = types.ModuleType(f"beambench.products.{NAME}")
    mod.NUMBERS = numbers

    def attach(r, cfg, bf, keep, tracer):
        bf.search_monitor = _Monitor(keep, alter)
        return bf.search_monitor

    def compare(ctx, ref, got):
        if got is None:
            return {"probe_err": math.inf}
        counts = torch.from_numpy(got).to(ctx.device).t()   # [F', T']
        want = (ref.power[..., BEAM] * ctx.scales[BEAM]).clamp(0.0, 255.0)
        gap = ((counts.to(torch.float64) - want).abs() - 0.5).clamp_min(0.0)
        return {"probe_err": float((gap / want.clamp_min(1.0)).max())}

    mod.attach, mod.compare = attach, compare
    return mod


@pytest.fixture
def probe(monkeypatch):
    def register(**kw):
        monkeypatch.setitem(sys.modules, f"beambench.products.{NAME}",
                            _probe_module(**kw))
    register()
    return register


def _run(config, traffic="ring_saturated", products=(NAME,),
         seed=2**31 + 31) -> Run:
    mix = run.traffic_mix(traffic)
    mix["products"] = mix["products"] + list(products)
    return Run(cell=CELL_OF_MIX[traffic], config=config, mix=mix, seed=seed,
               seconds=0.4, trace=False, device=torch.device("cpu"),
               t_process=time.perf_counter())


@pytest.fixture
def probed(tiny) -> dict:
    spec = copy.deepcopy(tiny)
    spec["checks"]["probe_err"] = 1e-3
    return spec


def test_the_ring_kind_attaches_the_product_and_keeps_its_blocks(probe,
                                                                   probed):
    out = ring.run(_run(probed))
    assert out.kept
    for k in out.kept:
        got = k.products[NAME]
        fil = k.products["uint8_fil"]          # [B, T', F'], descending
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, fil[BEAM, :, ::-1])


@pytest.mark.parametrize("traffic", ["ring_saturated", "ring_realtime"])
def test_its_number_stands_beside_its_limit_in_checks(probe, probed,
                                                      traffic):
    result, _ = run.execute(_run(probed, traffic), run.benchmark())
    checks = result["checks"]
    assert result["correct"] is True, checks
    assert checks["probe_err"]["limit"] == 1e-3
    assert 0 <= checks["probe_err"]["value"] <= 1e-3
    assert checks["compared"]["value"] >= 1
    assert list(checks) == ["power_err", "scale_err", "inco_err", "sk_err",
                            "probe_err", "order_faults", "lost", "compared"]


def test_a_product_past_its_limit_makes_the_run_not_correct(probe, probed):
    probe(alter=9)
    result, _ = run.execute(_run(probed), run.benchmark())
    checks = result["checks"]
    assert result["correct"] is False
    assert checks["probe_err"]["value"] > checks["probe_err"]["limit"]
    assert all(c["value"] <= c["limit"] for name, c in checks.items()
               if name not in ("probe_err", "compared"))


def _refuses(monkeypatch, r, match):
    """The run stops before the kind starts."""
    def never(_r):
        raise AssertionError("the kind ran")
    monkeypatch.setattr(ring, "run", never)
    with pytest.raises(ValueError, match=match):
        run.execute(r, run.benchmark())


def test_a_number_with_no_limit_stops_the_run(probe, tiny, monkeypatch):
    _refuses(monkeypatch, _run(tiny),
             r"with no limit in checks: \['probe_err'\]")


def test_a_limit_that_nothing_returns_stops_the_run(probe, probed,
                                                    monkeypatch):
    spec = copy.deepcopy(probed)
    spec["checks"]["ghost_err"] = 0.0
    _refuses(monkeypatch, _run(spec),
             r"limits that nothing returns: \['ghost_err'\]")
    _refuses(monkeypatch, _run(probed, products=()),
             r"limits that nothing returns: \['probe_err'\]")


def test_a_number_two_parts_return_stops_the_run(probe, probed,
                                                 monkeypatch):
    probe(numbers=("probe_err", "sk_err"))
    _refuses(monkeypatch, _run(probed),
             r"more than one part: \['sk_err'\]")


def test_a_product_without_a_module_stops_the_run(tiny):
    with pytest.raises(ModuleNotFoundError):
        check.product_modules(tiny, {"products": ["no_such_product"]})


def test_a_number_outside_the_product_s_numbers_is_refused(probe, probed):
    probe(numbers=("other_err",))
    probed["checks"]["other_err"] = 1.0
    del probed["checks"]["probe_err"]
    with pytest.raises(ValueError, match="not its NUMBERS"):
        run.execute(_run(probed), run.benchmark())


def test_the_resident_kind_refuses_a_product_it_cannot_attach(probe,
                                                              probed):
    r = _run(probed, traffic="resident")
    with pytest.raises(ValueError, match="resident kind makes"):
        resident.run(r)
