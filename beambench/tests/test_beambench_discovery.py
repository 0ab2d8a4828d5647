"""Every name in BENCHMARK.json finds its file, and the file holds what the
harness and the format of ``BENCHMARK.json`` need."""

import importlib
import json
import re

import pytest

from beambench import check, products, program, run

BENCH = run.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["beambench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((run.CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_find_their_file_and_match_the_port(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"beambench/configs/{cfg['name']}.json"
    spec = run.config_spec(cfg["name"])
    assert spec["name"] == cfg["name"]
    assert spec["reduced"] == cfg["reduced"] == []
    program.obs_config(spec)  # raises where a key departs from the preset


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cells_find_config_mix_kind(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    mix = run.traffic_mix(cell["traffic"])
    kind = importlib.import_module(f"beambench.kinds.{mix['kind']}")
    assert callable(kind.run)
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    check.product_modules(run.config_spec(cell["config"]), mix)
    e2e, layer = run.cell_metrics(BENCH, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics_find_their_reader(metric):
    e2e = metric in BENCH["end_to_end"]
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if e2e else {"layer", "moves"})
    assert keys <= set(metric) <= keys | {"workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    module = run.reader("e2e_metrics" if e2e else "layer_metrics",
                        metric["name"])
    assert callable(module.read)
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        for cell in metric["workloads"]:
            assert metric["moves"] in {
                m["name"] for m in run.cell_metrics(BENCH, cell)[0]}


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_one_layer_name_per_reader():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("path", sorted((run.HERE / "traffic").iterdir()),
                         ids=lambda p: p.stem)
def test_every_product_of_a_mix_finds_its_module(path):
    mix = json.loads(path.read_text())
    own = importlib.import_module(f"beambench.kinds.{mix['kind']}").OWN
    assert mix["products"]
    for name in mix["products"]:
        assert NAME.match(name)
        module = products.module(name)
        assert module.NUMBERS and callable(module.compare)
        if name not in own:
            assert callable(module.attach)


def test_traffic_files_are_data():
    for path in (run.HERE / "traffic").iterdir():
        assert path.suffix == ".json"
        json.loads(path.read_text())
