"""BENCHMARK.json against the contract's shape, and every configuration,
cell, mix, driver and metric found by its name."""

import json
import re

import pytest

from perfbench import core
from perfbench.devtrace import Trace

BENCH = json.loads((core.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYER = [m["name"] for m in BENCH["per_layer"]]
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|feats|experts_per)")


def test_top_level_keys_and_bounds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1].startswith("perfbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 338 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        items = BENCH[group]
        assert len({i["name"] for i in items}) == len(items)
        for i in items:
            assert NAME.match(i["name"]), i["name"]
            if "unit" in i:
                assert UNIT.match(i["unit"]) and i["better"] in ("lower", "higher")
            if "why" in i:
                assert 1 <= len(i["why"]) <= 200 and "\n" not in i["why"] and "\t" not in i["why"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name_and_reports_its_metrics(cell):
    spec = core.load_cell(cell)
    assert spec["entry"]["chips"] == 1
    assert (core.PKG / "drivers" / f"{spec['traffic']['driver']}.py").is_file()
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())
    e2e, layer = core.cell_metrics(cell, BENCH)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:  # what a per-layer metric moves is reported where it is
        assert m["moves"] in names


@pytest.mark.parametrize("name", LAYER)
def test_metric_reader_loads_and_reads_nothing_from_nothing(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["layer"] and entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert set(entry["workloads"]) <= set(CELLS)
    if "roofline" in name:
        assert name.split(".")[0].endswith("_roofline") and entry["unit"] == "%"
    reader = core.load_module("metrics", name)
    assert reader.read(None) is None
    assert reader.read(Trace(0, 1)) is None


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(conf):
    data = json.loads((core.REPO / conf["file"]).read_text())
    assert conf["file"].startswith("perfbench/configs/")
    assert data["reduced"] == conf["reduced"] and data["source"].startswith(conf["source"])
    for key in conf["reduced"]:
        assert key in data and not WIDTH.search(key), key
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
