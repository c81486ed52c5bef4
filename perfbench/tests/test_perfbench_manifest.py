"""BENCHMARK.json and the files it names: the contract's keys and names, and
every configuration, mix, driver and per-layer metric found by name."""

import json
import re

import pytest

from perfbench import core, system

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.manifest()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [x["name"] for x in BENCH[section]]
    assert len(names) == len(set(names))
    for x in BENCH[section]:
        assert NAME.match(x["name"]), x["name"]
        if "unit" in x:
            assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in x:
                assert 1 <= len(x[key]) <= 200 and "\n" not in x[key] and "\t" not in x[key]


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        work, centry, cfile, mix = core.cell(w["name"], BENCH)
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert core.driver(mix["driver"]).Driver
        assert cfile["reduced"] == centry["reduced"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_ports_preset(entry):
    cfile = core.read_json(core.REPO / entry["file"])
    assert entry["file"].startswith("perfbench/configs/")
    system.port_config(cfile)  # raises on any size the port's preset does not hold


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(metric):
    reader = core.metric_reader(metric["name"])
    assert callable(reader.read) and reader.__doc__
    ends = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = ends[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        ends = [m["name"] for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in ends and len(ends) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_layers_are_named_in_perf_md():
    perf = (core.REPO / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]
