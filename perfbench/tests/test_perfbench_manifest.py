"""BENCHMARK.json and the files it names: the contract's keys and names, and
every configuration, mix, driver and per-layer metric found by name."""

import copy
import dataclasses
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


@pytest.mark.parametrize("experts, stated, named", [
    (0, {}, None),
    (8, {}, "lm.num_experts: not in the file, port 8 (default 0)"),
    (0, {"num_layers": 27}, "lm.num_layers: file 27, port 28"),
], ids=["new_field_at_its_default", "new_field_off_its_default", "stated_key_differs"])
def test_preset_check_with_a_field_the_file_leaves_out(monkeypatch, experts, stated, named):
    """The port's LMConfig as it would be with a field gained since the
    configuration files were written (num_experts, default 0)."""
    from tdc_video_tpu_torch import config as C

    @dataclasses.dataclass(frozen=True)
    class LMWithExperts(C.LMConfig):
        num_experts: int = 0

    preset = C.tdc_qwen2_7b

    def gained(audio=False):
        cfg = preset(audio)
        lm = {f.name: getattr(cfg.lm, f.name) for f in dataclasses.fields(C.LMConfig)}
        return dataclasses.replace(cfg, lm=LMWithExperts(**lm, num_experts=experts))

    monkeypatch.setattr(C, "tdc_qwen2_7b", gained)
    cfile = copy.deepcopy(core.read_json(core.HERE / "configs" / "tdc_qwen2_7b.json"))
    cfile["model"]["lm"].update(stated)
    if named is None:
        assert system.port_config(cfile).lm.num_experts == 0
    else:
        with pytest.raises(ValueError, match=re.escape(named)):
            system.port_config(cfile)


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
