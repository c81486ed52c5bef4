"""The per-layer metrics that read the program's own spans
(perfbench/spans.py over tdc_video_tpu_torch.utils.profiling): a traced run
of each driver on the tiny model on the CPU reads every one of its cell's,
and a program without the recorder makes them read nothing."""

import json
import time

import pytest

from perfbench import core, run, spans

BENCH = core.manifest()


def _reads_spans(m):
    return "spans" in core.metric_reader(m["name"]).__dict__


def _new(cell):
    return {m["name"] for m in BENCH["per_layer"] if cell in m["workloads"] and _reads_spans(m)}


def _traced(work, cfile, mix, system):
    return run.run_cell(work, cfile, mix, 2**31 + 11, 0.5, True, "cpu", time.perf_counter(),
                        BENCH, system=system)


@pytest.mark.parametrize("kind", ["answer", "answer_many"])
def test_traced_serving_run_reads_the_span_metrics(kind, tiny, tiny_mix):
    cfg, system = tiny
    name = {"answer": "qa_long_video", "answer_many": "qa_open_answers"}[kind]
    res = _traced({"name": name, "chips": 1}, system.cfile, tiny_mix(kind), system)
    want = _new(name)
    assert len(want) == {"answer": 5, "answer_many": 3}[kind]
    assert want <= set(res["metrics"]), want - set(res["metrics"])
    if kind == "answer_many":
        m = res["metrics"]
        assert 0 < m["slot_occupancy_pct.decode"]["value"] <= 100
        # the tiny prompts share fewer rows than answer_many's threshold
        assert m["prefix_reuse_pct.decode"]["value"] == 0


def test_traced_training_run_reads_the_span_metrics(tiny_av):
    cfg, system = tiny_av
    mix = json.loads((core.HERE / "mixes" / "av_lora_sft.json").read_text())
    mix.update(frames=[16, 8], text_tokens=[300, 240], height=36, width=64, cut_min=3, cut_max=9,
               train_config={"model_max_length": 480, "max_visual_len": 128, "lora_r": 8,
                             "lora_alpha": 16})
    res = _traced({"name": "train_av_lora", "chips": 1}, system.cfile, mix, system)
    want = _new("train_av_lora")
    assert len(want) == 3 and want <= set(res["metrics"]), want - set(res["metrics"])


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    from tdc_video_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "collect")
    assert spans.recorded() is None
    for m in filter(_reads_spans, BENCH["per_layer"]):
        assert core.metric_reader(m["name"]).read(None) is None, m["name"]
