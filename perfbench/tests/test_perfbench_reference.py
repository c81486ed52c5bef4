"""The plain reference against the port's tiny model on the CPU, and whole
runs of each driver there: the result line's keys, `correct` on a sound
run, and `correct` false once the timed path is broken underneath."""

import json
import time

import pytest
import torch

from perfbench import core, run, traffic
from perfbench.reference import check as K
from perfbench.reference import model as R


@pytest.mark.parametrize("n_frames", [16, 32])
def test_reference_logits_match_the_port(tiny, n_frames):
    """Prefill logits of one request: the port (plain attention on the CPU,
    float32 model and compression) and the reference agree to float32
    rounding, the reference compressing along the port's judged cuts."""
    import tdc_video_tpu_torch.model as M
    from tdc_video_tpu_torch.eval.runner import TDCPredictor
    from tdc_video_tpu_torch.serving.generate import prefill_encoded

    cfg, system = tiny
    tok = traffic.QwenByteTokenizer()
    pred = TDCPredictor(cfg, system.params, tok, device_preprocess=True, device="cpu", attn_impl="xla")
    frames = traffic.video(5, "t", n_frames, n_frames, 36, 64, 3, 9)
    q = traffic.question(5, "t", n_frames, 3, 8, choices=4)
    cuts = []
    orig = M.segment_boundaries
    M.segment_boundaries = lambda *a, **k: cuts.append(orig(*a, **k)) or cuts[-1]
    try:
        gen = pred.prepare(frames, q, max_new_tokens=4)["gen"]
        gen.pop("max_new_tokens")
        logits, _ = prefill_encoded(cfg, system.params, **gen, max_new_tokens=4, attn_impl="xla")
    finally:
        M.segment_boundaries = orig
    ids, img = K.prompt_ids(tok, q)
    vis, gap, _, _ = K.visual_tokens(system.model, system.params, frames, cuts[0].numpy(), ids,
                                     R.F32, "cpu")
    assert gap == 0.0
    ref = K.logits_over(system.model, system.params,
                        R.spliced_prompt(system.model, system.params, ids, img, vis), [0])
    assert float((ref[0] - logits[0]).abs().max()) < 1e-4 * float(logits.abs().max())


def test_scene_cuts_and_their_gap():
    sims = torch.tensor([0.9, 0.2, 0.8, 0.3, 0.95, 0.1])
    starts = R.scene_cuts(sims, 7, 3)
    assert starts.tolist() == [True, False, True, False, True, False, True]
    assert R.cut_gap(sims, starts, 3) == 0.0
    moved = torch.tensor([True, True, False, False, True, False, True])  # cuts pair 0, not 1
    assert R.cut_gap(sims, moved, 3) == pytest.approx(0.9 - 0.2)
    assert R.chunks_of(starts.tolist(), 2) == [[0, 1], [2, 3], [4, 5], [6]]


def _run(kind, tiny, tiny_mix, trace=False, breakage=None, seed=2**31 + 3):
    cfg, system = tiny
    name = {"answer": "qa_long_video", "answer_many": "qa_open_answers"}[kind]
    work = {"name": name, "chips": 1}
    return run.run_cell(work, system.cfile, tiny_mix(kind), seed, 0.5, trace, "cpu",
                        time.perf_counter(), core.manifest(), system=system, breakage=breakage)


@pytest.mark.parametrize("kind", ["answer", "answer_many"])
def test_result_line_keys_and_a_sound_run(kind, tiny, tiny_mix):
    res = _run(kind, tiny, tiny_mix)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_traced_run_reads_per_layer_metrics(tiny, tiny_mix):
    res = _run("answer", tiny, tiny_mix, trace=True)
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert {"encode_ms_per_frame.answer", "prefill_ms.answer", "mfu.answer"} <= set(res["metrics"])


def _shift_tokens(monkeypatch):
    """Each decode step's logits rolled by one: every token after the first
    is altered where it is produced."""
    from tdc_video_tpu_torch.models import lm

    step = lm.decode_step

    def altered(*a, **k):
        logits, cache = step(*a, **k)
        return logits.roll(1, dims=-1), cache

    return lambda drv: monkeypatch.setattr(lm, "decode_step", altered)


@pytest.mark.parametrize("kind", ["answer", "answer_many"])
def test_an_altered_token_is_not_correct(kind, tiny, tiny_mix, monkeypatch):
    res = _run(kind, tiny, tiny_mix, breakage=_shift_tokens(monkeypatch))
    assert not res["correct"]
    assert res["checks"]["token_gap"]["value"] > res["checks"]["token_gap"]["limit"]


def test_control_reads_above_the_port(tiny):
    """At the tiny size the control (bf16, fp8 weights) parts from the
    float32 tokens on some seeds and the port's own greedy tokens never do;
    the limits come from the full-size readings (calibrate.py, the cuda
    test)."""
    from perfbench.system import System

    cfg, system = tiny
    tok = traffic.QwenByteTokenizer()
    ports, ctrls = [], []
    for seed in range(4):
        s = System(system.cfile, seed, "cpu", cfg=cfg)
        frames = traffic.video(seed, "t", 0, 32, 36, 64, 3, 9)
        q = traffic.question(seed, "t", 0, 3, 8, choices=4)
        ids, img = K.prompt_ids(tok, q)
        with torch.no_grad():
            vis, _, cuts, _ = K.visual_tokens(s.model, s.params, frames, None, ids, R.F32, "cpu")
            prompt = R.spliced_prompt(s.model, s.params, ids, img, vis)
            toks = []
            for _ in range(24):
                toks.append(int(K.logits_over(s.model, s.params, prompt, toks + [0])[-1].argmax()))
        ports.append(K.judge(s.model, s.params, tok, frames, q, toks, 24, cuts, "cpu")["token_gap"])
        ctrls.append(K.control(s.model, s.params, tok, frames, q, toks, 24, cuts, "cpu")["token_gap"])
    assert max(ports) == 0.0 and max(ctrls) > 0.05


# -- training ---------------------------------------------------------------


def _train_run(tiny_av, breakage=None):
    cfg, system = tiny_av
    mix = json.loads((core.HERE / "mixes" / "av_lora_sft.json").read_text())
    mix.update(frames=[16, 8], text_tokens=[300, 240], height=36, width=64, cut_min=3, cut_max=9,
               train_config={"model_max_length": 480, "max_visual_len": 128, "lora_r": 8,
                             "lora_alpha": 16})
    work = {"name": "train_av_lora", "chips": 1}
    return run.run_cell(work, system.cfile, mix, 2**31 + 9, 0.5, False, "cpu", time.perf_counter(),
                        core.manifest(), system=system, breakage=breakage)


def test_train_reference_follows_the_trainer(tiny_av):
    """The reference's losses, first clipped gradient and change after its
    steps match the trainer's to float32 rounding at the tiny size."""
    res = _train_run(tiny_av)
    assert res["correct"] and list(res)[-1] == "checks"
    assert "train_tokens_per_s" in res["metrics"]
    for k in ("loss_gap", "grad_gap", "change_gap"):
        assert res["checks"][k]["value"] < 1e-4, (k, res["checks"][k])


def test_train_state_left_unchanged_is_not_correct(tiny_av, monkeypatch):
    from tdc_video_tpu_torch.train import step as S

    def frozen_step(self):
        self.count += 1
        self.zero_grad()

    res = _train_run(tiny_av, lambda drv: monkeypatch.setattr(S.GroupedAdamW, "step", frozen_step))
    assert not res["correct"] and res["checks"]["change_gap"]["value"] >= 0.99


def test_train_half_the_rows_left_out_is_not_correct(tiny_av):
    from perfbench import calibrate

    undo = []
    try:
        res = _train_run(tiny_av, lambda drv: undo.append(calibrate.half_the_rows()))
    finally:
        for u in undo:
            u()
    assert not res["correct"]
    assert res["checks"]["loss_gap"]["value"] > res["checks"]["loss_gap"]["limit"]
