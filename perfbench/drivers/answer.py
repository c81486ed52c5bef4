"""Driver `answer`: one closed-loop client asking one question about one new
video at a time through TDCPredictor.answer (towers, compression, prefill,
greedy decode), on the device preprocessing path.

Mix parameters: frames (a cycle of frame counts), height, width, cut_min and
cut_max (scene lengths), question_words [min, max], choices,
max_new_tokens, trace_requests, check (requests the reference judges, one of
each frame count, drawn from the seed), limits {token_gap, cut_gap}.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from perfbench import core, traffic
from perfbench.reference import check as ref_check
from perfbench.reference import model as R
from perfbench.system import System

# the port's scene-cut decisions of the request in flight (_hook_cuts)
CUTS: List[torch.Tensor] = []


class Driver:
    def __init__(self, workload, cfile, mix, seed, device, system=None):
        self.workload, self.cfile, self.mix, self.seed = workload, cfile, mix, int(seed)
        self.device = torch.device(device)
        self.system = system
        self.setup_parts: Dict[str, float] = {}

    @property
    def tok(self):
        """The configuration's tokenizer: the one System holds beside the
        sizes, which the `flops` counts read too."""
        return self.system.model.tokenizer

    # -- set-up ---------------------------------------------------------------

    def _hook_cuts(self):
        """Record each scene-cut decision the port makes (its segment starts),
        so that the reference can judge them; the port exposes no such span.
        One wrapper a process, appending to the list every driver shares."""
        import tdc_video_tpu_torch.model as M

        if getattr(M.segment_boundaries, "perfbench_recorded", False):
            return
        orig = M.segment_boundaries

        def recorded(*a, **k):
            b = orig(*a, **k)
            CUTS.append(b)
            return b

        recorded.perfbench_recorded = True
        M.segment_boundaries = recorded

    def build_port(self):
        t = time.perf_counter()
        from tdc_video_tpu_torch.eval.runner import TDCPredictor
        from tdc_video_tpu_torch.ops import build

        self.setup_parts["import_s"] = time.perf_counter() - t
        if self.device.type == "cuda":
            t = time.perf_counter()
            build.build_all()
            self.setup_parts["kernels_s"] = time.perf_counter() - t
        if self.system is None:
            self.system = System(self.cfile, self.seed, self.device)
        self.setup_parts["weights_s"] = self.system.weights_s
        self.pred = TDCPredictor(self.system.cfg, self.system.params, self.tok, bert_tokenizer=None,
                                 max_new_tokens=self.mix["max_new_tokens"], device_preprocess=True,
                                 device=self.device,
                                 attn_impl="flash" if self.device.type == "cuda" else "xla")
        self._hook_cuts()

    def setup(self):
        self.build_port()
        t = time.perf_counter()
        for i in range(len(self.mix["frames"])):
            self.request(i, "warmup")
        self.setup_parts["warmup_s"] = time.perf_counter() - t

    # -- traffic --------------------------------------------------------------

    def inputs(self, i: int, stream: str):
        m = self.mix
        n = traffic.cycle(m["frames"], i)
        frames = traffic.video(self.seed, stream, i, n, m["height"], m["width"], m["cut_min"],
                               m["cut_max"])
        q = traffic.question(self.seed, stream, i, *m["question_words"], choices=m["choices"])
        return frames, q

    def request(self, i: int, stream: str = "window") -> dict:
        with torch.profiler.record_function("client.make_video"):
            frames, q = self.inputs(i, stream)
        CUTS.clear()
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("request.answer"):
                self.pred.answer(frames, q, max_new_tokens=self.mix["max_new_tokens"])
        except (RuntimeError, ValueError) as e:
            return {"i": i, "error": repr(e), "latency_s": time.perf_counter() - t0}
        latency = time.perf_counter() - t0
        st = self.pred.stats
        return {"i": i, "stream": stream, "frames": len(frames), "latency_s": latency,
                "encode_s": st.encode_s, "prefill_s": st.prefill_s, "decode_s": st.decode_s,
                "decode_steps": st.decode_steps, "tokens": list(st.last_ids),
                "cuts": [c.cpu().numpy() for c in CUTS], "question": q,
                "hw": frames.shape[1:3]}

    def window(self, seconds: float):
        recs, i = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            recs.append(self.request(i))
            i += 1
        return recs, time.perf_counter() - t0

    def trace_slice(self):
        return [self.request(i, "trace") for i in range(self.mix["trace_requests"])]

    # -- results --------------------------------------------------------------

    def end_to_end(self, records, window_s) -> Dict[str, float]:
        lat = [r["latency_s"] for r in records]
        core.log(f"answer latencies: n={len(lat)} by frames "
                 + str({n: [round(r['latency_s'], 4) for r in records if r.get('frames') == n]
                        for n in self.mix["frames"]}))
        return {"answer_p95_s": core.p95(lat)}

    def release(self):
        del self.pred
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, records) -> List[dict]:
        """One finished request of each frame count, drawn from the seed."""
        r = traffic.rng(self.seed, "check")
        out = []
        for n in self.mix["frames"][:self.mix["check"]]:
            pool = [x for x in records if not x.get("error") and x["frames"] == n]
            if pool:
                out.append(pool[int(r.integers(len(pool)))])
        return out

    def check(self, records) -> Dict[str, float]:
        worst = {"token_gap": 0.0, "cut_gap": 0.0}
        judged = 0
        for rec in self.sample(records):
            frames, q = self.inputs(rec["i"], "window")
            got = ref_check.judge(self.system.model, self.system.params, self.tok, frames, q,
                                  rec["tokens"], self.mix["max_new_tokens"], rec["cuts"][0],
                                  self.device)
            core.log(f"judged request {rec['i']} ({rec['frames']} frames): {got}")
            judged += got["tokens"]
            for k in worst:
                worst[k] = max(worst[k], got[k])
        if not judged:
            worst = {k: float("inf") for k in worst}
        return worst


def flops(model, rec) -> float:
    """Model FLOPs of one answered request (perfbench/flops.py)."""
    from perfbench import flops as Fl

    c = model.compression
    chunks = R.chunks_of(rec["cuts"][0], c.chunk_size)
    side = int(model.sva.image_token_len ** 0.5)
    valid, _ = R.token_layout(side, rec["hw"][0], rec["hw"][1], c.context_token_num)
    ids, _ = ref_check.prompt_ids(model.tokenizer, rec["question"])
    n_vis = R.visual_count(chunks, int(valid.sum()), c.context_token_num,
                           ref_check.sizes(model, ids, rec["frames"])["max_visual"])
    rows = len(ids) - 1 + n_vis
    return Fl.answer(model, rec["frames"], len(chunks), int(valid.sum()), rows, len(rec["tokens"]))
