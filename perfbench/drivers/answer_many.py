"""Driver `answer_many`: one closed-loop client asking several open questions
about one new video at a time through TDCPredictor.answer_many: the towers
run once a video, each question is packed and admitted behind the shared
prefix into its own slot of the DecodeEngine, and the slots decode in
lockstep.

Mix parameters: those of `answer` (frames, height, width, cut_min, cut_max,
question_words, choices, max_new_tokens, trace_requests, check: groups the
reference judges whole, limits {token_gap}), and questions (a group's size)
and slots.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from perfbench import core, traffic
from perfbench.drivers.answer import CUTS, Driver as AnswerDriver
from perfbench.reference import check as ref_check


class Driver(AnswerDriver):
    def setup(self):
        self.build_port()
        t = time.perf_counter()
        self.request(0, "warmup")
        self.setup_parts["warmup_s"] = time.perf_counter() - t

    def inputs(self, i: int, stream: str):
        m = self.mix
        frames = traffic.video(self.seed, stream, i, traffic.cycle(m["frames"], i), m["height"],
                               m["width"], m["cut_min"], m["cut_max"])
        qs = [traffic.question(self.seed, stream, i * m["questions"] + j, *m["question_words"],
                               choices=m["choices"]) for j in range(m["questions"])]
        return frames, qs

    def request(self, i: int, stream: str = "window") -> dict:
        with torch.profiler.record_function("client.make_video"):
            frames, qs = self.inputs(i, stream)
        CUTS.clear()
        first: Dict[int, float] = {}
        t0 = time.perf_counter()

        def on_tokens(req, new):
            if req.uid not in first:
                first[req.uid] = time.perf_counter() - t0

        try:
            with torch.profiler.record_function("request.answer_many"):
                self.pred.answer_many(frames, qs, max_new_tokens=self.mix["max_new_tokens"],
                                      num_slots=self.mix["slots"], on_tokens=on_tokens,
                                      video_uid=f"{stream}:{i}")
        except (RuntimeError, ValueError) as e:
            return {"i": i, "error": repr(e), "latency_s": time.perf_counter() - t0}
        latency = time.perf_counter() - t0
        eng = next(reversed(self.pred._engine_cache.values()))
        return {"i": i, "stream": stream, "frames": len(frames), "latency_s": latency,
                "ttft_s": [first.get(j, float("inf")) for j in range(len(qs))],
                "tokens": [list(t) for t in self.pred.stats.last_many_ids],
                "chunk_s": sum(b - a for a, b, _ in eng.chunk_spans),
                "steps": len(eng.chunk_spans) * eng.chunk_tokens,
                "cuts": [c.cpu().numpy() for c in CUTS], "questions": qs,
                "hw": frames.shape[1:3]}

    def end_to_end(self, records, window_s) -> Dict[str, float]:
        ttft = [t for r in records for t in r.get("ttft_s", [float("inf")])]
        n_tok = sum(len(t) for r in records for t in r.get("tokens", []))
        core.log(f"groups {len(records)}, questions {len(ttft)}, tokens {n_tok}, window "
                 f"{window_s:.3f} s, group latencies {[round(r['latency_s'], 4) for r in records]}")
        return {"ttft_p95_s": core.p95(ttft), "output_tokens_per_s": n_tok / window_s}

    def sample(self, records) -> List[dict]:
        r = traffic.rng(self.seed, "check")
        pool = [x for x in records if not x.get("error")]
        idx = r.permutation(len(pool))[:self.mix["check"]]
        return [pool[int(k)] for k in sorted(idx)]

    def check(self, records) -> Dict[str, float]:
        worst = {"token_gap": 0.0, "cut_gap": 0.0}
        judged = 0
        for rec in self.sample(records):
            frames, qs = self.inputs(rec["i"], "window")
            encs = {}
            for j, q in enumerate(qs):
                kept = ref_check.resampled(self.system.model, ref_check.prompt_ids(self.tok, q)[0], frames)
                if len(kept) not in encs:
                    encs[len(kept)] = ref_check.encode(self.system.model, self.system.params, kept,
                                                       device=self.device)
                got = ref_check.judge(self.system.model, self.system.params, self.tok, frames, q,
                                      rec["tokens"][j], self.mix["max_new_tokens"], rec["cuts"][j],
                                      self.device, encoded=encs[len(kept)])
                core.log(f"judged group {rec['i']} question {j}: {got}")
                judged += got["tokens"]
                for k in worst:
                    worst[k] = max(worst[k], got[k])
            del encs
        if not judged:
            worst = {k: float("inf") for k in worst}
        return worst


def flops(model, rec) -> float:
    """Model FLOPs of one group: the towers once, each question's
    compression, the prefix every prompt shares (the template head, the
    visual tokens and the newline after them) prefilled once, each
    question's suffix over it and each decode step (perfbench/flops.py; the
    decoder's count from its family, perfbench/lm/)."""
    from perfbench import flops as Fl
    from perfbench.reference import model as R

    c, lc = model.compression, model.lm
    lm = core.lm_family(model)
    H, K = lc.hidden_size, c.context_token_num
    side = int(model.sva.image_token_len ** 0.5)
    valid, _ = R.token_layout(side, rec["hw"][0], rec["hw"][1], K)
    n_valid = int(valid.sum())
    f = Fl.vit(model.siglip, rec["frames"]) + Fl.vit(model.dino, rec["frames"])
    f += Fl.sva(model.sva, (model.siglip.hidden_size, model.dino.hidden_size), H, rec["frames"])
    prefix = None
    for q, cuts, toks in zip(rec["questions"], rec["cuts"], rec["tokens"]):
        ids, img = ref_check.prompt_ids(model.tokenizer, q)
        chunks = R.chunks_of(cuts, c.chunk_size)
        n_vis = R.visual_count(chunks, n_valid, K, ref_check.sizes(model, ids, rec["frames"])["max_visual"])
        f += len(chunks) * Fl.mm(K, H, model.qformer.hidden_size)
        f += (rec["frames"] - len(chunks)) * Fl.qformer_pair(model.qformer, K, n_valid, H)
        rows = len(ids) - 1 + n_vis
        if prefix is None:
            prefix = img + n_vis + 1
            f += lm.forward_flops(lc, prefix, logits_rows=0)
        f += lm.forward_flops(lc, rows - prefix, prefix)
        for i in range(1, len(toks)):
            f += lm.forward_flops(lc, 1, rows + i - 1)
    return f
