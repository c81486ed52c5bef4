"""Driver `train`: stage-3 audio-visual LoRA fine-tuning through
Trainer.train_step, one sample a micro-step, an optimizer step every
gradient_accumulation_steps micro-steps.

Set-up builds the trainer once (the frozen bf16 base the benchmark made from
the seed, float32 copies of the trainable modules, LoRA factors made from the
seed in the decoder family's `lora_spec`), makes the cell's pool of samples,
and drives that same trainer through its first optimizer steps, which warm
every shape up; their losses, the first step's clipped gradient (from
AdamW's first moment) and the trainable leaves' change are kept for the
reference.  The window goes on with the same trainer, through whole
optimizer steps.

Mix parameters: frames (a cycle of frame counts, each with as many seconds of
audio), text_tokens (a cycle), height, width, cut_min, cut_max,
total_steps (the schedule's length), setup_steps (optimizer steps in
set-up), reference_steps (steps the reference follows), trace_steps,
limits {loss_gap, grad_gap, change_gap} (cut_gap is logged: it has no
upper reading in this cell).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from perfbench import core, traffic, weights
from perfbench.drivers.answer import CUTS, Driver as AnswerDriver
from perfbench.reference import check as ref_check
from perfbench.reference import model as R
from perfbench.reference import train as RT
from perfbench.system import System

FROZEN = ("lm", "siglip", "dino", "beats")


class Driver(AnswerDriver):
    def setup(self):
        t = time.perf_counter()
        from tdc_video_tpu_torch.ops import build
        from tdc_video_tpu_torch.train.stages import stage3_audio_lora
        from tdc_video_tpu_torch.train.trainer import Trainer

        self.setup_parts["import_s"] = time.perf_counter() - t
        if self.device.type == "cuda":
            t = time.perf_counter()
            build.build_all()
            self.setup_parts["kernels_s"] = time.perf_counter() - t
        if self.system is None:
            self.system = System(self.cfile, self.seed, self.device)
        t = time.perf_counter()
        m = self.mix
        self.tcfg = dataclasses.replace(
            stage3_audio_lora(os.path.join(os.environ.get("TMPDIR", tempfile.gettempdir()), "perfbench")),
            report_to="none", **m.get("train_config", {}))
        model = self.system.model
        self.lora0 = weights.make(core.lm_family(model).lora_spec(model.lm, self.tcfg.lora_r),
                                  self.seed + 1, self.device, torch.float32)
        trainable = {k: _map(v, lambda x: x.detach().float().clone())
                     for k, v in self.system.params.items() if k not in FROZEN}
        params = {**{k: v for k, v in self.system.params.items() if k in FROZEN}, **trainable}
        lora = {k: {n: x.clone() for n, x in ab.items()} for k, ab in self.lora0.items()}
        self.setup_parts["weights_s"] = self.system.weights_s + time.perf_counter() - t
        t = time.perf_counter()
        self.trainer = Trainer(self.system.cfg, self.tcfg, params, total_steps=m["total_steps"],
                               device=self.device, lora=lora)
        self._hook_cuts()
        self.named = self._named_trainables()
        self.setup_parts["trainer_s"] = time.perf_counter() - t
        t = time.perf_counter()
        # every (frames, text) pair of the two cycles, and at least set-up's
        # micro-steps, so that those all run on different samples
        cyc = math.lcm(len(m["frames"]), len(m["text_tokens"]))
        n_pool = cyc * -(-m["setup_steps"] * self.tcfg.gradient_accumulation_steps // cyc)
        self.pool = [self.sample(i) for i in range(n_pool)]
        self.setup_parts["pool_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.first: Dict[str, object] = {"losses": [], "cuts": [], "grad": None, "change": {}}
        k = self.tcfg.gradient_accumulation_steps
        for j in range(m["setup_steps"] * k):
            CUTS.clear()
            loss = self.trainer.train_step(self.pool[j])
            self.first["losses"].append(float(loss))
            self.first["cuts"].append(CUTS[0].cpu().numpy())
            step = (j + 1) // k
            if (j + 1) % k == 0:
                if step == 1:
                    self.first["grad"] = self._first_grad_norms()
                self.first["change"][step] = self._change_norms()
        self.micro = m["setup_steps"] * k
        self.setup_parts["warmup_s"] = time.perf_counter() - t

    # -- the trainer's state ----------------------------------------------------

    def _named_trainables(self) -> Dict[str, torch.Tensor]:
        out = {f"lora/{k}/{n}": t for k, ab in self.trainer.lora.items() for n, t in ab.items()}
        for k in self.trainer._extra_keys:
            out.update({f"{k}/{n}" if n else k: t
                        for n, t in RT.named_leaves(self.trainer.params[k]) if t.requires_grad})
        return out

    def _initial(self, name: str) -> torch.Tensor:
        if name.startswith("lora/"):
            key, ab = name[5:].rsplit("/", 1)
            return self.lora0[key][ab]
        top, _, rest = name.partition("/")
        leaves = dict(RT.named_leaves(self.system.params[top]))
        return leaves[rest] if rest else self.system.params[top]

    def _first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's clipped first gradient, from AdamW's first moment
        after one step: m1 = (1 - b1) g."""
        b1 = self.trainer.tx.opt.param_groups[0]["betas"][0]
        st = self.trainer.tx.opt.state
        # a leaf the optimizer never stepped has no first moment: it got nothing
        norms = torch.stack([st[t]["exp_avg"].float().norm() / (1 - b1) if "exp_avg" in st.get(t, {})
                             else torch.zeros((), device=t.device) for t in self.named.values()])
        return dict(zip(self.named, norms.tolist()))

    def _change_norms(self) -> Dict[str, float]:
        with torch.no_grad():
            norms = torch.stack([(t.float() - self._initial(n).float()).norm()
                                 for n, t in self.named.items()])
        return dict(zip(self.named, norms.tolist()))

    # -- traffic --------------------------------------------------------------

    def sample(self, i: int) -> Dict[str, np.ndarray]:
        """Micro-step i's sample, in the trainer's input format (host arrays):
        frames and as many seconds of audio from the frame cycle, a
        conversation from the text cycle, pixels made on the device."""
        m = self.mix
        n = traffic.cycle(m["frames"], i)
        frames = traffic.video(self.seed, "train", i, n, m["height"], m["width"], m["cut_min"],
                               m["cut_max"])
        ids, labels, img = traffic.conversation(self.seed, "train", i, traffic.cycle(m["text_tokens"], i),
                                                self.tok)
        u8 = torch.from_numpy(frames).to(self.device)
        side = int(self.system.model.sva.image_token_len ** 0.5)
        valid, pool = R.token_layout(side, m["height"], m["width"],
                                     self.system.model.compression.context_token_num)
        batch = {"input_ids": ids[None], "labels": labels[None], "image_pos": np.array([img], np.int32),
                 "text_len": np.array([len(ids)], np.int32), "has_image": np.array([True]),
                 "siglip_px": R.preprocess(u8, self.system.model.siglip.image_size, "siglip")[None].cpu().numpy(),
                 "dino_px": R.preprocess(u8, self.system.model.dino.image_size, "dino")[None].cpu().numpy(),
                 "frame_mask": np.ones((1, n), bool),
                 "qformer_text_ids": np.zeros((1, 64), np.int32),
                 "qformer_text_mask": np.zeros((1, 64), bool),
                 "token_valid": valid[None], "query_pool": pool[None]}
        batch.update(traffic.audio_arrays(traffic.wav(self.seed, "train", i, n), n))
        return batch

    def rows(self, j: int, cuts) -> int:
        """Non-pad rows of micro-step j's spliced sequence: its text less the
        <image> slot and its visual tokens, within model_max_length."""
        b = self.pool[j % len(self.pool)]
        model = self.system.model
        c = model.compression
        chunks = R.chunks_of(list(np.asarray(cuts, bool)), c.chunk_size)
        static = int(b["token_valid"][0].sum()) + (50 if model.audio_input else 0)
        nv = R.visual_count(chunks, static, c.context_token_num, self.tcfg.max_visual_len)
        return min(int(b["text_len"][0]) - 1 + nv, self.tcfg.model_max_length)

    def _steps(self, count: int = None, seconds: float = None):
        """Micro-steps on the pool from the current one: `count` of them, or
        whole optimizer steps until `seconds` have passed."""
        k = self.tcfg.gradient_accumulation_steps
        recs, cuts = [], []
        t0 = time.perf_counter()
        while (count is not None and len(recs) < count) or (
                count is None and (time.perf_counter() - t0 < seconds or self.micro % k)):
            j = self.micro
            CUTS.clear()
            with torch.profiler.record_function("request.train_step"):
                try:
                    loss = self.trainer.train_step(self.pool[j % len(self.pool)])
                except (RuntimeError, ValueError) as e:
                    recs.append({"j": j, "error": repr(e)})
                    self.micro += 1
                    continue
            cuts.append(CUTS[0])
            recs.append({"j": j, "loss": loss})
            self.micro += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        for r, c in zip((r for r in recs if "loss" in r), cuts):
            r["loss"] = float(r["loss"])
            r["cuts"] = c.cpu().numpy()
            r["rows"] = self.rows(r["j"], r["cuts"])
            r["frames"] = len(r["cuts"])
            r["text"] = int(self.pool[r["j"] % len(self.pool)]["text_len"][0])
        return recs, elapsed

    def window(self, seconds: float):
        return self._steps(seconds=seconds)

    def trace_slice(self):
        return self._steps(count=self.mix["trace_steps"] * self.tcfg.gradient_accumulation_steps)[0]

    def end_to_end(self, records, window_s) -> Dict[str, float]:
        rows = sum(r.get("rows", 0) for r in records)
        core.log(f"train: {len(records)} micro-steps, {rows} non-pad rows in {window_s:.3f} s; "
                 f"losses {[round(r['loss'], 4) for r in records if 'loss' in r]}")
        return {"train_tokens_per_s": rows / window_s}

    def release(self):
        del self.trainer
        self.named = {}  # the trainer's leaves and their gradients
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference --------------------------------------------------------

    def reference(self, P: R.Prec = R.F32) -> Dict[str, object]:
        """The reference's own readings over the first reference_steps
        optimizer steps from the initial weights, on the same samples."""
        m, k = self.mix, self.tcfg.gradient_accumulation_steps
        model = self.system.model
        frozen = {n: v for n, v in self.system.params.items() if n in FROZEN}
        train = {n: _map(v, lambda x: x.detach().float().clone().requires_grad_(True))
                 for n, v in self.system.params.items() if n not in FROZEN}
        lora = {key.split("/", 1)[1].rsplit("/", 1)[0]: {n: x.clone().requires_grad_(True)
                                                         for n, x in ab.items()}
                for key, ab in self.lora0.items()}
        named = {}
        for key, ab in lora.items():
            for n, x in ab.items():
                named[f"lora/layers/{key}/w/{n}"] = x
        for top, tree in train.items():
            for n, x in RT.named_leaves(tree):
                named[f"{top}/{n}" if n else top] = x
        opt = RT.AdamW(list(named.items()), RT.cosine_schedule(self.tcfg.learning_rate, m["total_steps"],
                                                               self.tcfg.warmup_ratio),
                       self.tcfg.grad_clip)
        out = {"losses": [], "cut_gap": 0.0, "grad": None, "change": None}
        scale = self.tcfg.lora_alpha / self.tcfg.lora_r
        for j in range(m["reference_steps"] * k):
            b = {n: torch.as_tensor(np.asarray(v)).to(self.device) for n, v in self.pool[j].items()}
            with ref_check.exact_f32():
                loss, cgap = RT.sample_loss(model, frozen, train, lora, scale, b, self.first["cuts"][j],
                                            self.tcfg.model_max_length, self.tcfg.max_visual_len, P)
                (loss / k).backward()
            out["losses"].append(float(loss.detach()))
            out["cut_gap"] = max(out["cut_gap"], cgap)
            if (j + 1) % k == 0:
                opt.step()
                if opt.count == 1:
                    out["grad"] = {n: float(opt.m[n].norm()) / (1 - opt.b1) for n in named}
        with torch.no_grad():
            out["change"] = {n: float((x - self._initial(n).float()).norm()) for n, x in named.items()}
        return out

    def check(self, records) -> Dict[str, float]:
        """Loss of each micro-step (relative gap), the first step's clipped
        gradient and the change after reference_steps steps, each by its
        worst leaf (leaves whose reference gradient is zero or under a
        thousandth of the median nonzero leaf's are left out: they move by
        round-off alone), and the port's cuts."""
        ref = self.reference()
        return self.compare(ref)

    def compare(self, ref, port=None) -> Dict[str, float]:
        """The numbers `check` compares, of `port` (the trainer's readings
        by default; calibrate.py passes the control's) against `ref`."""
        steps = self.mix["reference_steps"]
        port = self.first if port is None else port
        n = len(ref["losses"])
        loss_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(port["losses"][:n], ref["losses"]))
        med = float(np.median([v for v in ref["grad"].values() if v > 0] or [0.0]))
        live = [x for x in ref["grad"] if ref["grad"][x] > 0 and ref["grad"][x] >= 1e-3 * med]
        core.log(f"reference losses {ref['losses']}, port {port['losses'][:n]}; {len(live)} of "
                 f"{len(ref['grad'])} leaves compared")
        got = {"loss_gap": loss_gap,
               "grad_gap": RT.worst_leaf_gap(port["grad"], ref["grad"], live),
               "change_gap": RT.worst_leaf_gap(port["change"][steps], ref["change"], live),
               "cut_gap": ref["cut_gap"]}
        return got


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def flops(model, rec) -> float:
    """Model FLOPs of one micro-step (perfbench/flops.py)."""
    from perfbench import flops as Fl

    return Fl.train_sample(model, rec["frames"], R.chunks_of(list(np.asarray(rec["cuts"], bool)),
                                                             model.compression.chunk_size),
                           rec["rows"])
