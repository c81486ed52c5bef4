"""Trainer: freeze policy, per-module LR groups, AdamW with a warmup cosine
schedule, gradient accumulation, metrics logging (port of
tdc_video_tpu/train/trainer.py, one device).

What the JAX trainer does and this one matches: the freeze flags give a
trainable mask (`trainable_mask`); frozen leaves get no gradient (JAX's
stop_gradient; here requires_grad=False, so no graph is built through them);
the trainable leaves are clipped by their global norm, then updated by AdamW
per group (`lr_group` x decay or `_no_decay`), each group on its own
`make_schedule`; with gradient_accumulation_steps = k the optimizer updates
once every k calls of `train_step`, with the mean of the k micro-step
gradients, and its count and schedule advance once per update (optax
MultiSteps).

Divergences, each deliberate:

* accumulation: each micro-step adds grad(loss) / k into `.grad`, where
  MultiSteps keeps a separate running mean; the sum is the same mean, in
  another rounding order, and needs no second gradient-sized buffer;
* LoRA and `quantize_frozen`, the device mesh and FSDP, Orbax
  `save`/`restore_if_available`, TensorBoard and `export_merged` are not
  ported: each raises NotImplementedError where the JAX trainer uses it, and
  `fit` ends without the final save;
* the trainer sets requires_grad on the caller's parameter tensors in place,
  and updates them in place.
"""

from __future__ import annotations

import json
import math
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..config import TDCConfig
from ..constants import IGNORE_INDEX
from ..device import resolve_device
from ..model import tdc_loss
from .step import GroupedAdamW, set_trainable, train_view, tree_leaves, tree_map_with_path

Params = Any


@dataclass(frozen=True)
class TrainConfig:
    """Stage knobs (names follow the reference flags, as in the JAX package)."""

    output_dir: str = "./checkpoints/out"
    learning_rate: float = 5e-6
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_scheduler_type: str = "cosine"
    num_train_epochs: int = 1
    per_device_train_batch_size: int = 1
    gradient_accumulation_steps: int = 2
    save_steps: int = 1000
    save_total_limit: int = 1
    logging_steps: int = 1
    max_steps: Optional[int] = None
    grad_clip: float = 1.0
    seed: int = 42
    prefetch_batches: int = 2

    # per-module LRs
    mm_projector_lr: Optional[float] = None
    mm_vision_sampler_lr: Optional[float] = None
    mm_vision_tower_lr: Optional[float] = None

    # freeze policy
    freeze_backbone: bool = False
    tune_mm_mlp_adapter: bool = False
    freeze_mm_mlp_adapter: bool = False
    unfreeze_mm_vision_tower: bool = False
    unfreeze_mm_compressor: bool = True
    unfreeze_audio_encoder: bool = False

    # LoRA (stage 3): not ported
    lora_enable: bool = False
    lora_r: int = 128
    lora_alpha: int = 256
    quantize_frozen: Optional[str] = None

    # shapes
    model_max_length: int = 8192
    max_train_frames: int = 64
    max_visual_len: int = 4096
    loss_chunk: Optional[int] = None

    group_by_modality_length: bool = True
    report_to: str = "jsonl"  # "jsonl" | "tensorboard" | "none"
    # None -> device default ("flash" on CUDA, "xla" elsewhere)
    attn_impl: Optional[str] = None


def trainable_mask(params: Params, tcfg: TrainConfig) -> Params:
    """True = leaf receives gradients (the reference requires_grad policy)."""

    def rule(names, _leaf) -> bool:
        top = names[0]
        if top in ("siglip", "dino"):
            return tcfg.unfreeze_mm_vision_tower
        if top == "beats":
            return tcfg.unfreeze_audio_encoder
        if top == "compressor":
            return tcfg.unfreeze_mm_compressor
        if top == "lm":
            return not (tcfg.freeze_backbone or tcfg.lora_enable or tcfg.tune_mm_mlp_adapter)
        if top == "sva":
            return not (tcfg.freeze_mm_mlp_adapter and "mm_projector" in names)
        return True  # image_newline, audio_proj, ...

    return tree_map_with_path(rule, params)


def lr_group(path_names, tcfg: TrainConfig) -> str:
    """Optimizer group label (mm_trainer.py:264-484 name-substring groups)."""
    joined = "/".join(path_names)
    if tcfg.mm_projector_lr is not None and "mm_projector" in joined:
        return "projector"
    if tcfg.mm_vision_sampler_lr is not None and (
        "samplers" in joined or "vision_query" in joined
    ):
        return "sampler"
    if tcfg.mm_vision_tower_lr is not None and path_names[0] in ("siglip", "dino"):
        return "tower"
    return "base"


def _no_decay(path_names) -> bool:
    """LayerNorm/bias excluded from weight decay (mm_trainer.py:261-262)."""
    last = path_names[-1]
    return last in ("b", "bias", "scale") or "norm" in "/".join(path_names).lower()


def make_schedule(tcfg: TrainConfig, total_steps: int, base_lr: float):
    """count -> learning rate, as optax computes it: "cosine" is
    warmup_cosine_decay_schedule(0, base_lr, warmup, max(total, warmup + 1))
    (lr = 0 at count 0), anything else HF "linear" (warmup, then linear decay
    to 0)."""
    warmup = max(1, int(total_steps * tcfg.warmup_ratio))
    if tcfg.lr_scheduler_type == "cosine":
        decay = max(total_steps, warmup + 1) - warmup

        def cosine(count: int) -> float:
            if count < warmup:
                return base_lr * count / warmup
            c = min(count - warmup, decay)
            return base_lr * 0.5 * (1 + math.cos(math.pi * c / decay))

        return cosine
    rest = max(total_steps - warmup, 1)

    def linear(count: int) -> float:
        if count < warmup:
            return base_lr * count / warmup
        return base_lr * (1 - min(count - warmup, rest) / rest)

    return linear


def opt_labels(params: Params, mask: Params, tcfg: TrainConfig) -> Params:
    """Per-leaf optimizer label: "frozen", or "<group>:wd" / "<group>:nd"."""
    flags = {}
    tree_map_with_path(lambda path, m: flags.__setitem__(path, m), mask)

    def label(path, _leaf) -> str:
        if not flags[path]:
            return "frozen"
        return f"{lr_group(path, tcfg)}:{'nd' if _no_decay(path) else 'wd'}"

    return tree_map_with_path(label, params)


def build_optimizer(params: Params, tcfg: TrainConfig, total_steps: int):
    """Masked, grouped AdamW with the schedule; returns (optimizer, mask) and
    sets requires_grad on `params` from the mask."""
    mask = trainable_mask(params, tcfg)
    set_trainable(params, mask)
    group_lrs = {
        "base": tcfg.learning_rate,
        "projector": tcfg.mm_projector_lr or tcfg.learning_rate,
        "sampler": tcfg.mm_vision_sampler_lr or tcfg.learning_rate,
        "tower": tcfg.mm_vision_tower_lr or tcfg.learning_rate,
    }
    labels = opt_labels(params, mask, tcfg)
    members: Dict[str, list] = {}
    for t, lab in zip(tree_leaves(params), tree_leaves(labels, str)):
        members.setdefault(lab, []).append(t)
    groups = {}
    for g, lr in group_lrs.items():
        for d, wd in (("wd", tcfg.weight_decay), ("nd", 0.0)):
            groups[f"{g}:{d}"] = (members.get(f"{g}:{d}", []), wd,
                                  make_schedule(tcfg, total_steps, lr))
    return GroupedAdamW(groups, tcfg.grad_clip), mask


class Trainer:
    def __init__(
        self,
        cfg: TDCConfig,
        tcfg: TrainConfig,
        params: Params,
        total_steps: int,
        mesh=None,
        lora_key=None,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError("device meshes and FSDP are not ported: one device")
        if tcfg.lora_enable or lora_key is not None:
            raise NotImplementedError("LoRA training is not ported")
        if tcfg.quantize_frozen is not None:
            raise NotImplementedError("quantize_frozen (int8 frozen base) is not ported")
        self.cfg = cfg
        self.tcfg = tcfg
        self.total_steps = total_steps
        self.device = resolve_device(device)
        self.n_data = 1
        self.params = params
        want = self.device
        if any(t.device.type != want.type or (want.index is not None and t.device != want)
               for t in tree_leaves(params)):
            raise ValueError(f"params must be on {want}")
        self.tx, self.mask = build_optimizer(params, tcfg, total_steps)
        self._view = train_view(params)
        self.step = 0
        self._metrics_fh = None

    # -- the step ---------------------------------------------------------------

    def _loss_fn(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        attn_impl = self.tcfg.attn_impl
        if attn_impl is None:
            from ..models.attention import default_attn_impl

            attn_impl = default_attn_impl(self.device)
        return tdc_loss(
            self.cfg, self._view, batch, max_len=self.tcfg.model_max_length,
            max_visual_len=self.tcfg.max_visual_len, attn_impl=attn_impl, remat=True,
            loss_chunk=self.tcfg.loss_chunk,
        )

    def _pad_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Pad the sample axis to a multiple of the data-parallel size with
        loss-inert rows (labels all IGNORE_INDEX, no frames).  One device:
        n_data is 1 and batches pass unchanged."""
        B = batch["input_ids"].shape[0]
        rem = (-B) % self.n_data
        if rem == 0:
            return batch
        out = {}
        for k, v in batch.items():
            pad = np.zeros((rem,) + v.shape[1:], v.dtype)
            if k == "input_ids":
                pad[:] = self.cfg.lm.pad_token_id
            elif k == "labels":
                pad[:] = IGNORE_INDEX
            elif k == "text_len":
                pad[:] = 2
            out[k] = np.concatenate([np.asarray(v), pad], axis=0)
        return out

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Pixels ship in the compute dtype (the towers cast on arrival)."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v)).to(self.device)
            if k.endswith("_px") and t.dtype == torch.float32:
                t = t.to(self.cfg.dtype)
            out[k] = t
        return out

    def train_step(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One micro-step: forward and backward, and an optimizer update on
        every gradient_accumulation_steps-th call.  Returns the loss as a
        device tensor: reading it (float()) waits for the device, so `fit`
        reads it only every logging_steps."""
        b = self._to_device(self._pad_batch(batch))
        loss = self._loss_fn(b)
        k = max(1, self.tcfg.gradient_accumulation_steps)
        (loss / k).backward()
        self.step += 1
        if self.step % k == 0:
            self.tx.step()
        return loss.detach()

    # -- logging / checkpointing ------------------------------------------------

    def log(self, metrics: Dict[str, float]):
        metrics = {"step": self.step, "time": time.time(), **metrics}
        if self.tcfg.report_to == "tensorboard":
            raise NotImplementedError("TensorBoard logging is not ported: use report_to='jsonl'")
        if self.tcfg.report_to == "jsonl":
            if self._metrics_fh is None:
                os.makedirs(self.tcfg.output_dir, exist_ok=True)
                self._metrics_fh = open(os.path.join(self.tcfg.output_dir, "metrics.jsonl"), "a")
            self._metrics_fh.write(json.dumps(metrics, default=float) + "\n")
            self._metrics_fh.flush()

    def close(self) -> None:
        if self._metrics_fh is not None:
            self._metrics_fh.close()
            self._metrics_fh = None

    def save(self, wait: bool = True):
        raise NotImplementedError("checkpoint save (Orbax in the JAX package) is not ported")

    def restore_if_available(self) -> bool:
        raise NotImplementedError("checkpoint restore (Orbax in the JAX package) is not ported")

    def export_merged(self) -> Params:
        raise NotImplementedError("export_merged (LoRA merge) is not ported")

    # -- loop -------------------------------------------------------------------

    def fit(self, batches: Iterator[Dict[str, np.ndarray]]):
        """Training loop with host/device overlap: a prefetch thread runs the
        input pipeline (the host work inside `batches`) while the device runs
        the current step, and the loss is read only at logging_steps.  Ends
        without the JAX trainer's final save (not ported)."""
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.tcfg.prefetch_batches))
        END = object()
        err: list = []
        stop = threading.Event()

        def producer():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(self._pad_batch(b))
            except BaseException as e:  # surfaced in the main thread
                err.append(e)
            finally:
                q.put(END)

        worker = threading.Thread(target=producer, daemon=True)
        worker.start()
        t0 = time.time()
        try:
            while True:
                batch = q.get()
                if batch is END:
                    if err:
                        raise err[0]
                    break
                if self.tcfg.max_steps and self.step >= self.tcfg.max_steps:
                    break
                loss = self.train_step(batch)
                if self.step % self.tcfg.logging_steps == 0:
                    self.log({"loss": float(loss),
                              "steps_per_s": self.step / max(time.time() - t0, 1e-9)})
                if self.step % self.tcfg.save_steps == 0:
                    self.save(wait=False)
        finally:
            stop.set()
            while worker.is_alive():  # let a producer blocked on a full queue finish
                try:
                    q.get_nowait()
                except queue.Empty:
                    worker.join(timeout=0.1)
