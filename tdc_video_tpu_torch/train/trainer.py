"""Trainer: freeze policy, per-module LR groups, AdamW with a warmup cosine
schedule, gradient accumulation, LoRA and QLoRA, checkpoints, the merged
export and metrics logging, on one device or over a mesh (port of
tdc_video_tpu/train/trainer.py).

What the JAX trainer does and this one matches: the freeze flags give a
trainable mask (`trainable_mask`); frozen leaves get no gradient (JAX's
stop_gradient; here requires_grad=False, so no graph is built through them);
the trainable leaves are clipped by their global norm, then updated by AdamW
per group (`lr_group` x decay or `_no_decay`), each group on its own
`make_schedule`; with gradient_accumulation_steps = k the optimizer updates
once every k calls of `train_step`, with the mean of the k micro-step
gradients, and its count and schedule advance once per update (optax
MultiSteps).  With `lora_enable` the LM is frozen and AdamW runs over the
LoRA adapters (train/lora.py) and the non-LM modules the freeze flags leave
trainable, on one schedule; `quantize_frozen="int8"` stores the frozen LM
(its head included, as JAX does) and fully frozen towers as weight-only
int8 under the adapters.  A checkpoint holds what JAX's Orbax state holds,
{"params", "step", "lora"}: no optimizer state, so a resumed run restarts
AdamW's moments and its schedule, as in JAX.

Divergences, each deliberate:

* accumulation: each micro-step adds grad(loss) / k into `.grad`, where
  MultiSteps keeps a separate running mean; the sum is the same mean, in
  another rounding order, and needs no second gradient-sized buffer;
* checkpoints are the port's own layout (`save`), not Orbax directories,
  which the port does not read;
* the trainer sets requires_grad on the caller's parameter tensors in place,
  and updates them in place; `restore_if_available` copies into them.

Over a mesh (`mesh=`, parallel/mesh.py: one process a device; JAX's
trainer always builds one over every device) each rank runs the step on its
shards, with the collectives explicit:

* the parameters are cut as JAX cuts them (parallel/sharding.tdc_param_spec
  with fsdp_size = the data axis): the LM tensor-parallel over `model`, its
  stacked layer axis over `data` (FSDP, where the axis divides the layer
  count), the other modules whole; quantize_frozen quantizes before the cut;
* LoRA adapters are whole over `model` (replicated A/B: each rank's partial
  gradient is summed over `model`) and split over `data` with their layers
  under FSDP (the layer's broadcast carries them);
* each batch is padded to a multiple of the data axis with loss-inert rows
  and each rank takes its contiguous share of the samples (batch_spec);
* the loss is the whole batch's (one mean over its valid positions, equal
  on every rank); after the last micro-step of an optimizer step every
  trainable leaf that a rank of `data` holds whole has its gradient summed
  over `data` (an FSDP layer's is summed at its holder by the broadcast's
  backward), the adapters' over `model`, and the other leaves whole over
  `model` take model rank 0's gradient (so that every replica stays
  bitwise equal); the clip's norm is the whole gradient's (GroupedAdamW);
* rank 0 alone logs and writes checkpoints, each gathered into the
  one-process layout, so that a checkpoint restores on any mesh (each rank
  cuts its shard of what it reads); export_merged returns whole tensors on
  rank 0 and None on the others.

A mesh of one rank runs the one-process code.
"""

from __future__ import annotations

import json
import math
import os
import queue
import shutil
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
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, warmup_collectives
from ..parallel.sharding import local_slice, shard_tree, tdc_param_spec
from ..utils.profiling import span
from . import lora as lora_lib
from .step import (
    GroupedAdamW,
    lora_view,
    set_trainable,
    split_lora,
    train_view,
    tree_leaves,
    tree_leaves_with_path,
    tree_map_with_path,
)

Params = Any

CKPT_FILE = "state.safetensors"  # in <output_dir>/checkpoints/<step>/


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

    # LoRA (stage 3); quantize_frozen="int8": the frozen base stored as
    # weight-only int8 under the adapters (QLoRA), LoRA only
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


def build_optimizer(params: Params, tcfg: TrainConfig, total_steps: int, mesh=None,
                    split_axes=None):
    """Masked, grouped AdamW with the schedule; returns (optimizer, mask) and
    sets requires_grad on `params` from the mask.  mesh, split_axes: as
    GroupedAdamW's."""
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
    return GroupedAdamW(groups, tcfg.grad_clip, mesh=mesh, split_axes=split_axes), mask


def lora_spec(lora: Params, fsdp_size: int = 0) -> Params:
    """Spec tree of a LoRA tree over a mesh: whole over `model`, and a stacked
    layer adapter split over `data` where its base layer is (lm_param_spec's
    rule: fsdp_size > 0 dividing the layer count)."""
    def spec(key, t):
        split = key.startswith("layers/") and fsdp_size > 0 and t.shape[0] % fsdp_size == 0
        return (DATA_AXIS,) if split else ()

    return {k: {n: spec(k, t) for n, t in ab.items()} for k, ab in lora.items()}


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
        lora: Optional[Params] = None,
    ):
        """`lora_key`: a torch.Generator (or an int seed) for init_lora's A,
        default tcfg.seed; `lora`: a given adapter tree ({key: {a, b}}, e.g.
        a JAX tree through convert/from_numpy) instead of a fresh one.

        mesh: a parallel/mesh.Mesh over every rank of the process group, each
        rank constructing its Trainer with the same whole `params` on its
        device (the mesh's) and the same seed; each keeps its shard (module
        docstring).  A mesh of one rank is the one-process trainer."""
        if not tcfg.lora_enable and (lora is not None or lora_key is not None):
            raise ValueError("a LoRA tree or key was given without lora_enable")
        self.cfg = cfg
        self.tcfg = tcfg
        self.total_steps = total_steps
        if mesh is not None:
            device = mesh.device
            if mesh.size() == 1:
                mesh = None
        self.mesh = mesh
        self.device = resolve_device(device)
        self.n_data = 1 if mesh is None else mesh.size(DATA_AXIS)
        self.rank = 0
        if mesh is not None:
            import torch.distributed as dist

            warmup_collectives(mesh)
            self.rank = dist.get_rank()
        want = self.device
        if any(t.device.type != want.type or (want.index is not None and t.device != want)
               for t in tree_leaves(params)):
            raise ValueError(f"params must be on {want}")

        self.lora = None
        if tcfg.lora_enable:
            if lora is None:
                gen = lora_key
                if not isinstance(gen, torch.Generator):
                    seed = tcfg.seed if lora_key is None else int(lora_key)
                    gen = torch.Generator(device=self.device).manual_seed(seed)
                lora = lora_lib.init_lora(params["lm"], tcfg.lora_r, generator=gen)
            self.lora = {k: {n: t.to(self.device, torch.float32) for n, t in ab.items()}
                         for k, ab in lora.items()}

        if tcfg.quantize_frozen is not None:
            if tcfg.quantize_frozen != "int8":
                raise ValueError(f"quantize_frozen: {tcfg.quantize_frozen!r}")
            if not tcfg.lora_enable:
                # the frozen-base recipe is LoRA-only (QLoRA)
                raise ValueError("quantize_frozen requires lora_enable")
            params = self._quantize_frozen(params)
        self._spec = self._lora_spec = None
        self._axes: Dict[int, tuple] = {}
        if mesh is not None:  # after quantizing: w_q splits as its float weight would
            self._spec = tdc_param_spec(params, fsdp_size=self.n_data)
            params = shard_tree(params, self._spec, mesh)
            if self.lora is not None:
                self._lora_spec = lora_spec(self.lora, self.n_data)
                self.lora = shard_tree(self.lora, self._lora_spec, mesh)
        self.params = params
        split = None
        if mesh is not None:
            for _, t, spec in self._named():
                self._axes[id(t)] = tuple(a for a in spec if a is not None and mesh.size(a) > 1)
            split = lambda t: self._axes[id(t)]  # noqa: E731
        self.tx, self.mask = (build_optimizer(params, tcfg, total_steps, mesh, split)
                              if self.lora is None else self._lora_optimizer(total_steps, split))
        self._view = train_view(params)
        self._lora_split = None if self.lora is None else split_lora(self.lora)
        self.step = 0
        self._micro = 0  # micro-steps since the last update (MultiSteps' count)
        self._metrics_fh = None
        self._tb = None
        self._writer = None

    def _quantize_frozen(self, params: Params) -> Params:
        """The LM (embedding excepted; the head included, as in JAX) and the
        fully frozen towers -> weight-only int8; BEATs stays float.  The
        caller's tree is left as it is."""
        from ..models.quant import quantize_lm_int8, quantize_tree_int8

        mask0 = trainable_mask(params, self.tcfg)
        out = dict(params)
        with torch.no_grad():
            out["lm"] = quantize_lm_int8(params["lm"])
            for mod in ("siglip", "dino"):
                if mod in out and not any(tree_leaves(mask0[mod], bool)):
                    out[mod] = quantize_tree_int8(params[mod])
        return out

    # -- LoRA: optimize (lora, non-LM trainables) -------------------------------

    def _lora_optimizer(self, total_steps: int, split_axes=None):
        """AdamW over {lora, extra}: the adapters, and the leaves of the non-LM
        modules the freeze flags leave trainable (unfreeze_mm_compressor=False
        keeps the compressor frozen here too); labels "wd"/"nd" by _no_decay
        of the path under "lora" / "extra" (B, named "b", takes no decay, as
        in JAX); one schedule at tcfg.learning_rate."""
        tcfg = self.tcfg
        mask = trainable_mask(self.params, tcfg)
        set_trainable(self.params, mask)
        self._extra_keys = tuple(k for k in self.params
                                 if k != "lm" and any(tree_leaves(mask[k], bool)))
        members: Dict[str, list] = {"wd": [], "nd": []}
        for key, ab in self.lora.items():
            for n, t in ab.items():
                t.requires_grad_(True)
                members["nd" if _no_decay(("lora", key, n)) else "wd"].append(t)
        for k in self._extra_keys:
            for (path, t), m in zip(tree_leaves_with_path(self.params[k], ("extra", k)),
                                    tree_leaves(mask[k], bool)):
                if m:
                    members["nd" if _no_decay(path) else "wd"].append(t)
        sched = make_schedule(tcfg, total_steps, tcfg.learning_rate)
        groups = {"wd": (members["wd"], tcfg.weight_decay, sched),
                  "nd": (members["nd"], 0.0, sched)}
        return GroupedAdamW(groups, tcfg.grad_clip, mesh=self.mesh, split_axes=split_axes), mask

    # -- the step ---------------------------------------------------------------

    def _loss_fn(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        attn_impl = self.tcfg.attn_impl
        if attn_impl is None:
            from ..models.attention import default_attn_impl

            attn_impl = default_attn_impl(self.device)
        params = self._view
        if self.lora is not None:
            # runtime LoRA: A and B beside each weight, applied at matmul time
            params = dict(params, lm=lora_view(params["lm"], self._lora_split,
                                               self.tcfg.lora_alpha, self.tcfg.lora_r))
        return tdc_loss(
            self.cfg, params, batch, max_len=self.tcfg.model_max_length,
            max_visual_len=self.tcfg.max_visual_len, attn_impl=attn_impl, remat=True,
            loss_chunk=self.tcfg.loss_chunk, mesh=self.mesh,
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

    def _share(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This rank's contiguous share of a padded batch's samples (JAX's
        batch_spec: every leaf's leading axis split over `data`)."""
        if self.n_data == 1:
            return batch
        b = batch["input_ids"].shape[0] // self.n_data
        d = self.mesh.coords[DATA_AXIS]
        return {k: v[d * b:(d + 1) * b] for k, v in batch.items()}

    def _sync_grads(self) -> None:
        """Over a mesh, once an optimizer step: every trainable leaf's
        gradient made the whole gradient of the rank's shard, the same on
        every rank that holds the shard (module docstring)."""
        lora = {id(t) for ab in (self.lora or {}).values() for t in ab.values()}
        mesh = self.mesh
        with torch.no_grad():  # each a no-op over an axis of one rank
            for t in self.tx.params:
                axes = self._axes[id(t)]
                if DATA_AXIS not in axes:
                    mesh.all_reduce(t.grad, DATA_AXIS)
                if id(t) in lora:
                    mesh.all_reduce(t.grad, MODEL_AXIS)
                elif MODEL_AXIS not in axes:
                    mesh.broadcast(t.grad, MODEL_AXIS, 0)

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
        every gradient_accumulation_steps-th call since the optimizer was
        made.  Returns the loss as a device tensor: reading it (float())
        waits for the device, so `fit` reads it only every logging_steps.
        Over a mesh every rank passes the same whole batch and gets the
        whole batch's loss."""
        with span("train.step", root=True, samples=batch["input_ids"].shape[0]):
            with span("train.batch"):
                b = self._to_device(self._share(self._pad_batch(batch)))
            with span("train.forward", device=True):
                loss = self._loss_fn(b)
            k = max(1, self.tcfg.gradient_accumulation_steps)
            with span("train.backward", device=True):
                (loss / k).backward()
            self.step += 1
            self._micro += 1
            if self._micro == k:
                if self.mesh is not None:
                    with span("train.sync_grads", device=True):
                        self._sync_grads()
                with span("train.optimizer", device=True):
                    self.tx.step()
                self._micro = 0
            return loss.detach()

    # -- logging ------------------------------------------------------------------

    def log(self, metrics: Dict[str, float]):
        """Rank 0 alone writes (every rank holds the same numbers)."""
        if self.rank != 0:
            return
        metrics = {"step": self.step, "time": time.time(), **metrics}
        if self.tcfg.report_to == "tensorboard":
            if self._tb is None:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError as e:
                    raise ImportError("report_to='tensorboard' needs torch.utils.tensorboard "
                                      "(the tensorboard package); use --report_to jsonl") from e
                self._tb = SummaryWriter(os.path.join(self.tcfg.output_dir, "tensorboard_logs"))
            for k, v in metrics.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, float(v), self.step)
            self._tb.flush()
        elif self.tcfg.report_to == "jsonl":
            if self._metrics_fh is None:
                os.makedirs(self.tcfg.output_dir, exist_ok=True)
                self._metrics_fh = open(os.path.join(self.tcfg.output_dir, "metrics.jsonl"), "a")
            self._metrics_fh.write(json.dumps(metrics, default=float) + "\n")
            self._metrics_fh.flush()

    def close(self) -> None:
        """Finish a pending checkpoint write and close the metric sinks."""
        self._join_write()
        if self._metrics_fh is not None:
            self._metrics_fh.close()
            self._metrics_fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    # -- checkpoints ----------------------------------------------------------------

    def _ckpt_root(self) -> str:
        return os.path.join(os.path.abspath(self.tcfg.output_dir), "checkpoints")

    def _saved_steps(self) -> list:
        root = self._ckpt_root()
        if not os.path.isdir(root):
            return []
        return sorted(int(d) for d in os.listdir(root)
                      if d.isdigit() and os.path.exists(os.path.join(root, d, CKPT_FILE)))

    def _named(self):
        """[(name, leaf, spec)] of the checkpointed leaves: "params/<path>",
        "lora/<key>/a|b"; spec () without a mesh."""
        out = [("params/" + "/".join(path), t, _spec_at(self._spec, path))
               for path, t in tree_leaves_with_path(self.params)]
        for key, ab in (self.lora or {}).items():
            for n, t in ab.items():
                spec = () if self._lora_spec is None else self._lora_spec[key][n]
                out.append((f"lora/{key}/{n}", t, spec))
        return out

    def _state(self) -> Dict[str, torch.Tensor]:
        """The checkpointed leaves by name (this rank's shards)."""
        return {name: t for name, t, _ in self._named()}

    def _whole(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole leaf of which t is this rank's shard (a gather over each
        axis it is split over: collective, every rank calls it); t itself
        without a mesh."""
        with torch.no_grad():
            for dim, axis in enumerate(spec):
                if axis is not None and self.mesh.size(axis) > 1:
                    t = self.mesh.all_gather(t, axis, dim)
        return t

    def save(self, wait: bool = True):
        """Checkpoint {"params", "step", "lora"} as
        <output_dir>/checkpoints/<step>/state.safetensors, every leaf in its
        own dtype (f32, bf16, int8) bit for bit, keeping the newest
        save_total_limit steps.  A step at or below the newest saved one is
        not saved again (Orbax's rule).  wait=False copies every leaf to the
        host before returning (the next steps may update them) and writes on
        a thread, through a temporary directory renamed into place; the next
        save, restore or close waits for it.  tune_mm_mlp_adapter also
        writes <output_dir>/mm_projector-<step>.safetensors.  Orbax
        directories (the JAX package's) are not read or written.  Over a
        mesh every rank calls it: the leaves are gathered whole and rank 0
        writes them (the one-process layout)."""
        from ..convert.to_hf import export_mm_adapter, save_safetensors

        self._join_write()
        saved = self._saved_steps() if self.rank == 0 else []
        skip = bool(saved) and saved[-1] >= self.step
        if self.mesh is not None:  # rank 0's view of the directory decides for all
            flag = torch.tensor([int(skip)], device=self.device)
            skip = bool(self.mesh.all_reduce(flag, None, op="max").item())
        if skip:
            return
        state = {}  # gathered leaf by leaf over a mesh; rank 0 keeps the host copies
        for name, t, spec in self._named():
            whole = self._whole(t, spec)
            if self.rank == 0:
                state[name] = _to_host(whole)
        if self.rank != 0:
            return
        state["step"] = np.asarray(self.step, np.int64)
        adapter = export_mm_adapter(self.params) if self.tcfg.tune_mm_mlp_adapter else None
        root, step, keep = self._ckpt_root(), self.step, max(1, self.tcfg.save_total_limit)
        out_dir = self.tcfg.output_dir

        def write():
            final = os.path.join(root, str(step))
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            save_safetensors(state, os.path.join(tmp, CKPT_FILE))
            os.replace(tmp, final)
            for old in sorted(int(d) for d in os.listdir(root) if d.isdigit())[:-keep]:
                shutil.rmtree(os.path.join(root, str(old)), ignore_errors=True)
            if adapter is not None:
                path = os.path.join(out_dir, f"mm_projector-{step}.safetensors")
                save_safetensors(adapter, path + ".tmp")
                os.replace(path + ".tmp", path)

        if wait:
            write()
        else:
            self._writer = threading.Thread(target=write, daemon=True)
            self._writer.start()

    def _join_write(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def restore_if_available(self) -> bool:
        """Resume from the newest checkpoint under <output_dir>/checkpoints:
        every leaf copied in place (same names, shapes and dtypes, or
        ValueError), and the step.  The optimizer state is not restored (JAX
        saves none).  Over a mesh each rank reads the whole checkpoint and
        copies in its shard of every leaf (parallel/sharding.local_slice), so
        a checkpoint from any mesh, or from one device, restores on any."""
        from ..convert.from_hf import BF16, read_safetensors

        self._join_write()
        saved = self._saved_steps()
        if not saved:
            return False
        path = os.path.join(self._ckpt_root(), str(saved[-1]), CKPT_FILE)
        sd = read_safetensors(path)
        named = self._named()
        names = {name for name, _, _ in named}
        if set(sd) != names | {"step"}:
            raise ValueError(f"{path}: leaves differ from this trainer's: "
                             f"{sorted(set(sd) ^ (names | {'step'}))[:8]}")
        with torch.no_grad():
            for name, t, spec in named:
                a = sd[name]
                bf16 = a.dtype == BF16
                src = torch.from_numpy(np.array(a.view(np.int16) if bf16 else a))
                if bf16:
                    src = src.view(torch.bfloat16)
                if self.mesh is not None:
                    src = local_slice(src, spec, self.mesh.coords, self.mesh.shape)
                if src.dtype != t.dtype or tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"{path}: {name} is {src.dtype} {tuple(src.shape)}, "
                                     f"the trainer's {t.dtype} {tuple(t.shape)}")
                t.copy_(src)
        self.step = int(sd["step"])
        return True

    def export_merged(self) -> Params:
        """Final artifact: a plain param tree with the LoRA deltas baked in
        (the reference's merge_lora_weights.py).  Under quantize_frozen the
        int8 leaves are dequantized to cfg.param_dtype first, the base the
        adapters were trained against.  New tensors wherever a leaf changes;
        the trainer's tree is left as it is.  Over a mesh every rank calls
        it: the leaves are gathered whole, and rank 0 gets the tree (the
        other ranks None)."""
        params, lora = self.params, self.lora
        if self.mesh is not None:
            params = self._gathered(params, self._spec)
            lora = None if lora is None else self._gathered(lora, self._lora_spec)
            if self.rank != 0:
                return None
        if lora is None:
            return params
        from ..models.quant import dequantize_tree_int8

        out = dict(params)
        alpha, rank = self.tcfg.lora_alpha, self.tcfg.lora_r
        if self.tcfg.quantize_frozen is None:
            out["lm"] = lora_lib.merge_lora_params(out["lm"], lora, alpha, rank)
            return out
        with torch.no_grad():
            out = {k: dequantize_tree_int8(v, dtype=self.cfg.param_dtype) for k, v in out.items()}
        # the dequantized weights are this export's own: merge into them
        out["lm"] = lora_lib.apply_lora_(out["lm"], lora, alpha, rank)
        return out

    def _gathered(self, tree, spec):
        """The whole tree on rank 0 (None elsewhere), gathered leaf by leaf."""
        if isinstance(tree, dict):
            out = {k: self._gathered(v, spec[k]) for k, v in tree.items()}
        elif isinstance(tree, (list, tuple)):
            out = type(tree)(self._gathered(v, sp) for v, sp in zip(tree, spec))
        elif isinstance(tree, torch.Tensor):
            out = self._whole(tree, spec)
        else:
            out = tree
        return out if self.rank == 0 else None

    # -- loop -------------------------------------------------------------------

    def fit(self, batches: Iterator[Dict[str, np.ndarray]]):
        """Training loop with host/device overlap: a prefetch thread runs the
        input pipeline (the host work inside `batches`) while the device runs
        the current step, and the loss is read only at logging_steps.  Saves
        every save_steps (without waiting for the write) and once at the end
        (waiting), as JAX does."""
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
                    self.save(wait=False)  # the disk write overlaps the next steps
        finally:
            stop.set()
            while worker.is_alive():  # let a producer blocked on a full queue finish
                try:
                    q.get_nowait()
                except queue.Empty:
                    worker.join(timeout=0.1)
        self.save()


def _spec_at(spec, path) -> tuple:
    """The spec entry of the leaf at `path` (tree_leaves_with_path's names)
    in a parallel/sharding spec tree; () without one."""
    for name in path if spec is not None else ():
        spec = spec[name] if isinstance(spec, dict) else spec[int(name)]
    return () if spec is None else spec


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A leaf's bits on the host as numpy: bf16 under the safetensors
    reader's BF16 tag, other dtypes as themselves (a contiguous copy)."""
    from ..convert.from_hf import BF16

    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16)
    return t.contiguous().numpy()
