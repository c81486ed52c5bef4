"""Training step and optimizer (port of tdc_video_tpu/train/step.py).

The JAX package's optimizer is an optax chain; here `GroupedAdamW` computes
the same update over leaf tensors in place:

    clip_by_global_norm(grad_clip)                 over every trainable leaf
    adamw(schedule, b1, b2, eps=1e-8, weight_decay) per labelled group

`count` is optax's step count, the number of updates applied so far; an
update uses the learning rate schedule(count), so a warmup from 0 makes the
first update a no-op, as in optax.  AdamW runs as torch.optim.AdamW (fused
on CUDA: one pass over the f32 states, no full-size temporaries), whose
decoupled decay p *= 1 - lr * wd is optax's update + wd * p scaled by -lr.

Gradients live in `.grad`, allocated once and zeroed in place after each
update.  `train_view` turns each trainable stacked `layers` subtree (LM,
towers) into per-layer leaf views whose `.grad` are views of the stacked
`.grad`, so each layer's backward adds into its slice in place.  Indexing
`stacked[i]` instead makes autograd pad each layer's gradient to the full
stacked size and sum all of them in a buffer before the leaf sees it: one
extra full-size buffer while an earlier micro-step's gradient is held
(11 GB for the 3B LM's layers in f32).

LoRA (train/lora.py) trains stacked A [L, in, r] and B [L, r, out] beside
the frozen LM.  `lora_view` grafts them per layer the same way: the stored
A and B are split into per-layer leaf views (their `.grad` views of the
stored `.grad`), and B's alpha / r scale is applied to each layer's view in
the step, so the product's gradient reaches the stored B.  JAX's graft
stores the scaled B, which is no leaf: split that product, and no gradient
reaches B; index it per layer, and each layer's backward pads its gradient
to the full stacked size.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..config import TDCConfig
from ..model import tdc_loss
from ..models.lm import layer_params

Params = Any
Schedule = Callable[[int], float]

STACKED = ("lm", "siglip", "dino")  # top-level modules whose "layers" are stacked on axis 0


def tree_leaves(tree, kind=torch.Tensor) -> list:
    """Leaves of type `kind` in dict/list order (a mask's bools, a label
    tree's strings); None and other values are skipped."""
    if isinstance(tree, kind):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v, kind)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, kind)]
    return []


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """fn(path names, leaf) over tensor leaves; None stays None.  List
    indices are names "0", "1", ..., as JAX's tree paths print them."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def tree_leaves_with_path(tree, path: Tuple[str, ...] = (), sort: bool = False) -> list:
    """[(path names, tensor)] in dict order, or with dict keys sorted (JAX's
    leaf order) when `sort`."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        keys = sorted(tree) if sort else list(tree)
        return [x for k in keys for x in tree_leaves_with_path(tree[k], path + (str(k),), sort)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_with_path(v, path + (str(i),), sort)]
    return []


class GroupedAdamW:
    """AdamW over labelled groups of leaf tensors after one global-norm clip
    over all of them: optax.chain(clip_by_global_norm(grad_clip),
    multi_transform({label: adamw(schedule, b1, b2, weight_decay=wd)})).
    groups: {label: (tensors, weight_decay, schedule)}.

    Over a mesh (parallel/mesh.py) each rank holds shards: `split_axes(t)`
    names the axes leaf t is split over (parallel/sharding's spec entries).
    The clip's norm is the whole gradient's: each leaf's squared norm is
    summed over the axes it is split over, and a leaf every rank holds
    whole (its gradient already summed over the mesh, train/trainer.py)
    counts once.
    AdamW is elementwise and runs on the shards as they are."""

    def __init__(self, groups: Dict[str, Tuple[Sequence[torch.Tensor], float, Schedule]],
                 grad_clip: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mesh=None, split_axes: Optional[Callable[[torch.Tensor], tuple]] = None):
        groups = {k: g for k, g in groups.items() if len(g[0])}
        self.params = [t for ts, _, _ in groups.values() for t in ts]
        if not self.params:
            raise ValueError("no trainable parameters")
        self.mesh = mesh
        self.split = [() if split_axes is None else tuple(split_axes(t)) for t in self.params]
        for t in self.params:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        self.labels = list(groups)
        self.schedules = [sched for _, _, sched in groups.values()]
        kind = {"fused": True} if self.params[0].device.type == "cuda" else {"foreach": False}
        self.opt = torch.optim.AdamW(
            [{"params": list(ts), "weight_decay": wd, "lr": 0.0} for ts, wd, _ in groups.values()],
            betas=(b1, b2), eps=eps, **kind,
        )
        self.grad_clip = grad_clip
        self.count = 0
        self.norm = None

    def zero_grad(self) -> None:
        torch._foreach_zero_([t.grad for t in self.params])

    @torch.no_grad()
    def step(self) -> None:
        """Clip, update with lr = schedule(count), count += 1, zero the grads.
        `norm` keeps the global norm the clip saw (a device scalar)."""
        grads = [t.grad for t in self.params]
        norm = self.norm = self._global_norm(grads)
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)
        for g, sched in zip(self.opt.param_groups, self.schedules):
            g["lr"] = float(sched(self.count))
        self.opt.step()
        self.count += 1
        self.zero_grad()

    def _global_norm(self, grads) -> torch.Tensor:
        norms = torch._foreach_norm(grads)
        if self.mesh is None:
            return torch.linalg.vector_norm(torch.stack(norms))
        from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

        # squared norms by the axes each leaf is split over, each sum over them
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for axes in sorted(set(self.split)):
            sq = sum(n.float() ** 2 for n, a in zip(norms, self.split) if a == axes)
            if DATA_AXIS in axes and MODEL_AXIS in axes:
                sq = self.mesh.all_reduce(sq, None)
            elif axes:
                sq = self.mesh.all_reduce(sq, axes[0])
            total = total + sq
        return torch.sqrt(total)


def split_layers(t: torch.Tensor) -> list:
    """A stacked leaf -> its per-layer slices.  A leaf that requires grad
    gives leaf views whose `.grad` are views into its `.grad` (allocated
    here if missing), so each layer's backward adds into its slice in place."""
    if not t.requires_grad:
        return [t[i] for i in range(t.shape[0])]
    if t.grad is None:
        t.grad = torch.zeros_like(t)
    views = []
    for i in range(t.shape[0]):
        v = t.detach()[i].requires_grad_()
        v.grad = t.grad[i]
        views.append(v)
    return views


def train_view(params: Params) -> Params:
    """The param tree the loss runs on: each stacked `layers` leaf that
    requires grad becomes a list of per-layer leaf views (`split_layers`);
    the rest is shared as is.  The optimizer keeps updating the stacked
    leaves in place, which the views see."""

    def per_layer(tree, n: int):
        if isinstance(tree, dict):
            parts = {k: per_layer(v, n) for k, v in tree.items()}
            return [{k: p[i] for k, p in parts.items()} for i in range(n)]
        return split_layers(tree)

    out = dict(params)
    for top in STACKED:
        if top in params and any(t.requires_grad for t in tree_leaves(params[top]["layers"])):
            n = tree_leaves(params[top]["layers"])[0].shape[0]
            out[top] = dict(params[top], layers=per_layer(params[top]["layers"], n))
    return out


def split_lora(lora: Params) -> Params:
    """{key: {"a", "b"}} -> the same with each adapter of a stacked LM layer
    weight (key "layers/...") split into per-layer leaf views
    (`split_layers`); other adapters stay whole.  Made once: the views stay
    valid while the optimizer updates A and B in place."""
    return {k: {n: split_layers(t) if k.startswith("layers/") else t for n, t in ab.items()}
            for k, ab in lora.items()}


def lora_view(lm: Params, lora_split: Params, alpha: float, rank: int) -> Params:
    """The LM tree the loss runs on under LoRA: train/lora.graft_lora over
    per-layer views.  `lm["layers"]` (stacked, frozen) becomes a list of
    per-layer trees, each with its A view and its B view times alpha / rank
    beside the adapted weight; the scale is a product made in this call, so
    call it once per step.  The caller's tree is not changed."""
    scale = alpha / rank
    layers = lm["layers"]
    n = tree_leaves(layers)[0].shape[0] if isinstance(layers, dict) else len(layers)
    per_layer = [layer_params(layers, i) for i in range(n)]
    out = lm
    for key, ab in lora_split.items():
        names = key.split("/")
        if names[0] == "layers":
            for i in range(n):
                per_layer[i] = graft_at(per_layer[i], names[1:], ab["a"][i], ab["b"][i] * scale)
        else:
            out = graft_at(out, names, ab["a"], ab["b"] * scale)
    return dict(out, layers=per_layer)


def graft_at(tree: Params, names, a, b) -> Params:
    """A copy of the dicts along `names` (less the weight's own name) with
    lora_a / lora_b set beside the weight; the rest of the tree is shared."""
    if len(names) == 1:
        return dict(tree, lora_a=a, lora_b=b)
    return dict(tree, **{names[0]: graft_at(tree[names[0]], names[1:], a, b)})


def set_trainable(params: Params, mask: Params) -> None:
    """requires_grad per the mask, in place on the caller's leaves (a frozen
    leaf builds no graph: JAX's stop_gradient on frozen leaves)."""
    for t, m in zip(tree_leaves(params), tree_leaves(mask, bool)):
        t.requires_grad_(m)


def make_optimizer(
    params: Params,
    learning_rate: float = 1e-5,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    grad_clip: float = 1.0,
    trainable_mask: Optional[Params] = None,
) -> GroupedAdamW:
    """AdamW with clipping and an optional per-leaf freeze mask.  Unlike the
    optax transform this binds to `params` (torch optimizers hold their
    leaves) and sets requires_grad from the mask."""
    if trainable_mask is not None:
        set_trainable(params, trainable_mask)
    leaves = [t for t in tree_leaves(params) if trainable_mask is None or t.requires_grad]
    for t in leaves:
        t.requires_grad_(True)
    return GroupedAdamW({"train": (leaves, weight_decay, lambda _: learning_rate)}, grad_clip,
                        b1=b1, b2=b2)


def make_train_step(
    cfg: TDCConfig,
    tx: GroupedAdamW,
    max_len: int = 4096,
    max_visual_len: int = 2048,
    attn_impl: Optional[str] = None,
    remat: bool = True,
) -> Callable:
    """Returns step(params, batch) -> loss: forward, backward and one update
    of `tx`, in place on params (the JAX step returns new params and optimizer
    state).  attn_impl=None resolves to the device default (the CUDA kernels
    with their backward on a CUDA device)."""

    def step(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        impl = attn_impl
        if impl is None:
            from ..models.attention import default_attn_impl

            impl = default_attn_impl(batch["input_ids"].device)
        loss = tdc_loss(cfg, train_view(params), batch, max_len=max_len,
                        max_visual_len=max_visual_len, attn_impl=impl, remat=remat)
        loss.backward()
        tx.step()
        return loss.detach()

    return step
