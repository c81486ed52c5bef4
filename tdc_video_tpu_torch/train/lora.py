"""LoRA as explicit delta parameters (port of tdc_video_tpu/train/lora.py).

LoRA lives in its own tree, keyed by the "/"-joined path of the weight it
adapts, as in JAX:

    lora = init_lora(params["lm"], rank, generator=g)      # A ~ N(0, .02), B = 0
    lm = graft_lora(params["lm"], lora, alpha, rank)       # y = xW + (xA)B at matmul time
    merged_lm = apply_lora(params["lm"], lora, alpha, rank)  # w + A @ B * alpha / r

Weights stacked on a leading layer axis ([L, in, out]) get stacked A [L, in,
r] and B [L, r, out].  The trainer does not call graft_lora: it grafts the
per-layer views of train/step.lora_view, which carry the gradients of the
stored A and B.

Divergence from JAX, deliberate: apply_lora raises on an int8 "w_q" target,
where JAX adds the float delta to the int8 values and ignores the scale.
On every valid input the two give the same result.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from .step import graft_at, tree_leaves_with_path, tree_map_with_path

Params = Any

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate", "up", "down")


def _is_target(names, targets) -> bool:
    # "w_q": LoRA over an int8 frozen base (TrainConfig.quantize_frozen);
    # w_q keeps the float weight's [.., in, out] layout, so A/B shapes match
    return names[-1] in ("w", "w_q") and any(n in targets for n in names)


def init_lora(
    params: Params,
    rank: int = 128,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype=torch.float32,
    generator: Optional[torch.Generator] = None,
) -> Params:
    """{path: {"a", "b"}} for every targeted weight leaf, on the leaf's
    device, in JAX's key order (sorted paths).  A is N(0, 0.02) from
    `generator` (same distribution as JAX, not the same bits), B zeros."""
    out = {}
    for names, leaf in tree_leaves_with_path(params, sort=True):
        if not _is_target(names, targets):
            continue
        a = torch.randn((*leaf.shape[:-1], rank), generator=generator, dtype=torch.float32,
                        device=leaf.device)
        b = torch.zeros((*leaf.shape[:-2], rank, leaf.shape[-1]), dtype=dtype, device=leaf.device)
        out["/".join(names)] = {"a": (a * 0.02).to(dtype), "b": b}
    return out


def _merge(params: Params, lora: Params, alpha: float, rank: int, inplace: bool) -> Params:
    scale = alpha / rank

    def merge(names, p):
        key = "/".join(names)
        if names[-1] == "w_q" and (key in lora or key[:-2] in lora):
            raise ValueError(f"apply_lora: {key} is int8; dequantize the tree before merging")
        ab = lora.get(key)
        if ab is None and names[-1] == "w":
            ab = lora.get(key + "_q")
        if ab is None:
            return p
        out = p if inplace else p.clone()
        # one layer of a stacked [L, in, out] leaf at a time (the f32 delta of
        # one layer is the only temporary); a 2-D leaf whole ([...])
        for i in range(p.shape[0]) if p.dim() == 3 else [...]:
            delta = ab["a"][i].float() @ ab["b"][i].float()
            out[i] += (delta * scale).to(p.dtype)
        return out

    return tree_map_with_path(merge, params)


def apply_lora(params: Params, lora: Params, alpha: float, rank: int) -> Params:
    """params with w + (A @ B) * alpha / rank at each adapted path (new
    tensors; the caller's tree is left as it is).  Adapters keyed ".../w_q"
    (initialised over an int8 base) merge into the ".../w" of the
    dequantized tree.  Raises on an int8 "w_q" target: merge into a
    dequantized tree (models/quant.dequantize_tree_int8)."""
    with torch.no_grad():
        return _merge(params, lora, alpha, rank, inplace=False)


def apply_lora_(params: Params, lora: Params, alpha: float, rank: int) -> Params:
    """apply_lora into the adapted weights of `params` themselves (a tree
    the caller owns, e.g. just dequantized), with no second copy."""
    with torch.no_grad():
        return _merge(params, lora, alpha, rank, inplace=True)


def graft_lora(params: Params, lora: Params, alpha: float, rank: int) -> Params:
    """A / (B * alpha / rank) grafted beside each targeted weight, so that
    layers.linear computes y = x @ W + (x @ A) @ B at matmul time.  Only
    the dicts on each adapted path are copied: the caller's tree and its
    weights are shared, not changed.  Gradients reach the caller's A and B
    through the grafted references (B's scale is a differentiable product)."""
    scale = alpha / rank
    out = params
    for key, ab in lora.items():
        out = graft_at(out, key.split("/"), ab["a"], ab["b"] * scale)
    return out


def merge_lora_params(params: Params, lora: Params, alpha: float, rank: int) -> Params:
    """Bake the deltas into a plain param tree (export / serving)."""
    return apply_lora(params, lora, alpha, rank)
