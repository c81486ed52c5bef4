"""Sharding specs for the TDC parameter, batch and KV-cache trees (port of
tdc_video_tpu/parallel/sharding.py).

A spec is, leaf by leaf, a tuple of axis names or None per leading dim (a
shorter tuple leaves the trailing dims whole), the same entries as
`tuple(PartitionSpec)` of JAX's rules:

* LM decoder: Megatron-style tensor parallelism over `model`: q/k/v and the
  MLP's gate and up split their output dim, o_proj and down their input dim
  (one sum over `model` after each, models/lm.py), and the embedding and
  the head split the vocabulary.  int8 weights (models/quant.py) follow
  their float rules: `w_q` is the port's column-major [in, out] tensor,
  split on the same logical dims, and `w_scale` follows the output dim (a
  row-parallel weight keeps it whole: it scales output channels, so each
  partial product may be scaled before the sum).
* FSDP (fsdp_size > 0): the stacked layer axis also splits over `data`
  when it divides.  The specs are JAX's; the LM in this package does not
  run such a tree yet (models/lm.lm_backbone raises).
* Towers, SVA, Q-Former, compressor and BEATs stay whole on every rank;
  their work splits over the frames on `data` (model.encode_frames).

`shard_tree` cuts this rank's contiguous slice of every leaf, a plain
tensor on the rank's device (no DTensor): each rank holds its shard and
the collectives are explicit.  JAX's `to_named` (specs to NamedShardings
for jit) has no counterpart: PyTorch has no NamedSharding.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

Params = Any
Spec = Tuple[Optional[str], ...]

_COL = {"q_proj", "k_proj", "v_proj", "gate", "up"}  # shard the output dim
_ROW = {"o_proj", "down"}  # shard the input dim


def _map(fn, tree, path=()):
    """fn(path, leaf) over a tree's leaves; None leaves stay None (JAX's
    empty subtrees)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def _map2(fn, tree, spec):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, spec[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, spec))
    return fn(tree, spec)


def lm_param_spec(params: Params, fsdp_size: int = 0) -> Params:
    """Spec tree for a models.lm param tree (stacked layers).  fsdp_size:
    the size of the `data` axis; the stacked layer axis splits over it when
    it divides, else stays whole."""

    def rule(names, leaf) -> Spec:
        in_layers = "layers" in names
        shard_layers = fsdp_size > 0 and in_layers and leaf.shape[0] % fsdp_size == 0
        layer_ax = (DATA_AXIS,) if shard_layers else (None,)

        def wrap(*rest):
            return (*layer_ax, *rest) if in_layers else tuple(rest)

        body = leaf.dim() - (1 if in_layers else 0)
        if "embedding" in names:  # [V, H]
            return (MODEL_AXIS, None)
        if "lm_head" in names and names[-1] in ("w", "w_q"):  # [H, V]
            return (None, MODEL_AXIS)
        if "lm_head" in names and names[-1] == "w_scale":  # [V]
            return (MODEL_AXIS,)
        if any(n in _COL for n in names):
            if names[-1] in ("w", "w_q") and body == 2:
                return wrap(None, MODEL_AXIS)
            if names[-1] in ("b", "w_scale") and body == 1:
                return wrap(MODEL_AXIS)
            return wrap(*([None] * body))
        if any(n in _ROW for n in names):
            if names[-1] in ("w", "w_q") and body == 2:
                return wrap(MODEL_AXIS, None)
            return wrap(*([None] * body))
        if "gate_up" in names and names[-1] == "w" and body == 2:
            return wrap(None, MODEL_AXIS)
        return wrap(*([None] * body))

    return _map(rule, params)


def replicated_spec(params: Params) -> Params:
    return _map(lambda _p, _x: (), params)


def tdc_param_spec(params: Params, fsdp_size: int = 0) -> Params:
    """Spec tree for the full model.init_tdc tree: TP for the LM, every other
    module whole (its frame work splits on `data` instead)."""
    return {k: lm_param_spec(v, fsdp_size) if k == "lm" else replicated_spec(v)
            for k, v in params.items()}


def batch_spec(batch: Params) -> Params:
    """Every leaf of a batch splits its leading (sample) axis over `data`."""
    return _map(lambda _p, x: (DATA_AXIS, *([None] * (x.dim() - 1))) if x.dim() >= 1 else (),
                batch)


def kv_cache_spec(cache: Params) -> Params:
    """Spec of a models.lm.init_kv_cache dict under TP: K/V (and their int8
    scales) split the KV-head axis over `model`, the axis the attention
    heads split on, so that decode reads and writes its shard with no
    collective; mask and lengths are whole."""
    spec = {
        "k": (None, None, None, MODEL_AXIS, None),
        "v": (None, None, None, MODEL_AXIS, None),
        "mask": (),
        "lengths": (),
    }
    if "k_scale" in cache:  # int8 KV: [L, B, S, KVH] per-token-per-head scales
        spec["k_scale"] = (None, None, None, MODEL_AXIS)
        spec["v_scale"] = (None, None, None, MODEL_AXIS)
    return spec


def local_slice(x: torch.Tensor, spec: Spec, coords: Dict[str, int],
                sizes: Dict[str, int]) -> torch.Tensor:
    """The contiguous block of x that the rank at `coords` holds (a view):
    each dim named by an axis is cut into sizes[axis] equal parts.  A dim
    the axis does not divide raises ValueError."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the leaf's {x.dim()} dims")
    index = []
    for d, axis in enumerate(spec):
        n = 1 if axis is None else sizes[axis]
        if x.shape[d] % n:
            raise ValueError(f"axis {axis!r} of size {n} does not divide dim {d} of a leaf of "
                             f"shape {tuple(x.shape)}")
        w = x.shape[d] // n
        i = 0 if axis is None else coords[axis]
        index.append(slice(i * w, (i + 1) * w))
    return x[tuple(index)]


def _owned(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A compact copy of a slice on `device`, keeping a column-major leaf
    (the int8 `w_q` of models/quant.py) column-major in its last two dims."""
    if x.dim() >= 2 and x.stride(-2) == 1 and x.shape[-1] > 1 and x.shape[-2] > 1:
        return x.transpose(-1, -2).to(device).contiguous().transpose(-1, -2)
    return x.to(device).contiguous()


def shard_tree(tree: Params, spec: Params, mesh: Mesh) -> Params:
    """This rank's shard of every leaf (local_slice at the mesh's coords), on
    the mesh's device.  A leaf that is not cut and already lies there is
    kept as it is (no copy)."""

    def one(x, s):
        if not isinstance(x, torch.Tensor):
            return x
        part = local_slice(x, s, mesh.coords, mesh.shape)
        if part.shape == x.shape and x.device == mesh.device:
            return x
        return _owned(part, mesh.device)

    return _map2(one, tree, spec)
