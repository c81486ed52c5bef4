"""Weight bridge: a parameter tree of numpy arrays in the JAX layout -> the
port's parameter tree of tensors.

The port keeps the JAX layout (weights [d_in, d_out], layers stacked on
axis 0), so this is a plain tree map with no transposes.  Callers hand over
the JAX tree as numpy (e.g. `jax.tree_util.tree_map(np.asarray, params)`);
nothing here imports JAX.  A JAX LoRA tree ({"layers/q_proj/w": {"a", "b"}},
train/lora.py) crosses the same way, keys unchanged, so that both packages
can train the same adapters (Trainer(..., lora=...)).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device


def params_from_numpy(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """Map every array leaf to a tensor on `device` (CUDA unless "cpu" is
    asked for).  Float leaves are cast to `dtype` when given; integer and
    bool leaves keep their type.  None leaves stay None (the Q-Former's
    layers without cross-attention)."""
    device = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":  # ml_dtypes arrays: torch cannot wrap them
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr, order="C")).to(device)  # copy: JAX buffers are read-only
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    return conv(tree)
