"""Non-SVA multimodal projectors (port of tdc_video_tpu/models/projector.py).

The live path builds the SVA projector (models/sva.py); this module gives
the reference's other `mm_projector_type` options
(tdc/multimodal_projector/builder.py:33-52): `identity`, `linear` and
`mlpNx_gelu` (N linears with tanh-approximate GELU between them, as JAX's
jax.nn.gelu(approximate=True)).
"""

from __future__ import annotations

import re
from typing import Any

import torch

from ..device import resolve_device
from .layers import gelu_tanh, init_linear, linear

Params = Any


def init_projector(projector_type: str, d_in: int, d_out: int, generator: torch.Generator,
                   device=None, dtype=torch.float32) -> Params:
    """{"type": projector_type, "layers": [linear params, ...]}; an unknown
    type raises ValueError."""
    device = resolve_device(device)
    if projector_type == "identity":
        return {"type": "identity", "layers": []}
    if projector_type == "linear":
        return {"type": "linear", "layers": [init_linear(generator, d_in, d_out, dtype, device)]}
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if m:
        depth = int(m.group(1))
        layers = [init_linear(generator, d_in, d_out, dtype, device)]
        layers += [init_linear(generator, d_out, d_out, dtype, device) for _ in range(depth - 1)]
        return {"type": projector_type, "layers": layers}
    raise ValueError(f"Unknown projector type: {projector_type}")


def projector_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    layers = params["layers"]
    if not layers:
        return x
    x = linear(layers[0], x)
    for p in layers[1:]:
        x = linear(p, gelu_tanh(x))
    return x
