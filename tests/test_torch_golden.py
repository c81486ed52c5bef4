"""The port's converters and forwards replayed on the golden fixtures
(tests/golden/*.npz: HF reference state dicts, inputs and activations),
at the JAX golden suite's tolerances (2e-4 to 3e-4, tests/test_golden.py),
the audio-on compression emission (T=64) among them."""

import json
import os

import numpy as np
import pytest
import torch

from tdc_video_tpu_torch.compress import tdc as tdc_mod
from tdc_video_tpu_torch.config import LMConfig, QFormerConfig, ViTConfig, tdc_tiny
from tdc_video_tpu_torch.convert import from_hf
from tdc_video_tpu_torch.convert.from_numpy import params_from_numpy
from tdc_video_tpu_torch.models import lm as lm_mod
from tdc_video_tpu_torch.models import qformer as qf
from tdc_video_tpu_torch.models.vit import vit_forward
from torch_parity import close, t

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    z = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd/")}
    ins = {k[3:]: z[k] for k in z.files if k.startswith("in/")}
    outs = {k[4:]: z[k] for k in z.files if k.startswith("out/")}
    return sd, ins, outs, json.loads(bytes(z["meta"]).decode())


def _cfg(cls, meta):
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in meta["cfg"].items()})


@pytest.mark.parametrize("name,convert,atol", [("siglip", from_hf.convert_siglip, 2e-4),
                                               ("dinov2", from_hf.convert_dinov2, 3e-4)])
def test_golden_tower(name, convert, atol):
    sd, ins, outs, meta = _load(name)
    cfg = _cfg(ViTConfig, meta)
    params = params_from_numpy(convert(sd, cfg), device="cpu")
    out = vit_forward(cfg, params, t(ins["px"]), interpolate=False)
    ref = outs["last_hidden"][:, 1:] if cfg.use_cls_token else outs["last_hidden"]
    close(out, ref, atol=atol, rtol=atol)


@pytest.mark.parametrize("name", ["qwen2", "llama"])
def test_golden_lm(name):
    sd, ins, outs, meta = _load(f"lm_{name}")
    cfg = _cfg(LMConfig, meta)
    params = params_from_numpy(from_hf.convert_lm(sd, cfg), device="cpu")
    logits = lm_mod.lm_forward(cfg, params, input_ids=t(ins["input_ids"]), dtype=torch.float32)
    close(logits, outs["logits"], atol=2e-4, rtol=2e-4)


def test_golden_qformer():
    sd, ins, outs, meta = _load("qformer")
    cfg = _cfg(QFormerConfig, meta)
    params = params_from_numpy(from_hf.convert_qformer(sd, cfg), device="cpu")
    out = qf.qformer_forward(cfg, params, t(ins["query"]), t(ins["input_ids"]), t(ins["text_mask"]),
                             t(ins["enc"]), t(ins["enc_mask"]))
    close(out, outs["query_hidden"], atol=3e-4, rtol=3e-4)


def _tree_unflatten(template, leaves):
    """Fill `template`'s leaves in JAX's flattening order (dict keys sorted,
    lists in order, None leaves skipped) from the iterator `leaves`."""
    if isinstance(template, dict):
        return {k: _tree_unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_tree_unflatten(v, leaves) for v in template)
    return None if template is None else next(leaves)


def test_golden_compression():
    """The T=64 audio-on compression emission: static + audio + sep and
    per-chunk K + sep blocks, the budget clamp, the ragged tail.  The
    fixture's parameters are the JAX compressor's leaves in JAX's order."""
    sd, ins, outs, meta = _load("compression")
    cfg = tdc_tiny(audio=True)
    template = tdc_mod.init_compressor(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = iter(torch.from_numpy(sd[f"{i:04d}"]) for i in range(len(sd)))
    params = _tree_unflatten(template, leaves)
    assert next(leaves, None) is None
    got, n_vis = tdc_mod.compress_video(
        cfg, params, t(ins["frames"]), t(ins["mask"]), t(ins["boundary"]), t(ins["text_ids"]),
        t(ins["text_mask"]), t(ins["audio"]), max_visual_len=int(meta["max_visual"]))
    assert int(n_vis) == int(outs["n_visual"])
    close(got[: int(n_vis)], outs["emission"], atol=2e-4, rtol=3e-4)
