"""Port parity: the ViT towers (models/vit.py), f32 on the CPU, shared
weights.  Tolerance 3e-4 (golden suite)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tdc_video_tpu.config import VIT_TINY, VIT_TINY_DINO
from tdc_video_tpu.models import vit as jv
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.models import vit as tv
from torch_parity import close, t, to_torch


def test_patchify_drops_trailing_pixels():
    x = np.random.default_rng(0).normal(size=(2, 31, 45, 3)).astype(np.float32)
    np.testing.assert_array_equal(tv.patchify(t(x), 14).numpy(), np.asarray(jv.patchify(jnp.asarray(x), 14)))


@pytest.mark.parametrize("name", ["siglip", "dinov2"])
@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_vit_forward(name, impl):
    """SigLIP (tanh-GELU MLP) and DINOv2 (CLS, LayerScale, SwiGLU), with the
    bilinear resize of the patch grid to interp_tokens."""
    jcfg = VIT_TINY if name == "siglip" else VIT_TINY_DINO
    tcfg = tc.VIT_TINY if name == "siglip" else tc.VIT_TINY_DINO
    params = jv.init_vit(jax.random.PRNGKey(3), jcfg)
    # non-trivial LayerScale and norm params so those paths are exercised
    params["layers"] = dict(params["layers"])
    if jcfg.layerscale:
        params["layers"]["ls1"] = params["layers"]["ls1"] * 0.5
        params["layers"]["ls2"] = params["layers"]["ls2"] * 1.5
    px = np.random.default_rng(1).normal(size=(3, 56, 56, 3)).astype(np.float32)
    ref = jv.vit_forward(jcfg, params, jnp.asarray(px), attn_impl=impl)
    out = tv.vit_forward(tcfg, to_torch(params), t(px), attn_impl=impl)
    assert out.shape == (3, jcfg.interp_tokens, jcfg.hidden_size)
    close(out, ref)
