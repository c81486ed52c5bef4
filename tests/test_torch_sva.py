"""Port parity: SVA (models/sva.py), f32 on the CPU, shared weights.
Tolerance 3e-4 (golden suite)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tdc_video_tpu.config import SVA_TINY
from tdc_video_tpu.models import sva as js
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.models import sva as ts
from torch_parity import close, t, to_torch


def test_rearrange_windows():
    x = np.arange(2 * 36 * 3, dtype=np.float32).reshape(2, 36, 3)
    np.testing.assert_array_equal(ts.rearrange_windows(t(x), 3).numpy(),
                                  np.asarray(js.rearrange_windows(jnp.asarray(x), 3)))


@pytest.mark.parametrize("masked", [False, True])
def test_sva_forward(masked):
    """Aux projectors, the windowed cross-attention sampler (3 layers) and the
    mm projector; with per-tower token masks in the masked case."""
    rng = np.random.default_rng(0)
    params = js.init_sva(jax.random.PRNGKey(0), SVA_TINY, tower_dims=(32, 48), llm_hidden=64)
    feats = [rng.normal(size=(2, 16, 32)).astype(np.float32),
             rng.normal(size=(2, 16, 48)).astype(np.float32)]
    masks = None
    if masked:
        masks = [rng.random((2, 16)) > 0.3, None]
    ref = js.sva_forward(SVA_TINY, params, [jnp.asarray(f) for f in feats],
                         None if masks is None else [jnp.asarray(masks[0]), None])
    out = ts.sva_forward(tc.SVA_TINY, to_torch(params), [t(f) for f in feats],
                         None if masks is None else [t(masks[0]), None])
    assert out.shape == (2, 16, 64)
    close(out, ref)


def test_encode_frames():
    """Both towers, SVA and the per-row image_newline on tdc_tiny (f32): the
    frame features and the DINO features the segmentation reads."""
    from tdc_video_tpu import config as jc
    from tdc_video_tpu import model as jmodel
    from tdc_video_tpu_torch import model as tmodel

    jcfg, tcfg = jc.tdc_tiny(), tc.tdc_tiny()
    params = jmodel.init_tdc(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(5)
    sig = rng.normal(size=(3, 56, 56, 3)).astype(np.float32)
    dino = rng.normal(size=(3, 56, 56, 3)).astype(np.float32)
    ref = jmodel.encode_frames(jcfg, params, jnp.asarray(sig), jnp.asarray(dino))
    out = tmodel.encode_frames(tcfg, to_torch(params), t(sig), t(dino))
    assert out[0].shape[1] == tmodel.frame_token_len(tcfg) == jmodel.frame_token_len(jcfg)
    close(out[0], ref[0])
    close(out[1], ref[1])
