"""Port parity: on-device frame preprocessing (data/images.py) and the
token-grid resize (models/vit.py) against jax.image.resize.

jax.image.resize "cubic" with antialias is Keys cubic (a = -0.5) with the
kernel widened by 1/scale when downsampling, which is not torch's bicubic;
the port builds the same resize matrices.  Tolerance 3e-4 (golden suite)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tdc_video_tpu import config as jc
from tdc_video_tpu.data import images as jimg
from tdc_video_tpu.models import vit as jv
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.data import images as timg
from tdc_video_tpu_torch.models import vit as tv
from torch_parity import close, t


@pytest.mark.parametrize("n_in,n_out", [(640, 384), (640, 378), (100, 56), (56, 100)])
def test_cubic_resize_matrix(n_in, n_out):
    x = np.random.default_rng(0).normal(size=(n_in, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (n_out, 3), method="cubic", antialias=True)
    close(timg.cubic_resize_matrix(n_in, n_out) @ x, ref)


@pytest.mark.parametrize(
    "preset,hw",
    [("tdc_tiny", (48, 64)),  # landscape, downsampled to 56 px
     ("tdc_tiny", (70, 40)),  # portrait
     ("tdc_llama32_3b", (360, 640))],  # main-path frames to 384 / 378 px
)
def test_device_preprocess(preset, hw):
    jcfg, tcfg = getattr(jc, preset)(), getattr(tc, preset)()
    frames = np.random.default_rng(1).integers(0, 256, (2,) + hw + (3,), dtype=np.uint8)
    sig_j, dino_j = jimg.device_preprocess(jnp.asarray(frames), jcfg)
    sig_t, dino_t = timg.device_preprocess(t(frames), tcfg)
    assert sig_t.shape == sig_j.shape and dino_t.shape == dino_j.shape
    close(sig_t, sig_j)
    close(dino_t, dino_j)


@pytest.mark.parametrize("n", [5, 8, 11])
def test_pad_frames(n):
    """Right-padding to the frame bucket (and truncation past it)."""
    rng = np.random.default_rng(3)
    sig, dino = rng.normal(size=(n, 4, 4, 3)).astype(np.float32), rng.normal(size=(n, 3, 3, 3))
    for a, b in zip(timg.pad_frames(sig, dino, 8), jimg.pad_frames(sig, dino, 8)):
        np.testing.assert_array_equal(a, b)
    assert timg.frame_bucket(n) == jimg.frame_bucket(n)


@pytest.mark.parametrize("src,dst", [(27, 24), (12, 24), (4, 3)])
def test_bilinear_resize_tokens(src, dst):
    x = np.random.default_rng(2).normal(size=(2, src * src, 5)).astype(np.float32)
    close(tv.bilinear_resize_tokens(t(x), src, dst), jv.bilinear_resize_tokens(jnp.asarray(x), src, dst))
