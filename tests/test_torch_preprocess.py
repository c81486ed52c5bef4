"""Port parity: on-device frame preprocessing (data/images.py), the
token-grid resize (models/vit.py) against jax.image.resize, and the chat
tokenization with prompt-masked labels (data/preprocess.py).

jax.image.resize "cubic" with antialias is Keys cubic (a = -0.5) with the
kernel widened by 1/scale when downsampling, which is not torch's bicubic;
the port builds the same resize matrices.  Tolerance 3e-4 (golden suite)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tdc_video_tpu import config as jc
from tdc_video_tpu.data import images as jimg
from tdc_video_tpu.data import preprocess as jpre
from tdc_video_tpu.models import vit as jv
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.data import images as timg
from tdc_video_tpu_torch.data import preprocess as tpre
from tdc_video_tpu_torch.models import vit as tv
from torch_parity import StubTokenizer, close, t


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


_CONVS = [
    [{"from": "human", "value": "<image>\nWhat happens?"}, {"from": "gpt", "value": "A cat jumps."}],
    [{"role": "system", "content": "ignored"}, {"role": "user", "content": "Hi <image> there"},
     {"role": "assistant", "content": "Hello."}, {"role": "user", "content": "More?"},
     {"role": "assistant", "content": "No."}],
    [{"from": "human", "value": "Text only."}, {"from": "gpt", "value": "Sure."}],
]


@pytest.mark.parametrize("version", ["qwen", "llama3_2"])
@pytest.mark.parametrize("has_image", [True, False])
def test_preprocess_and_pack_text(version, has_image):
    """preprocess (assistant-only labels, <image> sentinels, Q-Former
    prompts) and pack_text (right padding, image slot, labels) agree with
    the JAX package token for token."""
    tok = StubTokenizer()
    ref = jpre.preprocess(_CONVS, tok, version, has_image=has_image)
    out = tpre.preprocess(_CONVS, tok, version, has_image=has_image)
    assert out == ref
    # labels keep assistant text and structural specials only
    for ids, labels in zip(out["input_ids"], out["labels"]):
        assert len(ids) == len(labels)
        assert any(lab == -100 for lab in labels) and any(lab >= 0 for lab in labels)
    for max_len in (40, 160):  # truncating and padding
        a = tpre.pack_text(out["input_ids"], out["labels"], max_len, pad_id=0)
        b = jpre.pack_text(ref["input_ids"], ref["labels"], max_len, pad_id=0)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
