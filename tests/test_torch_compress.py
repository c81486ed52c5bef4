"""Port parity: segmentation, pooling, Q-Former, TDC compression and the
splice (ops/segment.py, ops/pooling.py, models/qformer.py, compress/*).
f32 on the CPU with shared weights; tolerance 3e-4 (golden suite); index
outputs must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu.compress import assembly as jasm
from tdc_video_tpu.compress import aspect as jasp
from tdc_video_tpu.compress import tdc as jtdc
from tdc_video_tpu.models import qformer as jq
from tdc_video_tpu.ops import pooling as jpool
from tdc_video_tpu.ops import segment as jseg
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.compress import assembly as tasm
from tdc_video_tpu_torch.compress import aspect as tasp
from tdc_video_tpu_torch.compress import tdc as ttdc
from tdc_video_tpu_torch.models import qformer as tq
from tdc_video_tpu_torch.ops import pooling as tpool
from tdc_video_tpu_torch.ops import segment as tseg
from torch_parity import close, t, to_torch


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n_valid,k", [(10, 4), (5, 4), (12, 11)])
def test_segment_boundaries(n_valid, k):
    """Long videos (cuts at the k lowest similarities), short videos (every
    frame its own segment) and k = T-1."""
    feats = np.random.default_rng(0).normal(size=(12, 6, 5)).astype(np.float32)
    mask = np.arange(12) < n_valid
    close(tseg.adjacent_cosine_similarity(t(feats), t(mask)),
          jseg.adjacent_cosine_similarity(jnp.asarray(feats), jnp.asarray(mask)), 1e-6, 1e-6)
    _eq(tseg.segment_boundaries(t(feats), t(mask), k),
        jseg.segment_boundaries(jnp.asarray(feats), jnp.asarray(mask), k))


def test_segment_tie_order():
    """Equal similarities: lax.top_k picks the lowest indices first; the port
    must too (a bare torch.topk gives no such promise)."""
    a, b = np.ones((4,), np.float32), np.array([1, 0, 0, 0], np.float32)
    feats = np.stack([a, b] * 5)  # every adjacent pair has the same cosine
    mask = np.arange(10) < 9  # and the padded pair ties at 2.0
    ref = jseg.segment_boundaries(jnp.asarray(feats), jnp.asarray(mask), 3)
    out = tseg.segment_boundaries(t(feats), t(mask), 3)
    _eq(out, ref)
    assert out.numpy().nonzero()[0].tolist() == [0, 1, 2, 3]


def test_adaptive_pool():
    for n_in, n_out in [(20, 4), (156, 16), (7, 3)]:
        np.testing.assert_array_equal(tpool.adaptive_pool_matrix(n_in, n_out),
                                      jpool.adaptive_pool_matrix(n_in, n_out))
    x = np.random.default_rng(1).normal(size=(3, 20, 8)).astype(np.float32)
    close(tpool.adaptive_avg_pool_tokens(t(x), 4), jpool.adaptive_avg_pool_tokens(jnp.asarray(x), 4))


@pytest.mark.parametrize("with_text", [True, False])
def test_qformer_forward(with_text):
    cfg = jc.tdc_tiny().qformer
    params = jq.init_qformer(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(2)
    qe = rng.normal(size=(3, 4, 32)).astype(np.float32)
    enc = rng.normal(size=(3, 7, 64)).astype(np.float32)
    enc_mask = rng.random((3, 7)) > 0.3
    ids = rng.integers(0, 128, (3, 5)).astype(np.int32) if with_text else None
    tmask = (np.arange(5)[None] < np.array([[5], [3], [1]])) if with_text else None
    ref = jq.qformer_forward(cfg, params, jnp.asarray(qe), None if ids is None else jnp.asarray(ids),
                             None if tmask is None else jnp.asarray(tmask), jnp.asarray(enc),
                             jnp.asarray(enc_mask))
    out = tq.qformer_forward(tc.tdc_tiny().qformer, to_torch(params), t(qe),
                             None if ids is None else t(ids), None if tmask is None else t(tmask),
                             t(enc), t(enc_mask))
    close(out, ref)


def test_assign_chunks():
    boundary = np.array([1, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0], bool)
    mask = np.arange(12) < 11
    ref = jtdc.assign_chunks(jnp.asarray(boundary), jnp.asarray(mask), 4)
    out = ttdc.assign_chunks(t(boundary), t(mask), 4)
    for o, r in zip(out, ref):
        _eq(o, r)


@pytest.mark.parametrize("max_visual_len", [512, 40])
@pytest.mark.parametrize("aspect", [(48, 64), (1, 1)])
def test_compress_video(max_visual_len, aspect):
    """tdc_tiny, 8-frame bucket with 6 valid frames, f32 compression; the
    small budget exercises the force-remove clamp.  Landscape frames carry
    the unpad_image token mask and masked pooling matrix."""
    jcfg, tcfg = jc.tdc_tiny(), tc.tdc_tiny()
    params = jtdc.init_compressor(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(3)
    T, P, H = 8, 20, 64
    feats = rng.normal(size=(T, P, H)).astype(np.float32)
    mask = np.arange(T) < 6
    boundary = np.array([1, 0, 0, 1, 0, 0, 0, 0], bool)
    ids = rng.integers(0, 128, (16,)).astype(np.int32)
    tmask = np.arange(16) < 9
    tv, qp = jasp.frame_token_layout(jcfg, *aspect)
    tv2, qp2 = tasp.frame_token_layout(tcfg, *aspect)
    np.testing.assert_array_equal(tv, tv2)
    np.testing.assert_array_equal(qp, qp2)
    vis_j, n_j = jtdc.compress_video(
        jcfg, params, jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(boundary),
        jnp.asarray(ids), jnp.asarray(tmask), max_visual_len=max_visual_len, dtype=jnp.float32,
        token_valid=jnp.asarray(tv), query_pool=jnp.asarray(qp))
    vis_t, n_t = ttdc.compress_video(
        tcfg, to_torch(params), t(feats), t(mask), t(boundary), t(ids), t(tmask),
        max_visual_len=max_visual_len, dtype=torch.float32, token_valid=t(tv), query_pool=t(qp))
    assert int(n_t) == int(n_j)
    n = int(n_j)
    close(vis_t[:n], np.asarray(vis_j)[:n])


@pytest.mark.parametrize("max_visual_len", [1024, 150])
@pytest.mark.parametrize("aspect", [(48, 64), (1, 1)])
def test_compress_video_audio(max_visual_len, aspect):
    """tdc_tiny(audio=True): 50 audio tokens per frame after its P visual
    tokens, in the Q-Former's encoder and each chunk's static block (P + A
    tokens), not in the pooled query; with the aspect token mask, and a
    budget small enough to clamp."""
    jcfg, tcfg = jc.tdc_tiny(audio=True), tc.tdc_tiny(audio=True)
    params = jtdc.init_compressor(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(4)
    T, P, A, H = 8, 20, 50, 64
    feats = rng.normal(size=(T, P, H)).astype(np.float32)
    audio = rng.normal(size=(T, A, H)).astype(np.float32)
    mask = np.arange(T) < 7
    boundary = np.array([1, 0, 0, 0, 0, 1, 0, 0], bool)
    ids = rng.integers(0, 128, (16,)).astype(np.int32)
    tmask = np.arange(16) < 9
    tv, qp = jasp.frame_token_layout(jcfg, *aspect)
    vis_j, n_j = jtdc.compress_video(
        jcfg, params, jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(boundary),
        jnp.asarray(ids), jnp.asarray(tmask), jnp.asarray(audio), max_visual_len=max_visual_len,
        dtype=jnp.float32, token_valid=jnp.asarray(tv), query_pool=jnp.asarray(qp))
    vis_t, n_t = ttdc.compress_video(
        tcfg, to_torch(params), t(feats), t(mask), t(boundary), t(ids), t(tmask), t(audio),
        max_visual_len=max_visual_len, dtype=torch.float32, token_valid=t(tv), query_pool=t(qp))
    assert int(n_t) == int(n_j)
    n = int(n_j)
    close(vis_t[:n], np.asarray(vis_j)[:n])
    if max_visual_len == 1024:  # no clamp: each chunk's static block carries its A audio tokens
        _, _, n_chunks = ttdc.assign_chunks(t(boundary), t(mask), tcfg.compression.chunk_size)
        _, n_noaudio = ttdc.compress_video(
            tcfg, to_torch(params), t(feats), t(mask), t(boundary), t(ids), t(tmask),
            max_visual_len=max_visual_len, dtype=torch.float32, token_valid=t(tv),
            query_pool=t(qp))
        assert n - int(n_noaudio) == A * int(n_chunks)


def test_splice_visual_dynamic():
    """Batched splice vs JAX's per-sample function under vmap."""
    rng = np.random.default_rng(4)
    B, L, V, H, max_len = 3, 10, 6, 4, 14
    te = rng.normal(size=(B, L, H)).astype(np.float32)
    vis = rng.normal(size=(B, V, H)).astype(np.float32)
    ipos = np.array([2, 0, 5], np.int32)
    nv = np.array([4, 6, 1], np.int32)
    tl = np.array([10, 7, 9], np.int32)
    labels = rng.integers(0, 50, (B, L)).astype(np.int32)
    ref = jax.vmap(lambda a, b, c, d, e, f: jasm.splice_visual_dynamic(a, b, c, d, max_len, labels=f, text_len=e))(
        jnp.asarray(te), jnp.asarray(ipos), jnp.asarray(vis), jnp.asarray(nv), jnp.asarray(tl), jnp.asarray(labels))
    out = tasm.splice_visual_dynamic(t(te), t(ipos), t(vis), t(nv), max_len, labels=t(labels), text_len=t(tl))
    close(out[0], ref[0], 0, 0)
    for o, r in zip(out[1:], ref[1:]):
        _eq(o, r)


@pytest.mark.parametrize("case", ["two_images", "unused_slots", "truncated"])
def test_splice_visual_multi(case):
    """Batched splice of several <image> slots vs JAX's per-sample function
    under vmap (tests/test_compress.py::TestSpliceMulti's cases: two images
    in order, unused slots (-1) and a text-only row, a sequence cut at
    max_len): embeddings exact, masks, labels and lengths equal."""
    rng = np.random.default_rng(6)
    B, L, M, V, H = 3, 10, 3, 5, 4
    max_len = 11 if case == "truncated" else 24
    te = rng.normal(size=(B, L, H)).astype(np.float32)
    vis = rng.normal(size=(B, M, V, H)).astype(np.float32)
    ipos = {"two_images": [[2, 5, -1], [1, 8, -1], [0, 3, 9]],
            "unused_slots": [[4, -1, -1], [-1, -1, -1], [2, 6, -1]],
            "truncated": [[2, 5, 7], [1, 8, -1], [0, 3, 9]]}[case]
    ipos = np.asarray(ipos, np.int32)
    nv = rng.integers(1, V + 1, (B, M)).astype(np.int32)
    tl = np.array([10, 9, 10], np.int32)
    labels = rng.integers(0, 50, (B, L)).astype(np.int32)
    ref = jax.vmap(lambda a, b, c, d, e, f: jasm.splice_visual_multi(a, b, c, d, max_len, labels=f,
                                                                     text_len=e))(
        jnp.asarray(te), jnp.asarray(ipos), jnp.asarray(vis), jnp.asarray(nv), jnp.asarray(tl),
        jnp.asarray(labels))
    out = tasm.splice_visual_multi(t(te), t(ipos), t(vis), t(nv), max_len, labels=t(labels),
                                   text_len=t(tl))
    close(out[0], ref[0], 0, 0)
    for o, r in zip(out[1:], ref[1:]):
        _eq(o, r)
    nolab = tasm.splice_visual_multi(t(te), t(ipos), t(vis), t(nv), max_len)
    assert nolab[2] is None


@pytest.mark.parametrize("image_pos,n_vis,max_len", [(3, 6, 20), (0, 10, 20), (6, 4, 9), (3, 0, 12)])
def test_splice_visual(image_pos, n_vis, max_len):
    """The per-sample splice at a fixed <image> position vs JAX's
    (tests/test_compress.py::test_splice_visual, and cuts at max_len, an
    image first or last, no visual tokens): all outputs equal."""
    rng = np.random.default_rng(7)
    L, H, V = 7, 4, 10
    text = rng.normal(size=(L, H)).astype(np.float32)
    visual = rng.normal(size=(V, H)).astype(np.float32)
    labels = np.arange(L, dtype=np.int32)
    ref = jasm.splice_visual(jnp.asarray(text), image_pos, jnp.asarray(visual), jnp.asarray(n_vis),
                             max_len, jnp.asarray(labels))
    out = tasm.splice_visual(t(text), image_pos, t(visual), torch.tensor(n_vis), max_len,
                             t(labels))
    close(out[0], ref[0], 0, 0)
    for o, r in zip(out[1:], ref[1:]):
        _eq(o, r)


def test_uniform_sample_indices_and_square_layout():
    """The host helpers the training collator uses, equal to JAX's."""
    for n, m in [(5, 8), (8, 8), (9, 8), (224, 64), (1000, 224)]:
        assert tseg.uniform_sample_indices(n, m) == jseg.uniform_sample_indices(n, m)
    for jv, tv in zip(jasp.square_layout(jc.tdc_tiny()), tasp.square_layout(tc.tdc_tiny())):
        np.testing.assert_array_equal(tv, jv)
