"""Port parity: LM prefill and greedy decode steps (models/lm.py), f32 on the
CPU with shared weights.  Tolerance 3e-4 on the logits (golden suite)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.models import lm as tlm
from torch_parity import close, t, to_torch

# Llama-3 flavour at tiny width: tied embeddings, rope scaling, no qkv bias
LLAMA_KW = dict(tie_word_embeddings=True, attention_bias=False, rope_theta=500000.0,
                rope_scaling=(32.0, 1.0, 4.0, 64), rms_norm_eps=1e-5)


@pytest.mark.parametrize("flavour", ["qwen2", "llama"])
@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_prefill_and_decode_logits(flavour, impl):
    kw = LLAMA_KW if flavour == "llama" else {}
    jcfg = dataclasses.replace(jc.LM_TINY, **kw)
    tcfg = dataclasses.replace(tc.LM_TINY, **kw)
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    if not jcfg.tie_word_embeddings:
        params["layers"] = dict(params["layers"])
        for name in ("q_proj", "k_proj", "v_proj"):  # non-zero qkv biases
            b = params["layers"][name]["b"]
            params["layers"][name] = dict(params["layers"][name], b=b + 0.05 * jnp.arange(b.shape[-1]) / b.shape[-1])
    tp = to_torch(params)
    rng = np.random.default_rng(0)
    B, T, cap = 2, 12, 20
    emb = rng.normal(size=(B, T, jcfg.hidden_size)).astype(np.float32)
    am = np.arange(T)[None] < np.array([[12], [8]])  # right-padded second row

    jcache = jlm.init_kv_cache(jcfg, B, cap, dtype=jnp.float32)
    jlog, jcache = jlm.prefill(jcfg, params, jnp.asarray(emb), jnp.asarray(am), jcache,
                               attn_impl=impl, dtype=jnp.float32)
    tcache = tlm.init_kv_cache(tcfg, B, cap, dtype=torch.float32, device="cpu")
    tlog, tcache = tlm.prefill(tcfg, tp, t(emb), t(am), tcache, attn_impl=impl, dtype=torch.float32)
    close(tlog, jlog)
    np.testing.assert_array_equal(tcache["lengths"].numpy(), np.asarray(jcache["lengths"]))

    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(3):  # greedy decode steps, the sentinel id -200 clipped
        jemb = jlm.embed_tokens(jcfg, params, jnp.asarray(tok)[:, None], jnp.float32)
        temb = tlm.embed_tokens(tcfg, tp, t(tok)[:, None], torch.float32)
        close(temb, jemb, 0, 0)
        jlog, jcache = jlm.decode_step(jcfg, params, jemb, jcache, attn_impl=impl, dtype=jnp.float32)
        tlog, tcache = tlm.decode_step(tcfg, tp, temb, tcache, attn_impl=impl, dtype=torch.float32)
        close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert (tlog.argmax(-1).numpy() == tok).all()
    np.testing.assert_array_equal(tcache["mask"].numpy(), np.asarray(jcache["mask"]))
    close(tcache["k"], jcache["k"])


def test_embed_clips_sentinel():
    params = jlm.init_lm(jax.random.PRNGKey(1), jc.LM_TINY)
    ids = np.array([[-200, 0, 5, 511]], np.int32)
    close(tlm.embed_tokens(tc.LM_TINY, to_torch(params), t(ids), torch.float32),
          jlm.embed_tokens(jc.LM_TINY, params, jnp.asarray(ids), jnp.float32), 0, 0)
