"""Port parity of LoRA (train/lora.py and the LoRA branches of
layers.linear) on tdc_tiny in f32, on the CPU, against the JAX package.

Tolerances: linear's branches 1e-5 (JAX's own
test_linear_int8_lora_exact_decomposition bound); the LM forward and the
A/B gradients through graft_lora, and apply_lora / merge_lora_params, 3e-4
(the golden suite's f32 tolerance).  Named divergence: apply_lora raises on
an int8 "w_q" target, where JAX merges the float delta into the int8 values
and ignores the scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu.model import init_tdc as jinit_tdc
from tdc_video_tpu.models import layers as jlayers
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu.models import quant as jquant
from tdc_video_tpu.train import lora as jlora
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.models import layers as tlayers
from tdc_video_tpu_torch.models import lm as tlm
from tdc_video_tpu_torch.models import quant as tquant
from tdc_video_tpu_torch.train import lora as tlora
from tdc_video_tpu_torch.train.step import lora_view, split_lora, tree_leaves
from torch_parity import close, t, to_torch

ALPHA, RANK = 8, 4


@pytest.fixture(scope="module")
def lm_and_lora():
    """tdc_tiny's LM and a JAX LoRA tree with B moved off zero, so the
    deltas take part."""
    params = jinit_tdc(jax.random.PRNGKey(0), jc.tdc_tiny())["lm"]
    lora = jlora.init_lora(jax.random.PRNGKey(1), params, rank=RANK)
    lora = jax.tree_util.tree_map(
        lambda x: x + 0.03 * jax.random.normal(jax.random.PRNGKey(2), x.shape), lora)
    return params, lora


@pytest.mark.parametrize("base", ["float", "int8"])
def test_linear_lora_branches_match_jax(base):
    """y = x W + (x A) B (+ bias) over a float weight, and over an int8 weight
    as the scaled weight-only product + (x A) B: against JAX's linear at
    1e-5, and equal to the base product plus the delta."""
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(0, 0.1, (16, 24)).astype(np.float32),
         "b": rng.normal(0, 0.1, (24,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if base == "int8":
        jp = jquant.quantize_linear_int8(jp)
    jp["lora_a"] = jnp.asarray(rng.normal(0, 0.1, (16, 4)), jnp.float32)
    jp["lora_b"] = jnp.asarray(rng.normal(0, 0.1, (4, 24)), jnp.float32)
    x = rng.normal(0, 1, (3, 16)).astype(np.float32)
    ref = jlayers.linear(jp, jnp.asarray(x))
    tp = to_torch(jp)
    if base == "int8":
        tp = dict(tquant.quantize_linear_int8({"w": t(p["w"]), "b": t(p["b"])}),
                  lora_a=tp["lora_a"], lora_b=tp["lora_b"])
    out = tlayers.linear(tp, t(x))
    close(out, ref, atol=1e-5, rtol=1e-5)
    plain = {k: v for k, v in tp.items() if not k.startswith("lora")}
    delta = (t(x) @ tp["lora_a"]) @ tp["lora_b"]
    close(out, tlayers.linear(plain, t(x)) + delta, atol=1e-5, rtol=1e-5)


def test_init_lora_keys_and_shapes_match_jax(lm_and_lora):
    """Keys (in JAX's order), shapes and dtypes as JAX's; A ~ N(0, 0.02)
    from the generator, B zeros; over an int8 LM the keys end in w_q."""
    params, _ = lm_and_lora
    ref = jlora.init_lora(jax.random.PRNGKey(1), params, rank=RANK)
    tp = to_torch(params)
    out = tlora.init_lora(tp, RANK, generator=torch.Generator().manual_seed(0))
    assert list(out) == list(ref)
    for k in ref:
        for n in ("a", "b"):
            assert tuple(out[k][n].shape) == ref[k][n].shape, (k, n)
            assert out[k][n].dtype == torch.float32
        assert not out[k]["b"].any()
    a = torch.cat([out[k]["a"].flatten() for k in out])
    assert abs(float(a.std()) - 0.02) < 2e-3 and abs(float(a.mean())) < 2e-3
    same = tlora.init_lora(tp, RANK, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(same[k]["a"], out[k]["a"]) for k in out)
    q = tlora.init_lora(tquant.quantize_lm_int8(tp), RANK, generator=torch.Generator())
    jq = jlora.init_lora(jax.random.PRNGKey(1), jquant.quantize_lm_int8(params), rank=RANK)
    assert list(q) == list(jq) and all(k.endswith("/w_q") for k in q)


def _lm_loss_port(lmcfg, lm, ids):
    logits = tlm.lm_forward(lmcfg, lm, input_ids=ids, dtype=torch.float32)
    return logits, torch.log_softmax(logits, -1)[..., 7].mean()


def test_graft_lora_forward_and_grads_match_jax(lm_and_lora):
    """The LM forward through graft_lora against JAX's graft, and the A/B
    gradients of a scalar of the logits against jax.grad, both at 3e-4;
    the trainer's per-layer form (step.lora_view over split_lora) gives the
    same logits and the same A/B gradients, in the stored leaves' .grad."""
    params, lora = lm_and_lora
    lmcfg_j, lmcfg_t = jc.tdc_tiny().lm, tc.tdc_tiny().lm
    ids = np.random.default_rng(0).integers(2, 100, (2, 12)).astype(np.int32)

    def jloss(lo):
        g = jlora.graft_lora(params, lo, ALPHA, RANK)
        logits = jlm.lm_forward(lmcfg_j, g, input_ids=jnp.asarray(ids), dtype=jnp.float32)
        return jax.nn.log_softmax(logits, -1)[..., 7].mean(), logits

    (ref, ref_logits), ref_g = jax.value_and_grad(jloss, has_aux=True)(lora)
    tp = to_torch(params)
    for form in ("graft", "view"):
        tl = to_torch(lora)
        for x in tree_leaves(tl):
            x.requires_grad_()
        if form == "graft":
            lm = tlora.graft_lora(tp, tl, ALPHA, RANK)
        else:
            lm = lora_view(tp, split_lora(tl), ALPHA, RANK)
        logits, loss = _lm_loss_port(lmcfg_t, lm, t(ids))
        loss.backward()
        close(logits, ref_logits)
        close(loss, ref)
        for k in ref_g:
            for n in ("a", "b"):
                close(tl[k][n].grad, ref_g[k][n], atol=3e-4, rtol=3e-4)


def test_graft_lora_leaves_callers_tree_untouched(lm_and_lora):
    """graft_lora copies only the dicts on the adapted paths: the caller's
    tree has no LoRA keys after it, its weights are the same tensors, and
    the grafted B is the caller's B times alpha / rank."""
    params, lora = lm_and_lora
    tp, tl = to_torch(params), to_torch(lora)
    keys_before = sorted(tp["layers"]["q_proj"])
    g = tlora.graft_lora(tp, tl, ALPHA, RANK)
    assert sorted(tp["layers"]["q_proj"]) == keys_before
    assert "lora_a" not in tp["layers"]["mlp"]["gate"]
    assert g["layers"]["q_proj"]["w"] is tp["layers"]["q_proj"]["w"]
    assert g["embed"] is tp["embed"]
    assert g["layers"]["q_proj"]["lora_a"] is tl["layers/q_proj/w"]["a"]
    assert torch.equal(g["layers"]["q_proj"]["lora_b"], tl["layers/q_proj/w"]["b"] * ALPHA / RANK)
    v = lora_view(tp, split_lora(tl), ALPHA, RANK)
    assert isinstance(v["layers"], list) and len(v["layers"]) == jc.tdc_tiny().lm.num_layers
    assert sorted(tp["layers"]["q_proj"]) == keys_before


def test_apply_and_merge_lora_match_jax(lm_and_lora):
    """apply_lora and merge_lora_params against JAX at 3e-4 (every leaf),
    and the LM forward of the merged tree equal to the grafted one; after
    init (B = 0) apply_lora is the identity; adapters keyed over an int8
    base (".../w_q") merge into the dequantized tree's ".../w"."""
    params, lora = lm_and_lora
    ref = jlora.merge_lora_params(params, lora, ALPHA, RANK)
    tp, tl = to_torch(params), to_torch(lora)
    out = tlora.merge_lora_params(tp, tl, ALPHA, RANK)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    n = 0
    for path, leaf in flat_ref.items():
        names = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        node = out
        for nm in names:
            node = node[nm]
        close(node, leaf)
        n += 1
    assert n == len(tree_leaves(out))
    assert torch.equal(tlora.apply_lora(tp, tl, ALPHA, RANK)["layers"]["q_proj"]["w"],
                       out["layers"]["q_proj"]["w"])
    ids = t(np.random.default_rng(3).integers(2, 100, (1, 9)).astype(np.int32))
    lmcfg = tc.tdc_tiny().lm
    close(_lm_loss_port(lmcfg, out, ids)[0],
          _lm_loss_port(lmcfg, tlora.graft_lora(tp, tl, ALPHA, RANK), ids)[0].detach().numpy())
    zero = tlora.init_lora(tp, RANK, generator=torch.Generator().manual_seed(1))
    same = tlora.apply_lora(tp, zero, ALPHA, RANK)
    assert torch.equal(same["layers"]["q_proj"]["w"], tp["layers"]["q_proj"]["w"])
    q = tquant.quantize_lm_int8(tp)
    lq = {k + "_q": v for k, v in tl.items()}
    deq = tquant.dequantize_tree_int8(q)
    merged_q = tlora.apply_lora(deq, lq, ALPHA, RANK)
    close(merged_q["layers"]["q_proj"]["w"],
          tlora.apply_lora(deq, tl, ALPHA, RANK)["layers"]["q_proj"]["w"].numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("keys", ["w_q", "w"])
def test_apply_lora_raises_on_int8_target(lm_and_lora, keys):
    """The named divergence: merging into an int8 tree raises (JAX adds the
    delta to the int8 values and drops the scale, or skips the leaf when
    the adapter is keyed ".../w"); dequantize first."""
    params, lora = lm_and_lora
    q = tquant.quantize_lm_int8(to_torch(params))
    tl = to_torch(lora)
    if keys == "w_q":
        tl = {k + "_q": v for k, v in tl.items()}
    with pytest.raises(ValueError, match="int8"):
        tlora.apply_lora(q, tl, ALPHA, RANK)
