"""Sequence parallelism: `lm_forward(seq_axis="data")` (models/lm.py) and the
causal query offset of K1, K5 and K6 (ops/flash_attention.py), on the CPU
in f32 at LM_TINY.

* Without ranks: each plain version at a query offset equals the row block
  of the whole causal call (K1's o and lse, K5's dQ), the blocks' K6 partials
  sum to the whole dK and dV and are exact zeros on keys no query of the
  block sees; q_offset=0 is the call without one; an offset out of range
  raises before any launch; the mask check accepts the causal mask's row
  block and refuses the unshifted one.
* One launch of 2 gloo ranks (tests/torch_parallel_worker.py, mode "seq"):
  2x1, and 2x1 with FSDP's split layers; one of 4 ranks (mode "seq4"): 4x1
  (JAX's 4-way split of T=64, tests/test_parallel.py TestSequenceParallel)
  and 2x2 (with TP over `model`).  The ranks' gathered logits against JAX's
  unsharded lm_forward and JAX's lm_forward(seq_axis="data") under
  make_mesh(4, 2) at JAX's mesh tolerance (rtol/atol 2e-4); the shifted
  cross-entropy over the batch (each rank's rows' share summed over `data`)
  and its gradients, summed over `data` and gathered whole, against
  jax.value_and_grad of the unsharded forward's (rtol 2e-4, the golden
  suite's atol 3e-4).  The JAX references run under jax.jit while the
  ranks run.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu.parallel.mesh import make_mesh as jax_mesh
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.models import lm as tlm
from tdc_video_tpu_torch.models.attention import attention
from tdc_video_tpu_torch.ops import flash_attention as fa
from torch_parallel_worker import Launch
from torch_parity import StandInMesh, close, to_torch

MESH_TOL = 2e-4  # tests/test_parallel.py TestSequenceParallel
JAX_ATOL = 3e-4  # the golden suite's f32 tolerance, beside MESH_TOL for gradients
B, T = 2, 64
CASES = {"2x1": "seq", "2x1_fsdp": "seq", "4x1": "seq4", "2x2": "seq4"}


# ---------------------------------------------------------------------------
# The kernels' plain versions at a query offset (no ranks)
# ---------------------------------------------------------------------------


def _qkv(seed, Bq, Tq, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
                 for s in ((Bq, Tq, Hq, D), (Bq, S, Hkv, D), (Bq, S, Hkv, D), (Bq, Tq, Hq, D)))


@pytest.mark.parametrize("shape,n", [((2, 64, 4, 2, 16), 4), ((1, 96, 6, 2, 32), 3),
                                     ((1, 40, 3, 3, 8), 2)])
def test_offset_blocks_are_the_whole_call(shape, n):
    Bq, S, Hq, Hkv, D = shape
    q, k, v, do = _qkv(0, Bq, S, S, Hq, Hkv, D)
    scale = 1 / math.sqrt(D)
    o, lse = fa.flash_kernel(q, k, v, scale, True)
    delta = (do * o).sum(-1).permute(0, 2, 1).contiguous()[..., None]
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, scale, True)
    dk, dv = fa.flash_dkv_kernel(q, k, v, do, lse, delta, scale, True)
    w = S // n
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for c in range(n):
        r = slice(c * w, (c + 1) * w)
        ob, lb = fa.flash_kernel(q[:, r], k, v, scale, True, q_offset=c * w)
        close(ob, o[:, r], 1e-6, 1e-6)
        close(lb, lse[:, :, r], 1e-6, 1e-6)
        part = (q[:, r], k, v, do[:, r], lse[:, :, r].contiguous(), delta[:, :, r].contiguous())
        close(fa.flash_dq_kernel(*part, scale, True, q_offset=c * w), dq[:, r], 1e-5, 1e-5)
        a, b = fa.flash_dkv_kernel(*part, scale, True, q_offset=c * w)
        # keys past the block's last diagonal meet no query: exact zeros
        assert int(torch.count_nonzero(a[:, (c + 1) * w:])) == 0
        assert int(torch.count_nonzero(b[:, (c + 1) * w:])) == 0
        dk_sum, dv_sum = dk_sum + a, dv_sum + b
    close(dk_sum, dk, 1e-5, 1e-5)
    close(dv_sum, dv, 1e-5, 1e-5)


def test_offset_zero_is_todays_call():
    """q_offset=0 is the call without one, bit for bit, and causal stays
    top-left aligned when S > T (the sdpa of an explicit tril mask)."""
    q, k, v, do = _qkv(1, 2, 24, 40, 4, 2, 16)
    scale = 0.25
    o, lse = fa.flash_kernel(q, k, v, scale, True)
    o0, lse0 = fa.flash_kernel(q, k, v, scale, True, q_offset=0)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    delta = (do * o).sum(-1).permute(0, 2, 1).contiguous()[..., None]
    args = (q, k, v, do, lse, delta, scale, True)
    assert torch.equal(fa.flash_dq_kernel(*args), fa.flash_dq_kernel(*args, q_offset=0))
    for a, b in zip(fa.flash_dkv_kernel(*args), fa.flash_dkv_kernel(*args, q_offset=0)):
        assert torch.equal(a, b)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    assert torch.equal(fa.flash_attention(qa, ka, va, causal=True, scale=scale),
                       fa.flash_attention(q, k, v, causal=True, scale=scale, q_offset=0))
    tril = torch.tril(torch.ones(24, 40, dtype=torch.bool))
    ref = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.repeat_interleave(2, 2).transpose(1, 2),
        v.repeat_interleave(2, 2).transpose(1, 2), attn_mask=tril, scale=scale).transpose(1, 2)
    close(o, ref, 1e-5, 1e-5)


@pytest.mark.parametrize("q_offset", [-1, 41, 100])
@pytest.mark.parametrize("kernel", ["flash_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                                    "flash_attention"])
def test_offset_out_of_range_raises(kernel, q_offset):
    """q_offset < 0, or q_offset + T > S (T = 24, S = 64), raises
    ValueError before any launch or plain computation."""
    q, k, v, do = _qkv(2, 1, 24, 64, 2, 2, 8)
    lse = torch.zeros(1, 2, 24, 1)
    args = {"flash_kernel": (q, k, v, 0.3, True), "flash_attention": (q, k, v),
            "flash_dq_kernel": (q, k, v, do, lse, lse, 0.3, True),
            "flash_dkv_kernel": (q, k, v, do, lse, lse, 0.3, True)}[kernel]
    kw = {"causal": True} if kernel == "flash_attention" else {}
    with pytest.raises(ValueError, match="query offset"):
        getattr(fa, kernel)(*args, q_offset=q_offset, **kw)


def test_offset_needs_causal():
    q, k, v, _ = _qkv(3, 1, 16, 16, 2, 2, 8)
    with pytest.raises(ValueError, match="needs causal"):
        fa.flash_attention(q[:, :8], k, v, causal=False, q_offset=8)


def test_flash_mask_check_takes_the_row_block():
    """attention(impl="flash") on the CPU checks the mask: the causal mask's
    row block at the offset (right-padded keys too) passes and gives the
    whole call's rows; the unshifted tril block raises."""
    q, k, v, _ = _qkv(4, 2, 64, 64, 4, 2, 16)
    valid = torch.arange(64)[None] < torch.tensor([[64], [50]])
    full = torch.tril(torch.ones(64, 64, dtype=torch.bool))[None, None] & valid[:, None, None]
    whole = attention(q, k, v, full, impl="flash", causal=True)
    for c in range(4):
        r = slice(16 * c, 16 * (c + 1))
        out = attention(q[:, r], k, v, full[:, :, r], impl="flash", causal=True, q_offset=16 * c)
        close(out, whole[:, r], 1e-6, 1e-6)
    with pytest.raises(ValueError, match="causal"):
        attention(q[:, 16:32], k, v, full[:, :, :16], impl="flash", causal=True, q_offset=16)


# ---------------------------------------------------------------------------
# lm_forward(seq_axis=) over gloo ranks, against JAX
# ---------------------------------------------------------------------------


def test_seq_axis_raises_before_any_collective():
    params = {"embed": {"embedding": torch.zeros(tc.LM_TINY.vocab_size, tc.LM_TINY.hidden_size)}}
    ids = torch.zeros(1, 62, dtype=torch.long)
    with pytest.raises(ValueError, match="does not divide"):
        tlm.lm_forward(tc.LM_TINY, params, input_ids=ids, mesh=StandInMesh(4, 1), seq_axis="data")
    with pytest.raises(ValueError, match="splits over 'data' only"):
        tlm.lm_forward(tc.LM_TINY, params, input_ids=ids[:, :64], mesh=StandInMesh(1, 2),
                       seq_axis="model")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both launches started at once; the JAX references computed while the
    ranks run: ({tag: rank results}, JAX's unsharded and seq_axis logits,
    JAX's gradients)."""
    root = tmp_path_factory.mktemp("seq_parallel")
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jc.LM_TINY)
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 500, (B, T)).astype(np.int32)
    mask = np.arange(T)[None] < np.array([[T], [50]])  # the second sample right-padded
    labels = np.where(mask, ids, -100)
    inp = {"lm": to_torch(jparams), "ids": torch.from_numpy(ids).long(),
           "mask": torch.from_numpy(mask), "labels": torch.from_numpy(labels).long()}
    launches = {}
    for mode, world in (("seq", 2), ("seq4", 4)):
        workdir = root / mode
        workdir.mkdir()
        torch.save(inp, workdir / "inputs.pt")
        launches[mode] = Launch(mode, world, workdir, wall_s=90.0)

    jids, jmask = jnp.asarray(ids), jnp.asarray(mask)

    def fwd(p, **kw):
        return jlm.lm_forward(jc.LM_TINY, p, input_ids=jids, attention_mask=jmask,
                              dtype=jnp.float32, **kw)

    def loss_fn(p):
        tgt = jnp.asarray(labels[:, 1:])
        logp = jax.nn.log_softmax(fwd(p)[:, :-1], axis=-1)
        ll = jnp.take_along_axis(logp, jnp.maximum(tgt, 0)[..., None], axis=-1)[..., 0]
        return -(ll * (tgt >= 0)).sum() / (tgt >= 0).sum()

    ref = np.asarray(jax.jit(fwd)(jparams))
    with jax_mesh(4, 2):
        ref_sp = np.asarray(jax.jit(lambda p: fwd(p, seq_axis="data"))(jparams))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    out = {}
    for mode, launch in launches.items():
        launch.wait()
        res = launch.results()
        for tag, m in CASES.items():
            if m == mode:
                out[tag] = [r[tag] for r in res]
    return out, ref, ref_sp, (float(loss), jax.tree_util.tree_map(np.asarray, grads))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("tag", list(CASES))
def test_seq_parallel_logits(runs, tag):
    res, ref, ref_sp, _ = runs
    n_data = int(tag[0])
    for r in res[tag]:
        assert r["block"] == (B, T // n_data, tc.LM_TINY.vocab_size)
        close(r["logits"], ref, MESH_TOL, MESH_TOL)
        close(r["logits"], ref_sp, MESH_TOL, MESH_TOL)
        # two gathers (K, V) a layer forward, their gradient sums backward
        L = tc.LM_TINY.num_layers
        assert r["counts"]["gather_seq"] == 2 * L and r["counts"]["gather_seq_grad"] == 2 * L
        got, want = r["gather_seq"]
        close(got, want.numpy(), 1e-6, 1e-6)


@pytest.mark.parametrize("tag", list(CASES))
def test_seq_parallel_gradients(runs, tag):
    res, _, _, (loss, grads) = runs
    want = dict(_leaves(grads))
    for r in res[tag]:
        close(np.float32(r["loss"]), loss, MESH_TOL, MESH_TOL)
        got = dict(_leaves(r["grads"]))
        assert sorted(got) == sorted(want)
        for name, g in want.items():
            close(got[name], g, JAX_ATOL, MESH_TOL)
