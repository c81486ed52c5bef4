"""Port parity of the training path on tdc_tiny in f32, on the CPU: the LM
loss, the multimodal loss and its gradients, the freeze policy and optimizer
groups, the schedule, and a short run of the Trainer against the JAX
Trainer on the same bridged params and batches; the multimodal loss also
with the audio keys, on tdc_tiny(audio=True).

Tolerances: losses and gradients 3e-4 (the golden suite's f32 tolerance;
the two frameworks sum in other orders); schedules 1e-6 relative (optax
computes in f32, the port in f64).  Both configs use compress_dtype f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jm
from tdc_video_tpu.constants import IGNORE_INDEX
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu.ops import audio as jaudio
from tdc_video_tpu.parallel.mesh import make_mesh
from tdc_video_tpu.train import stages as jstages
from tdc_video_tpu.train import trainer as jtr
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch import model as tm
from tdc_video_tpu_torch.models import lm as tlm
from tdc_video_tpu_torch.train import stages as tstages
from tdc_video_tpu_torch.train import trainer as ttr
from tdc_video_tpu_torch.train.step import tree_leaves
from torch_parity import close, t, to_torch


def _cfgs():
    return (dataclasses.replace(jc.tdc_tiny(), compress_dtype=jnp.float32),
            dataclasses.replace(tc.tdc_tiny(), compress_dtype=torch.float32))


@pytest.fixture(scope="module")
def jparams():
    return jm.init_tdc(jax.random.PRNGKey(0), _cfgs()[0])


def _batch(cfg, B=2, T=4, L=24, seed=0):
    """The JAX trainer tests' batch (tests/test_train.py::_batch)."""
    rng = np.random.default_rng(seed)
    s, d = cfg.siglip.image_size, cfg.dino.image_size
    labels = np.full((B, L), IGNORE_INDEX, np.int32)
    labels[:, 10:] = rng.integers(2, 100, (B, L - 10))
    return {
        "input_ids": np.asarray(rng.integers(2, 100, (B, L)), np.int32),
        "labels": labels,
        "image_pos": np.full((B,), 5, np.int32),
        "text_len": np.full((B,), L, np.int32),
        "has_image": np.ones((B,), bool),
        "siglip_px": rng.normal(0, 1, (B, T, s, s, 3)).astype(np.float32),
        "dino_px": rng.normal(0, 1, (B, T, d, d, 3)).astype(np.float32),
        "frame_mask": np.ones((B, T), bool),
        "qformer_text_ids": rng.integers(1, 50, (B, 6)).astype(np.int32),
        "qformer_text_mask": np.ones((B, 6), bool),
    }


def _jax_leaves_with_names(tree):
    """[(path names, leaf)] in JAX's leaf order (dict keys sorted)."""
    return [(jtr._path_names(p), x) for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _port_by_names(tree):
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (str(k),))
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, path + (str(i),))
        elif x is not None:
            out[path] = x

    walk(tree, ())
    return out


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_lm_forward(jparams, remat):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    ids = rng.integers(2, 500, (2, 20)).astype(np.int32)
    am = np.arange(20)[None] < np.array([[20], [13]])  # one right-padded row
    ref = jlm.lm_forward(jcfg.lm, jparams["lm"], input_ids=jnp.asarray(ids),
                         attention_mask=jnp.asarray(am), dtype=jnp.float32)
    out = tlm.lm_forward(tcfg.lm, to_torch(jparams["lm"]), input_ids=t(ids), attention_mask=t(am),
                         dtype=torch.float32, remat=remat)
    close(out, ref)


@pytest.mark.parametrize("loss_chunk", [None, 5, 64])
def test_lm_loss_and_grads(jparams, loss_chunk):
    """Unchunked and chunked CE (the last chunk ragged, or one chunk longer
    than the sequence) against the JAX loss: value, the input embeddings'
    gradient, the head's and a stacked layer weight's."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    emb = rng.normal(0, 1, (2, 23, jcfg.lm.hidden_size)).astype(np.float32)
    labels = rng.integers(2, 500, (2, 23)).astype(np.int32)
    labels[:, :6] = IGNORE_INDEX
    am = np.arange(23)[None] < np.array([[23], [17]])
    labels[1, 17:] = IGNORE_INDEX

    def jloss(p, e):
        return jlm.lm_loss(jcfg.lm, p, e, jnp.asarray(labels), jnp.asarray(am),
                           dtype=jnp.float32, loss_chunk=loss_chunk)

    ref, (gp, ge) = jax.value_and_grad(jloss, argnums=(0, 1))(jparams["lm"], jnp.asarray(emb))
    tp = to_torch(jparams["lm"])
    for x in tree_leaves(tp):
        x.requires_grad_()
    e = t(emb).requires_grad_()
    loss = tlm.lm_loss(tcfg.lm, tp, e, t(labels), t(am), dtype=torch.float32,
                       loss_chunk=loss_chunk)
    loss.backward()
    close(loss, ref)
    close(e.grad, ge)
    close(tp["lm_head"]["w"].grad, gp["lm_head"]["w"])
    close(tp["layers"]["q_proj"]["w"].grad, gp["layers"]["q_proj"]["w"])


# ---------------------------------------------------------------------------
# Multimodal loss
# ---------------------------------------------------------------------------


def test_tdc_loss_and_grads(jparams):
    """tdc_loss with remat (checkpointed SVA chunks, compression, Q-Former
    and LM layers) and a chunked CE: value and every gradient leaf."""
    jcfg, tcfg = _cfgs()
    b = _batch(jcfg)
    kw = dict(max_len=48, max_visual_len=24, remat=True, loss_chunk=7)
    ref, grads = jax.value_and_grad(
        lambda p: jm.tdc_loss(jcfg, p, {k: jnp.asarray(v) for k, v in b.items()}, **kw))(jparams)
    tp = to_torch(jparams)
    for x in tree_leaves(tp):
        x.requires_grad_()
    loss = tm.tdc_loss(tcfg, tp, {k: t(v) for k, v in b.items()}, **kw)
    loss.backward()
    close(loss, ref)
    port = _port_by_names(tp)
    nonzero = 0
    for names, g in _jax_leaves_with_names(grads):
        x = port[tuple(names)]
        got = x.grad if x.grad is not None else torch.zeros_like(x)
        close(got, g)
        nonzero += bool(np.abs(np.asarray(g)).max() > 0)
    assert nonzero > 100  # towers, SVA, compressor and LM all receive gradients


def _audio_batch(cfg, source, B=2, T=4):
    """_batch plus the audio keys: precomputed per-frame `audio_tokens`, or
    one raw 10-s window per sample with its mask and second groups (frames
    at seconds 0, 2, 5, 7 of sample 0 and 0, 1, 2, 6 of sample 1; sample
    1's audio ends at 8 s)."""
    b = _batch(cfg, B=B, T=T)
    rng = np.random.default_rng(7)
    if source == "tokens":
        b["audio_tokens"] = rng.normal(0, 1, (B, T, 50, cfg.lm.hidden_size)).astype(np.float32)
        return b
    x = np.arange(160000) / 16000
    wins = np.stack([0.3 * np.sin(2 * np.pi * f0 * x) + 0.05 * rng.normal(size=x.shape)
                     for f0 in (440.0, 700.0)]).astype(np.float32)[:, None]
    wmask = np.ones(wins.shape, bool)
    wins[1, 0, 128000:], wmask[1, 0, 128000:] = 0.0, False
    groups = []
    for secs in ([0, 2, 5, 7], [0, 1, 2, 6]):
        keep = np.zeros(10, np.int64)
        keep[secs] = 1
        groups.append(jaudio.second_groups(keep))
    b.update(audio_windows=wins, audio_wmask=wmask,
             audio_frame_of_sec=np.stack([g[0] for g in groups]),
             audio_group_pos=np.stack([g[1] for g in groups]),
             audio_group_size=np.stack([g[2] for g in groups]),
             audio_sec_valid=np.stack([np.ones(10, bool), np.arange(10) < 8]))
    return b


@pytest.mark.parametrize("source", ["tokens", "windows"])
def test_tdc_loss_audio_and_grads(source):
    """tdc_loss on tdc_tiny(audio=True) with the audio keys, at 3e-4: with
    precomputed audio_tokens, the loss and its gradient with respect to
    those tokens; with raw audio_windows encoded in the graph (fbank,
    BEATs, pooling, audio_proj; checkpointed per sample under remat), the
    loss and the gradients of audio_proj and of every BEATs leaf."""
    jcfg = dataclasses.replace(jc.tdc_tiny(audio=True), compress_dtype=jnp.float32)
    tcfg = dataclasses.replace(tc.tdc_tiny(audio=True), compress_dtype=torch.float32)
    jp = jm.init_tdc(jax.random.PRNGKey(5), jcfg)
    b = _audio_batch(jcfg, source)
    fixed = {k: v for k, v in b.items() if k != "audio_tokens"}
    free = {k: v for k, v in b.items() if k == "audio_tokens"}
    kw = dict(max_len=24 + 160, max_visual_len=160, remat=True)

    def jloss(p, x):
        return jm.tdc_loss(jcfg, p, {**{k: jnp.asarray(v) for k, v in fixed.items()}, **x}, **kw)

    ref, (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, {k: jnp.asarray(v) for k, v in free.items()})
    tp = to_torch(jp)
    for x in tree_leaves(tp):
        x.requires_grad_()
    tfree = {k: t(v).requires_grad_() for k, v in free.items()}
    loss = tm.tdc_loss(tcfg, tp, {**{k: t(v) for k, v in fixed.items()}, **tfree}, **kw)
    loss.backward()
    close(loss, ref)
    if source == "tokens":
        close(tfree["audio_tokens"].grad, gx["audio_tokens"])
        assert np.abs(np.asarray(gx["audio_tokens"])).max() > 0
        return
    port = _port_by_names(tp)
    n = 0
    for names, g in _jax_leaves_with_names(gp):
        if names[0] in ("audio_proj", "beats"):
            close(port[tuple(names)].grad, g)
            n += 1
    assert n == 2 + len(jax.tree_util.tree_leaves(jp["beats"]))
    assert np.abs(np.asarray(gp["audio_proj"]["w"])).max() > 0


# ---------------------------------------------------------------------------
# Freeze policy, optimizer groups, schedule
# ---------------------------------------------------------------------------

_FREEZE_FLAGS = [
    {},
    {"freeze_backbone": True},
    {"tune_mm_mlp_adapter": True},
    {"freeze_mm_mlp_adapter": True},
    {"unfreeze_mm_vision_tower": True},
    {"unfreeze_mm_compressor": False},
    {"unfreeze_audio_encoder": True},
    {"lora_enable": True},
    {"mm_projector_lr": 1e-4, "mm_vision_tower_lr": 2e-5, "unfreeze_mm_vision_tower": True},
    {"mm_vision_sampler_lr": 3e-5},
]


def _presets():
    return [(getattr(jstages, n)(), getattr(tstages, n)())
            for n in ("stage1_image_align", "stage2_video_sft", "stage3_audio_lora")]


@pytest.mark.parametrize("which", range(len(_FREEZE_FLAGS) + 3))
def test_trainable_mask_and_labels(jparams, which):
    """The trainable mask and each leaf's optimizer label ("frozen" or
    group:wd/nd), for the default config, each freeze flag and each preset."""
    if which < len(_FREEZE_FLAGS):
        flags = _FREEZE_FLAGS[which]
        jt, tt = jtr.TrainConfig(**flags), ttr.TrainConfig(**flags)
    else:
        jt, tt = _presets()[which - len(_FREEZE_FLAGS)]
    assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
    tp = to_torch(jparams)
    jmask = jtr.trainable_mask(jparams, jt)
    tmask = ttr.trainable_mask(tp, tt)
    tlabels = _port_by_names(ttr.opt_labels(tp, tmask, tt))
    tflags = _port_by_names(tmask)
    for (names, m), (_, _) in zip(_jax_leaves_with_names(jmask), _jax_leaves_with_names(jparams)):
        assert tflags[tuple(names)] == m, names
        want = "frozen" if not m else (
            f"{jtr.lr_group(names, jt)}:{'nd' if jtr._no_decay(names) else 'wd'}")
        assert tlabels[tuple(names)] == want, names


@pytest.mark.parametrize("kind,total,warmup_ratio", [("cosine", 2, 0.03), ("cosine", 40, 0.1),
                                                     ("linear", 40, 0.1), ("linear", 3, 0.5)])
def test_make_schedule_matches_optax(kind, total, warmup_ratio):
    kw = dict(lr_scheduler_type=kind, warmup_ratio=warmup_ratio)
    js = jtr.make_schedule(jtr.TrainConfig(**kw), total, 5e-6)
    ts = ttr.make_schedule(ttr.TrainConfig(**kw), total, 5e-6)
    assert ts(0) == 0.0  # a warmup from 0: the first update is a no-op
    for count in range(total + 3):
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-6, atol=1e-12)


def test_clip_then_adamw_matches_optax():
    """One GroupedAdamW update against optax's clip_by_global_norm + adamw
    at a gradient norm above the clip (the scaled branch) and below it."""
    from tdc_video_tpu_torch.train.step import GroupedAdamW

    rng = np.random.default_rng(3)
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in ((4, 5), (7,))]
    for gscale in (10.0, 0.01):
        gs = [[gscale * rng.normal(0, 1, x.shape).astype(np.float32) for x in p0] for _ in range(3)]
        tx = optax.chain(optax.clip_by_global_norm(1.0),
                         optax.adamw(lambda c: 1e-2 * (c + 1), weight_decay=0.1))
        jp = [jnp.asarray(x) for x in p0]
        state = tx.init(jp)
        tp = [t(x) for x in p0]
        opt = GroupedAdamW({"g": (tp, 0.1, lambda c: 1e-2 * (c + 1))}, 1.0)
        for g in gs:
            upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
            jp = optax.apply_updates(jp, upd)
            for x, gx in zip(tp, g):
                x.grad.copy_(t(gx))
            opt.step()
        for a, b in zip(tp, jp):
            close(a, b, atol=1e-6, rtol=1e-6)


def _assert_params_close(got_tree, want_tree, before, lr):
    """Adam moves an element by at most ~lr an update, and an element whose
    gradient is rounding noise (the k-projection bias: softmax is invariant
    to a shift of a query's scores, so its exact gradient is 0) can move by
    a different fraction of lr in each framework: every element within
    2 lr, all but 1e-4 of them within 1e-2 lr (gradients agree to
    ~1e-6 relative elsewhere); the same leaves move, frozen towers stay
    bitwise unchanged."""
    port = _port_by_names(got_tree)
    n_far = n_all = 0
    for names, leaf in _jax_leaves_with_names(want_tree):
        key = tuple(names)
        got, want, start = port[key].detach().numpy(), np.asarray(leaf), before[key].numpy()
        np.testing.assert_allclose(got, want, atol=2 * lr, rtol=0, err_msg=str(names))
        n_far += int((np.abs(got - want) > 1e-2 * lr).sum())
        n_all += got.size
        assert np.array_equal(got, start) == np.array_equal(want, start), names
        if names[0] in ("siglip", "dino"):
            assert np.array_equal(got, start), names
    assert n_far <= 1e-4 * n_all


def test_make_train_step_matches_jax(jparams):
    """make_optimizer (clip, AdamW with decay, the default freeze mask) and
    make_train_step: 2 steps on 2 batches against the JAX step (as
    __graft_entry__.py drives it): per-step losses within 3e-4, params
    as _assert_params_close holds them."""
    from tdc_video_tpu.train import step as jstep
    from tdc_video_tpu_torch.train import step as tstep

    jcfg, tcfg = _cfgs()
    lr = 1e-3
    kw = dict(max_len=48, max_visual_len=24, attn_impl="xla", remat=True)
    tp = to_torch(jparams)
    before = {k: v.detach().clone() for k, v in _port_by_names(tp).items()}
    jtx = jstep.make_optimizer(learning_rate=lr, weight_decay=0.01,
                               trainable_mask=jtr.trainable_mask(jparams, jtr.TrainConfig()))
    jfn = jax.jit(jstep.make_train_step(jcfg, jtx, **kw))
    ttx = tstep.make_optimizer(tp, learning_rate=lr, weight_decay=0.01,
                               trainable_mask=ttr.trainable_mask(tp, ttr.TrainConfig()))
    tfn = tstep.make_train_step(tcfg, ttx, **kw)
    jp, state = jax.tree_util.tree_map(jnp.copy, jparams), None
    state = jtx.init(jp)
    for i in range(2):
        batch = _batch(jcfg, seed=20 + i)
        jp, state, ref = jfn(jp, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out = tfn(tp, {k: t(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(out), float(ref), atol=3e-4, rtol=3e-4)
    assert ttx.count == 2
    _assert_params_close(tp, jp, before, lr)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


def test_trainer_three_steps_match_jax(jparams, tmp_path):
    """3 optimizer steps with gradient_accumulation_steps=2 (6 micro-steps,
    a different batch each) against the JAX Trainer: per-micro-step losses
    within 3e-4, and the params within tolerances stated from lr
    (_assert_params_close)."""
    jcfg, tcfg = _cfgs()
    lr = 1e-3
    kw = dict(learning_rate=lr, gradient_accumulation_steps=2, model_max_length=48,
              max_visual_len=24, warmup_ratio=0.3, report_to="none", output_dir=str(tmp_path))
    tp = to_torch(jparams)
    before = {k: v.detach().clone() for k, v in _port_by_names(tp).items()}
    jtrainer = jtr.Trainer(jcfg, jtr.TrainConfig(**kw), jax.tree_util.tree_map(jnp.copy, jparams),
                           total_steps=3, mesh=make_mesh(1, 1))
    ttrainer = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), tp, total_steps=3, device="cpu")
    for i in range(6):
        batch = _batch(jcfg, seed=10 + i)
        ref = float(jtrainer.train_step(batch))
        out = float(ttrainer.train_step(batch))
        np.testing.assert_allclose(out, ref, atol=3e-4, rtol=3e-4)
    assert ttrainer.tx.count == 3 and ttrainer.step == 6
    _assert_params_close(ttrainer.params, jtrainer.params, before, lr)
