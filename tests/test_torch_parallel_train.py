"""Training over a mesh (parallel/autograd.py and the mesh paths of
models/layers.py, models/lm.py, model.py, train/step.py and
train/trainer.py) on gloo ranks of tdc_tiny in f32: one launch of two ranks
(1x2 and 2x1 meshes) and one of four (2x2), each rank its own process
(tests/torch_parallel_worker.py, modes "train" and "train22"), against the
one-process port and JAX on the same weights and global batches:

* the collectives with gradients, each against its one-process meaning;
* tdc_loss's value and every gradient, gathered whole after the trainer's
  sync, against JAX's unsharded jax.value_and_grad at 1x2, 2x1 (FSDP: one
  layer a rank) and 2x2 (JAX's TestShardedParity);
* Trainer full fine-tuning, 3 optimizer steps of 2 micro-steps with a clip
  that bites, at 1x2 and 2x1: the losses and the parameters against the
  one-process trainer's;
* stage-3 LoRA with audio at 1x2 and 2x2, with JAX's
  TestStage3AudioLoRAMesh invariants (the LM bitwise unchanged, B moved,
  BEATs frozen, audio_proj moved), and QLoRA at 1x2 and 2x2;
* a batch of one sample on a data axis of 2: the padded rank's rows are
  loss-inert (the one-process run of the same sample);
* a one-process checkpoint restored over 2x1 bitwise, export_merged equal
  to the one-process export bitwise, and the mesh's checkpoint restored by
  a one-process trainer bitwise;
* encode_frames(mesh=2x1, remat=True): the features and the SVA's
  gradients (summed over `data`) are one process's.

A mesh run is held to the port's one-process run at JAX's mesh tolerance
(rtol 2e-4, tests/test_parallel.py:72; parameters after AdamW updates also
within 1e-2 of the learning rate, UPDATE_ATOL); gradients against JAX at
rtol 2e-4 and the golden suite's f32 atol 3e-4.  The JAX references run under
jax.jit while the ranks run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jm
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch import model as tm
from tdc_video_tpu_torch.train.trainer import TrainConfig, Trainer
from test_torch_train import _batch
from torch_parallel_worker import Launch, clone_tree, whole_state
from torch_parity import close, to_jax

MESH_RTOL = 2e-4  # the JAX mesh tests' tolerance (tests/test_parallel.py:72)
MESH_ATOL = 1e-6
# parameters after AdamW updates at learning rate 1e-3: Adam scales each
# update to ~lr whatever the gradient's size, so a gradient component that
# is rounding noise (summed in another order over the ranks) moves its
# parameter by up to ~lr either way; 1e-2 lr, as tests/test_torch_train.py
# holds the port's updates to JAX's
UPDATE_ATOL = 1e-5
JAX_ATOL = 3e-4  # the golden suite's f32 tolerance, beside MESH_RTOL
LEN = {"model_max_length": 48, "max_visual_len": 24}


def _cfgs(audio=False):
    return (dataclasses.replace(jc.tdc_tiny(audio=audio), compress_dtype=jnp.float32),
            dataclasses.replace(tc.tdc_tiny(audio=audio), compress_dtype=torch.float32))


def _audio_batch(cfg, B=4, T=4, L=24, seed=0):
    """tests/test_parallel.py TestStage3AudioLoRAMesh's batch: two raw 10-s
    windows a sample, two seconds a frame."""
    b = _batch(cfg, B=B, T=T, L=L, seed=seed)
    rng = np.random.default_rng(seed + 100)
    W, S = 2, 20
    b.update({"audio_windows": rng.normal(0, 0.05, (B, W, 160000)).astype(np.float32),
              "audio_wmask": np.ones((B, W, 160000), bool),
              "audio_frame_of_sec": np.clip(np.arange(S) // 2, 0, T - 1)[None].repeat(B, 0)
              .astype(np.int32),
              "audio_group_pos": (np.arange(S) % 2)[None].repeat(B, 0).astype(np.int32),
              "audio_group_size": np.full((B, T), 2, np.int32),
              "audio_sec_valid": np.ones((B, S), bool)})
    return b


def _run(cfg, params, batches, tkw, total, lora=None):
    """One process: train_run's losses, norms and state."""
    tr = Trainer(cfg, TrainConfig(**tkw), clone_tree(params), total_steps=total, device="cpu",
                 lora=clone_tree(lora))
    losses, norms = [], []
    for b in batches:
        losses.append(tr.train_step(b).item())
        if tr._micro == 0:
            norms.append(float(tr.tx.norm))
    return {"losses": losses, "norms": norms, "state": whole_state(tr), "trainer": tr}


def _jax_loss_and_grads(jcfg, jparams, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jm.tdc_loss(
        jcfg, p, b, max_len=LEN["model_max_length"], max_visual_len=LEN["max_visual_len"],
        remat=True, loss_chunk=7)))
    loss, grads = fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    flat = {}
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        names = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        flat["params/" + "/".join(names)] = np.asarray(g)
    return float(loss), flat


def _held_state(got, want, rtol=MESH_RTOL, atol=UPDATE_ATOL, exact=()):
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        if any(name.startswith(p) for p in exact):
            assert torch.equal(got[name], ref), name
        else:
            close(got[name], ref.float().numpy() if ref.is_floating_point() else ref.numpy(),
                  atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_mesh")
    jcfg, cfg = _cfgs()
    jcfga, cfga = _cfgs(audio=True)
    params = tm.init_tdc(cfg, torch.Generator().manual_seed(0), "cpu")
    params_a = tm.init_tdc(cfga, torch.Generator().manual_seed(1), "cpu")
    base = {"report_to": "none", "output_dir": str(root / "unused")}
    lora = dict(base, learning_rate=1e-3, lora_enable=True, lora_r=4, lora_alpha=8,
                gradient_accumulation_steps=1)
    inp = {
        "tdc": params, "tdc_audio": params_a,
        "batch": _batch(cfg, B=2, seed=3),
        "grads_kw": dict(base, unfreeze_mm_vision_tower=True, unfreeze_audio_encoder=True,
                         loss_chunk=7, **LEN),
        # the clip at 0.05 bites at every update (the global norms are ~1)
        "full_kw": dict(base, learning_rate=1e-3, grad_clip=0.05, gradient_accumulation_steps=2,
                        **LEN),
        "full_batches": [_batch(cfg, B=2, seed=10 + i) for i in range(6)],
        "full_total": 3,
        "lora_kw": dict(lora, model_max_length=512, max_visual_len=400),
        "audio_batches": [_audio_batch(cfga, seed=k) for k in range(2)],
        "lora_total": 3,
        "qlora_kw": dict(lora, quantize_frozen="int8", **LEN),
        "pad_kw": dict(base, learning_rate=1e-3, gradient_accumulation_steps=1, **LEN),
        "pad_batches": [_batch(cfg, B=1, seed=20 + i) for i in range(2)],
        "ckpt_kw": dict(lora, output_dir=str(root / "ckpt_one"), **LEN),
        "ckpt_out": str(root / "ckpt_mesh"),
        "feat_w": None,
    }
    rng = np.random.default_rng(5)
    s, d = cfg.siglip.image_size, cfg.dino.image_size
    inp["sig"] = torch.from_numpy(rng.normal(0, 1, (4, s, s, 3)).astype(np.float32))
    inp["dino"] = torch.from_numpy(rng.normal(0, 1, (4, d, d, 3)).astype(np.float32))
    feats, _ = tm.encode_frames(cfg, params, inp["sig"], inp["dino"])
    inp["feat_w"] = torch.from_numpy(rng.normal(0, 1, tuple(feats.shape)).astype(np.float32))
    # the one-process checkpoint the ranks restore (2 LoRA steps, B moved)
    one = _run(cfg, params, inp["full_batches"][:2], inp["ckpt_kw"], inp["lora_total"])
    one["trainer"].save()
    torch.save(inp, root / "inputs.pt")

    launch = Launch("train", 2, root, wall_s=240.0)
    refs = {"ckpt_one": one}
    refs["jax_grads"] = _jax_loss_and_grads(jcfg, to_jax(params), inp["batch"])
    refs["full"] = _run(cfg, params, inp["full_batches"], inp["full_kw"], inp["full_total"])
    refs["lora"] = _run(cfga, params_a, inp["audio_batches"], inp["lora_kw"], inp["lora_total"])
    refs["qlora"] = _run(cfg, params, inp["full_batches"][:2], inp["qlora_kw"],
                         inp["lora_total"])
    refs["pad"] = _run(cfg, params, inp["pad_batches"], inp["pad_kw"], inp["full_total"])
    p = clone_tree(params)
    for t in [x for _, x in _sva_leaves(p)]:
        t.requires_grad_()
    ff, _ = tm.encode_frames(cfg, p, inp["sig"], inp["dino"], remat=True)
    (ff * inp["feat_w"]).sum().backward()
    refs["encode"] = {"feats": ff.detach(), "sva_grads": {k: t.grad for k, t in _sva_leaves(p)}}
    launch.wait()
    res = launch.results()

    launch22 = Launch("train22", 4, root, wall_s=240.0)
    launch22.wait()
    return {"inp": inp, "refs": refs, "res": res, "res22": launch22.results(), "root": root,
            "cfg": cfg}


def _sva_leaves(params):
    from tdc_video_tpu_torch.train.step import tree_leaves_with_path

    return [("/".join(k), t) for k, t in tree_leaves_with_path(params["sva"])]


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_collectives_with_gradients(setup, mesh):
    for r in setup["res"]:
        for name, (got, want) in r[f"collectives/{mesh}"].items():
            assert torch.equal(got, want) or torch.allclose(got, want, atol=1e-6), (mesh, name)


@pytest.mark.parametrize("mesh", ["1x2", "2x1", "2x2"])
def test_tdc_loss_and_every_gradient_match_jax(setup, mesh):
    res = setup["res22"] if mesh == "2x2" else setup["res"]
    ref_loss, ref_grads = setup["refs"]["jax_grads"]
    got = [r[f"grads/{mesh}"] for r in res]
    assert len({g["loss"] for g in got}) == 1  # every rank the whole batch's loss, bitwise
    np.testing.assert_allclose(got[0]["loss"], ref_loss, rtol=MESH_RTOL)
    grads = got[0]["grads"]
    assert sorted(grads) == sorted(ref_grads)
    nonzero = 0
    for name, g in ref_grads.items():
        close(grads[name], g, atol=JAX_ATOL, rtol=MESH_RTOL)
        nonzero += bool(np.abs(g).max() > 0)
    assert nonzero > 100
    counts = got[0]["counts"]
    if mesh != "2x1":  # TP: the Megatron pairs ran, forward and backward
        assert counts["copy_to_grad"] > 0 and counts["reduce_from"] > 0
    if mesh != "1x2":  # FSDP: each layer broadcast, then its gradient summed to its holder
        assert counts["broadcast"] > 0 and counts["broadcast_grad"] > 0


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_full_finetune_matches_one_process_with_the_clip_biting(setup, mesh):
    ref = setup["refs"]["full"]
    res = [r[f"full/{mesh}"] for r in setup["res"]]
    assert all(r["losses"] == res[0]["losses"] for r in res)
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], rtol=MESH_RTOL)
    assert all(n > setup["inp"]["full_kw"]["grad_clip"] for n in ref["norms"])
    np.testing.assert_allclose(res[0]["norms"], ref["norms"], rtol=MESH_RTOL)
    _held_state(res[0]["state"], ref["state"])
    cfg = setup["cfg"]
    if mesh == "2x1":  # FSDP: one layer a rank
        assert res[0]["lm_local_layers"] == cfg.lm.num_layers // 2
    else:
        assert res[0]["q_cols"] == cfg.lm.q_dim // 2


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_stage3_audio_lora_matches_one_process(setup, mesh):
    ref = setup["refs"]["lora"]
    res = [r[f"lora/{mesh}"] for r in (setup["res22"] if mesh == "2x2" else setup["res"])]
    assert all(r["losses"] == res[0]["losses"] for r in res)
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], rtol=MESH_RTOL)
    got = res[0]["state"]
    _held_state(got, ref["state"])
    init = setup["inp"]["tdc_audio"]
    # JAX's invariants: the LM bitwise unchanged, BEATs frozen, B and audio_proj moved
    from tdc_video_tpu_torch.train.step import tree_leaves_with_path

    for top, same in (("lm", True), ("beats", True), ("audio_proj", False)):
        before = {"params/" + "/".join((top,) + p): t
                  for p, t in tree_leaves_with_path(init[top])}
        moved = [not torch.equal(got[n], t) for n, t in before.items()]
        assert (not any(moved)) if same else any(moved), top
    assert got["lora/layers/q_proj/w/b"].abs().max() > 0


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_qlora_matches_one_process(setup, mesh):
    """QLoRA: the int8 base is quantized before the cut (bitwise the
    one-process base); at 2x2 its column-major int8 layers are broadcast
    over `data` (FSDP)."""
    ref = setup["refs"]["qlora"]
    res = [r[f"qlora/{mesh}"] for r in (setup["res22"] if mesh == "2x2" else setup["res"])]
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], rtol=MESH_RTOL)
    _held_state(res[0]["state"], ref["state"], exact=("params/lm/",))
    assert res[0]["state"]["params/lm/layers/q_proj/w_q"].dtype == torch.int8


def test_a_padded_rank_is_loss_inert(setup):
    """One sample a batch on a data axis of 2: rank 1 holds a padded row
    (labels ignored, no frames); the run is the one-process run."""
    ref = setup["refs"]["pad"]
    res = [r["pad/2x1"] for r in setup["res"]]
    assert all(np.isfinite(res[0]["losses"]))
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], rtol=MESH_RTOL)
    _held_state(res[0]["state"], ref["state"])


def test_checkpoints_cross_between_a_mesh_and_one_process(setup):
    r0 = setup["res"][0]
    one = setup["refs"]["ckpt_one"]
    assert all(r["ckpt/restored"] for r in setup["res"])
    _held_state(r0["ckpt/restored_state"], one["state"], exact=("",))
    # export_merged on rank 0 (None elsewhere), bitwise the one-process export
    assert setup["res"][1]["ckpt/export"] is None
    from tdc_video_tpu_torch.train.step import tree_leaves_with_path

    want = dict(tree_leaves_with_path(one["trainer"].export_merged()))
    got = dict(tree_leaves_with_path(r0["ckpt/export"]))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the mesh's checkpoint (one more step) restored by one process
    kw = dict(setup["inp"]["ckpt_kw"], output_dir=setup["inp"]["ckpt_out"])
    tr = Trainer(setup["cfg"], TrainConfig(**kw), clone_tree(setup["inp"]["tdc"]),
                 total_steps=setup["inp"]["lora_total"], device="cpu")
    assert tr.restore_if_available() and tr.step == 3
    _held_state(whole_state(tr), r0["ckpt/saved_state"], exact=("",))


def test_encode_frames_over_data_has_one_process_gradients(setup):
    ref = setup["refs"]["encode"]
    for r in setup["res"]:
        got = r["encode/2x1"]
        close(got["feats"], ref["feats"].numpy(), atol=2e-5, rtol=MESH_RTOL)
        assert sorted(got["sva_grads"]) == sorted(ref["sva_grads"])
        for k, g in ref["sva_grads"].items():
            # summed over `data` in another order: f32 rounding of the leaf's largest
            scale = max(1.0, float(g.abs().max()))
            close(got["sva_grads"][k], g.numpy(), atol=MESH_ATOL * scale, rtol=MESH_RTOL)
