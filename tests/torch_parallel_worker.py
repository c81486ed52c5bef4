"""One rank of the port's multi-device tests, and the launcher that starts
the ranks (tests/test_torch_parallel_*.py).

Each rank is its own process, on the CPU, with one torch thread: the
launcher sets torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR=127.0.0.1, MASTER_PORT) and the rank joins a gloo group through
parallel.mesh.init_distributed (env://), as under torchrun.  Inputs come
from `<workdir>/inputs.pt`, written by the test with torch.save; each rank
writes what the test compares to `<workdir>/<mode>-rank<r>.pt` and its
output to `<workdir>/log-<mode>-<r>.txt`.  No process group is ever made in
the pytest process.

Modes:
  tp     world 2: cli/serve.main --mesh 1x2 (its own init), warmup, TP
         generate and prefill logits (1x2, f32 and weight-only int8), the
         act-quant prefill with and without the row amax reduce, the TP
         engine (three modes and an int8 KV cache), frames over data (2x1:
         StreamingEncoder and its chunk check)
  tp22   world 4: TP generate and prefill on 2x2; the predictor's answer
         and answer_many
  round  world 3: the predictor on 3x1 (the frame bucket rounded up)
  eval   world 2: run_benchmark data-parallel over the ranks
         (--crash_after K: this rank dies after K answers)
  train  world 2: training over 1x2 and 2x1 meshes: the collectives with
         gradients, tdc_loss's value and gathered gradients, Trainer full
         fine-tuning (the clip biting), stage-3 LoRA with audio, QLoRA,
         a padded batch, checkpoints both ways, export_merged, and
         encode_frames(remat=True) over `data`
  train22 world 4: tdc_loss, stage-3 LoRA with audio and QLoRA on 2x2
  run    world 2: train.run.main with the coordinator flags
  seq    world 2: sequence parallelism (lm_forward(seq_axis="data")) of
         LM_TINY over 2x1, and 2x1 with FSDP's split layers: each rank's
         logits block gathered, and every gradient summed over `data` and
         gathered whole; gather_seq against its one-process meaning
  seq4   world 4: the same over 4x1 and 2x2 (with TP over `model`)

Not a test file (no test_ prefix): pytest does not collect it.
"""

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launch:
    """`world` ranks of `mode`, started at once, each with the launch's wall
    limit: past it, or once any rank has failed (a survivor would wait in a
    collective), the remaining ranks are killed and report -9."""

    def __init__(self, mode, world, workdir, extra=None, wall_s=60.0):
        self.mode, self.world, self.workdir = mode, world, str(workdir)
        port = _free_port()
        self.procs, self.logs = [], []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join([ROOT, HERE]))
            log = open(self._log(r), "w")
            cmd = [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"), mode,
                   "--workdir", self.workdir] + list((extra or {}).get(r, []))
            self.procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                               env=env, cwd=ROOT))
            self.logs.append(log)
        self.deadline = time.monotonic() + wall_s

    def _log(self, r):
        return os.path.join(self.workdir, f"log-{self.mode}-{r}.txt")

    def wait(self, expect_ok=True):
        """The ranks' exit codes; with expect_ok, any non-zero exit raises
        with the tail of each rank's log."""
        rcs = [None] * self.world
        try:
            while any(rc is None for rc in rcs):
                rcs = [p.poll() for p in self.procs]
                if any(rc not in (None, 0) for rc in rcs) or time.monotonic() > self.deadline:
                    for r, p in enumerate(self.procs):
                        if rcs[r] is None:
                            p.send_signal(signal.SIGKILL)
                            p.wait()
                            rcs[r] = -9
                    break
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        if expect_ok and any(rc != 0 for rc in rcs):
            tails = []
            for r in range(self.world):
                with open(self._log(r)) as fh:
                    tails.append(f"--- rank {r} ---\n" + "".join(fh.readlines()[-30:]))
            raise AssertionError(f"{self.mode}: ranks exited {rcs}\n" + "\n".join(tails))
        return rcs

    def results(self):
        """Each rank's saved results, in rank order."""
        import torch

        return [torch.load(os.path.join(self.workdir, f"{self.mode}-rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def launch(mode, world, workdir, extra=None, wall_s=60.0, expect_ok=True):
    """Start the ranks and wait for them: their exit codes."""
    return Launch(mode, world, workdir, extra, wall_s).wait(expect_ok)


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------


def _setup():
    import torch

    torch.set_num_threads(1)
    return torch


def _tiny(torch, f32_compress=True):
    import dataclasses

    from tdc_video_tpu_torch.config import tdc_tiny

    cfg = tdc_tiny()
    return dataclasses.replace(cfg, compress_dtype=torch.float32) if f32_compress else cfg


def _generate(torch, cfg, lm_full, ids, mesh, quantize):
    """Greedy tokens and prefill logits of the TP LM on this rank's shard."""
    from tdc_video_tpu_torch.models import lm as lm_mod
    from tdc_video_tpu_torch.models.quant import quantize_lm_int8
    from tdc_video_tpu_torch.parallel.sharding import lm_param_spec, shard_tree
    from tdc_video_tpu_torch.serving.generate import generate_text_only

    full = quantize_lm_int8(lm_full) if quantize else lm_full
    lm = shard_tree(full, lm_param_spec(full), mesh)
    mask = torch.ones(ids.shape, dtype=torch.bool)
    toks = generate_text_only(cfg, {"lm": lm}, ids, mask, max_new_tokens=8, mesh=mesh)
    emb = lm_mod.embed_tokens(cfg.lm, lm, ids, cfg.dtype, mesh)
    cache = lm_mod.init_kv_cache(cfg.lm, 1, ids.shape[1], cfg.dtype, "cpu", mesh=mesh)
    logits, _ = lm_mod.prefill(cfg.lm, lm, emb, mask, cache, dtype=cfg.dtype, mesh=mesh)
    q = lm["layers"]["q_proj"]
    return {"tokens": toks, "logits": logits, "q_cols": q["w_q" if quantize else "w"].shape[-1]}


def _act_quant(torch, cfg, lm_full, ids, mesh):
    """Act-quant prefill logits of the int8 LM over the mesh, with the row
    amax reduce and with each rank's own amax in its place."""
    from tdc_video_tpu_torch.models import layers
    from tdc_video_tpu_torch.models import lm as lm_mod
    from tdc_video_tpu_torch.models.quant import quantize_lm_int8
    from tdc_video_tpu_torch.parallel.sharding import lm_param_spec, shard_tree

    full = quantize_lm_int8(lm_full)
    lm = shard_tree(full, lm_param_spec(full), mesh)
    mask = torch.ones(ids.shape, dtype=torch.bool)

    def prefill():
        emb = lm_mod.embed_tokens(cfg.lm, lm, ids, cfg.dtype, mesh)
        cache = lm_mod.init_kv_cache(cfg.lm, 1, ids.shape[1], cfg.dtype, "cpu", mesh=mesh)
        return lm_mod.prefill(cfg.lm, lm, emb, mask, cache, dtype=cfg.dtype, act_quant=True,
                              mesh=mesh)[0]

    with_reduce = prefill()
    real = layers.row_amax
    layers.row_amax = lambda x, _mesh: x.float().abs().amax(dim=-1, keepdim=True)
    try:
        without = prefill()
    finally:
        layers.row_amax = real
    return {"with_reduce": with_reduce, "without_reduce": without}


def _engine(torch, cfg, lm_full, cases, mesh):
    """The TP engine's tokens per uid in each case, and the heads of its
    cache."""
    from tdc_video_tpu_torch.models import lm as lm_mod
    from tdc_video_tpu_torch.parallel.sharding import lm_param_spec, shard_tree
    from tdc_video_tpu_torch.serving.batching import DecodeEngine, Request

    lm = shard_tree(lm_full, lm_param_spec(lm_full), mesh)
    out = {}
    for name, case in cases.items():
        eng = DecodeEngine(cfg, {"lm": lm}, mesh=mesh, **case["engine"])
        for ids in case["prompts"]:
            t = torch.as_tensor(ids, dtype=torch.int64)[None]
            emb = lm_mod.embed_tokens(cfg.lm, lm, t, cfg.dtype, mesh)
            eng.submit(Request(embeds=emb, attn_mask=torch.ones(t.shape, dtype=torch.bool),
                               max_new_tokens=10, uid=tuple(int(i) for i in ids),
                               prompt_ids=ids if case["engine"].get("spec_window") else None))
        out[name] = {r.uid: list(r.tokens) for r in eng.run()}
        out[name + "/kv_heads"] = eng.cache["k"].shape[3]
    return out


def _predict(torch, inp, mesh):
    from tdc_video_tpu_torch.eval.runner import TDCPredictor
    from torch_stub_tokenizer import StubTokenizer

    pred = TDCPredictor(_tiny(torch), inp["tdc"], StubTokenizer(), max_new_tokens=4,
                        text_bucket=128, mesh=mesh)
    frames, qs = inp["frames"], inp["questions"]
    solo = pred.answer(frames, qs[0], video_uid="v")
    many = pred.answer_many(frames, qs, video_uid="v", num_slots=2)
    ff, _, fmask, T = pred._feat_cache[1]
    return {"answer": solo, "answer_many": many, "T": T, "valid_frames": int(fmask.sum()),
            "feat_frames": ff.shape[0],
            "q_cols": pred.params["lm"]["layers"]["q_proj"]["w"].shape[-1]}


def _serve(torch, inp, workdir):
    """cli/serve.main --mesh 1x2 over the checkpoint (loaded in f32 with an
    f32 compressor) and frames standing in for the decoded video; its own
    init_distributed joins the group.  Returns the answers."""
    import contextlib
    import io

    from tdc_video_tpu_torch.cli import serve
    from torch_stub_tokenizer import StubTokenizer

    for (mod, name), fn in serve_patches(inp["serve_frames"]).items():
        setattr(mod, name, fn)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve.run(serve.parse_args(inp["serve_argv"] + ["--mesh", "1x2"]),
                        tokenizer=StubTokenizer())
    return {"answers": out["answers"], "ids": out["ids"], "stdout": buf.getvalue()}


def serve_patches(frames):
    """{(module, name): replacement}: the port's loader in f32 with an f32
    compressor, and decode_video returning `frames` (one a second).  What
    the serve tests run the CLI on, in the pytest process (monkeypatch) and
    in each rank."""
    import dataclasses

    import numpy as np
    import torch

    from tdc_video_tpu_torch import builder
    from tdc_video_tpu_torch.media import io as media_io

    real = builder.load_pretrained_model

    def load(*a, **k):
        tok, m, pre, ctx = real(*a, **dict(k, dtype=torch.float32, load_tokenizer=False))
        cfg = dataclasses.replace(m.cfg, compress_dtype=torch.float32)
        return tok, builder.TDCModel(cfg, m.params), pre, ctx

    def decode_video(path, fps=1.0, max_frames=1000, **kw):
        n = min(len(frames), max_frames)
        return frames[:n], np.arange(n, dtype=np.float64)

    return {(builder, "load_pretrained_model"): load, (media_io, "decode_video"): decode_video}


def run_tp(torch, inp, workdir):
    from tdc_video_tpu_torch.parallel.mesh import make_mesh, warmup_collectives
    from tdc_video_tpu_torch.serving.streaming import StreamingEncoder

    res = {"serve": _serve(torch, inp, workdir)}  # the CLI joins the group first
    cfg = _tiny(torch)
    res["mesh_raises"] = []
    for shape, kw in (((2, 2), {}), ((1, 2), {"num_kv_heads": 3})):
        try:  # a mesh of the wrong size, a model axis that splits a KV head
            make_mesh(*shape, device="cpu", **kw)
            res["mesh_raises"].append(False)
        except ValueError:
            res["mesh_raises"].append(True)
    mesh = make_mesh(1, 2, device="cpu", num_kv_heads=cfg.lm.num_kv_heads)
    warmup_collectives(mesh)
    lm_full, ids = inp["tdc"]["lm"], inp["ids"]
    res["float"] = _generate(torch, cfg, lm_full, ids, mesh, quantize=False)
    res["int8"] = _generate(torch, cfg, lm_full, ids, mesh, quantize=True)
    res["act_quant"] = _act_quant(torch, cfg, lm_full, ids, mesh)
    res["engine"] = _engine(torch, cfg, lm_full, inp["engine_cases"], mesh)
    mesh21 = make_mesh(2, 1, device="cpu")
    warmup_collectives(mesh21)
    enc = StreamingEncoder(cfg, inp["tdc"], chunk_frames=8, device_prep=False, mesh=mesh21)
    res["encode"] = enc._encode(inp["sig"], inp["dino"])
    try:
        StreamingEncoder(cfg, inp["tdc"], chunk_frames=7, mesh=mesh21)
        res["chunk_raises"] = False
    except ValueError:
        res["chunk_raises"] = True
    return res


def run_tp22(torch, inp, workdir):
    from tdc_video_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(device="cpu", timeout_s=60)
    cfg = _tiny(torch)
    mesh = make_mesh(2, 2, device="cpu", num_kv_heads=cfg.lm.num_kv_heads)
    res = {"float": _generate(torch, cfg, inp["tdc"]["lm"], inp["ids"], mesh, quantize=False),
           "int8": _generate(torch, cfg, inp["tdc"]["lm"], inp["ids"], mesh, quantize=True)}
    res["predict"] = _predict(torch, inp, mesh)
    return res


def run_round(torch, inp, workdir):
    from tdc_video_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(device="cpu", timeout_s=60)
    return {"predict": _predict(torch, inp, make_mesh(3, 1, device="cpu"))}


def run_eval(torch, inp, workdir, crash_after=-1):
    import dataclasses

    from tdc_video_tpu_torch import builder
    from tdc_video_tpu_torch.eval import harness
    from tdc_video_tpu_torch.eval.runner import TDCPredictor
    from tdc_video_tpu_torch.parallel.mesh import init_distributed
    from torch_stub_tokenizer import StubTokenizer

    init_distributed(device="cpu", timeout_s=60)
    _, m, _, _ = builder.load_pretrained_model(inp["ckpt"], load_tokenizer=False,
                                               dtype=torch.float32, device="cpu")
    cfg = dataclasses.replace(m.cfg, compress_dtype=torch.float32)
    pred = TDCPredictor(cfg, m.params, StubTokenizer(), max_new_tokens=3, text_bucket=128,
                        device="cpu")
    if crash_after >= 0:
        real = pred.answer
        state = {"n": 0}

        def crashing(*a, **kw):
            if state["n"] >= crash_after:
                print(f"injected crash after {state['n']} answers", flush=True)
                os._exit(3)  # no log clean-up, no gather
            state["n"] += 1
            return real(*a, **kw)

        pred.answer = crashing
    metrics = harness.run_benchmark("mlvu", pred, inp["samples"], out_dir=inp["out_dir"])
    return {"metrics": metrics, "answered": pred.stats.samples,
            "world": torch.distributed.get_world_size()}


# ---------------------------------------------------------------------------
# Training over a mesh (tests/test_torch_parallel_train.py, test_torch_train_run_mp.py)
# ---------------------------------------------------------------------------


def clone_tree(tree):
    """A copy of a param tree (each Trainer takes its tree over)."""
    import torch

    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def whole_state(tr):
    """The trainer's checkpointed leaves by name, whole (collective: every
    rank calls it; only rank 0's is kept)."""
    out = {name: tr._whole(t, spec).detach().clone() for name, t, spec in tr._named()}
    return out if tr.rank == 0 else None


def train_run(cfg, params, batches, mesh, tkw, total, lora=None):
    """A Trainer over `mesh` on `batches` (one micro-step each): the losses,
    the clip's norms, and the whole state after (rank 0)."""
    from tdc_video_tpu_torch.train.trainer import TrainConfig, Trainer

    tr = Trainer(cfg, TrainConfig(**tkw), clone_tree(params), total_steps=total, mesh=mesh,
                 lora=clone_tree(lora))
    losses, norms = [], []
    for b in batches:
        losses.append(tr.train_step(b).item())
        if tr._micro == 0:
            norms.append(float(tr.tx.norm))
    return {"losses": losses, "norms": norms, "state": whole_state(tr),
            "lm_local_layers": tr.params["lm"]["layers"]["input_norm"]["scale"].shape[0],
            "q_cols": tr.params["lm"]["layers"]["q_proj"][
                "w_q" if "w_q" in tr.params["lm"]["layers"]["q_proj"] else "w"].shape[-1]}


def loss_and_grads(cfg, params, batch, mesh, tkw):
    """tdc_loss of the whole batch over `mesh` (every leaf trainable) and
    every gradient after the trainer's sync, gathered whole (rank 0)."""
    from tdc_video_tpu_torch.parallel import autograd
    from tdc_video_tpu_torch.train.trainer import TrainConfig, Trainer

    tr = Trainer(cfg, TrainConfig(**tkw), clone_tree(params), total_steps=1, mesh=mesh)
    autograd.reset_counts()
    loss = tr._loss_fn(tr._to_device(tr._share(tr._pad_batch(batch))))
    loss.backward()
    tr._sync_grads()
    grads = {name: tr._whole(t.grad, spec) for name, t, spec in tr._named()}
    return {"loss": loss.item(), "grads": grads if tr.rank == 0 else None,
            "counts": dict(autograd.counts)}


def collectives_check(torch, mesh):
    """Each Function of parallel/autograd against its one-process meaning,
    on data made from the rank's coordinates: (forward, gradients) pairs."""
    from tdc_video_tpu_torch.parallel import autograd as ag
    from tdc_video_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    axis = MODEL_AXIS if mesh.size(MODEL_AXIS) > 1 else DATA_AXIS
    n, c = mesh.size(axis), mesh.coords[axis]
    g = torch.Generator().manual_seed(7)
    xs = [torch.randn(3, 4, generator=g) for _ in range(n)]  # rank r's input is xs[r]
    w = torch.randn(3, 4, generator=g)  # the loss's weights, the same on every rank
    out = {}
    # copy_to: y = x (whole on every rank); each rank's loss part (y * w * (c+1)).sum();
    # the gradient of x is the sum of every part's: w * sum(r+1)
    x = xs[0].clone().requires_grad_()
    (ag.copy_to(x, mesh, axis) * w * (c + 1)).sum().backward()
    out["copy_to"] = (x.grad, w * sum(r + 1 for r in range(n)))
    # reduce_from: forward the sum of xs; backward the gradient as it is
    x = xs[c].clone().requires_grad_()
    y = ag.reduce_from(x, mesh, axis)
    (y * w).sum().backward()
    out["reduce_from"] = (torch.stack([y.detach(), x.grad]), torch.stack([sum(xs), w]))
    # gather_from: forward the concatenation; backward this rank's rows of w_all
    w_all = torch.randn(3 * n, 4, generator=g)
    x = xs[c].clone().requires_grad_()
    y = ag.gather_from(x, mesh, axis)
    (y * w_all).sum().backward()
    out["gather_from"] = (torch.cat([y.detach(), x.grad]),
                          torch.cat([torch.cat(xs), w_all[3 * c:3 * (c + 1)]]))
    # broadcast_from: rank n-1's x on every rank; its gradient the sum of
    # every rank's (y * w * (r+1)), none elsewhere
    src = n - 1
    x = (xs[c] if c == src else torch.zeros(3, 4)).clone().requires_grad_()
    y = ag.broadcast_from(x, mesh, axis, src)
    (y * w * (c + 1)).sum().backward()
    want = w * sum(r + 1 for r in range(n)) if c == src else torch.zeros(3, 4)
    got = x.grad if x.grad is not None else torch.zeros(3, 4)
    out["broadcast_from"] = (torch.stack([y.detach(), got]), torch.stack([xs[src], want]))
    return out


def encode_grads(torch, cfg, params, sig, dino, w, mesh):
    """encode_frames(remat=True) over `mesh`'s data axis: the features and
    the SVA's gradients of (features * w).sum(), summed over `data`."""
    from tdc_video_tpu_torch.model import encode_frames
    from tdc_video_tpu_torch.parallel.mesh import DATA_AXIS
    from tdc_video_tpu_torch.train.step import tree_leaves_with_path

    p = clone_tree(params)
    sva = tree_leaves_with_path(p["sva"])
    for _, t in sva:
        t.requires_grad_()
    ff, _ = encode_frames(cfg, p, sig, dino, remat=True, mesh=mesh)
    (ff * w).sum().backward()
    grads = {"/".join(k): mesh.all_reduce(t.grad.contiguous(), DATA_AXIS) for k, t in sva}
    return {"feats": ff.detach(), "sva_grads": grads}


def run_train(torch, inp, workdir):
    import dataclasses

    from tdc_video_tpu_torch.config import tdc_tiny
    from tdc_video_tpu_torch.parallel.mesh import init_distributed, make_mesh, warmup_collectives
    from tdc_video_tpu_torch.train.trainer import TrainConfig, Trainer

    init_distributed(device="cpu", timeout_s=120)
    cfg, cfga = _tiny(torch), dataclasses.replace(tdc_tiny(audio=True),
                                                  compress_dtype=torch.float32)
    res = {}
    meshes = {"1x2": make_mesh(1, 2, device="cpu", num_kv_heads=cfg.lm.num_kv_heads),
              "2x1": make_mesh(2, 1, device="cpu")}
    for tag, mesh in meshes.items():
        warmup_collectives(mesh)
        res[f"collectives/{tag}"] = collectives_check(torch, mesh)
        res[f"grads/{tag}"] = loss_and_grads(cfg, inp["tdc"], inp["batch"], mesh, inp["grads_kw"])
        res[f"full/{tag}"] = train_run(cfg, inp["tdc"], inp["full_batches"], mesh,
                                       inp["full_kw"], inp["full_total"])
    m12, m21 = meshes["1x2"], meshes["2x1"]
    res["lora/1x2"] = train_run(cfga, inp["tdc_audio"], inp["audio_batches"], m12,
                                inp["lora_kw"], inp["lora_total"])
    res["qlora/1x2"] = train_run(cfg, inp["tdc"], inp["full_batches"][:2], m12, inp["qlora_kw"],
                                 inp["lora_total"])
    res["pad/2x1"] = train_run(cfg, inp["tdc"], inp["pad_batches"], m21, inp["pad_kw"],
                               inp["full_total"])
    # a one-process checkpoint restored over 2x1, one more step, saved for
    # the one-process trainer to restore; export_merged gathered to rank 0
    tr = Trainer(cfg, TrainConfig(**inp["ckpt_kw"]), clone_tree(inp["tdc"]),
                 total_steps=inp["lora_total"], mesh=m21)
    res["ckpt/restored"] = tr.restore_if_available()
    res["ckpt/restored_state"] = whole_state(tr)
    merged = tr.export_merged()
    res["ckpt/export"] = merged
    tr.train_step(inp["full_batches"][0])
    tr.tcfg = dataclasses.replace(tr.tcfg, output_dir=inp["ckpt_out"])
    tr.save()
    res["ckpt/saved_state"] = whole_state(tr)
    res["encode/2x1"] = encode_grads(torch, cfg, inp["tdc"], inp["sig"], inp["dino"],
                                     inp["feat_w"], m21)
    return res


def run_train22(torch, inp, workdir):
    import dataclasses

    from tdc_video_tpu_torch.config import tdc_tiny
    from tdc_video_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(device="cpu", timeout_s=120)
    cfg, cfga = _tiny(torch), dataclasses.replace(tdc_tiny(audio=True),
                                                  compress_dtype=torch.float32)
    mesh = make_mesh(2, 2, device="cpu", num_kv_heads=cfg.lm.num_kv_heads)
    return {"grads/2x2": loss_and_grads(cfg, inp["tdc"], inp["batch"], mesh, inp["grads_kw"]),
            "lora/2x2": train_run(cfga, inp["tdc_audio"], inp["audio_batches"], mesh,
                                  inp["lora_kw"], inp["lora_total"]),
            "qlora/2x2": train_run(cfg, inp["tdc"], inp["full_batches"][:2], mesh,
                                   inp["qlora_kw"], inp["lora_total"])}


def run_run(torch, inp, workdir):
    """train.run.main --coordinator/--num_processes/--process_id over the
    ranks (the group made by the CLI itself, on the CPU)."""
    import contextlib
    import io

    from tdc_video_tpu_torch.train import run
    from torch_stub_tokenizer import StubTokenizer

    for (mod, name), fn in train_patches().items():
        setattr(mod, name, fn)
    argv = inp["argv"] + ["--coordinator", inp["coordinator"], "--num_processes",
                          os.environ["WORLD_SIZE"], "--process_id", os.environ["RANK"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tr = run.main(argv, tokenizer=StubTokenizer())
    return {"n_data": tr.n_data, "step": tr.step, "mesh": dict(tr.mesh.shape),
            "stdout": buf.getvalue()}


def train_patches():
    """{(module, name): replacement}: the port's read_config giving f32
    compute and an f32 compressor, as tests/test_torch_train_run.py runs
    the CLI (in bf16 a random tiny model's losses part by rounding)."""
    import dataclasses

    import torch

    from tdc_video_tpu_torch import builder

    real = builder.read_config
    return {(builder, "read_config"): lambda path: dataclasses.replace(
        real(path), dtype=torch.float32, compress_dtype=torch.float32)}


# ---------------------------------------------------------------------------
# Sequence parallelism (tests/test_torch_seq_parallel.py)
# ---------------------------------------------------------------------------


def whole_grads(params, spec, mesh):
    """Every leaf's gradient as one process has it (collective: every rank
    calls it): summed over `data` where the leaf is whole on it (each rank's
    rows give a part), taken as it is where FSDP splits the layers over
    `data` (the owner's broadcast gathered every rank's part), then
    gathered over each axis that splits the leaf.  Leaves whole over
    `model` already hold the whole gradient on every rank of it."""
    import torch

    from tdc_video_tpu_torch.parallel.mesh import DATA_AXIS
    from tdc_video_tpu_torch.parallel.sharding import _map2

    def one(t, s):
        with torch.no_grad():
            g = t.grad.clone()
            if DATA_AXIS not in s:
                mesh.all_reduce(g, DATA_AXIS)
            for dim, axis in enumerate(s):
                if axis is not None and mesh.size(axis) > 1:
                    g = mesh.all_gather(g, axis, dim)
        return g

    return _map2(one, params, spec)


def seq_case(torch, inp, mesh, fsdp):
    """lm_forward(seq_axis="data") of LM_TINY on this rank's shard: the
    gathered logits, the shifted cross-entropy over the whole batch (each
    rank's rows' share, summed over `data`) and its whole gradients, the
    block's shape and the collectives counted."""
    from tdc_video_tpu_torch.config import LM_TINY
    from tdc_video_tpu_torch.models.lm import lm_forward
    from tdc_video_tpu_torch.parallel import autograd
    from tdc_video_tpu_torch.parallel.mesh import DATA_AXIS
    from tdc_video_tpu_torch.parallel.sharding import _map, lm_param_spec, shard_tree

    spec = lm_param_spec(inp["lm"], fsdp_size=mesh.size(DATA_AXIS) if fsdp else 0)
    params = shard_tree(clone_tree(inp["lm"]), spec, mesh)
    _map(lambda _p, t: t.requires_grad_(), params)
    autograd.reset_counts()
    logits = lm_forward(LM_TINY, params, input_ids=inp["ids"], attention_mask=inp["mask"],
                        attn_impl="flash", dtype=torch.float32, mesh=mesh, seq_axis=DATA_AXIS)
    n, c = mesh.size(DATA_AXIS), mesh.coords[DATA_AXIS]
    labels = inp["labels"]
    w = labels.shape[1] // n
    # row t predicts label t + 1; the last row predicts nothing
    target = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -100)], 1)[:, c * w:(c + 1) * w]
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.take_along_dim(logp, target.clamp_min(0)[..., None], dim=-1)[..., 0]
    loss = -(ll * (target >= 0)).sum() / (labels[:, 1:] >= 0).sum()
    loss.backward()
    counts = dict(autograd.counts)
    return {"logits": mesh.all_gather(logits.detach(), DATA_AXIS, dim=1),
            "loss": float(mesh.all_reduce(loss.detach().clone(), DATA_AXIS)),
            "grads": whole_grads(params, spec, mesh), "block": tuple(logits.shape),
            "counts": counts}


def gather_seq_check(torch, mesh):
    """gather_seq over `data`: forward every rank's block in rank order;
    backward, with rank r's loss sum(y * w * (r + 1)), each block's rows of
    w times the sum of (r + 1) over the ranks."""
    from tdc_video_tpu_torch.parallel import autograd as ag
    from tdc_video_tpu_torch.parallel.mesh import DATA_AXIS

    n, c = mesh.size(DATA_AXIS), mesh.coords[DATA_AXIS]
    g = torch.Generator().manual_seed(5)
    xs = [torch.randn(2, 3, 4, generator=g) for _ in range(n)]
    w = torch.randn(2, 3 * n, 4, generator=g)
    x = xs[c].clone().requires_grad_()
    y = ag.gather_seq(x, mesh, DATA_AXIS, 1)
    (y * w * (c + 1)).sum().backward()
    return (torch.cat([y.detach(), x.grad], 1),
            torch.cat([torch.cat(xs, 1), w[:, 3 * c:3 * (c + 1)] * sum(range(1, n + 1))], 1))


def _seq_mode(torch, inp, shapes):
    from tdc_video_tpu_torch.parallel.mesh import init_distributed, make_mesh, warmup_collectives

    init_distributed(device="cpu", timeout_s=120)
    res = {}
    for tag, (n_data, n_model, fsdp) in shapes.items():
        mesh = make_mesh(n_data, n_model, device="cpu")
        warmup_collectives(mesh)
        res[tag] = seq_case(torch, inp, mesh, fsdp)
        res[tag]["gather_seq"] = gather_seq_check(torch, mesh)
    return res


def run_seq(torch, inp, workdir):
    return _seq_mode(torch, inp, {"2x1": (2, 1, False), "2x1_fsdp": (2, 1, True)})


def run_seq4(torch, inp, workdir):
    return _seq_mode(torch, inp, {"4x1": (4, 1, False), "2x2": (2, 2, False)})


MODES = {"tp": run_tp, "tp22": run_tp22, "round": run_round, "eval": run_eval,
         "train": run_train, "train22": run_train22, "run": run_run, "seq": run_seq,
         "seq4": run_seq4}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=sorted(MODES))
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--crash_after", type=int, default=-1)
    args = ap.parse_args()
    torch = _setup()
    inp = torch.load(os.path.join(args.workdir, "inputs.pt"), weights_only=False)
    kw = {"crash_after": args.crash_after} if args.mode == "eval" else {}
    res = MODES[args.mode](torch, inp, args.workdir, **kw)
    rank = torch.distributed.get_rank()
    torch.save(res, os.path.join(args.workdir, f"{args.mode}-rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
