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


MODES = {"tp": run_tp, "tp22": run_tp22, "round": run_round, "eval": run_eval}


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
