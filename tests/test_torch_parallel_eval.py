"""The port's evaluation, data-parallel over two gloo ranks
(tests/torch_parallel_worker.py, mode "eval", each launch with a wall
limit), against the JAX package's one-process run_benchmark on the same
checkpoint (tests/test_multiprocess.py's TestMultiProcessEval): tdc_tiny
written by tests/test_builder.write_checkpoint, loaded in f32 with an f32
compressor, five questions on two JPEG frame directories (MVBench's shape:
3 + 2 questions, a bound each).

* run_benchmark on two ranks: each answers its round-robin video group,
  every rank gets JAX's metrics, rank 0's dumped records are JAX's, only
  rank 0 writes result files, and both ranks' logs are gone;
* one rank killed after one answer (the other is then killed, as a rank
  left waiting in the gather would be), then a fresh two-rank run over the
  same out_dir: each rank answers only what its log lacks, and the records
  and metrics are JAX's.
"""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import builder as jbuilder
from tdc_video_tpu.config import tdc_tiny as jtiny
from tdc_video_tpu.eval import harness as jh
from tdc_video_tpu.eval import runner as jrun
from test_builder import write_checkpoint
from test_torch_e2e import JaxStubTokenizer
from test_torch_eval_harness import frame_samples, records
from torch_parallel_worker import Launch


def _sorted(recs):
    return sorted(recs, key=lambda r: (r["video_name"], r["question"]))


def _write_frame_dirs(root):
    from PIL import Image

    rng = np.random.default_rng(0)
    dirs = []
    for d in range(2):
        fd = root / f"frames{d}"
        fd.mkdir()
        for k in range(30):
            px = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
            Image.fromarray(np.kron(px, np.ones((8, 8, 1), np.uint8))).save(
                str(fd / f"{k:05d}.jpg"))
        dirs.append(str(fd))
    return dirs


def _inputs(wd, ckpt, samples, out_dir):
    wd.mkdir()
    torch.save({"ckpt": ckpt, "samples": samples, "out_dir": str(out_dir)}, wd / "inputs.pt")
    return wd


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    ckpt = str(root / "ckpt")
    write_checkpoint(ckpt, jtiny(), audio=False)
    samples = frame_samples({"dirs": _write_frame_dirs(root)})
    plain = Launch("eval", 2, _inputs(root / "plain", ckpt, samples, root / "mp"), wall_s=120.0)
    crash_wd = _inputs(root / "crash", ckpt, samples, root / "mp_crash")
    crash = Launch("eval", 2, crash_wd, extra={1: ["--crash_after", "1"]}, wall_s=120.0)

    _, jm, _, _ = jbuilder.load_pretrained_model(ckpt, load_tokenizer=False, dtype=jnp.float32)
    jpred = jrun.TDCPredictor(dataclasses.replace(jm.cfg, compress_dtype=jnp.float32), jm.params,
                              JaxStubTokenizer(), max_new_tokens=3, text_bucket=128)
    jmetrics = jh.run_benchmark("mlvu", jpred, samples, out_dir=str(root / "jax"))
    jrecords = _sorted(records(str(root / "jax")))

    plain.wait()
    crash_rcs = crash.wait(expect_ok=False)
    wals = {}
    for rank in (0, 1):
        path = root / "mp_crash" / "MLVU" / f"wal-host{rank}.jsonl"
        if path.exists():  # whole lines only: a kill may tear the last
            with open(path) as fh:
                wals[rank] = sum(1 for line in fh if line.endswith("\n"))
    resume = Launch("eval", 2, _inputs(root / "resume", ckpt, samples, root / "mp_crash"),
                    wall_s=120.0)
    resume.wait()
    return dict(root=root, jmetrics=jmetrics, jrecords=jrecords, plain=plain.results(),
                crash_rcs=crash_rcs, wals=wals, resume=resume.results())


def test_two_ranks_match_one_process_jax(runs):
    r0, r1 = runs["plain"]
    assert r0["world"] == r1["world"] == 2
    # 2 video groups (3 + 2 questions), one a rank
    assert sorted([r0["answered"], r1["answered"]]) == [2, 3]
    assert r0["metrics"] == r1["metrics"] == runs["jmetrics"]
    assert _sorted(records(str(runs["root"] / "mp"))) == runs["jrecords"]


def test_only_rank0_writes_and_the_logs_go(runs):
    out = runs["root"] / "mp" / "MLVU"
    assert len(glob.glob(str(out / "outputs-*.json"))) == 1
    assert len(glob.glob(str(out / "result-*.json"))) == 1
    assert not glob.glob(str(out / "wal-host*.jsonl"))
    assert sorted(os.listdir(out)) == sorted(os.path.basename(p) for p in
                                             glob.glob(str(out / "*-*.json")))


def test_crash_one_rank_then_resume(runs):
    assert runs["crash_rcs"][1] == 3  # the injected exit
    assert runs["wals"].get(1) == 1  # rank 1 logged exactly its one answer
    r0, r1 = runs["resume"]
    # the resumed ranks answer only what their logs lack
    assert r0["answered"] == 3 - runs["wals"].get(0, 0)
    assert r1["answered"] == 2 - 1
    assert r0["metrics"] == r1["metrics"] == runs["jmetrics"]
    assert _sorted(records(str(runs["root"] / "mp_crash"))) == runs["jrecords"]
