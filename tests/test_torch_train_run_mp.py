"""The training entry point over two processes: `train.run.main` with
JAX's flags (--coordinator, --num_processes, --process_id) in two gloo
ranks on the CPU (tests/torch_parallel_worker.py, mode "run"), against the
same CLI in one process, both in f32 on one tiny audio-visual checkpoint
and data.json (stage 3: LoRA, accumulation 2, 4 micro-steps).  Two ranks
and tdc_tiny's two KV heads make auto_mesh a 1x2 mesh (tensor parallel),
whose global batch is the one-process run's.  Held, as JAX holds its
two-process run (tests/test_multiprocess.py:312-345): the metrics.jsonl
losses at rtol 2e-4, atol 1e-5, written by rank 0 alone with one line a
step; final/model.safetensors within the same bounds (plus 1e-2 of the
learning rate for the updated adapters, UPDATE_ATOL); both ranks end at
the same step."""

import json
import os

import numpy as np
import pytest
import torch

from tdc_video_tpu_torch.config import tdc_tiny
from tdc_video_tpu_torch.convert.from_hf import read_safetensors
from tdc_video_tpu_torch.convert.to_hf import save_checkpoint_dir
from tdc_video_tpu_torch.model import init_tdc
from tdc_video_tpu_torch.train import run as trun
from test_torch_dataset import write_wav
from torch_parallel_worker import Launch, _free_port, train_patches
from torch_parity import StubTokenizer

LR = 1e-2
RTOL, ATOL = 2e-4, 1e-5
UPDATE_ATOL = 1e-2 * LR


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_mp")
    cfg = tdc_tiny(audio=True)
    save_checkpoint_dir(init_tdc(cfg, torch.Generator().manual_seed(0), "cpu"), cfg,
                        str(root / "ckpt"))
    rng = np.random.default_rng(1)
    rows = []
    for i in range(4):
        write_wav(str(root / f"v{i}.wav"), 4.5 + i, seed=i)
        np.save(root / f"v{i}.npy", rng.integers(0, 256, (5 + i, 32, 40, 3), dtype=np.uint8))
        rows.append({"video": f"v{i}.npy", "audio": f"v{i}.wav", "conversations": [
            {"from": "human", "value": "<image>\nWhat color is the square ?"},
            {"from": "gpt", "value": "It looks like red ." if i % 2 else "blue square ."}]})
    with open(root / "data.json", "w") as fh:
        json.dump(rows, fh)

    def argv(out):
        return ["--stage", "3", "--model_path", str(root / "ckpt"),
                "--data_path", str(root / "data.json"), "--image_folder", str(root),
                "--output_dir", str(out), "--bert_tokenizer", "", "--max_steps", "4",
                "--report_to", "jsonl", "--learning_rate", str(LR), "--max_train_frames", "8",
                "--model_max_length", "256", "--device", "cpu"]

    torch.save({"argv": argv(root / "mesh"), "coordinator": f"127.0.0.1:{_free_port()}"},
               root / "inputs.pt")
    launch = Launch("run", 2, root, wall_s=150.0)
    mp = pytest.MonkeyPatch()
    try:
        for (mod, name), fn in train_patches().items():
            mp.setattr(mod, name, fn)
        one = trun.main(argv(root / "one"), tokenizer=StubTokenizer())
    finally:
        mp.undo()
    launch.wait()
    return root, one, launch.results()


def _metrics(out):
    return [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]


def test_two_ranks_train_as_one_process(runs):
    root, one, res = runs
    assert [r["mesh"] for r in res] == [{"data": 1, "model": 2}] * 2
    assert [r["step"] for r in res] == [one.step] * 2 == [4, 4]
    assert [r["n_data"] for r in res] == [1, 1]
    mesh, ref = _metrics(root / "mesh"), _metrics(root / "one")
    steps = [m["step"] for m in mesh]
    assert steps == sorted(set(steps)) == [m["step"] for m in ref]  # rank 0 alone wrote
    np.testing.assert_allclose([m["loss"] for m in mesh], [m["loss"] for m in ref],
                               rtol=RTOL, atol=ATOL)
    assert all("done at step 4" in r["stdout"] for r in res)


def test_rank0_writes_final_and_checkpoints_equal_to_one_process(runs):
    root, _, _ = runs
    a = read_safetensors(str(root / "mesh" / "final" / "model.safetensors"))
    b = read_safetensors(str(root / "one" / "final" / "model.safetensors"))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), rtol=RTOL,
                                   atol=UPDATE_ATOL, err_msg=k)
    assert sorted(os.listdir(root / "mesh" / "checkpoints")) == ["4"]
    c = read_safetensors(str(root / "mesh" / "checkpoints" / "4" / "state.safetensors"))
    d = read_safetensors(str(root / "one" / "checkpoints" / "4" / "state.safetensors"))
    assert sorted(c) == sorted(d)
    for k in d:
        np.testing.assert_allclose(np.asarray(c[k]).astype(np.float64),
                                   np.asarray(d[k]).astype(np.float64), rtol=RTOL,
                                   atol=UPDATE_ATOL, err_msg=k)
