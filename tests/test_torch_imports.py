"""The port imports neither JAX nor the JAX package, and its entry points do
not drop silently to the CPU."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def test_port_and_smoke_script_import_no_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import tdc_video_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for n in names:
            importlib.import_module(n)
        import chip_smoke
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "tdc_video_tpu."))
                     or m == "tdc_video_tpu")
        assert not bad, bad
        # the checkpoint reader, the image resize and the demo need none of
        # these at import (the tokenizer is imported only when asked for)
        libs = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("PIL", "safetensors", "transformers"))
        assert not libs, libs
        assert len(names) >= 20, names
        # the serving options' modules (quantization, speculative decoding,
        # profiling) among them
        for m in ("models.quant", "serving.speculative", "utils.profiling", "train.lora",
                  "train.dataset", "train.runner_utils", "train.run", "serving.prng",
                  "serving.batching", "serving.session", "cli.serve", "eval.datasets",
                  "eval.harness", "serving.streaming", "cli.activation_diff", "cli.model_ops",
                  "models.projector", "parallel.mesh", "parallel.sharding"):
            assert "tdc_video_tpu_torch." + m in names, m
        print(len(names))
        """
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_without_device_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from tdc_video_tpu_torch.config import LM_TINY, tdc_tiny
    from tdc_video_tpu_torch.eval.runner import TDCPredictor
    from tdc_video_tpu_torch.model import init_tdc
    from tdc_video_tpu_torch.models.lm import init_kv_cache

    with pytest.raises(RuntimeError, match="CUDA"):
        init_kv_cache(LM_TINY, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_tdc(tdc_tiny(), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        TDCPredictor(tdc_tiny(), params={}, tokenizer=None)
    from tdc_video_tpu_torch.builder import load_pretrained_model

    with pytest.raises(RuntimeError, match="CUDA"):
        load_pretrained_model(str(ROOT / "no-such-checkpoint"), load_tokenizer=False)


def test_smoke_script_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_train_modules_import_and_trainer_needs_cuda():
    """The training slice's modules import without JAX (covered above) and
    the Trainer, an entry point, raises without CUDA unless given the CPU;
    the stage-3 preset (LoRA) builds on the CPU, and only a device mesh and
    multi-process runs raise NotImplementedError."""
    from tdc_video_tpu_torch.data import preprocess  # noqa: F401
    from tdc_video_tpu_torch.train import stages, step, trainer  # noqa: F401

    assert set(stages.STAGES) == {1, 2, 3}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from tdc_video_tpu_torch.config import tdc_tiny
    from tdc_video_tpu_torch.model import init_tdc

    params = init_tdc(tdc_tiny(), torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.Trainer(tdc_tiny(), trainer.TrainConfig(), params, total_steps=1)
    tr = trainer.Trainer(tdc_tiny(), stages.stage3_audio_lora(), params, total_steps=1,
                         device="cpu")
    assert tr.lora and tr.lora["layers/q_proj/w"]["a"].shape[-1] == 128
    with pytest.raises(NotImplementedError, match="mesh"):
        trainer.Trainer(tdc_tiny(), trainer.TrainConfig(), params, total_steps=1, mesh=object(),
                        device="cpu")
    from tdc_video_tpu_torch.train import run

    for flag in (["--coordinator", "localhost:1234"], ["--num_processes", "2"],
                 ["--process_id", "0"]):
        with pytest.raises(NotImplementedError, match="multi-process"):
            run.main(["--model_path", "m", "--data_path", "d", "--output_dir", "o",
                      "--device", "cpu", *flag])
