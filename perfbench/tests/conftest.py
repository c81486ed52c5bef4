"""Shared fixtures of the benchmark's tests: a tiny TDC-Video model on the CPU
(the port's tdc_tiny preset) with seeded weights made as the benchmark
makes them."""

import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def tiny_cfile(audio=False, **over):
    from perfbench.system import _plain
    from tdc_video_tpu_torch import config as C

    cfg = dataclasses.replace(C.tdc_tiny(audio=audio), **over)
    model = {f.name: _plain(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    return cfg, {"preset": "tdc_tiny", "audio": audio, "weights_dtype": "float32", "model": model}


@pytest.fixture(scope="session")
def tiny():
    """(port config, System) of the tiny model, compression in float32."""
    from perfbench.system import System

    cfg, cfile = tiny_cfile(compress_dtype=torch.float32)
    return cfg, System(cfile, 7, "cpu", cfg=cfg)


@pytest.fixture
def tiny_mix():
    """kind -> that kind's cell mix cut to the tiny model's sizes."""
    import json

    from perfbench import core

    def make(kind: str) -> dict:
        name = {"answer": "long_video_mc", "answer_many": "open_questions_32f"}[kind]
        mix = json.loads((core.HERE / "mixes" / f"{name}.json").read_text())
        mix.update(frames=[32, 16] if kind == "answer" else [16], height=36, width=64, cut_min=3,
                   cut_max=9, question_words=[3, 8], max_new_tokens=6, check=2, trace_requests=1)
        return mix

    return make


@pytest.fixture(scope="session")
def tiny_av():
    """(port config, System) of the tiny audio-visual model."""
    from perfbench.system import System

    cfg, cfile = tiny_cfile(audio=True, compress_dtype=torch.float32)
    return cfg, System(cfile, 5, "cpu", cfg=cfg)
