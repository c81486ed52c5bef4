"""Serving over parameters that require grad records no autograd graph.

A trainer's export (`Trainer.export_merged`) hands back its trainable
leaves, which require grad; a predictor, engine or streamer built on them
used to record a graph in every forward.  The KV cache is written in
place, so such a graph lived as long as the cache and held every
activation it saved (found on the H100: ~34 GiB left allocated after
`chip_smoke.py` phase 11 (e) answered over an export).  Held here on
tdc_tiny on the CPU: after `answer`, `answer_many` and a streamed encode
over leaves that require grad, no cached feature or cache tensor has a
graph, the caller's leaves keep requires_grad, and the answers are those
over the same values without grad."""

import dataclasses

import numpy as np
import torch

from tdc_video_tpu_torch.config import tdc_tiny
from tdc_video_tpu_torch.eval.runner import TDCPredictor
from tdc_video_tpu_torch.model import init_tdc
from tdc_video_tpu_torch.serving.streaming import StreamingEncoder
from tdc_video_tpu_torch.train.step import tree_leaves
from torch_parity import StubTokenizer

QUESTIONS = ["What happens?", "Which colour is it?"]


def _graph_free(x) -> bool:
    return all(not t.requires_grad for t in tree_leaves(x))


def test_serving_over_trainable_leaves_records_no_graph():
    cfg = dataclasses.replace(tdc_tiny(), compress_dtype=torch.float32)
    frozen = init_tdc(cfg, torch.Generator().manual_seed(0), "cpu")
    trainable = init_tdc(cfg, torch.Generator().manual_seed(0), "cpu")
    for t in tree_leaves(trainable):
        t.requires_grad_(True)
    frames = np.random.default_rng(0).integers(0, 255, (5, 48, 64, 3)).astype(np.uint8)
    out = {}
    for name, p in (("trainable", trainable), ("frozen", frozen)):
        pred = TDCPredictor(cfg, p, StubTokenizer(), max_new_tokens=4, text_bucket=128,
                            device="cpu")
        out[name] = (pred.answer(frames, QUESTIONS[0], video_uid="v"),
                     pred.answer_many(frames, QUESTIONS, video_uid="v", num_slots=2))
        assert _graph_free(pred._feat_cache[1])
        assert all(_graph_free(eng.cache) for eng in pred._engine_cache.values())
    assert out["trainable"] == out["frozen"]
    assert all(t.requires_grad for t in tree_leaves(trainable))  # the caller's tree as it was
    enc = StreamingEncoder(cfg, trainable, chunk_frames=4, device_prep=False, device="cpu")
    rng = np.random.default_rng(1)
    s, d = cfg.siglip.image_size, cfg.dino.image_size
    sig = rng.normal(0, 1, (4, s, s, 3)).astype(np.float32)
    dino = rng.normal(0, 1, (4, d, d, 3)).astype(np.float32)
    assert _graph_free(enc._encode(sig, dino))
