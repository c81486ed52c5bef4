"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; JAX
params cross over as numpy through convert.from_numpy.params_from_numpy.
"""

import jax
import numpy as np
import torch

from tdc_video_tpu_torch.convert.from_numpy import params_from_numpy

# xdist runs several workers on a few cores: keep each worker's torch to a
# couple of threads
torch.set_num_threads(2)

# f32 module parity tolerance of the golden suite (tests/test_golden.py)
ATOL = 3e-4
RTOL = 3e-4


def to_torch(tree):
    """JAX param tree -> the port's tree on the CPU (f32 stays f32)."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def t(x, dtype=None):
    """numpy / JAX array -> CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def close(port, ref, atol=ATOL, rtol=RTOL):
    a = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(a, np.asarray(ref, dtype=np.float32), atol=atol, rtol=rtol)


class StubTokenizer:
    """Offline tokenizer with encode/decode: one id per character, Llama-3
    and ChatML specials mapped to fixed ids inside a 512-token vocabulary."""

    SPECIALS = {"<|begin_of_text|>": 300, "<|start_header_id|>": 301, "<|end_header_id|>": 302,
                "<|eot_id|>": 303, "<|im_start|>": 304, "<|im_end|>": 305}

    def encode(self, text):
        ids, i = [], 0
        while i < len(text):
            for s, sid in self.SPECIALS.items():
                if text.startswith(s, i):
                    ids.append(sid)
                    i += len(s)
                    break
            else:
                ids.append(2 + ord(text[i]) % 250)
                i += 1
        return ids

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)
