"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; JAX
params cross over as numpy through convert.from_numpy.params_from_numpy.
"""

import jax
import numpy as np
import torch

from tdc_video_tpu_torch.convert.from_numpy import params_from_numpy
from torch_stub_tokenizer import StubTokenizer  # noqa: F401  (the tests import it from here)

# xdist runs several workers on a few cores: keep each worker's torch to a
# couple of threads
torch.set_num_threads(2)

# f32 module parity tolerance of the golden suite (tests/test_golden.py)
ATOL = 3e-4
RTOL = 3e-4


def to_torch(tree):
    """JAX param tree -> the port's tree on the CPU (f32 stays f32)."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def to_jax(tree):
    """The port's tree -> JAX's (its container types kept, None leaves
    too): the inverse of to_torch, for weights made fast by the port's
    seeded init (JAX's eager init of tdc_tiny takes seconds)."""
    import jax.numpy as jnp

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax(v) for v in tree)
    return jnp.asarray(tree.detach().cpu().numpy())


def t(x, dtype=None):
    """numpy / JAX array -> CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def close(port, ref, atol=ATOL, rtol=RTOL):
    a = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(a, np.asarray(ref, dtype=np.float32), atol=atol, rtol=rtol)


class StandInMesh:
    """A mesh's shape, coordinates and device without a process group, for
    the checks that come before any collective (divisibility raises, spec
    slicing): a collective over an axis of more than one rank raises."""

    def __init__(self, n_data=1, n_model=1, data=0, model=0):
        self.shape = {"data": n_data, "model": n_model}
        self.coords = {"data": data, "model": model}
        self.device = torch.device("cpu")

    def size(self, axis=None):
        return self.shape["data"] * self.shape["model"] if axis is None else self.shape[axis]

    def all_reduce(self, x, axis, op="sum"):
        if self.size(axis) > 1:
            raise RuntimeError("a stand-in mesh has no process group")
        return x

    def all_gather(self, x, axis, dim=0):
        return self.all_reduce(x, axis)

    def broadcast(self, x, axis, src):
        return self.all_reduce(x, axis)

