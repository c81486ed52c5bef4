"""JAX's counter-mode PRNG keys (threefry2x32) in PyTorch, bit for bit.

The JAX package samples with `jax.random` (serving/generate.sample_rows,
serving/speculative.accept_and_emit_sampled), so a request's sampled stream
is a pure function of (seed, token index).  This module draws the same bits,
so that the port's sampled tokens are JAX's: `PRNGKey`, `fold_in`, `split`,
the 32-bit `random_bits`, `uniform`, `gumbel` and `categorical`, as JAX's
default threefry2x32 implementation computes them with
`jax_threefry_partitionable=True` (the default from JAX 0.5).

A key is a tensor [..., 2] of the two uint32 words.  uint32 values are
carried in int64 tensors and masked to 32 bits after every add and shift,
so the same ops run on the CPU and on the card.  Leading dimensions of a
key are batch dimensions, as under `jax.vmap` over keys: `random_bits(key
[B, 2], (V,))` gives each row the bits its own key gives for shape (V,).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32's smallest normal: gumbel's uniform draws from [tiny, 1)
_F32_TINY = torch.finfo(torch.float32).tiny


def _u32(x) -> torch.Tensor:
    return x & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2); all int64 tensors holding uint32 values,
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = _u32(x1 + ks[0])
    x2 = _u32(x2 + ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = _u32(x1 + x2)
            x2 = _rotl(x2, r) ^ x1
        x1 = _u32(x1 + ks[(i + 1) % 3])
        x2 = _u32(x2 + ks[(i + 2) % 3] + (i + 1))
    return x1, x2


def PRNGKey(seed: Union[int, torch.Tensor], device=None) -> torch.Tensor:
    """jax.random.PRNGKey of a 32-bit seed: [0, seed mod 2**32]; a tensor
    of seeds gives a key per seed ([..., 2])."""
    if isinstance(seed, int):  # a fill, not a host-to-device copy: capturable in a CUDA graph
        s = torch.full((), seed & _M32, dtype=torch.int64, device=device)
    else:
        s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """jax.random.fold_in: the hash of the counter pair (0, data mod 2**32)
    under `key`.  `data` broadcasts against the key's batch dimensions."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (partitionable): key i hashes the counter pair
    (0, i).  Returns [..., num, 2]."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None], torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random bits of `shape` for each key (partitionable threefry):
    element n of the flattened shape hashes the counter pair (n >> 32,
    n mod 2**32), and its bits are the two words' xor.  Returns
    [*key batch, *shape] int64 holding uint32 values."""
    shape = tuple(int(s) for s in shape)
    n = torch.arange(int(torch.Size(shape).numel()), dtype=torch.int64,
                     device=key.device).reshape(shape)
    batch = key.shape[:-1]
    view = batch + (1,) * len(shape)
    y1, y2 = threefry2x32(key[..., 0].reshape(view), key[..., 1].reshape(view), n >> 32,
                          n & _M32)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform in float32: the top 23 bits as the mantissa of a
    float in [1, 2), less 1, scaled to [minval, maxval) and clamped below
    at minval, in f32 as XLA computes it."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """jax.random.gumbel in float32 (its default "low" mode):
    -log(-log(u)), u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_F32_TINY, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical over the last axis by the Gumbel-max trick.
    The key's batch dimensions lead `logits`' dimensions: each key draws the
    gumbel noise of the remaining shape, so a single key [2] over logits
    [B, V] draws as JAX's one-key call, and keys [B, 2] over [B, V] as JAX's
    call vmapped over rows."""
    nb = key.dim() - 1
    noise = gumbel(key, logits.shape[nb:])
    return torch.argmax(noise + logits, dim=-1)
