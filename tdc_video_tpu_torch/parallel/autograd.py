"""Collectives with gradients, for training over a mesh (parallel/mesh.py).

Megatron's pairing over an axis of the mesh, each a torch.autograd.Function:

    copy_to(x, mesh, axis)       forward x;               backward: sum over the axis
    reduce_from(x, mesh, axis)   forward: sum over axis;  backward: the gradient as it is
    gather_from(x, mesh, axis)   forward: concatenation;  backward: this rank's slice
    gather_seq(x, mesh, axis, dim)
                                 forward: concatenation;  backward: the sum over the
                                 axis, then this rank's slice
    broadcast_from(x, mesh, axis, src)
                                 forward: the rank at `src`'s x on every rank;
                                 backward: the sum of the gradients, to `src`

`copy_to` sits where an activation that every rank of `model` holds whole
enters a product split over `model` (q/k/v, gate/up, the vocabulary-split
head): each rank's backward gives a part of the activation's gradient, and
the sum is the whole.  `reduce_from` sits after a product whose partial
results sum to the output (o_proj, down, the vocabulary-split embedding,
the vocabulary-parallel loss): the output's gradient reaches every part as
it is.  `torch.distributed.nn.functional.all_reduce` is not this: its
backward sums again, which counts a gradient that every rank holds whole n
times.  `broadcast_from` carries a layer split over `data` (FSDP) from its
owner to every rank; the owner's leaf receives the sum of every rank's
gradient of it, and the other ranks' input (a stand-in of the same shape)
none.  `gather_seq` carries a layer's keys and values, split over the
sequence (models/lm.py under `seq_axis`), to every rank: each rank's
queries give a partial gradient of every key and value, so the backward
sums them before it takes the rank's own block (an all_reduce, as gloo has
no reduce-scatter for CUDA tensors).

Each wrapper is x itself over an axis of one rank, and the plain collective
when no gradient is recorded.  `counts` counts the collectives each kind
runs (forward and backward apart).
"""

from __future__ import annotations

from collections import Counter

import torch

counts: Counter = Counter()


def reset_counts() -> None:
    counts.clear()


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        counts["copy_to_grad"] += 1
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        counts["reduce_from"] += 1
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.coord, ctx.n, ctx.dim = mesh.coords[axis], mesh.size(axis), dim
        counts["gather_from"] += 1
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        w = g.shape[ctx.dim] // ctx.n
        return g.narrow(ctx.dim, ctx.coord * w, w), None, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        counts["gather_seq"] += 1
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        counts["gather_seq_grad"] += 1
        g = ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.axis)
        w = g.shape[ctx.dim] // ctx.mesh.size(ctx.axis)
        return g.narrow(ctx.dim, ctx.mesh.coords[ctx.axis] * w, w), None, None, None


def _dense(x: torch.Tensor):
    """(a contiguous tensor holding x's elements, whether it is x
    transposed in its last two dims): the column-major int8 weights of
    models/quant.py are contiguous only so."""
    if x.is_contiguous() or x.dim() < 2:
        return x.contiguous(), False
    t = x.transpose(-1, -2)
    return (t, True) if t.is_contiguous() else (x.contiguous(), False)


def _broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """The `src` rank's x on every rank of the axis: x itself there, a new
    tensor of x's layout elsewhere."""
    counts["broadcast"] += 1
    buf, flipped = _dense(x)
    if mesh.coords[axis] != src:
        buf = torch.empty_like(buf)
    mesh.broadcast(buf, axis, src)
    return buf.transpose(-1, -2) if flipped else buf


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, src):
        ctx.mesh, ctx.axis, ctx.src = mesh, axis, src
        out = _broadcast(x, mesh, axis, src)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        # a sum over the axis (gloo has no reduce for CUDA tensors), kept by
        # the owner alone
        counts["broadcast_grad"] += 1
        g = ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.axis)
        return (g if ctx.mesh.coords[ctx.axis] == ctx.src else None), None, None, None


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    if mesh is None or mesh.size(axis) == 1 or not _grad(x):
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of x over the axis.  Without a gradient to record, in place
    on x (every caller passes a fresh product)."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    if not _grad(x):
        counts["reduce_from"] += 1
        return mesh.all_reduce(x.contiguous(), axis)
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    if mesh is None or mesh.size(axis) == 1:
        return x
    if not _grad(x):
        counts["gather_from"] += 1
        return mesh.all_gather(x, axis, dim)
    return _GatherFrom.apply(x, mesh, axis, dim)


def gather_seq(x: torch.Tensor, mesh, axis: str, dim: int = 1) -> torch.Tensor:
    """Every rank's block of x along `dim`, concatenated in rank order; the
    gradient of the result summed over the axis flows back to each block."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    if not _grad(x):
        counts["gather_seq"] += 1
        return mesh.all_gather(x, axis, dim)
    return _GatherSeq.apply(x, mesh, axis, dim)


def broadcast_from(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """The leaf x of the rank at coordinate `src` of the axis, on every rank
    of it; x elsewhere is a stand-in of the same shape, dtype and
    requires_grad (its values unused, no gradient given to it)."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    if not _grad(x):
        with torch.no_grad():
            return _broadcast(x, mesh, axis, src)
    return _BroadcastFrom.apply(x, mesh, axis, src)
