"""Device mesh over torch.distributed (port of tdc_video_tpu/parallel/mesh.py).

JAX's mesh is single-controller: one process drives every chip and GSPMD
inserts the collectives from sharding annotations.  The port runs one
process per device (launched by `torchrun`, or by hand with the JAX-style
coordinator flags of `init_distributed`) with explicit collectives over a
`data` axis (frames of a video, samples of a benchmark) and a `model` axis
(tensor parallelism of the LM).

    init_distributed()                     # env:// under torchrun
    mesh = make_mesh(n_data, n_model)      # the whole world, row-major
    mesh.all_reduce(x, MODEL_AXIS)         # in place, over this rank's row

Rank r sits at (r // n_model, r % n_model), JAX's row-major device grid.
Unlike JAX, which takes the first D x M devices, a mesh takes the whole
world: a rank outside it would have nothing to do.  Every group carries a
timeout, so a rank left waiting in a collective fails instead of hanging.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
# seconds a rank waits in a collective before failing (the default group's
# unless init_distributed is given another; the mesh's axis groups always)
DEFAULT_TIMEOUT_S = 600.0

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def auto_mesh_shape(n_devices: int, num_kv_heads: int = 4) -> Tuple[int, int]:
    """Pick (n_data, n_model): the largest model axis that divides the KV head
    count (TP shards K/V projections head-wise), remainder to data."""
    n_model = 1
    for cand in range(min(n_devices, num_kv_heads), 0, -1):
        if num_kv_heads % cand == 0 and n_devices % cand == 0:
            n_model = cand
            break
    return n_devices // n_model, n_model


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: `device` when it names one ("cpu", "cuda:1"), else
    cuda:LOCAL_RANK (torchrun sets LOCAL_RANK; 0 without it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(dev)


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device: DeviceLike = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group and return this rank's device.

    coordinator "host:port" with num_processes and process_id (JAX's flags)
    rendezvous over tcp://; without them over env:// (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, as torchrun sets them).  The backend is
    NCCL for a CUDA device and gloo for the CPU unless `backend` names one
    (gloo also carries CUDA tensors: two ranks on one card, where NCCL
    refuses).  A group that is already up is kept as it is."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    elif num_processes is not None or process_id is not None:
        raise ValueError("num_processes and process_id need a coordinator")
    elif "WORLD_SIZE" not in os.environ:
        raise ValueError("no rendezvous: run under torchrun (it sets RANK, WORLD_SIZE, "
                         "MASTER_ADDR and MASTER_PORT) or pass coordinator, num_processes and "
                         "process_id")
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    return dev


class Mesh:
    """A (data, model) grid over every rank of the default process group.

    `shape` and `coords` map each axis to its size and this rank's index on
    it; `device` is the rank's device.  Collectives run over this rank's
    line of an axis (its row for `model`, its column for `data`), or over
    the whole mesh with axis=None; over an axis of size 1 they return their
    input."""

    def __init__(self, n_data: int, n_model: int, device: torch.device):
        rank = dist.get_rank()
        self.shape: Dict[str, int] = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.coords: Dict[str, int] = {DATA_AXIS: rank // n_model, MODEL_AXIS: rank % n_model}
        self.device = device
        self._groups: Dict[Optional[str], object] = {None: dist.group.WORLD}
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        lines = {
            MODEL_AXIS: [[d * n_model + m for m in range(n_model)] for d in range(n_data)],
            DATA_AXIS: [[d * n_model + m for d in range(n_data)] for m in range(n_model)],
        }
        # new_group is collective: every rank creates every group, in one order
        for axis, groups in lines.items():
            if self.shape[axis] == 1:
                continue
            for ranks in groups:
                g = dist.new_group(ranks, timeout=timeout)
                if rank in ranks:
                    self._groups[axis] = g

    def size(self, axis: Optional[str] = None) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS] if axis is None else self.shape[axis]

    def all_reduce(self, x: torch.Tensor, axis: Optional[str], op: str = "sum") -> torch.Tensor:
        """x reduced (sum or max) over the axis, in place; returns x (which
        must be contiguous).  Every rank receives the same bits."""
        if self.size(axis) > 1:
            dist.all_reduce(x, op=_OPS[op], group=self._groups[axis])
        return x

    def rank_at(self, axis: str, coord: int) -> int:
        """The global rank at `coord` on this rank's line of `axis`."""
        d, m = self.coords[DATA_AXIS], self.coords[MODEL_AXIS]
        if axis == DATA_AXIS:
            d = coord
        else:
            m = coord
        return d * self.shape[MODEL_AXIS] + m

    def broadcast(self, x: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """x of the rank at coordinate `src` of the axis, in place on every
        rank of this rank's line (x contiguous, of the same shape and dtype
        everywhere); returns x."""
        if self.size(axis) > 1:
            dist.broadcast(x, src=self.rank_at(axis, src), group=self._groups[axis])
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """Every rank's x along the axis, concatenated on `dim` in rank order
        (the list form of all_gather, which gloo has for CUDA tensors)."""
        n = self.size(axis)
        if n == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._groups[axis])
        return torch.cat(parts, dim=dim)


def make_mesh(n_data: int, n_model: int, device: DeviceLike = None,
              num_kv_heads: Optional[int] = None) -> Mesh:
    """The (n_data, n_model) mesh over the default process group, whose world
    size must be n_data * n_model.  num_kv_heads, when given, must divide
    by n_model (the model axis splits whole KV heads)."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"mesh {n_data}x{n_model} needs an initialized process group "
                         "(init_distributed)")
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs a world of {n_data * n_model} ranks, "
                         f"the process group has {world}")
    if num_kv_heads is not None and num_kv_heads % n_model:
        raise ValueError(f"model axis {n_model} does not divide {num_kv_heads} KV heads")
    return Mesh(n_data, n_model, rank_device(device))


def auto_mesh(n_devices: Optional[int] = None, num_kv_heads: int = 4,
              device: DeviceLike = None) -> Mesh:
    n = dist.get_world_size() if n_devices is None else n_devices
    return make_mesh(*auto_mesh_shape(n, num_kv_heads), device=device)


def warmup_collectives(mesh: Mesh) -> None:
    """Connect the mesh's groups before any heavy work: one blocking tiny
    all_reduce per axis of size > 1, then one over the whole mesh, each read
    back before the next (JAX :56-90: lazy communicator set-up under load
    can starve past gloo's connect windows, and a broken link should show
    before a long compile or load).  A no-op with one rank."""
    if mesh.size() == 1:
        return
    for axis in (DATA_AXIS, MODEL_AXIS, None):
        if axis is not None and mesh.size(axis) == 1:
            continue
        x = torch.zeros(8, dtype=torch.float32, device=mesh.device)
        float(mesh.all_reduce(x, axis).sum())
