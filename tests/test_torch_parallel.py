"""The port's mesh and sharding rules (parallel/mesh.py, parallel/sharding.py)
against the JAX package's, in this process and with no process group
(the multi-rank behaviour runs in tests/test_torch_parallel_*.py):

* auto_mesh_shape equals JAX's on a grid of device and KV-head counts;
* lm_param_spec (fsdp 0 and 2), tdc_param_spec, batch_spec and
  kv_cache_spec equal JAX's leaf by leaf (`tuple(PartitionSpec)`), on
  tdc_tiny's float tree and on its quantize_lm_int8 tree;
* local_slice over every coordinate reassembles every leaf bitwise, and
  shard_tree keeps the int8 weights column-major;
* the raises that come before any collective: a dim an axis does not
  divide, a model axis that does not divide the heads, a layer axis split
  over `data`, a mesh without a process group; warmup_collectives is a
  no-op with one rank.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu.models.quant import quantize_lm_int8 as j_quantize_lm_int8
from tdc_video_tpu.parallel import mesh as jmesh
from tdc_video_tpu.parallel import sharding as jsharding
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch import model as tmodel
from tdc_video_tpu_torch.models import lm as tlm
from tdc_video_tpu_torch.models.quant import quantize_lm_int8
from tdc_video_tpu_torch.parallel import mesh as tmesh
from tdc_video_tpu_torch.parallel import sharding as tsharding
from torch_parity import StandInMesh, to_jax


@pytest.fixture(scope="module")
def trees():
    tp = tmodel.init_tdc(tc.tdc_tiny(), torch.Generator().manual_seed(0), "cpu")
    return {"float": (tp, to_jax(tp)),
            "int8": (dict(tp, lm=quantize_lm_int8(tp["lm"])),
                     dict(to_jax(tp), lm=j_quantize_lm_int8(to_jax(tp["lm"]))))}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _jax_specs(tree):
    """path -> tuple(PartitionSpec) of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path): tuple(s)
            for path, s in flat}


def _port_specs(tree, path=()):
    """path -> spec of the port's spec tree (tuples are its leaves)."""
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in _port_specs(v, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: s for i, v in enumerate(tree) for p, s in _port_specs(v, path + (i,)).items()}
    return {} if tree is None else {path: tree}


def test_auto_mesh_shape_equals_jax():
    for n, kv in itertools.product(range(1, 17), (1, 2, 4, 7, 8, 28)):
        assert tmesh.auto_mesh_shape(n, kv) == jmesh.auto_mesh_shape(n, kv), (n, kv)


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("fsdp", [0, 2])
def test_param_specs_equal_jax(trees, kind, fsdp):
    tp, jp = trees[kind]
    got = _port_specs(tsharding.tdc_param_spec(tp, fsdp_size=fsdp))
    want = _jax_specs(jsharding.tdc_param_spec(jp, fsdp_size=fsdp))
    assert got == want
    lm = _port_specs(tsharding.lm_param_spec(tp["lm"], fsdp_size=fsdp))
    assert lm == _jax_specs(jsharding.lm_param_spec(jp["lm"], fsdp_size=fsdp))
    # the rules reach the leaves they are for
    assert lm[("layers", "o_proj", "w_q" if kind == "int8" else "w")] == (
        "data" if fsdp else None, "model", None)
    if kind == "int8":
        assert lm[("layers", "q_proj", "w_scale")] == ("data" if fsdp else None, "model")
        assert lm[("layers", "mlp", "down", "w_scale")] == ("data" if fsdp else None, None)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_batch_and_kv_cache_specs_equal_jax(quant):
    from tdc_video_tpu.models import lm as jlm

    cache = tlm.init_kv_cache(tc.tdc_tiny().lm, 2, 8, device="cpu", quant=quant)
    jcache = jlm.init_kv_cache(jc.tdc_tiny().lm, 2, 8, quant=quant)
    assert tsharding.kv_cache_spec(cache) == {k: tuple(v) for k, v in
                                              jsharding.kv_cache_spec(jcache).items()}
    batch = {"input_ids": torch.zeros(4, 7, dtype=torch.int32), "frames": torch.zeros(4, 2, 3, 3),
             "scalar": torch.zeros(())}
    jbatch = {k: np.zeros(tuple(v.shape), np.float32) for k, v in batch.items()}
    assert _port_specs(tsharding.batch_spec(batch)) == _jax_specs(jsharding.batch_spec(jbatch))


def _reassemble(x, spec, sizes, coords=None, dims=None):
    """Concatenate local_slice over every coordinate of the named axes, in
    the order of the dims they cut."""
    coords = dict(coords or {"data": 0, "model": 0})
    dims = [d for d, a in enumerate(spec) if a is not None] if dims is None else dims
    if not dims:
        return tsharding.local_slice(x, spec, coords, sizes)
    d, rest = dims[0], dims[1:]
    parts = []
    for i in range(sizes[spec[d]]):
        coords[spec[d]] = i
        parts.append(_reassemble(x, spec, sizes, coords, rest))
    return torch.cat(parts, dim=d)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_local_slices_reassemble_every_leaf(trees, kind):
    tp, _ = trees[kind]
    sizes = {"data": 2, "model": 2}
    spec = tsharding.tdc_param_spec(tp, fsdp_size=2)
    specs = _port_specs(spec)
    cut = 0
    for path, x in _leaves(tp):
        if x is None:
            continue
        s = specs[path]
        assert torch.equal(_reassemble(x, s, sizes), x), path
        cut += any(a is not None for a in s)
    assert cut >= 10  # the LM's leaves are cut, on both axes
    # this rank's shard, column-major int8 weights kept column-major
    mesh = StandInMesh(n_data=1, n_model=2, model=1)
    lm = tsharding.shard_tree(tp["lm"], tsharding.lm_param_spec(tp["lm"]), mesh)
    key = "w_q" if kind == "int8" else "w"
    for name, split in (("q_proj", -1), ("o_proj", -2)):
        full, part = tp["lm"]["layers"][name][key], lm["layers"][name][key]
        assert part.shape[split] * 2 == full.shape[split]
        assert torch.equal(part, full.narrow(split % 3, full.shape[split] // 2,
                                              full.shape[split] // 2))
        if kind == "int8":
            assert part.stride(-2) == 1 and full.stride(-2) == 1
    assert lm["final_norm"]["scale"] is tp["lm"]["final_norm"]["scale"]  # whole: no copy


def test_local_slice_raises_on_an_axis_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        tsharding.local_slice(torch.zeros(6, 4), ("model", None), {"model": 0}, {"model": 4})
    with pytest.raises(ValueError, match="does not divide"):
        tsharding.shard_tree({"w": torch.zeros(4, 6)}, {"w": (None, "model")},
                             StandInMesh(n_model=4))


def test_tp_raises_where_the_model_axis_does_not_divide_the_lm():
    cfg = tc.tdc_tiny()  # 4 query heads, 2 KV heads, 512 tokens
    for n in (3, 4):
        with pytest.raises(ValueError, match="does not divide"):
            tlm.init_kv_cache(cfg.lm, 1, 8, device="cpu", mesh=StandInMesh(n_model=n))
    assert tlm.tp_size(cfg.lm, StandInMesh(n_model=2)) == 2


def test_lm_raises_on_a_layer_axis_split_over_data(trees):
    tp, _ = trees["float"]
    cfg = tc.tdc_tiny()
    mesh = StandInMesh(n_data=2)
    lm = tsharding.shard_tree(tp["lm"], tsharding.lm_param_spec(tp["lm"], fsdp_size=2), mesh)
    assert lm["layers"]["q_proj"]["w"].shape[0] == cfg.lm.num_layers // 2
    ids = torch.ones((1, 4), dtype=torch.int64)
    emb = tlm.embed_tokens(cfg.lm, lm, ids, cfg.dtype, mesh)
    cache = tlm.init_kv_cache(cfg.lm, 1, 4, cfg.dtype, "cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="FSDP"):
        tlm.prefill(cfg.lm, lm, emb, torch.ones((1, 4), dtype=torch.bool), cache,
                    dtype=cfg.dtype, mesh=mesh)


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()  # no group is ever made in the pytest process
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_mesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        tmesh.init_distributed(device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        tmesh.init_distributed(num_processes=2, device="cpu")
    assert not dist.is_initialized()


def test_warmup_collectives_is_a_noop_with_one_rank():
    tmesh.warmup_collectives(StandInMesh())  # would raise on any collective
