"""The port's sharding plan (``repro_torch.distributed.sharding``,
``repro_torch.launch.specs``) against the reference's on every parameter
of all ten full configs, and on every batch and cache leaf of each
``SHAPES`` cell.

The meshes are ducks with only a ``.shape`` (axis name -> size): the
reference's rules read nothing else.  For each of the 16 x 16, 2 x 16 x
16 and 2 x 2 x 2 meshes, each layout, ``pod_fsdp`` and each ``ep_axis``:
the port's mesh-axis tuple equals the reference's ``PartitionSpec`` (its
stacked ``layers`` dim dropped), and its local block shape (DTensor's
``compute_local_shape_and_global_offset`` arithmetic) equals the
reference's ``NamedSharding.shard_shape``; every rank's offset follows
JAX's major-to-minor order."""
import collections
import itertools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import SHAPES as REF_SHAPES
from repro.configs.registry import get_config as ref_config
from repro.distributed import sharding as ref_sharding
from repro.launch import specs as ref_specs
from repro.models.transformer import Transformer as RefTransformer
from repro_torch.configs.registry import ARCHS, SHAPES, get_config
from repro_torch.convert import _named_leaves
from repro_torch.distributed import sharding
from repro_torch.launch.specs import (abstract_cache, abstract_init,
                                      batch_specs, param_specs)
from repro_torch.models import Transformer

pytestmark = pytest.mark.tier1

MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16)),
          "2x2x2": (("pod", 2), ("data", 2), ("model", 2))}


class Duck:
    """A mesh with only ``.shape``."""

    def __init__(self, axes):
        self.shape = collections.OrderedDict(axes)


def _abstract(axes):
    return AbstractMesh(tuple(s for _, s in axes), tuple(n for n, _ in axes))


def _device_mesh(axes):
    """What the port's placement code reads of a ``DeviceMesh``."""
    return types.SimpleNamespace(mesh_dim_names=tuple(n for n, _ in axes),
                                 shape=tuple(s for _, s in axes))


def _parallels(axes):
    pod = "pod" if axes[0][0] == "pod" else None
    out = []
    for layout, pod_fsdp, ep in itertools.product(
            ("tp_fsdp", "fsdp_only", "tp_only"), (False, True),
            ("model", "data")):
        if pod_fsdp and pod is None:
            continue
        kw = dict(pod_axis=pod, pod_fsdp=pod_fsdp, layout=layout,
                  ep_axis=ep)
        out.append((ref_sharding.ParallelConfig(**kw),
                    sharding.ParallelConfig(**kw)))
    return out


def _ref_tuple(pspec) -> tuple:
    out = [tuple(e) if isinstance(e, (list, tuple)) else e for e in pspec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        ref = RefTransformer(ref_config(arch))
        shapes, specs = ref_specs.abstract_init(ref)
        _MODELS[arch] = (ref, shapes, specs,
                         Transformer(get_config(arch), device="meta"))
    return _MODELS[arch]


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_archs_match():
    assert ARCHS == REF_ARCHS and SHAPES == REF_SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_references(arch):
    """Every parameter's logical spec is the reference's leaf spec with
    its stacked ``layers`` dim dropped, and its shape the leaf's shape
    without that dim."""
    _ref, shapes, specs, model = _models(arch)
    port_specs = param_specs(model)
    params = dict(model.named_parameters())
    assert set(port_specs) == set(params)
    for name, path, i in _named_leaves(model):
        ref_spec, ref_shape = _at(specs, path), _at(shapes, path).shape
        if i is None:
            assert port_specs[name] == tuple(ref_spec), name
            assert tuple(params[name].shape) == tuple(ref_shape), name
        else:
            assert ref_spec[0] == "layers"
            assert port_specs[name] == tuple(ref_spec[1:]), name
            assert tuple(params[name].shape) == tuple(ref_shape[1:]), name
    shp, spc = abstract_init(model)
    assert spc == port_specs and all(t.is_meta for t in shp.values())


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_and_shards_match(arch, mesh_name):
    axes = MESHES[mesh_name]
    duck, abstract, dmesh = Duck(axes), _abstract(axes), _device_mesh(axes)
    _ref, shapes, specs, model = _models(arch)
    params = dict(model.named_parameters())
    leaves = _named_leaves(model)
    seen = {}
    for ref_pc, pc in _parallels(axes):
        for name, path, i in leaves:
            ref_spec, ref_shape = _at(specs, path), _at(shapes, path).shape
            port_shape = tuple(params[name].shape)
            key = (path, port_shape, ref_pc)
            if key in seen:
                assert sharding.spec_to_pspec(
                    tuple(ref_spec[1:] if i is not None else ref_spec),
                    port_shape, duck, pc) == seen[key]
                continue
            want = ref_sharding.spec_to_pspec(tuple(ref_spec), ref_shape,
                                              duck, ref_pc)
            got = sharding.spec_to_pspec(
                tuple(ref_spec[1:] if i is not None else ref_spec),
                port_shape, duck, pc)
            want_t = _ref_tuple(want)
            if i is not None:
                assert want_t[:1] in ((), (None,)), "layers never shard"
                want_t = want_t[1:]
            assert got == want_t, (name, pc)
            seen[key] = got
            ref_local = NamedSharding(abstract, want).shard_shape(ref_shape)
            local, _off = sharding.local_shape_and_offset(
                port_shape, dmesh, got, coordinate=[0] * len(axes))
            if i is not None:
                ref_local = ref_local[1:]
            assert tuple(local) == tuple(ref_local), (name, got)


def _jax_offset(shape, pspec, axes, coord):
    """JAX's block of a tensor laid out by ``pspec`` at mesh coordinate
    ``coord``: a dim on axes (a1, a2, ...) takes block index
    sum_i coord[a_i] * prod_{j > i} size[a_j] (major to minor)."""
    size = dict(axes)
    where = {n: c for (n, _), c in zip(axes, coord)}
    local, off = list(shape), [0] * len(shape)
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        n = int(np.prod([size[a] for a in names]))
        idx = 0
        for a in names:
            idx = idx * size[a] + where[a]
        local[d] = shape[d] // n
        off[d] = idx * local[d]
    return tuple(local), tuple(off)


@pytest.mark.parametrize("mesh_name", ["2x2x2", "2x16x16"])
def test_rank_offsets_follow_major_to_minor(mesh_name):
    """Every rank's block of tensors laid out over one axis, two axes of
    one dim (``("pod", "data")``) and several dims, against JAX's
    major-to-minor order."""
    axes = MESHES[mesh_name]
    dmesh = _device_mesh(axes)
    cases = [((64, 128), (("pod", "data"), "model")),
             ((64, 128), ("data", "model")),
             ((32, 32, 64), (None, "model", ("pod", "data"))),
             ((1024,), (("pod", "data", "model"),)),
             ((16, 4), ())]
    coords = list(itertools.product(*(range(s) for _, s in axes)))
    if len(coords) > 64:
        coords = coords[::37] + [coords[-1]]
    for shape, pspec in cases:
        for coord in coords:
            got = sharding.local_shape_and_offset(shape, dmesh, pspec,
                                                  coordinate=list(coord))
            assert tuple(map(tuple, got)) == _jax_offset(shape, pspec, axes,
                                                         coord), \
                (shape, pspec, coord)


def test_placements_shard_both_axes_of_a_dim_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    dmesh = _device_mesh(MESHES["2x16x16"])
    assert sharding.to_placements((("pod", "data"), "model"), dmesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert sharding.to_placements((None, "model"), dmesh) == [
        Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="mesh order"):
        sharding.to_placements((("data", "pod"),), dmesh)


def _ref_cache_leaves(arch, shape_name):
    seq, gbatch, _mode = REF_SHAPES[shape_name]
    ref = RefTransformer(ref_config(arch))
    import jax.numpy as jnp
    tree = ref_specs.abstract_cache(ref, gbatch, seq, dtype=jnp.bfloat16,
                                    window_bound=shape_name == "long_500k")
    return [tuple(x.shape) for x in jax.tree.leaves(tree)]


def _port_cache_leaves(arch, shape_name):
    seq, gbatch, _mode = SHAPES[shape_name]
    model = _models(arch)[3]
    tree = abstract_cache(model, gbatch, seq,
                          window_bound=shape_name == "long_500k")
    out = []
    for group in sorted(tree):       # jax.tree.leaves' sorted dict keys
        slots = tree[group]
        for slot in ([slots] if group == "prefix" else slots):
            out += [tuple(t.shape) for t in slot]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_pspecs_match(arch):
    """``batch_pspec`` on every input and ``cache_pspec`` on every cache
    leaf of each ``SHAPES`` cell, on every mesh and layout."""
    cfg = get_config(arch)
    rcfg = ref_config(arch)
    for shape_name in SHAPES:
        mode = SHAPES[shape_name][2]
        ref_batch = ref_specs.batch_specs(rcfg, shape_name)
        port_batch = batch_specs(cfg, shape_name)
        assert list(port_batch) == list(ref_batch)
        for k in ref_batch:
            assert tuple(port_batch[k].shape) == tuple(ref_batch[k].shape)
            assert port_batch[k].is_meta
        caches = []
        if mode != "train" and (shape_name != "long_500k"
                                or arch in ("mamba2_1p3b",
                                            "recurrentgemma_2b")):
            caches = _ref_cache_leaves(arch, shape_name)
            assert _port_cache_leaves(arch, shape_name) == caches
        for axes in MESHES.values():
            duck = Duck(axes)
            for ref_pc, pc in _parallels(axes):
                for k, v in ref_batch.items():
                    if v.ndim == 0:
                        continue
                    sd = 1 if v.ndim >= 2 else None
                    for seq_shard in (False, True):
                        rp = ref_sharding.ParallelConfig(
                            **{**ref_pc.__dict__, "seq_shard": seq_shard})
                        pp = sharding.ParallelConfig(
                            **{**pc.__dict__, "seq_shard": seq_shard})
                        want = ref_sharding.batch_pspec(v.shape[0], v.ndim,
                                                        duck, rp, seq_dim=sd)
                        got = sharding.batch_pspec(v.shape[0], v.ndim, duck,
                                                   pp, seq_dim=sd)
                        assert got == _ref_tuple(want), (k, pp)
                for shape in caches:
                    want = ref_sharding.cache_pspec(shape, duck, ref_pc)
                    got = sharding.cache_pspec(shape, duck, pc)
                    assert got == _ref_tuple(want), shape


def test_constrain_batch_activations_is_a_no_op_on_plain_tensors():
    x = torch.randn(4, 3, 2)
    pc = sharding.ParallelConfig(axis_sizes=(("data", 2), ("model", 2)))
    assert sharding.constrain_batch_activations(x, pc) is x
    assert sharding.constrain_batch_activations(x, None) is x
    assert sharding.constrain_batch_activations(
        x, sharding.ParallelConfig()) is x
