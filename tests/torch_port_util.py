"""Helpers shared by the ``test_torch_*`` files: numpy <-> torch key and
table conversions, and snapshots of an OCF's full state for comparing the
port with the reference."""
import dataclasses

import numpy as np
import torch

from repro_torch.convert import state_to_numpy
from repro_torch.kernels.staging_cases import (  # noqa: F401 (re-exported)
    ADAPTIVE_STAGING_CASES, STAGING_CASES, adaptive_planes,
    adaptive_staging_inputs, random_keys, staging_inputs)


def split(keys):
    """uint64 keys -> (hi, lo) uint32 numpy halves."""
    k = np.asarray(keys, dtype=np.uint64)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def t32(a):
    """uint32 (or bool) numpy -> the port's tensor (int32 bit pattern)."""
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32).copy())


def u32(t):
    """The port's int32 tensor -> uint32 numpy (same bits)."""
    return t.detach().cpu().numpy().view(np.uint32)


def ref_snapshot(ocf):
    st = ocf.stash
    return {"table": np.asarray(ocf.state.table),
            "count": int(ocf.state.count),
            "n_buckets": int(ocf.state.n_buckets),
            "stash": None if st is None else np.asarray(st),
            "capacity_history": list(ocf.capacity_history),
            "stats": dataclasses.asdict(ocf.stats)}


def port_snapshot(ocf):
    d = state_to_numpy(ocf.state, ocf.stash)
    d["capacity_history"] = list(ocf.capacity_history)
    d["stats"] = dataclasses.asdict(ocf.stats)
    return d


def assert_same_state(ref, port, where=""):
    assert ref.keys() == port.keys()
    for key, rv in ref.items():
        pv = port[key]
        if isinstance(rv, np.ndarray) or isinstance(pv, np.ndarray):
            assert rv is not None and pv is not None, (where, key)
            np.testing.assert_array_equal(rv, pv, err_msg=f"{where} {key}")
        else:
            assert rv == pv, (where, key, rv, pv)


def ocf_stream(seed, n_keys=40_000):
    """A seeded op stream: insert bursts of growing size (grows, and
    failed inserts that force emergency grows), lookups of present and
    absent keys, verified deletes mixed with blind ones, and deletes down
    to a shrink, then a re-insert burst."""
    rng = np.random.RandomState(seed)
    keys = random_keys(rng, n_keys)
    absent = random_keys(rng, 4000)
    ops, i = [], 0
    for frac in (0.075, 0.125, 0.3, 0.2, 0.3):
        size = int(n_keys * frac)
        ops.append(("insert", keys[i:i + size]))
        i += size
        ops.append(("lookup", np.concatenate([keys[max(0, i - 3000):i],
                                              absent[:1000]])))
    ops.append(("delete", np.concatenate([keys[:500], absent[:300],
                                          keys[:100]])))
    for j in range(500, int(n_keys * 0.9), 6000):
        ops.append(("delete", keys[j:j + 6000]))
    ops.append(("lookup", np.concatenate([keys[-4000:], absent])))
    ops.append(("insert", keys[:5000]))
    ops.append(("lookup", np.concatenate([keys[:6000], absent])))
    return ops


def run_ocf_parity(ref_ocf, port_ocf, ops):
    """Drive both OCFs through ``ops``; compare answers and full state
    after every operation."""
    for step, (op, keys) in enumerate(ops):
        ra = np.asarray(getattr(ref_ocf, op)(keys))
        pa = np.asarray(getattr(port_ocf, op)(keys))
        np.testing.assert_array_equal(pa, ra, err_msg=f"{step} {op}")
        assert_same_state(ref_snapshot(ref_ocf), port_snapshot(port_ocf),
                          f"after op {step} ({op})")


# ------------------------------------------------------------ streaming --


def ref_ring_snapshot(ring):
    """The reference ``GenerationalFilter``'s state in the form of
    ``repro_torch.convert.generational_to_numpy``."""
    return {"gens": [{"table": np.asarray(g.state.table),
                      "stash": np.asarray(g.stash.array),
                      "count": int(g.state.count), "born": g.born,
                      "expires": g.expires} for g in ring.gens],
            "last_now": ring._last_now,
            "stats": dataclasses.asdict(ring.stats)}


def assert_same_ring(ref_ring, port_ring, where=""):
    from repro_torch.convert import generational_to_numpy
    ref, port = ref_ring_snapshot(ref_ring), generational_to_numpy(port_ring)
    assert ref["last_now"] == port["last_now"], where
    assert ref["stats"] == port["stats"], (where, ref["stats"],
                                           port["stats"])
    assert len(ref["gens"]) == len(port["gens"]), where
    for i, (rg, pg) in enumerate(zip(ref["gens"], port["gens"])):
        assert_same_state(rg, pg, f"{where} gen {i}")


# ------------------------------------------------------------- LM stack --

# name -> (arch, ModelConfig overrides) of the smoke configs the LM tests
# hold against the reference; gemma3 at 14 layers runs 2 periods + a tail;
# deepseek runs a dense MLA prefix layer, then MLA + MoE blocks; mamba2
# two SSM blocks; recurrentgemma one (rglru, rglru, local) period; musicgen
# global blocks with cross-attention; llava a global stack that takes
# prefix embeddings.
LM_CONFIGS = {"gemma3": ("gemma3_1b", {}),
              "gemma3-14": ("gemma3_1b", dict(n_layers=14)),
              "gemma2": ("gemma2_27b", {}),
              "mistral-nemo": ("mistral_nemo_12b", {}),
              "deepseek": ("deepseek_v2_lite_16b", {}),
              "qwen3-moe": ("qwen3_moe_235b_a22b", {}),
              "mamba2": ("mamba2_1p3b", {}),
              "recurrentgemma": ("recurrentgemma_2b", {}),
              "musicgen": ("musicgen_large", {}),
              "llava": ("llava_next_mistral_7b", {})}
_REF_PARAMS = {}


def _ref_vectors(n):
    """The reference's init of the per-channel leaves of a layer with
    ``n`` channels (``repro/models/ssm.py:45-54``, ``rglru.py:49-53``)."""
    y = np.linspace(0.9, 0.999, n) ** (1.0 / 8.0)
    return {"A_log": np.log(np.linspace(1.0, 16.0, n)),
            "D": np.ones(n),
            "dt_bias": np.log(np.expm1(np.exp(np.linspace(
                np.log(1e-3), np.log(1e-1), n)))),
            "lam": np.log(y / (1.0 - y))}


def lm_configs(name, dtype="float32"):
    """(reference config, port config) of ``LM_CONFIGS[name]``."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro_torch.configs import get_smoke_config
    arch, over = LM_CONFIGS[name]
    return (dataclasses.replace(ref_smoke(arch), dtype=dtype, **over),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over))


def lm_params_np(name, seed=0):
    """Weights for ``LM_CONFIGS[name]`` in the reference's parameter pytree,
    made with numpy from ``seed``: fan-in scaled normals for the matrices
    and the embedding, 1 + 0.1 N(0, 1) for the norm weights (so that a
    norm weight read from the wrong place shows), the reference's init
    values plus 0.1 N(0, 1) for the SSM's and RG-LRU's per-channel leaves
    (``A_log``, ``D``, ``dt_bias``, ``lam``) and 0.1 N(0, 1) for their
    biases (``conv_b``, ``b_a``, ``b_x``; the reference's are 0).  The
    pytree's structure and shapes are the reference init's
    (``jax.eval_shape``)."""
    import jax
    from repro.models import Transformer as RefTransformer
    rcfg, _ = lm_configs(name)
    shapes = jax.eval_shape(lambda k: RefTransformer(rcfg).init(k)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        key = getattr(path[-1], "key", str(path[-1]))
        if "norm" in key:
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if key in ("A_log", "D", "dt_bias", "lam"):
            base = _ref_vectors(leaf.shape[-1])[key]
            return (base + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if key in ("conv_b", "b_a", "b_x"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[-1] if "embed" in key else leaf.shape[-2]
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def lm_models(name, dtype="float32"):
    """-> (reference Transformer, its params as jax arrays, the port's
    Transformer on the CPU holding the same weights), the weights from
    ``lm_params_np`` (made once per config and process)."""
    import jax
    import jax.numpy as jnp
    from repro.models import Transformer as RefTransformer
    from repro_torch.convert import transformer_params_from_numpy
    rcfg, pcfg = lm_configs(name, dtype)
    if name not in _REF_PARAMS:
        _REF_PARAMS[name] = lm_params_np(name)
    pnp = _REF_PARAMS[name]
    return (RefTransformer(rcfg), jax.tree.map(jnp.asarray, pnp),
            transformer_params_from_numpy(pnp, pcfg, device="cpu"))


def ref_logits(ref, params, toks):
    """The reference's cache-less forward logits of numpy token ids."""
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.jit(lambda p, t: ref.apply(p, t).logits)(
        params, jnp.asarray(toks)))


def lm_tokens(cfg, shape, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


def row_rel_err(got, want):
    """Per output row (the last axis) ||got - want|| / ||want|| over the
    rows whose ``want`` is not all 0 -> a float tensor of those rows."""
    num = (got.float() - want.float()).norm(dim=-1)
    den = want.float().norm(dim=-1)
    live = den > 0
    return num[live] / den[live]


# -------------------------------------------------------------- serving --

# Short scenario streams (tests/test_slo.py's SMALL) for waves of 64 keys.
SLO_WS = 64
SLO_SMALL = {
    "uniform": dict(waves=8),
    "zipfian": dict(waves=8),
    "adversarial": dict(rounds=2),
    "burst_train": dict(bursts=2, burst_waves=2, gap_waves=2),
    "ttl_churn": dict(waves=8),
    "delete_heavy": dict(waves=9),
}


def recording_harness(base):
    """An instance of a subclass of ``base`` (the reference's or the port's
    ``SloHarness``) that keeps what a replay drove: ``target`` (the
    batcher or the ring) and ``waves`` (every submitted ``OpWave``, report
    waves included, or every ring call's host answer), in order."""
    class Recording(base):
        def run(self, batcher, stream, **kw):
            self.target, self.waves = batcher, []
            submit = batcher.submit

            def recorded(kind, keys):
                wave = submit(kind, keys)
                self.waves.append(wave)
                return wave
            batcher.submit = recorded
            return super().run(batcher, stream, **kw)

        def run_generational(self, filt, stream, **kw):
            self.target, self.waves = filt, []
            for op in ("insert", "lookup"):
                def recorded(keys, now=None, _fn=getattr(filt, op)):
                    out = _fn(keys, now=now)
                    self.waves.append(out)
                    return out
                setattr(filt, op, recorded)
            return super().run_generational(filt, stream, **kw)
    return Recording()


def report_fields(report):
    """An ``SloReport``'s fields that are no host time: counts, extras and
    each sample's (kind, ops, burst, deferred)."""
    return {"ops": report.ops, "waves": report.waves,
            "shed_ops": report.shed_ops,
            "deferred_waves": report.deferred_waves,
            "held_ticks": report.held_ticks, "extras": report.extras,
            "kinds": sorted(report.per_kind),
            "samples": [(s.kind, s.ops, s.burst, s.deferred)
                        for s in report.recorder.samples]}


# ------------------------------------------- reference runs on a mesh ---

_ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
_PREAMBLE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
import numpy as np
IN = dict(np.load({inp!r}))
OUT = {{}}
"""


def reference_run(script: str, *, devices: int, inputs=None,
                  timeout: int = 300) -> dict:
    """Run ``script`` against the reference in a subprocess whose JAX sees
    ``devices`` CPU devices (meshes from ``filter_mesh(n)``) -> ``OUT``.

    The script reads numpy ``inputs`` as ``IN`` and fills the dict ``OUT``
    with numpy arrays and numbers, which come back through an ``.npz``.
    """
    import os
    import subprocess
    import sys
    import tempfile
    import textwrap
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(inp, **(inputs or {}))
        code = (_PREAMBLE.format(n=devices, inp=inp)
                + textwrap.dedent(script)
                + f"\nnp.savez({out!r}, **OUT)\n")
        env = {"PYTHONPATH": str(_ROOT / "src"), "JAX_PLATFORMS": "cpu",
               "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
               "HOME": os.environ.get("HOME", tmp)}
        res = subprocess.run([sys.executable, "-c", code], cwd=str(_ROOT),
                             env=env, capture_output=True, text=True,
                             timeout=timeout)
        assert res.returncode == 0, res.stderr[-4000:]
        with np.load(out) as f:
            return {k: f[k] for k in f.files}


# Reference-side helpers for ``reference_run`` scripts: ``lookup`` is the
# reference's ``distributed_lookup`` under one jit per setting (the bare
# call re-traces its shard_map on every call, ~10 s each on the CPU), and
# it replaces the module attribute, which ``degraded_lookup`` imports at
# call time; ``put`` stores a sharded state and arrays under a tag.
REF_JIT_LOOKUP = """
import jax
import jax.numpy as jnp
from repro.core import distributed as _dist

_orig_lookup = _dist.distributed_lookup
_LOOKUPS = {}


def lookup(mesh, state, hi, lo, *, fp_bits, backend="auto", route="key",
           capacity_factor=2.0, axis="data"):
    key = (mesh, axis, state.n_buckets, state.stashes is None, fp_bits,
           backend, route, capacity_factor)
    fn = _LOOKUPS.get(key)
    if fn is None:
        nb = state.n_buckets

        def run(tables, stashes, hi, lo):
            st = _dist.ShardedFilterState(tables, stashes, nb)
            return _orig_lookup(mesh, axis, st, hi, lo, fp_bits=fp_bits,
                                backend=backend, route=route,
                                capacity_factor=capacity_factor)
        fn = _LOOKUPS[key] = jax.jit(run)
    return fn(state.tables, state.stashes, jnp.asarray(hi), jnp.asarray(lo))


def _jit_lookup(mesh, axis, state, hi, lo, *, fp_bits, capacity_factor=2.0,
                backend="auto", route="key"):
    return lookup(mesh, state, hi, lo, fp_bits=fp_bits, backend=backend,
                  route=route, capacity_factor=capacity_factor, axis=axis)


_dist.distributed_lookup = _jit_lookup


def put(tag, state, **arrays):
    OUT[tag + "/tables"] = np.asarray(state.tables)
    if state.stashes is not None:
        OUT[tag + "/stashes"] = np.asarray(state.stashes)
    for k, v in arrays.items():
        OUT[f"{tag}/{k}"] = np.asarray(v)
"""


# ------------------------------------------------------- small-mesh dry-run --
#
# The port's dry-run on a 2 x 2 x 2 (pod, data, model) mesh of the fake
# process-group backend (world 8, one process a run), and the reference's
# ``tests/test_dryrun_small.py`` step on 8 host devices, for the same smoke
# config, batch (8 x 32) and decode cache (64).

# Records, in a dry-run process, every DTensor transition that torch 2.11's
# DTensor refuses and later versions carry out: a redistribution from
# ``Shard`` to ``Partial`` on a mesh dim ("redistribute from S(0) to P(sum)
# not supported yet"), and a strict view (``view``, ``_unsafe_view``) that
# flattens input dims of which one but the first is sharded ("Attempted to
# flatten multiple dimensions, with dimension 1 being sharded"), or whose
# first is sharded unevenly, or that splits a sharded dim whose first part
# the shards do not divide ("Attempted to split the sharded dimension"),
# and a pointwise operation that 2.11 would resolve by turning a shard into
# a partial sum (``_Meets``, over the steps run through ``watched``).  The
# port lays such sites out explicitly, so a run on any version records
# none.
REFUSED_RECORDER = """
import torch
from torch.distributed.tensor import Partial, Shard
from torch.distributed.tensor import _api, _dispatch, _redistribute
from torch.distributed.tensor._ops import _view_ops
from torch.utils._python_dispatch import TorchDispatchMode
try:
    from torch.distributed.tensor.placement_types import _StridedShard
except ImportError:
    _StridedShard = Shard
REFUSED = []


def _sharded(p):
    return isinstance(p, (Shard, _StridedShard))


def _recording_redistribute(fn):
    def redistribute_local_tensor(local, current, target, *a, **kw):
        if any(_sharded(src) and isinstance(dst, Partial)
               for src, dst in zip(current.placements, target.placements)):
            REFUSED.append(f"redistribute {tuple(current.placements)} -> "
                           f"{tuple(target.placements)} of "
                           f"{tuple(current.shape)}")
        return fn(local, current, target, *a, **kw)
    return redistribute_local_tensor


for _mod in (_api, _dispatch, _redistribute):
    _mod.redistribute_local_tensor = _recording_redistribute(
        _mod.redistribute_local_tensor)


def _flattens(spec):
    if isinstance(spec, _view_ops.Flatten):
        yield spec
    for child in spec.inputs():
        yield from _flattens(child)


def _splits(spec):
    # (input dim, first output size) of each split that starts a dim
    if isinstance(spec, _view_ops.Split) and spec.split_id == 0:
        src = spec.input_dim
        if isinstance(src, _view_ops.Flatten):
            src = src.input_dims[0]
        if isinstance(src, _view_ops.InputDim):
            yield src.input_dim, spec.group_shape[0]
    for child in spec.inputs():
        yield from _splits(child)


_propagate = _view_ops.propagate_shape_and_sharding


def propagate_shape_and_sharding(placements, shape, rule, mesh_sizes,
                                 strict_view=False):
    if strict_view:
        sharded = {p.dim for p in placements if _sharded(p)}
        uneven = {p.dim for p, n in zip(placements, mesh_sizes)
                  if _sharded(p) and shape[p.dim] % n}
        for spec in rule:
            for f in _flattens(spec):
                dims = [d.input_dim for d in f.input_dims
                        if isinstance(d, _view_ops.InputDim)]
                if sharded & set(dims[1:]) or uneven & set(dims[:1]):
                    REFUSED.append(f"flatten dims {dims} of {tuple(shape)} "
                                   f"under {tuple(placements)}")
            for dim, first in _splits(spec):
                ways = 1
                for p, n in zip(placements, mesh_sizes):
                    ways *= n if _sharded(p) and p.dim == dim else 1
                if first % ways:
                    REFUSED.append(f"split dim {dim} of {tuple(shape)} "
                                   f"into {first} x .. under "
                                   f"{tuple(placements)}")
    return _propagate(placements, shape, rule, mesh_sizes, strict_view)


_view_ops.propagate_shape_and_sharding = propagate_shape_and_sharding


class _Meets(TorchDispatchMode):
    # a pointwise operation whose most sharded DTensor operand (the first
    # on a tie: the one 2.11's strategy follows) holds a partial sum on a
    # mesh dim where another operand is sharded: 2.11 asks for that shard
    # to become a partial sum
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dts = [a for a in (*args, *kwargs.values())
               if type(a).__name__ == "DTensor"]
        if torch.Tag.pointwise in func.tags and len(dts) > 1:
            lead = max(dts, key=lambda d: sum(map(_sharded, d.placements)))
            for i, p in enumerate(lead.placements):
                if p.is_partial() and any(_sharded(d.placements[i])
                                          for d in dts if d is not lead):
                    REFUSED.append(f"{func} follows a partial sum onto a "
                                   f"shard: "
                                   f"{[tuple(d.placements) for d in dts]}")
                    break
        return func(*args, **kwargs)


def watched(fn, *args, **kwargs):
    # fn under _Meets, entered inside the step counter so that it sees
    # the DTensor operations
    with _Meets():
        return fn(*args, **kwargs)
"""

DRYRUN_PORT_SCRIPT = REFUSED_RECORDER + """
import json, sys, torch
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import ParallelConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_process_group, make_test_mesh
from repro_torch.launch.specs import abstract_cache
from repro_torch.models import Transformer
from repro_torch.optim.adamw import AdamW
from repro_torch.serving.engine import make_decode_step
from repro_torch.train.step import make_train_step

arch = sys.argv[1]
dryrun._quiet()
init_fake_process_group(8)
dryrun.register_strategies()
mesh = make_test_mesh(2, 2, pod=2)
parallel = ParallelConfig(pod_axis="pod", remat="dots", compress_grads=True,
                          axis_sizes=tuple(zip(mesh.mesh_dim_names,
                                               mesh.shape)))
cfg = get_smoke_config(arch)
B, S = 8, 32
meta = dict(dtype=torch.int32, device="meta")
batch = {"tokens": torch.empty(B, S, **meta),
         "targets": torch.empty(B, S, **meta)}
if cfg.prefix_embed_len:
    batch["prefix_embeds"] = torch.empty(
        B, cfg.prefix_embed_len, cfg.d_model, dtype=torch.bfloat16,
        device="meta")
if cfg.cross_attn_memory_len:
    batch["memory"] = torch.empty(
        B, cfg.cross_attn_memory_len, cfg.cross_attn_memory_dim,
        dtype=torch.bfloat16, device="meta")
batch = dryrun.distribute_batch(batch, mesh, parallel)
model = Transformer(cfg, device="meta")
dryrun.distribute_params(model, mesh, parallel)
tx = AdamW(lr=1e-3)
step = make_train_step(model, tx, parallel)
params = dict(model.named_parameters())
opt = tx.init(params)
_, train = dryrun.trace(lambda: watched(step, params, opt, batch))

dec_model = Transformer(cfg, device="meta")
dryrun.distribute_params(dec_model, mesh, parallel)
cache = dryrun.distribute_cache(abstract_cache(dec_model, B, 64), mesh,
                                parallel)
tok = dryrun.distribute_batch(
    {"token": torch.empty(B, 1, **meta)}, mesh, parallel)["token"]
kw = {"memory": batch["memory"]} if cfg.cross_attn_memory_len else {}
dec = make_decode_step(dec_model)
(logits, _), decode = dryrun.trace(lambda: watched(dec, cache, tok, 63,
                                                   **kw))
print(json.dumps({
    "train_collectives": train.count, "train_flops": train.flops,
    "train_by_op": train.by_op, "decode_collectives": decode.count,
    "decode_shape": list(logits.shape), "decode_ok": True,
    "refused": REFUSED}))
"""

DRYRUN_REF_FLOPS_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_smoke_config
from repro.distributed.sharding import (ParallelConfig, batch_pspec,
                                        make_shardings)
from repro.launch.specs import abstract_init
from repro.models.transformer import Transformer
from repro.optim.adamw import AdamW, AdamWState
from repro.train.step import make_train_step
from repro.roofline.analysis import parse_collectives

arch = sys.argv[1]
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
parallel = ParallelConfig(pod_axis="pod", remat="dots", compress_grads=True)
cfg = get_smoke_config(arch)
model = Transformer(cfg)
shapes, specs = abstract_init(model)
shard = make_shardings(mesh, specs, shapes, parallel)
tx = AdamW(lr=1e-3)
o_shapes = jax.eval_shape(tx.init, shapes)
rep = NamedSharding(mesh, P())
o_shard = AdamWState(step=rep, m=shard, v=shard)
B, S = 8, 32
batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
         "targets": jax.ShapeDtypeStruct((B, S), jnp.int32)}
bs = {k: NamedSharding(mesh, batch_pspec(B, 2, mesh, parallel))
      for k in batch}
if cfg.cross_attn_memory_len:
    batch["memory"] = jax.ShapeDtypeStruct(
        (B, cfg.cross_attn_memory_len, cfg.cross_attn_memory_dim),
        jnp.bfloat16)
    bs["memory"] = NamedSharding(mesh, batch_pspec(B, 3, mesh, parallel))
if cfg.prefix_embed_len:
    batch["prefix_embeds"] = jax.ShapeDtypeStruct(
        (B, cfg.prefix_embed_len, cfg.d_model), jnp.bfloat16)
    bs["prefix_embeds"] = NamedSharding(mesh, batch_pspec(B, 3, mesh,
                                                          parallel))
step = make_train_step(model, tx, parallel)
with mesh:
    compiled = jax.jit(step, in_shardings=(shard, o_shard, bs)).lower(
        shapes, o_shapes, batch).compile()
coll = parse_collectives(compiled.as_text())
print(json.dumps({"train_flops": coll.flops, "train_collectives": coll.count}))
"""


def run_script(script: str, *args, jax_devices: bool = False,
               timeout: int = 600) -> dict:
    """Run a script in a process of its own (one process group, or one
    JAX device count, a process) -> the JSON of its last line."""
    import json
    import os
    import subprocess
    import sys
    env = {"PYTHONPATH": str(_ROOT / "src"),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp")}
    if jax_devices:
        env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", script, *args],
                         cwd=str(_ROOT), env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def check_traced(out: dict) -> None:
    """A small-mesh dry-run traced its train and decode steps, and the
    sharded train step communicated."""
    assert out["decode_ok"] and out["decode_shape"][:2] == [8, 1]
    assert out["train_collectives"] > 0, "sharded training must communicate"
    assert out["train_flops"] > 0
    assert not out["refused"], out["refused"]
