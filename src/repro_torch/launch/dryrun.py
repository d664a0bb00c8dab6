"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step on
DTensors over the production mesh, with nothing allocated.

Counterpart of ``repro.launch.dryrun``.  Run it as its own process: it
starts a ``fake`` process group of the mesh's size (256 ranks single-pod,
512 multi-pod), this process being rank 0.  For each cell it

  1. builds the production mesh (16 x 16, or 2 x 16 x 16),
  2. builds the model on ``meta`` and lays every parameter, optimizer
     moment, cache and input out as a DTensor by the sharding rules of
     ``repro_torch.distributed.sharding`` (each rank's block is a
     ``meta`` tensor),
  3. runs the step once: train cells the port's ``make_train_step`` and
     ``AdamW``, serving cells prefill or one decode step on bfloat16
     weights (window-bound caches for ``long_500k``); DTensor inserts the
     collectives its layouts need,
  4. counts rank 0's FLOPs, bytes and collectives
     (``roofline.analysis.StepCounter``) and writes the roofline terms to
     ``artifacts/dryrun_torch/<arch>__<shape>__<mesh><tag>.json``.

A kernel wrapper given a ``meta`` DTensor takes its plain version, one
block a rank (``kernels.ops.attention``), as the reference's dry-run
lowers its off-TPU path.  Argument and output bytes a device are exact
(the local shapes); ``meta`` tensors have no allocator, so the
temporary and peak bytes are ``None``, as the reference records them
where a backend gives none.  A cell that raises prints FAIL with the
error; nothing is caught and counted as OK.

Usage:
  python -m repro_torch.launch.dryrun --arch mistral-nemo-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time
import traceback

import torch


def _quiet() -> None:
    """DTensor warns at every multi-dim redistribution and the fake
    backend at every all-to-all; the counts carry what they say."""
    for name in ("torch.distributed.tensor._redistribute",
                 "torch.distributed.distributed_c10d", "torch._logging"):
        logging.getLogger(name).setLevel(logging.ERROR)
    import warnings
    warnings.filterwarnings("ignore", message=".*backward hooks.*")


def register_strategies() -> None:
    """Sharding rules DTensor lacks for an operation the step runs:
    ``log_sigmoid_backward`` (the RG-LRU's gate, in training) is
    elementwise, so every operand takes the output's placement."""
    op = torch.ops.aten.log_sigmoid_backward.default
    try:
        from torch.distributed.tensor._ops._pointwise_ops import \
            _register_single_dim_pointwise
    except ImportError:
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import register_sharding

        @register_sharding(op)
        def _pointwise(grad, x, buffer):
            out = [([Replicate()], [Replicate(), Replicate(), Replicate()])]
            for d in range(x.ndim):
                out.append(([Shard(d)], [Shard(d), Shard(d), Shard(d)]))
            return out
        return
    _register_single_dim_pointwise(op)


# ----------------------------------------------------------- layouts --


def distribute_params(model, mesh, parallel, *, dtype=None) -> dict:
    """Replace every parameter of a ``meta`` model by a DTensor laid out
    by its logical spec (``dtype``: cast float32 weights, as serving
    does) -> ``{name: mesh-axis tuple}``."""
    from repro_torch.distributed.sharding import distribute, make_shardings
    from repro_torch.launch.specs import abstract_init
    shapes, specs = abstract_init(model)
    pspecs = make_shardings(mesh, specs, shapes, parallel)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        t = p.data
        if dtype is not None and t.dtype == torch.float32:
            t = t.to(dtype)
        model.get_submodule(owner)._parameters[leaf] = torch.nn.Parameter(
            distribute(t, mesh, pspecs[name]), requires_grad=False)
    return pspecs


def distribute_cache(cache, mesh, parallel):
    """A cache of ``meta`` tensors -> the same tree of DTensors laid out
    by ``cache_pspec``."""
    from repro_torch.distributed.sharding import cache_pspec, distribute
    if isinstance(cache, dict):
        return {k: distribute_cache(v, mesh, parallel)
                for k, v in cache.items()}
    if isinstance(cache, list):
        return [distribute_cache(v, mesh, parallel) for v in cache]
    return type(cache)(*(distribute(t, mesh, cache_pspec(tuple(t.shape),
                                                          mesh, parallel))
                         for t in cache))


def distribute_batch(batch: dict, mesh, parallel) -> dict:
    """Step inputs laid out by ``batch_pspec`` (a 0-dim input
    replicated)."""
    from repro_torch.distributed.sharding import batch_pspec, distribute
    return {k: distribute(v, mesh, () if v.ndim == 0 else batch_pspec(
        v.shape[0], v.ndim, mesh, parallel,
        seq_dim=1 if v.ndim >= 2 else None)) for k, v in batch.items()}


def local_bytes(tree) -> int:
    """Bytes of rank 0's blocks of every tensor in a tree."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


# -------------------------------------------------------------- cells --


def _build(arch: str, shape_name: str, mesh_kind: str, knobs: dict):
    """-> (step thunk, its inputs, cfg, parallel, mesh) of one cell."""
    from repro_torch.configs.registry import SHAPES, get_config
    from repro_torch.distributed.sharding import ParallelConfig
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import abstract_cache, batch_specs
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.serving.engine import make_decode_step, make_prefill_step
    from repro_torch.train.step import make_train_step

    cfg = get_config(arch)
    seq, gbatch, mode = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    parallel = ParallelConfig(
        axis_sizes=tuple(zip(mesh.mesh_dim_names, mesh.shape)),
        pod_axis="pod" if mesh_kind == "multi" else None,
        pod_fsdp=knobs.get("pod_fsdp", False),
        compress_grads=knobs.get("compress_grads", False),
        remat=knobs.get("remat", "dots"),
        microbatches=knobs.get("microbatches", 1),
        seq_shard=knobs.get("seq_shard", False),
        layout=knobs.get("layout", "tp_fsdp"),
        ep_axis=knobs.get("ep_axis", "model"),
    )
    model = Transformer(cfg, device="meta")
    batch = distribute_batch(batch_specs(cfg, shape_name), mesh, parallel)

    if mode == "train":
        distribute_params(model, mesh, parallel)
        tx = AdamW(lr=cosine_schedule(3e-4, 100, 10000))
        step = make_train_step(model, tx, parallel)
        params = dict(model.named_parameters())
        opt = tx.init(params)
        return (lambda: step(params, opt, batch),
                (params, opt.m, opt.v, batch), cfg, parallel, mesh)

    # serving runs bfloat16 weights; long-context decode gives local
    # attention slots window-sized rings
    distribute_params(model, mesh, parallel, dtype=torch.bfloat16)
    cache = distribute_cache(
        abstract_cache(model, gbatch, seq, dtype=torch.bfloat16,
                       window_bound=(shape_name == "long_500k")),
        mesh, parallel)
    params = dict(model.named_parameters())
    if mode == "prefill":
        step = make_prefill_step(model, parallel)
        kw = {k: batch[k] for k in ("memory", "prefix_embeds") if k in batch}
        return (lambda: step(cache, batch["tokens"], **kw),
                (params, cache, batch), cfg, parallel, mesh)
    step = make_decode_step(model, parallel)
    kw = {k: batch[k] for k in ("memory",) if k in batch}
    return (lambda: step(cache, batch["token"], seq - 1, **kw),
            (params, cache, batch), cfg, parallel, mesh)


def trace(thunk):
    """Run a step thunk once under the counter -> (its outputs, the
    counter's ``CollectiveStats``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.roofline.analysis import StepCounter
    counter = StepCounter()
    # plain tensors that meet DTensors (positions, masks, rope tables,
    # scalars) are the same on every rank: treat them as replicated
    with counter, implicit_replication():
        out = thunk()
    return out, counter.stats


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             knobs=None, tag: str = "") -> dict:
    from repro_torch.roofline.analysis import Roofline, model_flops_for

    knobs = knobs or {}
    t0 = time.time()
    thunk, inputs, cfg, parallel, mesh = _build(arch, shape_name, mesh_kind,
                                                knobs)
    t_build = time.time() - t0
    out, stats = trace(thunk)
    t_trace = time.time() - t0 - t_build
    mem = {"argument_bytes": local_bytes(inputs),
           "output_bytes": local_bytes(out),
           "temp_bytes": None, "peak_bytes": None}
    n_active = cfg.active_param_count()
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_kind, chips=mesh.size(),
        flops_per_dev=float(stats.flops), bytes_per_dev=float(stats.hbm_bytes),
        wire_bytes_per_dev=float(stats.wire_bytes),
        model_flops=model_flops_for(cfg, shape_name, n_active),
        collectives={"by_op": stats.by_op, "count": stats.count,
                     "operand_bytes": stats.operand_bytes},
        memory_stats=mem,
    ).finalize()
    rec = rl.to_dict()
    rec.update({
        "params_total": cfg.param_count(),
        "params_active": n_active,
        "t_build_s": round(t_build, 2),
        "t_trace_s": round(t_trace, 2),
        "knobs": knobs,
        "counted_on": "rank 0's local operations",
    })
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}__{shape_name}__{mesh_kind}{tag}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--remat", default="dots",
                    choices=["none", "full", "dots"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--pod-fsdp", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--layout", default="tp_fsdp",
                    choices=["tp_fsdp", "fsdp_only", "tp_only"])
    ap.add_argument("--ep-axis", default="model", choices=["model", "data"])
    args = ap.parse_args(argv)
    if args.mesh == "both":
        # one process group a process: each mesh in a process of its own
        argv = list(sys.argv[1:] if argv is None else argv)
        i = argv.index("--mesh")
        rcs = [subprocess.call([sys.executable, "-m",
                                "repro_torch.launch.dryrun",
                                *argv[:i], "--mesh", mk, *argv[i + 2:]])
               for mk in ("single", "multi")]
        sys.exit(1 if any(rcs) else 0)
    knobs = {"remat": args.remat, "microbatches": args.microbatches,
             "pod_fsdp": args.pod_fsdp, "compress_grads": args.compress_grads,
             "seq_shard": args.seq_shard, "layout": args.layout,
             "ep_axis": args.ep_axis}

    from repro_torch.configs.registry import canonical, cells
    from repro_torch.launch.mesh import init_fake_process_group

    _quiet()
    init_fake_process_group(512 if args.mesh == "multi" else 256)
    register_strategies()
    if args.all:
        todo = [(a, s) for a, s, ok in cells() if ok]
    else:
        todo = [(canonical(args.arch), args.shape)]
    failures = 0
    for arch, shape in todo:
        try:
            rec = run_cell(arch, shape, args.mesh, args.out, knobs, args.tag)
            print(f"OK   {arch:26s} {shape:12s} {args.mesh:6s} "
                  f"Tc={rec['t_compute']:.4f}s Tm={rec['t_memory']:.4f}s "
                  f"Tx={rec['t_collective']:.4f}s "
                  f"bn={rec['bottleneck']:10s} mfu={rec['mfu']:.3f} "
                  f"trace={rec['t_trace_s']}s", flush=True)
        except Exception as e:  # noqa: BLE001 — one cell's failure, reported
            failures += 1
            where = " ".join(getattr(e, "__notes__", []))
            print(f"FAIL {arch} {shape} {args.mesh}: {e} {where}", flush=True)
            traceback.print_exc()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
