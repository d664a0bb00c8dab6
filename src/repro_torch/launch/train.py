"""End-to-end training driver.

Counterpart of ``repro.launch.train`` (``build_state``, ``train``,
``main``): config registry -> model -> OCF-dedup data pipeline -> train
step -> checkpoint/restart loop with a straggler watchdog, on one device
(``device="cuda"`` by default; ``"cpu"`` runs every kernel's plain
version).  The reference's mesh and sharded init have no counterpart on
one card (``ParallelConfig``'s mesh fields are carried and inert).

Checkpoints go through ``checkpoint.ckpt``: every ``ckpt_every`` steps the
parameters (with the dedup filter's table and keys, ``ocf=``) under
``ckpt_dir`` and the optimizer state under ``ckpt_dir/opt``.  A resumed
run restores both from the latest step and, unlike the reference's
(which restarts the doc stream), replays the data pipeline through the
batches of the steps already taken, so the resumed steps see the batches
an uninterrupted run would have seen.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --smoke --steps 20 --batch 8 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

log = logging.getLogger("repro_torch.train")


def build_state(arch: str, *, smoke: bool, seed: int = 0,
                device: str = "cuda"):
    """-> (cfg, model, tx, params, opt_state): the model initialised from
    ``seed`` on ``device``, ``params`` its named parameters, AdamW on the
    reference's schedule ``cosine_schedule(3e-4, 20, 10000)``."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import AdamW, cosine_schedule

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = Transformer(cfg, seed=seed, device=device)
    params = dict(model.named_parameters())
    tx = AdamW(lr=cosine_schedule(3e-4, 20, 10000))
    opt_state = tx.init(params)
    return cfg, model, tx, params, opt_state


def _restore_into(tensors: list, restored: list) -> None:
    with torch.no_grad():
        for t, r in zip(tensors, restored):
            t.copy_(torch.as_tensor(r).to(t.device))


def train(arch: str, *, steps: int, batch: int, seq: int, smoke: bool = True,
          ckpt_dir: str | None = None, ckpt_every: int = 10,
          resume: bool = True, data_seed: int = 0, parallel=None,
          inject_failure_at: int | None = None, device: str = "cuda"):
    """Train ``steps`` steps of ``batch`` x ``seq`` tokens -> {"params",
    "opt_state", "history" (per-step float metrics), "pipeline_stats",
    "dedup_ocf_stats", "straggler_flags", "step_seconds", "model",
    "cfg"}.  ``inject_failure_at``: raise at the start of that step."""
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.data.pipeline import DedupPipeline, SyntheticDocs
    from repro_torch.distributed.fault import StragglerWatchdog
    from repro_torch.distributed.sharding import ParallelConfig
    from repro_torch.train.step import make_train_step

    parallel = parallel or ParallelConfig()
    cfg, model, tx, params, opt_state = build_state(arch, smoke=smoke,
                                                    device=device)
    dev = model.device

    start_step = 0
    if ckpt_dir and resume:
        last = ckpt_mod.latest_step(ckpt_dir)
        if last is not None:
            names = list(params)
            restored, _ = ckpt_mod.restore(ckpt_dir, last, params)
            _restore_into([params[k] for k in names],
                          [restored[k] for k in names])
            restored, _ = ckpt_mod.restore(ckpt_dir + "/opt", last,
                                           opt_state)
            _restore_into([opt_state.step, *opt_state.m.values(),
                           *opt_state.v.values()],
                          [restored.step, *restored.m.values(),
                           *restored.v.values()])
            start_step = last
            log.info("resumed from step %d", last)

    pipe = DedupPipeline(
        SyntheticDocs(cfg.vocab_size, doc_len=seq + 1, seed=data_seed),
        batch=batch, seq=seq, device=str(dev))
    data = iter(pipe)
    for _ in range(start_step):     # the batches of the steps already taken
        next(data)

    step_fn = make_train_step(model, tx, parallel)
    watchdog = StragglerWatchdog()
    history, seconds = [], []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        raw = next(data)
        batch_d = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        if cfg.prefix_embed_len:
            batch_d["prefix_embeds"] = torch.zeros(
                (batch, cfg.prefix_embed_len, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        if cfg.cross_attn_memory_len:
            batch_d["memory"] = torch.zeros(
                (batch, cfg.cross_attn_memory_len,
                 cfg.cross_attn_memory_dim), dtype=torch.bfloat16,
                device=dev)
        if inject_failure_at is not None and step == inject_failure_at:
            raise RuntimeError(f"injected node failure at step {step}")
        params, opt_state, metrics = step_fn(params, opt_state, batch_d)
        history.append({k: float(v) for k, v in metrics.items()})
        dt = time.perf_counter() - t0
        seconds.append(dt)
        watchdog.observe(dt)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt_mod.save(ckpt_dir, step + 1, params, ocf=pipe.ocf)
            ckpt_mod.save(ckpt_dir + "/opt", step + 1, opt_state)
    return {
        "params": params, "opt_state": opt_state, "history": history,
        "pipeline_stats": pipe.stats, "dedup_ocf_stats": pipe.ocf.stats,
        "straggler_flags": watchdog.flagged, "step_seconds": seconds,
        "model": model, "cfg": cfg,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                smoke=args.smoke, ckpt_dir=args.ckpt_dir, device=args.device)
    losses = [h["loss"] for h in out["history"]]
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    print(f"dedup: {out['pipeline_stats']}")


if __name__ == "__main__":
    main()
