"""End-to-end driver of the PyTorch/CUDA port: train an architecture for
a few hundred steps with the OCF-dedup data pipeline, checkpointing and
the straggler watchdog (``repro_torch.launch.train``), on the card by
default or on the CPU with ``--device cpu``.

    PYTHONPATH=src python examples/torch_train_lm_with_dedup.py \\
        --arch gemma2-27b --steps 200 --device cpu

It trains the reduced (smoke) config, as the reference's example does;
``chip_smoke.py`` phase 5i trains gemma3-1b at full width on the card.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-27b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one)")
    args = ap.parse_args()

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                smoke=True, ckpt_dir=ckpt_dir, ckpt_every=50,
                device=args.device)
    losses = [h["loss"] for h in out["history"]]
    n = len(losses)
    print(f"steps: {n} on {args.device}")
    for i in range(0, n, max(1, n // 10)):
        print(f"  step {i:4d}  loss {losses[i]:.4f}")
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")
    if n >= 40:
        assert np.mean(losses[-20:]) < np.mean(losses[:20]), \
            "should be learning"
    ps = out["pipeline_stats"]
    print(f"data pipeline: {ps.docs_seen} docs seen, {ps.docs_deduped} "
          f"dropped by the OCF "
          f"({ps.docs_deduped / max(1, ps.docs_seen):.1%}), "
          f"{ps.shards_retired} shards retired")
    print(f"filter: {out['dedup_ocf_stats']}")
    print(f"straggler flags: {out['straggler_flags']}; checkpoints in "
          f"{ckpt_dir}")


if __name__ == "__main__":
    main()
