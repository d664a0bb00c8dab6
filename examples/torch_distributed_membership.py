"""Distributed membership service on the PyTorch/CUDA port: OCF shards
routed shard to shard (paper §I-B).

The paper's Cassandra-cluster scenario: keys are owned by shards; batched
inserts, lookups and verified deletes are routed to their owner with one
capacity-bounded exchange and run by the owner's data plane.  With
``--cards N`` shard s lies on ``cuda:(s % N)``, one part a shard
(``filter_mesh(devices=...)``), and the exchange copies each shard's
slice of the send buffers to its owner's card; without it every shard
lies in one part on ``--device`` and the exchange stays on that device.
The writes resolve their eviction chains and stash spills on the device.
On the card by default, on the CPU with ``--device cpu``:

    PYTHONPATH=src python examples/torch_distributed_membership.py
    PYTHONPATH=src python examples/torch_distributed_membership.py --cards 4
"""
import argparse

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import hashing
from repro_torch.distributed.elastic import filter_mesh
from repro_torch.serving.scheduler import DeferredWritePump


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--n-buckets", type=int, default=4096)
    ap.add_argument("--keys", type=int, default=32768)
    ap.add_argument("--cards", type=int, default=0,
                    help="put shard s on cuda:(s %% N), one part a shard "
                         "(with --device cpu: every part on the CPU)")
    args = ap.parse_args()
    n_shards, n_buckets, n = args.shards, args.n_buckets, args.keys

    if args.cards:
        mesh = filter_mesh(n_shards, devices=[
            f"cuda:{s % args.cards}" if args.device == "cuda"
            else args.device for s in range(n_shards)])
    else:
        mesh = filter_mesh(n_shards, device=args.device)
    print(f"shards on {[str(d) for d in mesh.devices]}")
    rng = np.random.RandomState(0)

    def halves(k):
        hi, lo = hashing.key_to_u32_pair_np(k)
        return (torch.from_numpy(hi.view(np.int32).copy()),
                torch.from_numpy(lo.view(np.int32).copy()))

    keys = rng.randint(0, 2 ** 63, size=n, dtype=np.int64).astype(np.uint64)
    hi_np, lo_np = hashing.key_to_u32_pair_np(keys)
    hi, lo = halves(keys)

    # routed insert: every key goes to its owner shard, which runs the
    # conflict-aware scheduled insert on its table on the device
    owner = np.asarray(hashing.owner_shard_np(hi_np, lo_np, n_shards))
    state = dist.make_sharded_state(n_shards, n_buckets, 4, mesh=mesh)
    state, ok, deferred, _ov = dist.distributed_insert(
        mesh, "data", state, hi, lo, fp_bits=16)
    assert bool(ok.all()) and not bool(deferred.any())
    print(f"{n_shards} shards, {n} keys routed+inserted on-device, "
          f"owner histogram: {np.bincount(owner, minlength=n_shards)}")
    print(f"aggregate load: {float(dist.sharded_occupancy(state)):.3f}")

    # lookup: one exchange out, the owner's probe, one exchange back
    hits, overflow = dist.distributed_lookup(mesh, "data", state, hi, lo,
                                             fp_bits=16)
    print(f"present keys found: {int(hits.sum())}/{n}")
    print(f"per-shard routing overflow: {overflow.cpu().numpy()}")
    assert bool(hits.all()), "a routed key was lost"

    absent = rng.randint(0, 2 ** 63, size=n,
                         dtype=np.int64).astype(np.uint64)
    ahits, _ = dist.distributed_lookup(mesh, "data", state, *halves(absent),
                                       fp_bits=16)
    print(f"false positives on {absent.size} absent keys: "
          f"{int(ahits.sum())}")

    # congestion: a tight routing capacity makes the overflow counters fire
    # (the EOF signal) while the answers stay conservative
    thits, tov = dist.distributed_lookup(mesh, "data", state, hi, lo,
                                         fp_bits=16, capacity_factor=0.5)
    print(f"tight capacity: found={int(thits.sum())}/{n} "
          f"overflow={tov.cpu().numpy()} (burst signal -> EOF controller)")
    assert bool(thits.all()) and int(tov.sum()) > 0

    # routed verified delete: half the keys churn out
    half = n // 2
    state, dok, _, _ = dist.distributed_delete(
        mesh, "data", state, hi[:half], lo[:half], fp_bits=16)
    rhits, _ = dist.distributed_lookup(mesh, "data", state, hi, lo,
                                       fp_bits=16)
    print(f"deleted {int(dok.sum())}/{half}; survivors found: "
          f"{int(rhits[half:].sum())}/{n - half}, "
          f"load now {float(dist.sharded_occupancy(state)):.3f}")
    assert bool(rhits[half:].all()), "a survivor was lost"

    # deferred-batch resubmission: a skewed burst under a tight routing
    # capacity overflows the hot owners' rows; those lanes come back
    # deferred and the pump re-offers them under the admission
    # controller's hysteresis
    burst = rng.randint(0, 2 ** 63, size=n // 4,
                        dtype=np.int64).astype(np.uint64)
    bhi, blo = hashing.key_to_u32_pair_np(burst)
    hot = np.asarray(hashing.owner_shard_np(bhi, blo, n_shards)) < 2
    skewed = np.concatenate([burst[hot], burst[hot], burst[~hot]])[:n // 4]
    shi, slo = hashing.key_to_u32_pair_np(skewed)
    pump = DeferredWritePump(mesh, "data",
                             dist.make_sharded_state(n_shards, n_buckets, 4,
                                                     mesh=mesh),
                             fp_bits=16, capacity_factor=0.5)
    ok, deferred = pump.submit(shi, slo)
    print(f"\nburst of {skewed.size} under tight capacity: "
          f"{int(ok.sum())} landed, {int(deferred.sum())} deferred")
    pump.run_until_drained(max_ticks=64)
    print(f"pump drained: inserted={pump.stats.inserted} "
          f"resubmitted={pump.stats.resubmitted} held_ticks="
          f"{pump.stats.held_ticks} pending={pump.pending} "
          f"(signal={pump.admission.signal():.2f})")
    phits, _ = dist.distributed_lookup(mesh, "data", pump.state,
                                       *halves(skewed), fp_bits=16)
    assert int(deferred.sum()) > 0, "the skewed burst must overflow"
    assert bool(phits.all()), "a deferred key never landed"
    print("every burst key resident after hysteresis-gated resubmission")


if __name__ == "__main__":
    main()
