#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each timed, each fatal on failure:

  1. print the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card,
     bit for bit, at main-path shapes (4096-key chunks, 16M-slot tables,
     the parity block): the four OCF kernels (insert and delete also on
     STAGING_CASES, which stress their rows staged in shared memory), the
     four adaptive ones on a four-plane state with nonzero selectors
     (insert and delete also on ADAPTIVE_STAGING_CASES, and once split
     into launches of fewer keys than a call; probe_adaptive also on
     PROBE_ADAPTIVE_CASES: full, empty and multi-pass stashes, entries
     that share a key's fingerprint or fold but not its buckets, fp_bits
     32 and 8, slots holding a family fingerprint under another selector,
     bucket sizes 1, 2 and 8, 1 to 1.1M keys; the tables and their inputs
     come from ``repro_torch.kernels.staging_cases``, as in the tests), and
     ``probe_multi`` over K = 1, 2, 4 of four generation tables
     int32[4, 2^20, 4], pools of 65 and 130 slots, and PROBE_MULTI_CASES
     (full stashes, fingerprints that share a key's 16-bit fold, fp_bits 32
     and 8, live slots in any order, ragged n, bucket sizes 2 and 8); the
     four telemetry instantiations (``probe_tm``, ``insert_bulk_tm``,
     ``probe_adaptive_tm``, ``insert_bulk_adaptive_tm``) against their
     plain versions with stats (answers, tables and counter planes) and
     against the flag-off kernels, on the same cases and on PROBE_CASES
     (with and without a stash, padding lanes that hit and must not count,
     n no multiple of 256); and
     ``flash_attention`` within a stated tolerance at gemma3-1b's shapes
     (Hq=4, Hkv=1, S=8192, D=256; float32 and bfloat16; window 512 and
     none), small cases of the reference's sweep, a case with Sq > Skv and
     lengths (200, 300) that end in ragged tiles;
  3. run seeded streams through the card and the CPU and require
     identical state and answers after every operation: ~100k-key EOF
     streams through ``OCF`` (with and without a stash), two
     ``AdaptiveMembership`` streams (inserts, lookups, reports, deletes;
     one at load ~0.95 with kicks of adapted slots), a ~100k-event
     ``GenerationalFilter`` stream (rotations, TTL expiries, spills, a
     rotate-and-retry), a ``GenerationalPrefixIndex`` stream, two
     ``FilterOpBatcher`` wave streams with telemetry on (a static filter
     with an 8-slot stash, an adaptive one with report waves: waves,
     states and every counter of the registry equal); the six scenarios
     of the SLO harness through ``run_scenario`` at the reference's sizes
     (every wave's results, the final state and every report field that
     is no host time equal); the LM at gemma3-1b's full width and one
     period's depth (6 layers, float32, TF32 off), built on the CPU and
     copied to the card: forward logits within a stated tolerance at S =
     512 and 200, greedy tokens of prefill + 8 decode steps equal; and
     ``ContinuousBatcher`` over that model, a burst of 7 requests into 3
     slots (greedy tokens and ``SchedStats`` equal);
  4. the OCF main path at full size: one node's membership filter of a
     distributed store (capacity 2^22 slots, 8 bursts of 1M inserts, 3M
     verified + 100k blind deletes, lookups of every resident key plus 5M
     absent ones), with its kernels' launch counts read around it;
  5. the adaptive path at full size: an abuse-detection denylist of one
     node (2^22 buckets of 4, 12 bursts of 1M members, 4 feedback rounds
     over 10M replayed benign keys, 3M deletes), launch counts read
     around it;
  5b. the streaming path at full size: the dedup stage of one node
     (``examples/streaming_dedup.py`` at scale: a ring of 4 generations
     of 2^22 slots, 32 ticks of 600k events with a 4x burst, 40% repeats),
     then the TTL step; launch counts read around it;
  5d. filter-op waves at full size: the filter's serving front
     (``FilterOpBatcher``, 4096-key waves, double-buffered) over 2^20
     buckets of 4 with a 128-slot stash: inserts to load 0.85, lookups of
     every acknowledged key and as many absent ones, deletes of half;
     the same over the adaptive planes with report waves; each with
     telemetry off and on in turns (off, on, on, off, off, on: equal
     results and states, the counter sums checked, no telemetry launch in
     the off arm, the median walls), then each under a trace for the
     device's idle share;
  5e. SLO scenarios at node size: each scenario of the SLO harness with
     its own mix, hit blend, burst pattern and load trajectory at one
     node's filter (the reference's stacks with n_buckets and wave_slots
     scaled by one factor: 2^20 buckets of 4 and waves of 2^17–2^18 keys;
     the ttl ring at 4 generations of 2^22 slots and 2^19-key waves; the
     admission arm at 2^20 buckets, 2^19-key waves); the burst train also
     through the sync and async arms (equal bit for bit); no false
     negatives from the waves' own results; the scenario telemetry mode
     card vs CPU; ``uniform`` once more under a trace for the idle share;
     a ``{"slo": ...}`` JSON line of the rows; launch counts read around
     it;
  5c. the LM serving path at full size: gemma3-1b (26 layers, full width,
     bfloat16 activations, float32 weights from SEED): a cache-less
     forward over 8192 tokens (prompt scoring, the flash kernel), the
     flash forward against the cached prefill + decode of the same prompt
     (float32, 1024 tokens, log-softmax within 1e-3), ``serve()`` of 16
     requests, and (d) ``ContinuousBatcher``: 8 requests of 1008 + 16
     tokens into 4 slots (tokens equal to ``generate``'s, ``SchedStats``
     equal to the CPU's over a 2-layer model); launch counts read around
     it;
  6. hold each kernel against its plain version at the paths' full size,
     bit for bit, then time it, its plain version and its bound (the
     telemetry instantiations beside their flag-off kernels; for flash
     attention, one ``scaled_dot_product_attention`` call as the library's
     yardstick), and print them as one JSON line; beside them the launch
     floor (the device time of a one-element add), for ``probe_multi``
     the timed call's live stash entries, and ``probe_adaptive`` at the
     adaptive path's launch size too (its 10M benign keys with its stash,
     the same with 128 live stash entries, its remaining members; each
     held against the plain version bit for bit first, then timed by CUDA
     events with L2 flushed before each launch).

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
CHUNK = 4096
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
# H100 SXM float32 rate outside the tensor cores (data sheet); no higher
# rate is listed for the 32-bit integer operations the kernels do.
SCALAR_OPS_PER_S = 67e12
# H100 SXM dense bfloat16 tensor-core rate (data sheet): the bound of the
# attention kernel's multiply-adds.
TENSOR_OPS_PER_S = 989e12
SECTOR = 32                   # bytes per device-memory sector
# 32-bit operations per key of the fused hash (fingerprint, index_hash and
# alt_index of csrc/ocf_common.cuh, each modulo counted as one).
HASH_OPS = 55
# ... and of the family hash: three more fingerprint_sel of ~24 operations
# each (two murmur3 mixes, the seed tweak, mask and zero remap).
FAMILY_OPS = HASH_OPS + 3 * 24
FULL_BUCKETS = 1 << 22        # 16M slots of 4: the main path's grown size
KERNEL_ROWS = {
    # name: (source, TPU kernel it replaces, what holds it back on the card)
    "fingerprint_hash": ("src/repro_torch/csrc/fingerprint.cu",
                         "src/repro/kernels/fingerprint.py:63",
                         "not measured"),
    "probe": ("src/repro_torch/csrc/probe.cu",
              "src/repro/kernels/probe.py:122", "not measured"),
    "insert_bulk": ("src/repro_torch/csrc/insert.cu",
                    "src/repro/kernels/insert.py:440", "serial_cta_loop"),
    "delete_bulk": ("src/repro_torch/csrc/delete.cu",
                    "src/repro/kernels/delete.py:129", "serial_cta_loop"),
    "fingerprint_hash_family": ("src/repro_torch/csrc/fingerprint_family.cu",
                                "src/repro/kernels/fingerprint.py:119",
                                "not measured"),
    "probe_adaptive": ("src/repro_torch/csrc/probe_adaptive.cu",
                       "src/repro/kernels/probe.py:264",
                       "random_sector_fetches"),
    "insert_bulk_adaptive": ("src/repro_torch/csrc/insert_adaptive.cu",
                             "src/repro/kernels/insert.py:929",
                             "serial_cta_loop"),
    "delete_bulk_adaptive": ("src/repro_torch/csrc/delete_adaptive.cu",
                             "src/repro/kernels/delete.py:245",
                             "serial_cta_loop"),
    "probe_multi": ("src/repro_torch/csrc/probe_multi.cu",
                    "src/repro/kernels/probe.py:403",
                    "bucket_and_stash_latency"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:113",
                        "not measured"),
    # The telemetry instantiations, in place of the reference's twins (its
    # XLA emulations with want_stats, not pallas_call sites).
    "probe_tm": ("src/repro_torch/csrc/probe.cu",
                 "src/repro/kernels/probe.py:156", "not measured"),
    "insert_bulk_tm": ("src/repro_torch/csrc/insert.cu",
                       "src/repro/kernels/insert.py:531", "serial_cta_loop"),
    "probe_adaptive_tm": ("src/repro_torch/csrc/probe_adaptive.cu",
                          "src/repro/kernels/probe.py:296",
                          "random_sector_fetches"),
    "insert_bulk_adaptive_tm": ("src/repro_torch/csrc/insert_adaptive.cu",
                                "src/repro/kernels/insert.py:995",
                                "serial_cta_loop"),
}
STATIC_KERNELS = ("fingerprint_hash", "probe", "insert_bulk", "delete_bulk")
ADAPTIVE_KERNELS = ("fingerprint_hash_family", "probe_adaptive",
                    "insert_bulk_adaptive", "delete_bulk_adaptive")
STREAMING_KERNELS = ("probe_multi",)
LM_KERNELS = ("flash_attention",)
LM_ARCH = "gemma3-1b"
LM_SEQ = 8192                 # the prompt-scoring forward of phase 5c
# Flash attention against its plain version, |got - want| <= tol * (1 +
# |want|): the reference sweep's tolerances (tests/test_kernels.py).
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
# ... and row by row, ||got - want|| / ||want|| over each output row with a
# live key.  On long rows the outputs shrink as 1/sqrt(live keys) (~0.02
# at 8192), so the elementwise form above is about as large as the values
# there; this one is not.  Limits: bfloat16 rounds p and the output (a few
# 1e-3 a row); a kernel that dropped one 64-key tile from a row of n keys
# reads about 8 / sqrt(n), 0.09 at n = 8192 (FlashKernelBench prints it).
FLASH_ROW_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# The streaming dedup stage of one node: examples/streaming_dedup.py's ring
# at 2^22 slots a generation (4 x 16 MiB of tables on the card).
RING = dict(generations=4, capacity=1 << 22, bucket_size=4, fp_bits=16,
            stash_slots=128, ttl=24.0, o_max=0.85)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name: str):
    """Context manager printing a phase's wall time."""
    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"== {name}", flush=True)
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== {name}: {time.perf_counter() - self.t0:.2f} s",
                      flush=True)
            return False
    return _Phase()


def random_keys(rng: np.random.RandomState, n: int) -> np.ndarray:
    return rng.randint(0, 2**63, size=n, dtype=np.int64).astype(np.uint64)


# ------------------------------------------------------- phase 2: kernels --


class KernelBench:
    """Kernel-vs-plain comparisons at main-path shapes on one device."""

    def __init__(self, device, n_buckets: int = FULL_BUCKETS - 256 * 37,
                 buffer: int = FULL_BUCKETS, n_keys: int = CHUNK):
        import torch
        self.torch = torch
        self.dev = torch.device(device)
        self.buffer, self.n_buckets, self.n_keys = buffer, n_buckets, n_keys
        self.rng = np.random.RandomState(SEED)
        self.max_err = {}

    def synthetic_table(self, load: float):
        """A buffer filled to ``load`` with random nonzero fingerprints."""
        torch = self.torch
        fill = self.rng.rand(self.buffer, 4) < load
        fps = self.rng.randint(1, 1 << 16, size=(self.buffer, 4))
        table = np.where(fill, fps, 0).astype(np.int32)
        table[self.n_buckets:] = 0
        return torch.from_numpy(table).to(self.dev)

    def keys(self):
        from repro_torch.core import hashing
        k = random_keys(self.rng, self.n_keys)
        hi, lo = hashing.key_to_u32_pair_np(k)
        t = self.torch
        return (k, t.from_numpy(hi.view(np.int32)).to(self.dev),
                t.from_numpy(lo.view(np.int32)).to(self.dev))

    def record(self, name: str, pairs) -> None:
        torch = self.torch
        err = 0
        for a, b in pairs:
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{name}: kernel and plain outputs differ in shape/dtype")
            d = (a.to(torch.int64) - b.to(torch.int64)).abs()
            err = max(err, int(d.max()) if d.numel() else 0)
        check(err == 0, f"{name}: kernel differs from its plain version "
                        f"(max abs err {err})")
        self.max_err[name] = max(self.max_err.get(name, 0), err)

    def plain_insert(self, table, hi, lo, valid, *, stash, rounds, block,
                     schedule):
        """The plain insert with stats -> (ok, counter plane)."""
        from repro_torch.core.scheduling import dispatch_order_from_buckets
        from repro_torch.kernels.fingerprint import fingerprint_hash_plain
        from repro_torch.kernels.insert import insert_bulk_plain
        from repro_torch.kernels.telemetry import insert_plane
        inv = None
        if schedule and hi.shape[0] > block:
            _fp, i1, _i2 = fingerprint_hash_plain(
                hi, lo, fp_bits=16, n_buckets=self.n_buckets)
            perm, inv = dispatch_order_from_buckets(i1, valid)
            hi, lo, valid = hi[perm], lo[perm], valid[perm]
        ok, stats = insert_bulk_plain(table, hi, lo, valid, fp_bits=16,
                                      n_buckets=self.n_buckets,
                                      evict_rounds=rounds, stash=stash,
                                      block=block, want_stats=True)
        plane = insert_plane(*stats, valid)
        return (ok if inv is None else ok[inv]), plane

    def hold_tm(self, name: str, got, want, off_pairs) -> None:
        """A telemetry instantiation against its plain version with stats
        (``got`` and ``want``: (outputs, plane)) and against the flag-off
        kernel (``off_pairs``: its outputs beside the twin's)."""
        self.record(name, [*zip(got[0], want[0]), (got[1], want[1]),
                           *off_pairs])

    def run(self) -> None:
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.delete import delete_bulk, delete_bulk_plain
        from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                                     fingerprint_hash_plain)
        from repro_torch.kernels.insert import insert_bulk, insert_bulk_tm
        from repro_torch.kernels.probe import probe, probe_plain, probe_tm

        nb = self.n_buckets
        # fingerprint_hash at a chunk, non-pow2 active count.
        _k, hi, lo = self.keys()
        self.record("fingerprint_hash", zip(
            fingerprint_hash(hi, lo, fp_bits=16, n_buckets=nb),
            fingerprint_hash_plain(hi, lo, fp_bits=16, n_buckets=nb)))

        # probe on a 0.85-load full-size table, half the keys planted.
        table = self.synthetic_table(0.85)
        keys, hi, lo = self.keys()
        half = keys[: keys.size // 2]
        h_hi, h_lo = hashing.key_to_u32_pair_np(half)
        fp = hashing.fingerprint_np(h_hi, h_lo, 16).astype(np.int64)
        i1 = hashing.index_hash_np(h_hi, h_lo, nb).astype(np.int64)
        table[torch.from_numpy(i1).to(self.dev), 0] = \
            torch.from_numpy(fp).to(self.dev).to(torch.int32)
        stash = torch.zeros((2, 128), dtype=torch.int32, device=self.dev)
        stash[0, :64] = torch.from_numpy(fp[:64]).to(self.dev).int()
        stash[1, :64] = torch.from_numpy(
            hashing.alt_index_np(i1[:64], fp[:64], nb).astype(np.int64)
        ).to(self.dev).int()
        pblock = min(kops.autotune_block("probe", table_bytes=table.numel() * 4),
                     CHUNK)
        for st in (None, stash):
            got = probe(table, hi, lo, fp_bits=16, n_buckets=nb, stash=st,
                        block=pblock)
            want = probe_plain(table, hi, lo, fp_bits=16, n_buckets=nb,
                               stash=st)
            self.record("probe", [(got, want)])
            # the telemetry twin, the last 100 lanes uncounted
            self.hold_probe_tm("probe_tm", probe_tm, probe_plain, got,
                               (table, hi, lo), CHUNK - 100, pblock,
                               dict(fp_bits=16, n_buckets=nb, stash=st))
            _u, inv, cnt = np.unique(i1, return_inverse=True,
                                     return_counts=True)
            sole = torch.from_numpy(cnt[inv] == 1).to(self.dev)
            check(bool(got[: half.size][sole].all()), "probe missed a key")

        # insert: uncontended, 0.9-load eviction storms (a tight budget of
        # 8 rounds) with rollback and with a stash, and the schedule
        # pre-pass.
        cases = [("uncontended", 0.5, 32, False, False),
                 ("storm+rollback", 0.9, 8, False, False),
                 ("storm+stash", 0.9, 8, True, False),
                 ("schedule", 0.85, 32, False, True)]
        for label, load, rounds, with_stash, schedule in cases:
            base = self.synthetic_table(load)
            _k, hi, lo = self.keys()
            valid = torch.from_numpy(self.rng.rand(self.n_keys) < 0.97
                                     ).to(self.dev)
            block = min(kops.autotune_block(
                "insert", table_bytes=base.numel() * 4, evict_rounds=rounds,
                stash_slots=128 if with_stash else 0, n_keys=CHUNK), CHUNK)
            tk, tp, tt = base.clone(), base.clone(), base.clone()
            sk = (torch.zeros((2, 128), dtype=torch.int32, device=self.dev)
                  if with_stash else None)
            sp = None if sk is None else sk.clone()
            st = None if sk is None else sk.clone()
            kw = dict(fp_bits=16, n_buckets=nb, valid=valid,
                      evict_rounds=rounds, block=block, schedule=schedule)
            out = insert_bulk(tk, hi, lo, stash=sk, **kw)
            okp, plane = self.plain_insert(tp, hi, lo, valid, stash=sp,
                                           rounds=rounds, block=block,
                                           schedule=schedule)
            pairs = [(tk, tp), (out[-1], okp)]
            if sk is not None:
                pairs.append((sk, sp))
            self.record("insert_bulk", pairs)
            tm = insert_bulk_tm(tt, hi, lo, stash=st, **kw)
            self.hold_tm("insert_bulk_tm", ([tt, tm[-2]], tm[-1]),
                         ([tp, okp], plane),
                         [(tt, tk), (tm[-2], out[-1])]
                         + ([] if sk is None else [(st, sk)]))
            failed = int((valid & ~okp).sum())
            spilled = 0 if sp is None else int((sp[0] != 0).sum())
            print(f"   insert {label}: block={block} rounds={rounds} "
                  f"failed={failed} stashed={spilled}", flush=True)
            if label == "storm+rollback":
                check(failed > 0, "the storm case rolled nothing back")
            if label == "storm+stash":
                check(spilled > 0, "the stash case spilled nothing")

        # delete with duplicates, from a table holding the keys.
        base = self.synthetic_table(0.5)
        keys, hi, lo = self.keys()
        valid = torch.ones(self.n_keys, dtype=torch.bool, device=self.dev)
        _t, ins_ok = insert_bulk(base, hi, lo, fp_bits=16, n_buckets=nb,
                                 valid=valid, evict_rounds=32, block=128)
        dup = np.concatenate([keys[: CHUNK // 2], keys[: CHUNK // 4],
                              keys[: CHUNK // 4]])
        d_hi, d_lo = hashing.key_to_u32_pair_np(dup)
        d_hi = torch.from_numpy(d_hi.view(np.int32)).to(self.dev)
        d_lo = torch.from_numpy(d_lo.view(np.int32)).to(self.dev)
        dblock = min(kops.autotune_block(
            "delete", table_bytes=base.numel() * 4, n_keys=CHUNK), CHUNK)
        tk, tp = base.clone(), base.clone()
        _t, okk = delete_bulk(tk, d_hi, d_lo, fp_bits=16, n_buckets=nb,
                              valid=valid, block=dblock)
        okp = delete_bulk_plain(tp, d_hi, d_lo, valid, fp_bits=16,
                                n_buckets=nb, block=dblock)
        self.record("delete_bulk", [(tk, tp), (okk, okp)])
        first = slice(0, CHUNK // 2)
        check(bool(okk[first][ins_ok[first]].all()),
              "delete missed a resident key")
        self.staging()
        self.probe_cases()

    def hold_probe_tm(self, name, kern_tm, plain, off, args, counted, block,
                      kw) -> list:
        """A probe's telemetry twin against the plain version with stats
        (answers and the depth plane of the first ``counted`` lanes) and
        against the flag-off kernel's answers ``off`` -> the plane."""
        torch = self.torch
        from repro_torch.kernels.telemetry import probe_depth_counts
        hit, plane = kern_tm(*args, n_valid=counted, block=block, **kw)
        want, hs = plain(*args, want_stats=True, **kw)
        n = want.shape[0]
        mask = torch.arange(n, device=self.dev) < counted
        self.record(name, [(hit, want), (plane, probe_depth_counts(*hs,
                                                                   mask)),
                           (hit, off)])
        return plane.tolist()

    def probe_cases(self) -> None:
        """PROBE_CASES, with and without their stash: probe's telemetry
        twin against the plain version with stats and the flag-off
        kernel (padding key 0 planted after the counted lanes)."""
        from repro_torch.core import hashing
        from repro_torch.kernels.probe import probe, probe_plain, probe_tm
        from repro_torch.kernels.staging_cases import (PROBE_CASES,
                                                       probe_inputs)
        torch = self.torch

        def dev32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                                    .view(np.int32)).to(self.dev)

        for label in PROBE_CASES:
            c = probe_inputs(label, SEED)
            table = dev32(c["table"])
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(c["keys"]))
            planes = []
            for st in (None, None if c["stash"] is None
                       else dev32(c["stash"])):
                kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"],
                          stash=st)
                off = probe(table, hi, lo, block=c["block"], **kw)
                self.record("probe", [(off, probe_plain(table, hi, lo,
                                                        **kw))])
                planes.append(self.hold_probe_tm(
                    "probe_tm", probe_tm, probe_plain, off, (table, hi, lo),
                    c["counted"], c["block"], kw))
            print(f"   probe case {label}: n={c['keys'].size} counted="
                  f"{c['counted']} depth planes without / with the stash="
                  f"{planes}: same as the plain version", flush=True)

    def staging(self) -> None:
        """STAGING_CASES: insert (the first quarter of the keys twice, in
        other blocks), then delete (the first half, then the first quarter
        twice more: the k-th repeat clears the k-th copy), kernel against
        plain version on the same table, stash and keys."""
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels.delete import delete_bulk, delete_bulk_plain
        from repro_torch.kernels.insert import (insert_bulk,
                                                insert_bulk_plain,
                                                insert_bulk_tm)
        from repro_torch.kernels.staging_cases import (STAGING_CASES,
                                                       staging_inputs)
        from repro_torch.kernels.telemetry import insert_plane

        def dev32(a):
            return torch.from_numpy(a.astype(np.uint32).view(np.int32)
                                    ).to(self.dev)

        for label in STAGING_CASES:
            c = staging_inputs(label, SEED)
            nb, block, rounds = c["n_buckets"], c["block"], c["rounds"]
            sk = None if c["stash"] is None else dev32(c["stash"])
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(
                c["keys"]))
            valid = torch.from_numpy(c["valid"]).to(self.dev)
            tk = dev32(c["table"])
            tp, sp = tk.clone(), None if sk is None else sk.clone()
            tt, st = tk.clone(), None if sk is None else sk.clone()
            okk = insert_bulk(tk, hi, lo, fp_bits=16, n_buckets=nb,
                              valid=valid, evict_rounds=rounds, stash=sk,
                              block=block)[-1]
            okp, stats = insert_bulk_plain(tp, hi, lo, valid, fp_bits=16,
                                           n_buckets=nb, evict_rounds=rounds,
                                           stash=sp, block=block,
                                           want_stats=True)
            pairs = [(tk, tp), (okk, okp)]
            if sk is not None:
                pairs.append((sk, sp))
            self.record("insert_bulk", pairs)
            tm = insert_bulk_tm(tt, hi, lo, fp_bits=16, n_buckets=nb,
                                valid=valid, evict_rounds=rounds, stash=st,
                                block=block)
            plane = insert_plane(*stats, valid)
            self.hold_tm("insert_bulk_tm", ([tt, tm[-2]], tm[-1]),
                         ([tp, okp], plane),
                         [(tt, tk), (tm[-2], okk)]
                         + ([] if sk is None else [(st, sk)]))
            dele = c["delete"]
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(dele))
            every = torch.ones(dele.size, dtype=torch.bool, device=self.dev)
            _t, dk = delete_bulk(tk, hi, lo, fp_bits=16, n_buckets=nb,
                                 valid=every, block=block)
            dp = delete_bulk_plain(tp, hi, lo, every, fp_bits=16,
                                   n_buckets=nb, block=block)
            self.record("delete_bulk", [(tk, tp), (dk, dp)])
            failed = int((valid & ~okp).sum())
            slots = 0 if sp is None else sp.shape[1]
            print(f"   staging {label}: block={block} rounds={rounds} "
                  f"bucket_size={tk.shape[1]} keys={c['keys'].size} "
                  f"failed={failed} stashed="
                  f"{0 if sp is None else int((sp[0] != 0).sum())}/{slots} "
                  f"deleted={int(dp.sum())} of {dele.size}; telemetry "
                  f"twin's plane {plane.tolist()} same as the plain "
                  f"version's", flush=True)
            check(failed > 0, f"staging {label}: no insert failed")


class AdaptiveKernelBench(KernelBench):
    """The four adaptive kernels against their plain versions on a
    four-plane state of main-path size with nonzero selectors."""

    def adaptive_state(self, load: float, sel_share: float = 0.25):
        """Keys placed in their home buckets up to ``load`` of the active
        region; a ``sel_share`` of the occupied slots on a nonzero selector
        with the fingerprint rewritten under it -> [table, sels, khi, klo]
        int32 tensors on the card, and the resident keys' (hi, lo)."""
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.core.scheduling import conflict_waves
        from repro_torch.kernels.selector import sel_pack
        nb, buf, dev = self.n_buckets, self.buffer, self.dev
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(self.rng.randint(1 << 30)))
        n = int(nb * 4 * load * 2.5)
        keys = torch.randint(-2 ** 31, 2 ** 31, (2, n), dtype=torch.int32,
                             device=dev, generator=gen)
        home = hashing.index_hash(keys[0], keys[1], nb)
        rank = conflict_waves(home, torch.ones_like(home, dtype=torch.bool))
        take = torch.nonzero(rank < 4).flatten()[: int(nb * 4 * load)]
        b, s = home[take], rank[take]
        khi = torch.zeros((buf, 4), dtype=torch.int32, device=dev)
        klo = torch.zeros_like(khi)
        khi[b, s], klo[b, s] = keys[0, take], keys[1, take]
        sel = torch.zeros((buf, 4), dtype=torch.int64, device=dev)
        adapt = torch.rand(take.numel(), generator=gen, device=dev) < sel_share
        sel[b[adapt], s[adapt]] = torch.randint(
            1, 4, (int(adapt.sum()),), generator=gen, device=dev)
        table = torch.zeros_like(khi)
        table[b, s] = hashing.to_i32(hashing.fingerprint_sel(
            khi[b, s], klo[b, s], sel[b, s], 16))
        return [table, sel_pack(sel), khi, klo], (keys[0, take],
                                                  keys[1, take])

    @staticmethod
    def adapted_slots(planes) -> int:
        from repro_torch.kernels.selector import sel_unpack
        return int(((planes[0] != 0) &
                    (sel_unpack(planes[1], planes[0].shape[1]) != 0)).sum())

    def run(self) -> None:
        torch = self.torch
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.delete import (delete_bulk_adaptive,
                                                delete_bulk_adaptive_plain)
        from repro_torch.kernels.fingerprint import (
            fingerprint_hash, fingerprint_hash_family,
            fingerprint_hash_family_plain)
        from repro_torch.kernels.insert import (insert_bulk_adaptive,
                                                insert_bulk_adaptive_plain)
        from repro_torch.kernels.probe import (probe, probe_adaptive,
                                               probe_adaptive_plain)

        nb = self.n_buckets
        _k, hi, lo = self.keys()
        fam, i1, i2 = fingerprint_hash_family(hi, lo, fp_bits=16,
                                              n_buckets=nb)
        p_fam, p_i1, p_i2 = fingerprint_hash_family_plain(
            hi, lo, fp_bits=16, n_buckets=nb)
        self.record("fingerprint_hash_family",
                    zip((*fam, i1, i2), (*p_fam, p_i1, p_i2)))
        static = fingerprint_hash(hi, lo, fp_bits=16, n_buckets=nb)
        check(all(torch.equal(a, b) for a, b in zip((fam[0], i1, i2),
                                                     static)),
              "the family's (f0, i1, i2) differ from fingerprint_hash")

        # With an all-zero selector plane the adaptive probe is the probe.
        table = self.synthetic_table(0.85)
        zero = torch.zeros((self.buffer, 1), dtype=torch.int32,
                           device=self.dev)
        stash = torch.zeros((2, 128), dtype=torch.int32, device=self.dev)
        stash[0, :64] = torch.arange(1, 65, device=self.dev)
        stash[1, :64] = i2[:64]
        for st in (None, stash):
            check(torch.equal(
                probe_adaptive(table, zero, hi, lo, fp_bits=16, n_buckets=nb,
                               stash=st),
                probe(table, hi, lo, fp_bits=16, n_buckets=nb, stash=st)),
                "probe_adaptive on a zero selector plane differs from probe")

        # insert: (load, evict_rounds, stash, what it must reach).
        cases = [("uncontended", 0.5, 32, False, set()),
                 ("optimistic+spill", 0.85, 0, True, {"spill"}),
                 ("storm+rollback", 0.95, 8, True,
                  {"kick", "spill", "rollback"}),
                 ("storm", 0.95, 32, True, {"kick", "spill"})]
        storm = None
        for label, load, rounds, with_stash, must in cases:
            base, (m_hi, m_lo) = self.adaptive_state(load)
            _k, hi, lo = self.keys()
            valid = torch.from_numpy(self.rng.rand(self.n_keys) < 0.97
                                     ).to(self.dev)
            block = min(kops.autotune_block(
                "insert", table_bytes=kops._adaptive_plane_bytes(base[0]),
                evict_rounds=2 * rounds,
                stash_slots=128 if with_stash else 0, n_keys=CHUNK), CHUNK)
            pk = [p.clone() for p in base]
            pp = [p.clone() for p in base]
            sk = (torch.zeros((2, 128), dtype=torch.int32, device=self.dev)
                  if with_stash else None)
            sp = None if sk is None else sk.clone()
            out = insert_bulk_adaptive(*pk, hi, lo, fp_bits=16, n_buckets=nb,
                                       valid=valid, evict_rounds=rounds,
                                       stash=sk, block=block)
            okp = insert_bulk_adaptive_plain(*pp, hi, lo, valid, fp_bits=16,
                                             n_buckets=nb,
                                             evict_rounds=rounds, stash=sp,
                                             block=block)
            pairs = list(zip(pk, pp)) + [(out[-1], okp)]
            if sk is not None:
                pairs.append((sk, sp))
            self.record("insert_bulk_adaptive", pairs)
            failed = int((valid & ~okp).sum())
            spilled = 0 if sp is None else int((sp[0] != 0).sum())
            reset = self.adapted_slots(base) - self.adapted_slots(pp)
            print(f"   insert_adaptive {label}: block={block} "
                  f"rounds={rounds} failed={failed} stashed={spilled} "
                  f"adapted slots reset by kicks={reset}", flush=True)
            reached = {name for name, hit in (("kick", reset > 0),
                                              ("spill", spilled > 0),
                                              ("rollback", failed > 0))
                       if hit}
            check(must <= reached, f"insert case {label} reached {reached}, "
                                   f"not {must}")
            if label == "storm+rollback":
                storm = pk, sk, (m_hi, m_lo), (hi, lo, okp)

        # probe and delete on the storm's state: members, landed keys,
        # absent keys; deletes with duplicates.
        planes, stash, (m_hi, m_lo), (n_hi, n_lo, okp) = storm
        half = CHUNK // 2
        _k, a_hi, a_lo = self.keys()
        p_hi = torch.cat([m_hi[:half // 2], n_hi[okp][:half // 2],
                          a_hi[:half]])
        p_lo = torch.cat([m_lo[:half // 2], n_lo[okp][:half // 2],
                          a_lo[:half]])
        pblock = min(kops.autotune_block(
            "probe", table_bytes=kops._adaptive_plane_bytes(planes[0]),
            stash_slots=128), CHUNK)
        for st in (None, stash):
            got = probe_adaptive(planes[0], planes[1], p_hi, p_lo,
                                 fp_bits=16, n_buckets=nb, stash=st,
                                 block=pblock)
            want = probe_adaptive_plain(planes[0], planes[1], p_hi, p_lo,
                                        fp_bits=16, n_buckets=nb, stash=st)
            self.record("probe_adaptive", [(got, want)])
        check(bool(got[:p_hi.numel() - half].all()),
              "probe_adaptive missed a member")
        d_hi = torch.cat([m_hi[:half], m_hi[:half // 2], m_hi[:half // 2]])
        d_lo = torch.cat([m_lo[:half], m_lo[:half // 2], m_lo[:half // 2]])
        valid = torch.ones(CHUNK, dtype=torch.bool, device=self.dev)
        dblock = min(kops.autotune_block(
            "delete", table_bytes=kops._adaptive_plane_bytes(planes[0]),
            n_keys=CHUNK), CHUNK)
        pk = [p.clone() for p in planes]
        pp = [p.clone() for p in planes]
        okk = delete_bulk_adaptive(*pk, d_hi, d_lo, fp_bits=16, n_buckets=nb,
                                   valid=valid, block=dblock)[-1]
        okd = delete_bulk_adaptive_plain(*pp, d_hi, d_lo, valid, fp_bits=16,
                                         n_buckets=nb, block=dblock)
        self.record("delete_bulk_adaptive",
                    list(zip(pk, pp)) + [(okk, okd)])
        print(f"   delete_adaptive: block={dblock} cleared={int(okd.sum())} "
              f"of {CHUNK} (duplicates past the resident copy miss)",
              flush=True)
        self.staging()
        self.cases()

    def staging(self) -> None:
        """ADAPTIVE_STAGING_CASES: insert, then delete (with repeats and
        residents), kernel against plain version on copies of the same
        planes, stash and keys; then the tiny table again with its calls
        split into launches of at most 300 keys (two logical blocks)."""
        torch = self.torch
        from repro_torch.kernels import cuda
        from repro_torch.kernels.delete import (delete_bulk_adaptive,
                                                delete_bulk_adaptive_plain)
        from repro_torch.kernels.insert import (insert_bulk_adaptive,
                                                insert_bulk_adaptive_plain,
                                                insert_bulk_adaptive_tm)
        from repro_torch.kernels.staging_cases import (
            ADAPTIVE_STAGING_CASES, adaptive_staging_inputs)
        from repro_torch.kernels.telemetry import insert_plane
        from repro_torch.core import hashing

        def dev32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                                    .view(np.int32)).to(self.dev)

        def one(label, split_keys=cuda.SPLIT_KEYS):
            c = adaptive_staging_inputs(label, SEED)
            nb, block, rounds = c["n_buckets"], c["block"], c["rounds"]
            pk = [dev32(p) for p in c["planes"]]
            pp = [p.clone() for p in pk]
            pt = [p.clone() for p in pk]
            sk = None if c["stash"] is None else dev32(c["stash"])
            sp = None if sk is None else sk.clone()
            st = None if sk is None else sk.clone()
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(c["keys"]))
            valid = torch.from_numpy(c["valid"]).to(self.dev)
            before = self.adapted_slots(pk)
            okk = insert_bulk_adaptive(*pk, hi, lo, fp_bits=16, n_buckets=nb,
                                       valid=valid, evict_rounds=rounds,
                                       stash=sk, block=block,
                                       split_keys=split_keys)[-1]
            okp, stats = insert_bulk_adaptive_plain(
                *pp, hi, lo, valid, fp_bits=16, n_buckets=nb,
                evict_rounds=rounds, stash=sp, block=block, want_stats=True)
            pairs = list(zip(pk, pp)) + [(okk, okp)]
            if sk is not None:
                pairs.append((sk, sp))
            self.record("insert_bulk_adaptive", pairs)
            tm = insert_bulk_adaptive_tm(*pt, hi, lo, fp_bits=16,
                                         n_buckets=nb, valid=valid,
                                         evict_rounds=rounds, stash=st,
                                         block=block, split_keys=split_keys)
            self.hold_tm("insert_bulk_adaptive_tm",
                         ([*pt, tm[-2]], tm[-1]),
                         ([*pp, okp], insert_plane(*stats, valid)),
                         [*zip(pt, pk), (tm[-2], okk)]
                         + ([] if sk is None else [(st, sk)]))
            failed = int((valid & ~okp).sum())
            reset = before - self.adapted_slots(pp)
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(
                c["delete"]))
            every = torch.ones(c["delete"].size, dtype=torch.bool,
                               device=self.dev)
            dk = delete_bulk_adaptive(*pk, hi, lo, fp_bits=16, n_buckets=nb,
                                      valid=every, block=block,
                                      split_keys=split_keys)[-1]
            dp = delete_bulk_adaptive_plain(*pp, hi, lo, every, fp_bits=16,
                                            n_buckets=nb, block=block)
            self.record("delete_bulk_adaptive",
                        list(zip(pk, pp)) + [(dk, dp)])
            return failed, reset, sp, int(dp.sum()), c

        for label in ADAPTIVE_STAGING_CASES:
            failed, reset, sp, deleted, c = one(label)
            print(f"   adaptive staging {label}: block={c['block']} rounds="
                  f"{c['rounds']} bucket_size={c['planes'][0].shape[1]} "
                  f"keys={c['keys'].size} failed={failed} adapted slots "
                  f"reset by kept kicks={reset} stashed="
                  f"{0 if sp is None else int((sp[0] != 0).sum())} "
                  f"deleted={deleted} of {c['delete'].size}", flush=True)
            check(failed > 0, f"adaptive staging {label}: no insert failed")
        before = cuda.LAUNCHES["insert_bulk_adaptive"]
        one("tiny-table", split_keys=300)
        n_launch = cuda.LAUNCHES["insert_bulk_adaptive"] - before
        check(n_launch == 4, f"a split call made {n_launch} launches, not 4")
        print(f"   adaptive staging tiny-table split into {n_launch} "
              f"launches: same as the plain version", flush=True)

    def cases(self) -> None:
        """PROBE_ADAPTIVE_CASES, with and without the stash: kernel against
        plain version on the same planes, stash and keys."""
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels.probe import (probe_adaptive,
                                               probe_adaptive_plain,
                                               probe_adaptive_tm)
        from repro_torch.kernels.staging_cases import (
            PROBE_ADAPTIVE_CASES, probe_adaptive_inputs)

        def dev32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                                    .view(np.int32)).to(self.dev)

        for label in PROBE_ADAPTIVE_CASES:
            c = probe_adaptive_inputs(label, SEED)
            table, sels = dev32(c["table"]), dev32(c["sels"])
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(c["keys"]))
            hits, planes = [], []
            for st in (None, dev32(c["stash"])):
                kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"],
                          stash=st)
                got = probe_adaptive(table, sels, hi, lo, block=c["block"],
                                     **kw)
                want = probe_adaptive_plain(table, sels, hi, lo, **kw)
                self.record("probe_adaptive", [(got, want)])
                hits.append(int(got.sum()))
                # the telemetry twin, the last 7 lanes uncounted
                planes.append(self.hold_probe_tm(
                    "probe_adaptive_tm", probe_adaptive_tm,
                    probe_adaptive_plain, got, (table, sels, hi, lo),
                    max(0, c["keys"].size - 7), c["block"], kw))
            print(f"   probe_adaptive case {label}: bucket_size="
                  f"{c['table'].shape[1]} fp_bits={c['fp_bits']} n="
                  f"{c['keys'].size} stash slots={c['stash'].shape[1]} live="
                  f"{int((c['stash'][0] != 0).sum())} hits without / with "
                  f"the stash={hits}, depth planes={planes}: same as the "
                  f"plain version", flush=True)


class StreamingKernelBench(KernelBench):
    """probe_multi against its plain version at the ring's shape: K = 1, 2,
    4 of four generation tables int32[4, 2^20, 4] filled by the insert
    kernel to loads 0.25 .. 0.9 (spills in their int32[2, 128] stashes),
    with and without the stashes, once with n_buckets == buffer (the
    ring's case) and once below it; 4096-key chunks half present, half
    absent."""

    def __init__(self, device):
        buf = RING["capacity"] // RING["bucket_size"]
        super().__init__(device, n_buckets=buf, buffer=buf)

    def generations(self, nb: int, loads):
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels.insert import insert_bulk
        k = len(loads)
        tables = torch.zeros((k, self.buffer, 4), dtype=torch.int32,
                             device=self.dev)
        stashes = torch.zeros((k, 2, 128), dtype=torch.int32,
                              device=self.dev)
        landed = []
        for g, load in enumerate(loads):
            keys = random_keys(self.rng, int(nb * 4 * load) // 128 * 128)
            hi, lo = (torch.from_numpy(x.view(np.int32)).to(self.dev)
                      for x in hashing.key_to_u32_pair_np(keys))
            ok = insert_bulk(tables[g], hi, lo, fp_bits=16, n_buckets=nb,
                             evict_rounds=16, stash=stashes[g], block=128)[-1]
            landed.append(keys[ok.cpu().numpy()])
        return tables, stashes, landed

    def run(self) -> None:
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.probe import probe_multi, probe_multi_plain

        half = CHUNK // 2
        pblock = min(kops.autotune_block(
            "probe", table_bytes=self.buffer * 4 * 4, stash_slots=128), CHUNK)
        for nb in (self.buffer, self.buffer - self.buffer // 100):
            tables, stashes, landed = self.generations(
                nb, (0.25, 0.5, 0.75, 0.9))
            spilled = [int((s[0] != 0).sum()) for s in stashes]
            check(spilled[-1] > 0, "the 0.9-load generation spilled nothing")
            for k in (1, 2, 4):
                pool = np.concatenate(landed[:k])
                keys = np.concatenate([
                    pool[self.rng.randint(0, pool.size, half)],
                    random_keys(self.rng, half)])
                hi, lo = (torch.from_numpy(x.view(np.int32)).to(self.dev)
                          for x in hashing.key_to_u32_pair_np(keys))
                for st in (None, stashes[:k]):
                    got = probe_multi(tables[:k], hi, lo, fp_bits=16,
                                      n_buckets=nb, stashes=st, block=pblock)
                    want = probe_multi_plain(tables[:k], hi, lo, fp_bits=16,
                                             n_buckets=nb, stashes=st)
                    self.record("probe_multi", [(got, want)])
                check(bool(got[:half].all()), "probe_multi missed a key")
                # The ring's launch: the pool's live slots, in any order.
                gens = list(range(k - 1, -1, -1))
                got = probe_multi(tables, hi, lo, fp_bits=16, n_buckets=nb,
                                  stashes=stashes, gens=gens, block=pblock)
                want = probe_multi_plain(tables, hi, lo, fp_bits=16,
                                         n_buckets=nb, stashes=stashes,
                                         gens=gens)
                self.record("probe_multi", [(got, want)])
                check(bool(got[:half].all()), "probe_multi missed a key")
                print(f"   probe_multi n_buckets={nb} K={k}: hits "
                      f"{int(got[:half].sum())} of {half} present, "
                      f"{int(got[half:].sum())} of {half} absent; stash "
                      f"entries {spilled[:k]}", flush=True)
        # More pool slots than the kernel's 64-bit live mask (one launch per
        # 64 slots holding a generation to probe): the four generations
        # repeated into pools of 65 and 130 slots.
        for k in (65, 130):
            pick = torch.arange(k, device=self.dev) % 4
            big, big_st = tables[pick], stashes[pick]
            hits = []
            for gens in (None, [0, 63, 64, k - 1]):
                for st in (None, big_st):
                    got = probe_multi(big, hi, lo, fp_bits=16, n_buckets=nb,
                                      stashes=st, gens=gens, block=pblock)
                    want = probe_multi_plain(big, hi, lo, fp_bits=16,
                                             n_buckets=nb, stashes=st,
                                             gens=gens)
                    self.record("probe_multi", [(got, want)])
                    hits.append(int(got[:half].sum()))
            # Every slot live, with the stashes: all four generations.
            check(hits[1] == half, "probe_multi missed a key")
            print(f"   probe_multi K={k}: hits of {half} present {hits} "
                  f"(all slots without / with stashes, then slots 0, 63, "
                  f"64, K - 1: generations 0 and 3)", flush=True)
        self.cases()

    def cases(self) -> None:
        """PROBE_MULTI_CASES, with and without the stashes: kernel against
        plain version on the same tables, stashes, live slots and keys."""
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels.probe import probe_multi, probe_multi_plain
        from repro_torch.kernels.staging_cases import (PROBE_MULTI_CASES,
                                                       probe_multi_inputs)

        def dev32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                                    .view(np.int32)).to(self.dev)

        for label in PROBE_MULTI_CASES:
            c = probe_multi_inputs(label, SEED)
            tables = dev32(c["tables"])
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(c["keys"]))
            sts = [None] + ([] if c["stashes"] is None
                            else [dev32(c["stashes"])])
            for st in sts:
                kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"],
                          stashes=st, gens=c["gens"])
                got = probe_multi(tables, hi, lo, block=c["block"], **kw)
                want = probe_multi_plain(tables, hi, lo, **kw)
                self.record("probe_multi", [(got, want)])
            live = (range(c["tables"].shape[0]) if c["gens"] is None
                    else c["gens"])
            entries = (0 if c["stashes"] is None
                       else int((c["stashes"][list(live), 0] != 0).sum()))
            print(f"   probe_multi case {label}: K={c['tables'].shape[0]} "
                  f"live={len(live)} bucket_size={c['tables'].shape[2]} "
                  f"fp_bits={c['fp_bits']} n={c['keys'].size} live stash "
                  f"entries={entries} hits={int(got.sum())}: same as the "
                  f"plain version", flush=True)


def row_rel_err(got, want):
    """Per output row (the last axis) ||got - want|| / ||want|| over the
    rows whose ``want`` is not all 0 -> a float tensor of those rows."""
    num = (got.float() - want.float()).norm(dim=-1)
    den = want.float().norm(dim=-1)
    live = den > 0
    return num[live] / den[live]


class FlashKernelBench:
    """flash_attention against its plain version on the card: gemma3-1b's
    heads at the prompt-scoring length (global and 512-window layers, both
    dtypes), small cases of the reference's sweep (soft-cap 30,
    non-causal, decode-style Sq = 1, D of 16 to 128), Sq > Skv, whose
    first rows have no live key and must be 0, and lengths that cut the
    kernel's 128-row q tile and 64-key kv tile short.  STRIDED_CASES pass
    q as a [B, S, Hq, D] tensor seen as [B, Hq, S, D] and k, v as slices
    of one packed [B, S, 2, Hkv, D] tensor (Hkv > 1, so no stride is
    dense), held against the plain version on contiguous copies.  Each
    case is held elementwise (FLASH_TOL) and row by row (FLASH_ROW_TOL);
    on the long global case the script also reads what the row check
    would see from a kernel that dropped the first 64-key tile of every
    row (the plain version without those keys) and requires the check to
    catch it."""

    CASES = [
        # b, hq, hkv, sq, skv, d, causal, window, softcap
        (1, 4, 1, LM_SEQ, LM_SEQ, 256, True, 512, None),
        (1, 4, 1, LM_SEQ, LM_SEQ, 256, True, None, None),
        (2, 4, 2, 128, 128, 64, True, None, None),
        (1, 8, 1, 256, 256, 64, True, 64, None),
        (2, 2, 2, 128, 256, 128, True, None, 30.0),
        (1, 4, 4, 1, 384, 64, True, None, None),
        (1, 2, 1, 128, 128, 32, False, None, None),
        (1, 4, 1, 256, 256, 16, True, 16, None),
        (1, 2, 1, 256, 128, 32, True, None, None),
        # the bfloat16 kernel's 128-row q tile and 64-key kv tile cut short
        (1, 2, 2, 72, 72, 64, True, None, None),
        (1, 4, 2, 1, 72, 128, True, None, None),
        (1, 4, 1, 96, 96, 256, True, 1, None),
        # lengths that are no multiple of the tiles: ragged last q and kv
        # tiles (gemma3-1b heads at S = 200, global and windowed)
        (1, 4, 1, 200, 200, 256, True, None, None),
        (1, 4, 1, 200, 200, 256, True, 64, None),
        (1, 2, 1, 300, 300, 64, True, None, 20.0),
    ]
    STRIDED_CASES = [
        (1, 8, 2, 1024, 1024, 256, True, None, None),
        (2, 8, 4, 128, 256, 128, True, 64, 30.0),
        (1, 4, 2, 128, 128, 64, False, None, None),
        (1, 4, 2, 96, 96, 32, True, None, None),
        (2, 4, 2, 72, 72, 16, True, 16, None),
    ]

    def __init__(self, device):
        import torch
        self.torch = torch
        self.dev = torch.device(device)
        self.max_err = {"flash_attention": 0.0}

    def run(self) -> None:
        torch = self.torch
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED)
        cases = [(c, False) for c in self.CASES] + \
            [(c, True) for c in self.STRIDED_CASES]
        for case, strided in cases:
            b, hq, hkv, sq, skv, d, causal, window, cap = case
            for dtype in (torch.float32, torch.bfloat16):
                def randn(*shape):
                    return torch.randn(shape, device=self.dev,
                                       generator=gen).to(dtype)
                if strided:
                    kv = randn(b, skv, 2, hkv, d)
                    q, k, v = (randn(b, sq, hq, d).transpose(1, 2),
                               kv[:, :, 0].transpose(1, 2),
                               kv[:, :, 1].transpose(1, 2))
                    check(not any(t.is_contiguous() for t in (q, k, v)),
                          f"flash_attention {case}: a strided view is dense")
                else:
                    q, k, v = (randn(b, hq, sq, d), randn(b, hkv, skv, d),
                               randn(b, hkv, skv, d))
                kw = dict(causal=causal, window=window, logit_softcap=cap)
                got = flash_attention(q, k, v, **kw).float()
                want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                             v.contiguous(), **kw).float()
                err = (got - want).abs()
                name = str(dtype).split(".")[-1]
                tol, row_tol = FLASH_TOL[name], FLASH_ROW_TOL[name]
                excess = float((err - tol * (1 + want.abs())).max())
                m = float(err.max())
                rel = float(row_rel_err(got, want).max())
                if strided:
                    name += ", strided"
                print(f"   flash_attention {case} {name}: max_abs_err {m!r}"
                      f" (tolerance {tol} x (1 + |want|), max |want| "
                      f"{float(want.abs().max())!r}); row relative error "
                      f"{rel!r} (limit {row_tol})", flush=True)
                check(excess <= 0, f"flash_attention {case} {name}: "
                                   f"outside the tolerance by {excess}")
                check(rel <= row_tol, f"flash_attention {case} {name}: row "
                                      f"relative error {rel} > {row_tol}")
                if causal and window is None and sq == skv >= 4096:
                    # The first 64-key tile dropped from every row: the
                    # plain version over keys 64.. (query i at key 64 + i).
                    cut = flash_attention_plain(q[:, :, 64:], k[:, :, 64:],
                                                v[:, :, 64:], bq=64, bk=64,
                                                **kw)
                    fault = row_rel_err(cut[:, :, sq // 2 - 64:],
                                        want[:, :, sq // 2:])
                    weakest = float(fault.min())
                    print(f"   ... a kernel dropping one 64-key tile of each "
                          f"row of {sq // 2}+ keys would read at least "
                          f"{weakest!r}", flush=True)
                    check(weakest > row_tol, "the row check would not catch "
                                             "a dropped kv tile")
                if skv < sq:
                    check(float(got[:, :, :sq - skv].abs().max()) == 0.0,
                          "flash_attention: a row with no live key is not 0")
                self.max_err["flash_attention"] = max(
                    self.max_err["flash_attention"], m)


# --------------------------------------------------- phase 3: slice parity --


def snapshot(ocf) -> dict:
    from repro_torch.convert import state_to_numpy
    d = state_to_numpy(ocf.state, ocf.stash)
    d["capacity_history"] = list(ocf.capacity_history)
    d["stats"] = dataclasses.asdict(ocf.stats)
    return d


def same_snapshot(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for key, va in a.items():
        vb = b[key]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if va is None or vb is None or va.shape != vb.shape \
                    or not (va == vb).all():
                return False
        elif va != vb:
            return False
    return True


def parity_stream(n_keys: int, rng: np.random.RandomState):
    """Bursty inserts (grows, failed inserts), verified + blind deletes down
    to a shrink, and lookups of present and absent keys."""
    keys = random_keys(rng, n_keys)
    absent = random_keys(rng, n_keys // 10)
    ops, i = [], 0
    for size in (n_keys // 8, n_keys // 8, n_keys // 4, n_keys // 2):
        ops.append(("insert", keys[i:i + size]))
        i += size
    ops.append(("lookup", np.concatenate([keys[: n_keys // 10], absent])))
    ops.append(("delete", np.concatenate([keys[: n_keys // 20],
                                          absent[: n_keys // 50]])))
    step = n_keys // 8
    for j in range(n_keys // 20, int(n_keys * 0.8), step):
        ops.append(("delete", keys[j:j + step]))
    ops.append(("lookup", np.concatenate([keys[-n_keys // 10:], absent])))
    return ops


def slice_parity(n_keys: int, stash_slots: int):
    from repro_torch.core.ocf import OCF, OcfConfig
    rng = np.random.RandomState(SEED)
    ocfs = [OCF(OcfConfig(capacity=4096, mode="EOF",
                          stash_slots=stash_slots, device=d))
            for d in ("cuda", "cpu")]
    for step, (op, keys) in enumerate(parity_stream(n_keys, rng)):
        answers = [np.asarray(getattr(o, op)(keys)) for o in ocfs]
        check((answers[0] == answers[1]).all(),
              f"{op} #{step}: answers differ between devices")
        snaps = [snapshot(o) for o in ocfs]
        check(same_snapshot(*snaps),
              f"{op} #{step}: filter state differs between devices")
    o = ocfs[0]
    print(f"   stash_slots={stash_slots}: capacity_history="
          f"{o.capacity_history} grows={o.stats.grows} "
          f"shrinks={o.stats.shrinks} failed_inserts="
          f"{o.stats.failed_inserts} stash_spills={o.stats.stash_spills} "
          f"blind_deletes_blocked={o.stats.blind_deletes_blocked}",
          flush=True)
    check(o.stats.grows >= 1 and o.stats.shrinks >= 1,
          "the parity stream did not both grow and shrink")


def adaptive_snapshot(m) -> dict:
    from repro_torch.convert import adaptive_state_to_numpy
    d = adaptive_state_to_numpy(m.filt.state)
    d["stash"] = m.filt.stash.cpu().numpy()
    d["adapted"] = m.filt.adapted
    d["promoted"] = m.reputation.promoted
    d["deferred"] = m.deferred_reports
    return d


def adaptive_parity(label: str, *, n_buckets: int, n_members: int,
                    n_benign: int, late: int = 0):
    """One seeded AdaptiveMembership stream on the card and on the CPU:
    4096-key insert bursts, lookups, two report rounds over the benign
    hits, deletes (with duplicates and absent keys); ``late`` more members
    are inserted after the reports, so their chains kick adapted slots.
    Identical state and answers after every operation."""
    from repro_torch.adaptive import AdaptiveConfig, AdaptiveMembership
    rng = np.random.RandomState(SEED + 4)
    members = random_keys(rng, n_members + late)
    benign = random_keys(rng, n_benign)
    probe = np.concatenate([members, benign])
    ops = [("insert", members[i:i + CHUNK])
           for i in range(0, n_members, CHUNK)]
    ops += [("lookup", probe), ("report", None), ("lookup", probe),
            ("report", None)]
    ops += [("insert", members[i:i + CHUNK])
            for i in range(n_members, n_members + late, CHUNK)]
    ops += [("lookup", probe),
            ("delete", np.concatenate([members[: n_members // 4],
                                       members[: n_members // 16],
                                       benign[:1000]])),
            ("lookup", probe)]
    ms = [AdaptiveMembership(AdaptiveConfig(n_buckets=n_buckets,
                                            stash_slots=128, device=d))
          for d in ("cuda", "cpu")]
    hits, peak = None, 0.0
    for step, (op, keys) in enumerate(ops):
        if op == "report":
            keys = benign[hits[members.size:]]
        answers = [np.asarray(getattr(m, op)(keys)) for m in ms]
        peak = max(peak, ms[1].filt.fills()[0])
        check((answers[0] == answers[1]).all(),
              f"{label} {op} #{step}: answers differ between devices")
        check(same_snapshot(*(adaptive_snapshot(m) for m in ms)),
              f"{label} {op} #{step}: adaptive state differs between "
              f"devices")
        if op == "lookup":
            hits = answers[1]
    m = ms[1]
    snap = adaptive_snapshot(m)
    print(f"   {label}: peak load={peak!r} "
          f"final load={snap['count'] / (n_buckets * 4)!r} "
          f"stash={int((snap['stash'][0] != 0).sum())} "
          f"adapted={m.filt.adapted} promoted={m.reputation.promoted} "
          f"sels_nonzero={int((snap['sels'] != 0).sum())}", flush=True)
    check(m.filt.adapted > 0, f"{label}: no report adapted a slot")


def ring_snapshot(ring) -> dict:
    from repro_torch.convert import generational_to_numpy
    d = generational_to_numpy(ring)
    for i, g in enumerate(d.pop("gens")):
        for key, value in g.items():
            d[f"gen{i}.{key}"] = value
    return d


def ring_parity(n_events: int = 100_000):
    """One seeded dedup stream through a ring on the card and one on the
    CPU: per tick a lookup of the tick's events (60% fresh, 40% repeats of
    recent ones), an insert of those it missed and a lookup_active of the
    repeats; 8192-slot generations so 4096-key chunks overflow a filling
    generation (spills, a rotate-and-retry) and the ring rotates; one
    explicit rotate, and a quiet gap in the clock that expires every
    generation.  Identical answers, tables, stashes, counts, clock and
    GenStats after every operation."""
    from repro_torch.streaming import GenerationalFilter, GenerationConfig
    cfg = dict(generations=3, capacity=8192, stash_slots=32, evict_rounds=8,
               ttl=6.0)
    rings = [GenerationalFilter(GenerationConfig(device=d, **cfg), now=0.0)
             for d in ("cuda", "cpu")]
    rng = np.random.RandomState(SEED + 7)
    recent, done, step, t = [], 0, 0, 0.0

    def both(op, *args, **kw):
        nonlocal step
        answers = [getattr(r, op)(*args, **kw) for r in rings]
        if answers[0] is not None:
            check(np.array_equal(answers[0], answers[1]),
                  f"ring {op} #{step}: answers differ between devices")
        check(same_snapshot(*(ring_snapshot(r) for r in rings)),
              f"ring {op} #{step}: ring state differs between devices")
        step += 1
        return answers[1]

    while done < n_events:
        n = int(rng.choice([3000, 6000, 12000]))
        fresh = random_keys(rng, int(n * 0.6))
        pool = np.concatenate(recent[-3:]) if recent else fresh
        repeats = pool[rng.randint(0, pool.size, n - fresh.size)]
        events = np.concatenate([fresh, repeats])
        new = ~both("lookup", events, now=t)
        both("insert", events[new], now=t)
        both("lookup_active", repeats, now=t)
        recent.append(fresh)
        done += n
        t += 1.0
        if done >= n_events // 2 and t < 20.0:
            both("rotate", now=t)
            t = 20.0                         # a quiet gap: all expire
            both("advance", now=t)
    st = rings[1].stats
    print(f"   ring stream: {done} events, {step} ops, stats={st}",
          flush=True)
    check(st.rotations > 0 and st.expirations > 0 and st.spills > 0
          and st.rotate_retries > 0,
          "the ring stream missed a rotation, expiry, spill or retry")


def batcher_stream(device: str, *, adaptive: bool, telemetry: bool,
                   n_buckets: int = 1024, wave: int = 1024):
    """A seeded wave stream through a ``FilterOpBatcher`` over a 8-slot
    stash on ``device``: insert waves to load ~0.95 (kicks, spills,
    rollbacks), lookups with repeats (dedup) and absent keys, for the
    adaptive filter reports of the false positives, then deletes of the
    acknowledged keys, the last ones twice -> (batcher, wave results,
    registry snapshot without the host's latencies)."""
    from repro_torch.adaptive.state import make_adaptive_state
    from repro_torch.core.filter import make_state
    from repro_torch.core.filter_ops import FilterOps
    from repro_torch.kernels.stash import make_stash
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import FilterOpBatcher

    rng = np.random.RandomState(SEED + 17)
    state = (make_adaptive_state(n_buckets, device=device) if adaptive
             else make_state(n_buckets, device=device))
    m = MetricsRegistry()
    b = FilterOpBatcher(FilterOps(fp_bits=8 if adaptive else 12,
                                  evict_rounds=4),
                        state, stash=make_stash(8, device=device),
                        wave_slots=wave, double_buffer=True,
                        telemetry=telemetry, metrics=m)
    members = random_keys(rng, 4 * wave)
    benign = random_keys(rng, wave)
    waves = [b.submit("insert", members[i:i + wave])
             for i in range(0, members.size, wave)]
    b.flush()
    taken = members[np.concatenate([w.results for w in waves])]
    waves.append(b.submit("lookup", np.concatenate(
        [taken[:wave // 2], taken[:wave // 8], benign[:wave // 4]])))
    if adaptive:
        b.flush()
        waves.append(b.submit("report", benign[:wave // 4][waves[-1].results[
            -(wave // 4):]]))
    waves.append(b.submit("lookup", benign))
    for i in range(0, taken.size, wave):
        waves.append(b.submit("delete", taken[i:i + wave]))
    waves.append(b.submit("delete", taken[-wave // 8:]))
    b.flush()
    snap = {k: v for k, v in m.snapshot().items() if "latency" not in k}
    return b, [w.results for w in waves], snap


def batcher_parity(adaptive: bool) -> None:
    """The filter's serving front (``FilterOpBatcher``) with telemetry on,
    card against CPU on one seeded stream: every wave's results, the
    table (and the adaptive planes), the stash, the count and every
    counter of the registry equal."""
    import torch
    from repro_torch.kernels import cuda
    cuda.reset_counts()
    card, card_res, card_snap = batcher_stream("cuda", adaptive=adaptive,
                                               telemetry=True)
    tm_launches = {k: cuda.LAUNCHES[k] for k in cuda.TM_KERNELS
                   if cuda.LAUNCHES[k]}
    cpu, cpu_res, cpu_snap = batcher_stream("cpu", adaptive=adaptive,
                                            telemetry=True)
    label = "adaptive" if adaptive else "static"
    check(len(card_res) == len(cpu_res) and all(
        np.array_equal(a, b) for a, b in zip(card_res, cpu_res)),
        f"batcher stream ({label}): a wave's results differ, card vs CPU")
    planes = ("table", "sels", "khi", "klo") if adaptive else ("table",)
    for plane in planes:
        check(torch.equal(getattr(card.state, plane).cpu(),
                          getattr(cpu.state, plane)),
              f"batcher stream ({label}): {plane} differs, card vs CPU")
    check(torch.equal(card.stash.cpu(), cpu.stash)
          and int(card.state.count) == int(cpu.state.count),
          f"batcher stream ({label}): stash or count differs")
    check(card_snap == cpu_snap,
          f"batcher stream ({label}): counters differ, card {card_snap} vs "
          f"CPU {cpu_snap}")
    want = ["filter_stash_spills", "filter_rollback_lanes",
            "filter_stash_deletes", "filter_table_deletes"]
    if adaptive:
        want.append("filter_selector_bumps")
    zero = [k for k in want if not card_snap.get(k)]
    check(not zero, f"batcher stream ({label}): counters never moved: {zero}")
    counters = {k: v for k, v in card_snap.items()
                if k.startswith(("filter_stash", "filter_rollback",
                                 "filter_selector", "filter_table",
                                 "filter_probe"))}
    print(f"   batcher stream ({label}, telemetry on): {len(card_res)} waves, "
          f"tm launches {tm_launches}, kick depth "
          f"{card_snap['filter_kick_depth']['counts']}, {counters}: same "
          f"as the CPU", flush=True)


def prefix_index_parity(steps: int = 40):
    """One seeded GenerationalPrefixIndex stream (shared system prompts,
    varied user turns, a TTL on a logical clock) on the card and the CPU:
    identical answers, PrefixStats and ring state after every call."""
    from repro_torch.serving import GenerationalPrefixIndex
    idx = [GenerationalPrefixIndex(block=32, capacity=4096, generations=3,
                                   ttl=5.0, now=0.0, device=d)
           for d in ("cuda", "cpu")]
    rng = np.random.RandomState(SEED + 8)
    systems = [rng.randint(0, 32000, 256).astype(np.uint32)
               for _ in range(4)]
    for step in range(steps):
        now = 0.5 * step
        prompt = np.concatenate([
            systems[rng.randint(len(systems))],
            rng.randint(0, 32000, int(rng.randint(64, 257))).astype(
                np.uint32)])
        for op in ("match_prefix", "admit"):
            answers = [getattr(i, op)(prompt, now=now) for i in idx]
            check(answers[0] == answers[1],
                  f"prefix {op} #{step}: answers differ between devices")
            check(dataclasses.asdict(idx[0].stats)
                  == dataclasses.asdict(idx[1].stats)
                  and same_snapshot(*(ring_snapshot(i.filt) for i in idx)),
                  f"prefix {op} #{step}: state differs between devices")
    st, gs = idx[1].stats, idx[1].filt.stats
    print(f"   prefix index: {st} hit_rate={idx[1].hit_rate!r} ring={gs}",
          flush=True)
    check(st.block_hits > 0 and gs.expirations > 0,
          "the prefix stream never hit or never expired a generation")


def lm_parity(seqs=(512, 200), steps: int = 8):
    """gemma3-1b at full width, one period deep (6 layers), float32, TF32
    off: one seeded init on the CPU, copied to the card.  The cache-less
    forward's logits agree within 1e-3 (float32 sums in other orders on
    the two devices, through 6 layers and a 1152-wide unembedding; logits
    are O(1)) at each length of ``seqs`` (200 is no multiple of the flash
    kernel's tiles); the greedy tokens of prefill + ``steps`` decode steps
    of the first are equal."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models import Transformer
    from repro_torch.serving.engine import generate
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=6,
                              dtype="float32")
    cpu = Transformer(cfg, seed=SEED, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    for i, seq in enumerate(seqs):
        toks = torch.from_numpy(np.random.RandomState(SEED + 10).randint(
            0, cfg.vocab_size, (1, seq)))
        cuda.reset_counts()
        a = card.apply(toks.cuda()).logits
        torch.cuda.synchronize()
        check(cuda.LAUNCHES["flash_attention"] == cfg.n_layers,
              "the card's forward did not launch flash_attention per layer")
        b = cpu.apply(toks).logits
        err = float((a.cpu() - b).abs().max())
        print(f"   LM {cfg.name} x{cfg.n_layers} layers, float32, S={seq}: "
              f"logits max_abs_err card vs cpu {err!r} (max |logit| "
              f"{float(b.abs().max())!r})", flush=True)
        check(err < 1e-3, f"LM logits differ between devices by {err}")
        if i == 0:
            gen = [generate(m, t, steps + 1).tokens.cpu().numpy()
                   for m, t in ((card, toks.cuda()), (cpu, toks))]
            print(f"   greedy tokens {gen[0].tolist()} / "
                  f"{gen[1].tolist()}", flush=True)
            check(np.array_equal(*gen), "greedy tokens differ between "
                                        "devices")
    return card, cpu


def slo_recorder():
    """A ``SloHarness`` that keeps what a replay drove: ``target`` (the
    batcher or the ring) and ``waves`` in submit order (kind, keys, and the
    ``OpWave`` or the ring call's answer); for a batcher ``launched``, its
    waves in launch order with their keys (a wave parked by admission
    launches later than it was submitted); for a ring each call's clock,
    the generation an insert went into (None when the call rotated) and
    the generations live at a lookup."""
    from repro_torch.serving.slo import SloHarness

    class Recording(SloHarness):
        def run(self, batcher, stream, **kw):
            self.target, self.waves, self.launched = batcher, [], []
            submit, launch = batcher.submit, batcher._launch

            def submitted(kind, keys):
                wave = submit(kind, keys)
                self.waves.append((kind, keys, wave))
                return wave

            def launched(wave, keys):
                self.launched.append((wave, keys))
                launch(wave, keys)
            batcher.submit, batcher._launch = submitted, launched
            return super().run(batcher, stream, **kw)

        def run_generational(self, filt, stream, **kw):
            self.target, self.waves = filt, []
            insert, lookup = filt.insert, filt.lookup

            def inserted(keys, now=None):
                before = (filt.stats.rotations, filt.stats.rotate_retries)
                ok = insert(keys, now=now)
                calm = before == (filt.stats.rotations,
                                  filt.stats.rotate_retries)
                self.waves.append(("insert", keys, ok,
                                   filt.gens[-1] if calm else None, now))
                return ok

            def looked_up(keys, now=None):
                live = [g for g in filt.gens if g.live(now)]
                hits = lookup(keys, now=now)
                self.waves.append(("lookup", keys, hits, live, now))
                return hits
            filt.insert, filt.lookup = inserted, looked_up
            return super().run_generational(filt, stream, **kw)
    return Recording()


def slo_fields(rep) -> dict:
    """An ``SloReport``'s fields that are no host time."""
    return {"ops": rep.ops, "waves": rep.waves, "shed_ops": rep.shed_ops,
            "deferred_waves": rep.deferred_waves,
            "held_ticks": rep.held_ticks, "extras": rep.extras,
            "samples": [(x.kind, x.ops, x.burst, x.deferred)
                        for x in rep.recorder.samples]}


def slo_same_waves(a, b) -> bool:
    """Two recordings' waves: the same kinds, keys, results (None for a
    shed wave) and parked ticks."""
    if len(a.waves) != len(b.waves):
        return False
    for x, y in zip(a.waves, b.waves):
        if x[0] != y[0] or not np.array_equal(x[1], y[1]):
            return False
        rx, ry = x[2], y[2]
        if hasattr(rx, "results"):
            if rx.deferred_ticks != ry.deferred_ticks:
                return False
            rx, ry = rx.results, ry.results
        if (rx is None) != (ry is None) or (
                rx is not None and not np.array_equal(rx, ry)):
            return False
    return True


def slo_same_stack(a, b) -> bool:
    """Two batchers' final planes, stash and count, or two rings' state."""
    import torch
    if hasattr(a, "gens"):
        return same_snapshot(ring_snapshot(a), ring_snapshot(b))
    planes = [p for p in ("table", "sels", "khi", "klo")
              if hasattr(a.state, p)]
    return (all(torch.equal(getattr(a.state, p).cpu(),
                            getattr(b.state, p).cpu()) for p in planes)
            and int(a.state.count) == int(b.state.count)
            and (a.stash is None) == (b.stash is None)
            and (a.stash is None or torch.equal(a.stash.cpu(),
                                                b.stash.cpu())))


def slo_parity() -> None:
    """Every scenario of the SLO harness through ``run_scenario`` with the
    reference's defaults (its stacks, 512-key waves, the generators'
    lengths), on the card and on the CPU: every wave's results, the final
    state (the ring's generations for ``ttl_churn``) and every report field
    that is no host time equal."""
    from repro_torch.serving.slo import BENCH_SCENARIOS, run_scenario
    for name in BENCH_SCENARIOS:
        runs = []
        for device in ("cuda", "cpu"):
            h = slo_recorder()
            runs.append((h, run_scenario(name, seed=SEED, device=device,
                                         harness=h)))
        (ch, crep), (ph, prep) = runs
        check(slo_same_waves(ch, ph),
              f"scenario {name}: a wave differs, card vs CPU")
        check(slo_same_stack(ch.target, ph.target),
              f"scenario {name}: the final state differs, card vs CPU")
        check(slo_fields(crep) == slo_fields(prep),
              f"scenario {name}: the report differs, card vs CPU")
        print(f"   scenario {name}: {crep.waves} waves, {crep.ops} ops, "
              f"extras {crep.extras}: same as the CPU (card p99 "
              f"{crep.percentiles_us['p99']!r} us)", flush=True)


def burst_prompts(vocab: int, n: int = 7) -> list:
    """tests/test_scheduler.py's burst: 64-token prompts, the even ones
    sharing a 48-token prefix."""
    rng = np.random.RandomState(SEED)
    shared = rng.randint(0, vocab, 48).astype(np.int32)
    return [np.concatenate([shared, rng.randint(0, vocab, 16).astype(
        np.int32)]) if i % 2 == 0 else rng.randint(0, vocab, 64).astype(
        np.int32) for i in range(n)]


def continuous_batcher_parity(card_model, cpu_model) -> None:
    """tests/test_scheduler.py's burst of 7 requests into 3 slots through
    ``ContinuousBatcher`` over the card's and the CPU's copy of one model:
    equal greedy tokens, ``SchedStats`` equal field by field."""
    from repro_torch.serving import ContinuousBatcher, Request
    prompts = burst_prompts(cpu_model.cfg.vocab_size)
    out = []
    for model in (card_model, cpu_model):
        b = ContinuousBatcher(model, slots=3, cache_len=128, block=16)
        reqs = [Request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        check(b.congestion > 1.0, "the burst did not exceed the slots")
        stats = b.run_until_drained()
        out.append(([r.out for r in reqs], dataclasses.asdict(stats)))
    (card_toks, card_stats), (cpu_toks, cpu_stats) = out
    print(f"   ContinuousBatcher burst: tokens {card_toks} / {cpu_toks}, "
          f"stats {card_stats}", flush=True)
    check(card_toks == cpu_toks, "ContinuousBatcher: greedy tokens differ "
                                 "between devices")
    check(card_stats == cpu_stats, f"ContinuousBatcher: SchedStats differ: "
                                   f"{card_stats} vs {cpu_stats}")
    check(card_stats["finished"] == 7
          and card_stats["prefix_blocks_reused"] > 0,
          "ContinuousBatcher: the burst did not drain or reuse a prefix")


# ------------------------------------------------------ phase 4: main path --


def main_path(device, card: str, *, capacity=1 << 22, bursts=8,
              burst=1_000_000, n_delete=3_000_000, n_blind=100_000,
              n_absent=5_000_000):
    import torch
    from repro_torch.core.metrics import (measure_false_negatives,
                                          measure_false_positives,
                                          theoretical_fp_rate)
    from repro_torch.core.ocf import OCF, OcfConfig
    from repro_torch.kernels import cuda

    rng = np.random.RandomState(SEED + 1)
    keys = random_keys(rng, bursts * burst)
    blind = random_keys(rng, n_blind)
    absent = random_keys(rng, n_absent)
    ocf = OCF(OcfConfig(capacity=capacity, bucket_size=4, fp_bits=16,
                        mode="EOF", device=device))

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    sync()
    cuda.reset_counts()
    t0 = time.perf_counter()
    for b in range(bursts):
        ocf.insert(keys[b * burst:(b + 1) * burst])
    sync()
    t_ins = time.perf_counter() - t0
    t0 = time.perf_counter()
    present = ocf.delete(np.concatenate([keys[:n_delete], blind]))
    sync()
    t_del = time.perf_counter() - t0
    resident = keys[n_delete:]
    t0 = time.perf_counter()
    hits = ocf.lookup(np.concatenate([resident, absent]))
    sync()
    t_look = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    plain = dict(cuda.PLAIN_CALLS)

    fn = int((~hits[: resident.size]).sum())
    fp = int(hits[resident.size:].sum())
    occ = ocf.occupancy
    eps = theoretical_fp_rate(4, 16, occ)
    fp_rate = fp / absent.size
    print(f"   capacity_history={ocf.capacity_history}", flush=True)
    print(f"   stats={dataclasses.asdict(ocf.stats)}", flush=True)
    print(f"   false_negatives={fn} false_positives={fp} fp_rate={fp_rate!r}"
          f" theoretical={eps!r} occupancy={occ!r}", flush=True)
    print(f"   launches={launches} plain_calls={plain}", flush=True)
    n_ins, n_del = bursts * burst, n_delete + n_blind
    n_look = resident.size + absent.size
    print(f"   [{card}] insert {n_ins / t_ins!r} keys/s ({t_ins!r} s), "
          f"delete {n_del / t_del!r} keys/s ({t_del!r} s), lookup "
          f"{n_look / t_look!r} keys/s ({t_look!r} s)", flush=True)

    check(fn == 0, f"{fn} false negatives")
    check(int(present.sum()) == n_delete, "a verified delete was refused")
    check(ocf.stats.blind_deletes_blocked == n_blind,
          "blind deletes were not all blocked")
    check(ocf.stats.grows >= 1, "the main path never grew the filter")
    check(fp_rate <= 4 * eps, f"fp rate {fp_rate} > 4 x {eps}")
    check(measure_false_negatives(ocf, resident[:100_000]) == 0,
          "measure_false_negatives found a miss")
    check(measure_false_positives(ocf, absent[:100_000]) <= 100_000 * 4 * eps
          + 10, "measure_false_positives out of bound")
    return ocf, resident, launches, plain, {
        "insert_s": t_ins, "delete_s": t_del, "lookup_s": t_look}


# ---------------------------------------------- phase 5: the adaptive path --


def adaptive_path(card: str, *, n_buckets=1 << 22, bursts=12,
                  burst=1_000_000, n_benign=10_000_000, rounds=4,
                  n_delete=3_000_000):
    """An abuse-detection denylist of one node (the deployment of
    examples/adaptive_abuse_detection.py at 16M slots): member bursts, a
    lookup of every member, feedback rounds over one replayed benign
    population, deletes, and a lookup of the remaining members."""
    import torch
    from repro_torch.adaptive import AdaptiveConfig, AdaptiveMembership
    from repro_torch.kernels import cuda
    from repro_torch.kernels.stash import stash_occupancy
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(SEED + 3)
    members = random_keys(rng, bursts * burst)
    benign = random_keys(rng, n_benign)
    m = AdaptiveMembership(AdaptiveConfig(n_buckets=n_buckets, bucket_size=4,
                                          fp_bits=16, stash_slots=128))
    times, phases = {}, []

    def timed(name, fn):
        before = dict(cuda.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        phases.append((name, {k: v - before.get(k, 0)
                              for k, v in cuda.LAUNCHES.items()
                              if v != before.get(k, 0)}))
        return out

    # One CUDA-activity trace over the whole path gives the device's busy
    # time per kernel (the host's time is the rest of each phase).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        cuda.reset_counts()
        ok = np.concatenate([timed("insert", lambda b=b: m.insert(
            members[b * burst:(b + 1) * burst])) for b in range(bursts)])
        acked = members[ok]
        load = m.filt.fills()[0]
        hit = timed("member lookup", lambda: m.lookup(members))
        fn_before = int((~hit[ok]).sum())
        fp_rounds = []
        for r in range(rounds):
            hits = timed("benign lookup", lambda: m.lookup(benign))
            fps = benign[hits]
            adapted = timed("report", lambda: m.report(fps))
            fp_rounds.append((int(fps.size), int(adapted.sum()),
                              m.reputation.promoted, m.deferred_reports))
        d_ok = timed("delete", lambda: m.delete(acked[:n_delete]))
        remaining = acked[n_delete:]
        hit_r = timed("member lookup", lambda: m.lookup(remaining))
        fn_after = int((~hit_r).sum())
        launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    device_s = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0) or 0.0
        if us > 0:
            device_s[ev.key] = device_s.get(ev.key, 0.0) + us / 1e6

    stash_n = int(stash_occupancy(m.filt.stash))
    eps = 2 * 4 * load / 2 ** 16
    for name, counts in phases:
        print(f"   phase {name}: launches {counts}", flush=True)
    print(f"   load after inserts={load!r} failed inserts="
          f"{int((~ok).sum())} stash occupancy={stash_n} "
          f"false negatives before deletes={fn_before} after={fn_after}",
          flush=True)
    for r, (n_fp, n_ad, n_pr, n_def) in enumerate(fp_rounds):
        print(f"   [{card}] round {r}: false positives={n_fp} "
              f"(rate {n_fp / n_benign!r}, bound 4 x {eps!r}) "
              f"adapted={n_ad} promoted={n_pr} deferred={n_def}",
              flush=True)
    n_look = members.size + remaining.size
    print(f"   [{card}] insert {bursts * burst / times['insert']!r} keys/s, "
          f"member lookup {n_look / times['member lookup']!r} keys/s, "
          f"benign lookup {rounds * n_benign / times['benign lookup']!r} "
          f"keys/s, report {sum(r[0] for r in fp_rounds) / times['report']!r}"
          f" keys/s ({times['report']!r} s), delete "
          f"{n_delete / times['delete']!r} keys/s", flush=True)
    print(f"   launches={launches} plain_calls={plain}", flush=True)
    wall = sum(times.values())
    busy = sum(device_s.values())
    print(f"   [{card}] device busy {busy!r} s of {wall!r} s of phases "
          f"(idle share {1 - busy / wall!r})", flush=True)
    for kernel, phase_names in (
            ("insert_adaptive_kernel", ("insert",)),
            ("probe_adaptive_kernel", ("member lookup", "benign lookup")),
            ("family_kernel", ("report",)),
            ("delete_adaptive_kernel", ("delete",))):
        k_s = sum(v for key, v in device_s.items() if kernel in key)
        p_s = sum(times[n] for n in phase_names)
        print(f"   {kernel}: {k_s!r} s on the device, {k_s / p_s!r} of "
              f"its phases ({'+'.join(phase_names)}, {p_s!r} s)", flush=True)

    check(fn_before == 0 and fn_after == 0,
          f"false negatives: {fn_before} before, {fn_after} after deletes")
    check(bool(d_ok.all()), "a verified delete was refused")
    check(fp_rounds[0][0] / n_benign <= 4 * eps,
          f"round 0 fp rate {fp_rounds[0][0] / n_benign} > 4 x {eps}")
    check(fp_rounds[-1][0] <= 0.01 * fp_rounds[0][0],
          f"the last round kept {fp_rounds[-1][0]} of "
          f"{fp_rounds[0][0]} false positives")
    return m, remaining, launches, plain, {
        "load": load, "fp_rounds": fp_rounds, "times": times,
        "device_s": device_s, "benign": benign}


# ------------------------------- phase 5d: filter-op waves at full size --


def filter_wave_run(keys: np.ndarray, absent: np.ndarray, *,
                    adaptive: bool, telemetry: bool, n_buckets: int,
                    wave: int, stash_slots: int, load: float) -> dict:
    """One arm of phase 5d: a ``FilterOpBatcher`` over a fresh state and
    stash on the card; insert waves of ``keys``, lookup waves over every
    acknowledged key and as many of ``absent``, for the adaptive filter
    report waves of the absent keys that hit, then delete waves over the
    first half of the acknowledged keys."""
    import torch
    from repro_torch.adaptive.state import make_adaptive_state
    from repro_torch.core.filter import make_state
    from repro_torch.core.filter_ops import FilterOps, evict_rounds_for_load
    from repro_torch.kernels import cuda
    from repro_torch.kernels.stash import make_stash
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import FilterOpBatcher

    m = MetricsRegistry()
    b = FilterOpBatcher(
        FilterOps(fp_bits=16, evict_rounds=evict_rounds_for_load(load),
                  donate=True),
        (make_adaptive_state if adaptive else make_state)(n_buckets, 4),
        stash=make_stash(stash_slots), wave_slots=wave, double_buffer=True,
        telemetry=telemetry, metrics=m)

    def waves(kind, k):
        return [b.submit(kind, k[i:i + wave]) for i in range(0, k.size, wave)]

    gc.collect()      # the earlier arms' garbage, outside the timed span
    torch.cuda.synchronize()
    cuda.reset_counts()
    t0 = time.perf_counter()
    ins = waves("insert", keys)
    b.flush()
    acked = keys[np.concatenate([w.results for w in ins])]
    look = waves("lookup", np.concatenate([acked, absent[:acked.size]]))
    reps = []
    if adaptive:
        b.flush()
        hit = np.concatenate([w.results for w in look])[acked.size:]
        reps = waves("report", absent[:acked.size][hit])
    dels = waves("delete", acked[: acked.size // 2])
    b.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    every = ins + look + reps + dels
    return {"wall": wall, "waves": len(every),
            "keys": sum(w.n for w in every), "acked": acked.size,
            "hits": np.concatenate([w.results for w in look]),
            "reported": sum(w.n for w in reps),
            "deleted": np.concatenate([w.results for w in dels]),
            "results": [w.results for w in every],
            "probed": sum(w._n_probe for w in look),
            "planes": [p.cpu() for p in b.state[:-2]],
            "stash": b.stash.cpu(), "count": int(b.state.count),
            "launches": launches, "plain": plain, "snapshot": m.snapshot()}


def filter_wave_family(card: str, adaptive: bool, keys, absent,
                       **kw) -> dict:
    """Phase 5d for one state family: telemetry off, on, on, off, off, on
    from the same seed (walls in turns, the median of three an arm), then
    each once more under a CUDA-activity trace; checks the arms equal and
    the counters' sums."""
    import torch
    from repro_torch.kernels import cuda
    from torch.profiler import ProfilerActivity, profile

    label = "adaptive" if adaptive else "static"
    for tm in (False, True):        # warm-up: the first waves' set-up
        filter_wave_run(keys[: 16 * kw["wave"]], absent, adaptive=adaptive,
                        telemetry=tm, **kw)
    arms = {"off": filter_wave_run(keys, absent, adaptive=adaptive,
                                   telemetry=False, **kw),
            "on": filter_wave_run(keys, absent, adaptive=adaptive,
                                  telemetry=True, **kw)}
    off, on = arms["off"], arms["on"]
    walls = {"off": [off["wall"]], "on": [on["wall"]]}
    plain = collections.Counter(off["plain"]) + collections.Counter(
        on["plain"])
    for name in ("on", "off", "off", "on"):
        t = filter_wave_run(keys, absent, adaptive=adaptive,
                            telemetry=name == "on", **kw)
        check(t["count"] == off["count"],
              f"filter-op waves ({label}): a repeated arm left another "
              f"count")
        walls[name].append(t["wall"])
        plain.update(t["plain"])         # Counter.update adds
        del t
    busy = {}
    for name, tm in (("off", False), ("on", True)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = filter_wave_run(keys, absent, adaptive=adaptive,
                                     telemetry=tm, **kw)
        busy[name] = (sum((getattr(ev, "device_time_total", 0.0) or 0.0)
                          for ev in prof.key_averages()) / 1e6,
                      traced["wall"])
        check(traced["count"] == arms[name]["count"],
              f"filter-op waves ({label}): the traced {name} arm left "
              f"another count")

    check(len(off["results"]) == len(on["results"]) and all(
        np.array_equal(a, b) for a, b in zip(off["results"], on["results"])),
        f"filter-op waves ({label}): a wave's results differ with "
        f"telemetry on")
    check(all(torch.equal(a, b) for a, b in zip(off["planes"], on["planes"]))
          and torch.equal(off["stash"], on["stash"])
          and off["count"] == on["count"],
          f"filter-op waves ({label}): the state differs with telemetry on")
    fn = int((~on["hits"][: on["acked"]]).sum())
    check(fn == 0, f"filter-op waves ({label}): {fn} false negatives")
    tm_off = {k: v for k, v in off["launches"].items()
              if k in cuda.TM_KERNELS}
    check(not tm_off, f"the telemetry-off arm ({label}) launched {tm_off}")
    snap = on["snapshot"]
    kicks = sum(snap["filter_kick_depth"]["counts"])
    depth = sum(v for k, v in snap.items()
                if k.startswith("filter_probe_depth"))
    deletes = snap.get("filter_table_deletes", 0) + snap.get(
        "filter_stash_deletes", 0)
    n_del = int(on["deleted"].sum())
    check(kicks == keys.size, f"{label}: kick_hist sums to {kicks}, not the "
                              f"{keys.size} insert lanes offered")
    check(depth == on["probed"], f"{label}: probe_depth sums to {depth}, "
                                 f"not the {on['probed']} lanes probed")
    check(deletes == n_del, f"{label}: table + stash deletes {deletes} != "
                            f"{n_del} acknowledged deletes")
    if adaptive:
        check(snap.get("filter_selector_bumps", 0) > 0,
              "adaptive: the report waves bumped no selector")
    n_slots = kw["n_buckets"] * 4
    print(f"   {label}: {keys.size} insert lanes, {on['acked']} acknowledged "
          f"(load {on['acked'] / n_slots!r}), false positives "
          f"{int(on['hits'][on['acked']:].sum())} of {on['acked']} absent "
          f"({on['reported']} reported), {n_del} of {on['acked'] // 2} "
          f"deletes acknowledged, no false negatives", flush=True)
    print(f"   {label} counters: kick depth "
          f"{snap['filter_kick_depth']['counts']}, "
          + ", ".join(f"{k} {v}" for k, v in sorted(snap.items())
                      if k.startswith(("filter_probe_depth", "filter_stash",
                                       "filter_rollback", "filter_table",
                                       "filter_selector"))), flush=True)
    print(f"   {label} launches: off {off['launches']}, on {on['launches']}",
          flush=True)
    wall = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    for name, arm in arms.items():
        dev_s, t_wall = busy[name]
        print(f"   [{card}] {label}, telemetry {name}: "
              f"{' / '.join(repr(w) for w in walls[name])} s wall, "
              f"{arm['waves'] / wall[name]!r} waves/s, "
              f"{arm['keys'] / wall[name]!r} keys/s (the median); traced "
              f"run: "
              f"device busy {dev_s!r} s of {t_wall!r} s (idle share "
              f"{1 - dev_s / t_wall!r})", flush=True)
    overhead = (wall["on"] - wall["off"]) / wall["off"] * 100
    dev_over = ((busy["on"][0] - busy["off"][0]) / busy["off"][0] * 100
                if busy["off"][0] > 0 else None)
    print(f"   [{card}] {label} telemetry overhead: {overhead!r} % of the "
          f"wall, {dev_over!r} % of the device's busy time", flush=True)
    return {"launches": on["launches"],
            "plain": dict(plain),
            "overhead_pct": overhead, "busy": busy, "wall": walls}


def filter_wave_path(card: str, *, n_buckets=1 << 20, wave=4096,
                     stash_slots=128, load=0.85) -> dict:
    """The filter's serving front at full size: one node's membership
    filter (2^20 buckets of 4, the 16 MB table of phase 4's 2^22 slots,
    fp_bits 16, a 128-slot stash, the eviction budget of load 0.85) behind
    ``FilterOpBatcher`` (4096-key waves, double-buffered): seeded insert
    waves up to load 0.85, lookups of every acknowledged key and as many
    absent ones, deletes of half the acknowledged keys; the same over the
    four adaptive planes with report waves of the false positives
    (``filter_wave_family``)."""
    rng = np.random.RandomState(SEED + 19)
    keys = random_keys(rng, int(load * n_buckets * 4))
    absent = random_keys(rng, keys.size)
    kw = dict(n_buckets=n_buckets, wave=wave, stash_slots=stash_slots,
              load=load)
    out = {"launches": {}, "plain": {}, "families": {}}
    for adaptive in (False, True):
        fam = filter_wave_family(card, adaptive, keys, absent, **kw)
        out["launches"].update(fam["launches"])
        for k, v in fam["plain"].items():
            out["plain"][k] = out["plain"].get(k, 0) + v
        out["families"]["adaptive" if adaptive else "static"] = fam
    return out


# ------------------------------------- phase 5e: SLO scenarios at node size --

# Each scenario at one node's filter: the reference's stack and wave size
# (repro/serving/slo.py:272-283, 512-key waves) with n_buckets and
# wave_slots scaled by one factor; stash sizes, fp_bits, TTL and the
# admission band stay the reference's.  name: (make_batcher kwargs, wave).
SLO_NODE = {
    "uniform": (dict(n_buckets=1 << 20), 1 << 17),
    "zipfian": (dict(n_buckets=1 << 20), 1 << 17),
    "burst_train": (dict(n_buckets=1 << 20, stash_slots=64), 1 << 18),
    "delete_heavy": (dict(n_buckets=1 << 20), 1 << 18),
    "adversarial": (dict(n_buckets=1 << 20), 1 << 18),
}
# ttl_churn: the reference's ring (4 generations of 4096 slots, ttl 3.0) at
# phase 5b's 2^22 slots a generation.
SLO_RING = dict(generations=4, capacity=1 << 22, fp_bits=16, ttl=3.0)
SLO_RING_WAVE = 1 << 19
# The admission arm: the reference's 1024 buckets and 32-slot stash with
# the band 0.18 / 0.12, double-buffered.
SLO_ADMISSION = (dict(n_buckets=1 << 20, stash_slots=32), 1 << 19)
SLO_BAND = (0.18, 0.12)
SLO_KERNELS = ("probe", "insert_bulk", "delete_bulk", "probe_adaptive",
               "insert_bulk_adaptive", "fingerprint_hash_family",
               "probe_multi", "fingerprint_hash", "probe_tm",
               "insert_bulk_tm", "probe_adaptive_tm",
               "insert_bulk_adaptive_tm")


def device_busy_s(prof) -> float:
    """Device time summed over a CUDA-activity profile, in seconds."""
    return sum((getattr(ev, "device_time_total", 0.0) or 0.0)
               for ev in prof.key_averages()) / 1e6


def replay(h, run, trace: bool):
    """``run()`` -> its report; with ``trace``, under a CUDA-activity
    profile whose device busy time lands in ``h.busy_s``."""
    if not trace:
        return run()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rep = run()
    h.busy_s = device_busy_s(prof)
    return rep


def slo_arm(name: str, *, stack: dict, wave: int, label=None,
            double_buffer="auto", admission=None, trace: bool = False):
    """One batcher arm of phase 5e: a fresh stack from ``make_batcher``,
    warmed on a throwaway stack of the same shape, then the scenario's
    default stream through ``SloHarness().run`` (with ``trace``, under a
    profile) -> (report, recording)."""
    import torch
    from repro_torch.serving.slo import _warm_batcher, make_batcher
    from repro_torch.serving.workloads import scenario_stream
    t0 = time.perf_counter()
    stream = scenario_stream(name, SEED, wave_slots=wave)
    t1 = time.perf_counter()
    b = make_batcher(name, wave_slots=wave, double_buffer=double_buffer,
                     admission=admission, **stack)
    kinds = {x.kind for x in stream}
    if any(x.feedback for x in stream):
        kinds.add("report")
    _warm_batcher(b, kinds)
    h = slo_recorder()
    gc.collect()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rep = replay(h, lambda: h.run(b, stream, scenario=label or name), trace)
    print(f"   {label or name}: stream built in {t1 - t0!r} s, stack and "
          f"warm-up {t2 - t1!r} s, replay {time.perf_counter() - t2!r} s",
          flush=True)
    return rep, h


def filter_signatures(keys: np.ndarray, fp_bits: int, n_buckets: int):
    """uint64 per key: its fingerprint and unordered bucket pair, the slots
    a delete of it could clear (``core.hashing``'s numpy twins)."""
    from repro_torch.core.hashing import (alt_index_np, fingerprint_np,
                                          index_hash_np, key_to_u32_pair_np)
    hi, lo = key_to_u32_pair_np(keys)
    fp = fingerprint_np(hi, lo, fp_bits).astype(np.uint64)
    i1 = index_hash_np(hi, lo, n_buckets).astype(np.uint64)
    i2 = alt_index_np(i1.astype(np.uint32), fp.astype(np.uint32),
                      n_buckets).astype(np.uint64)
    return ((fp << np.uint64(42)) | (np.minimum(i1, i2) << np.uint64(21))
            | np.maximum(i1, i2))


class KeyIds:
    """Ids of the keys a run inserted (sorted, distinct); -1 for others."""

    def __init__(self, inserted: list):
        self.keys = (np.unique(np.concatenate(inserted)) if inserted
                     else np.zeros(0, np.uint64))

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        out = np.full(keys.size, -1, np.int64)
        if not self.keys.size:
            return out
        # sorted queries walk the sorted keys in order (5x faster than
        # random ones at millions of keys)
        order = np.argsort(keys)
        sk = keys[order]
        pos = np.searchsorted(self.keys, sk)
        pos[pos == self.keys.size] = 0
        out[order] = np.where(self.keys[pos] == sk, pos, -1)
        return out


def batcher_false_negatives(h, *, fp_bits: int) -> dict:
    """Check (b) of phase 5e for a batcher arm, from the waves' own results
    in launch order: a key an insert wave acknowledged, and no acknowledged
    delete has removed since, must answer True in every lookup wave, and
    again in lookups of every such key after the run.  An acknowledged
    delete of a key that is not held (a shed insert's key, under
    admission) may clear a held key's entry with the same fingerprint and
    buckets; such keys are exempt, and counted."""
    t0 = time.perf_counter()
    b = h.target
    n_buckets = int(b.state.n_buckets)
    ids = KeyIds([k for w, k in h.launched if w.kind == "insert"])
    held = np.zeros(ids.keys.size, bool)
    exempt = np.zeros(ids.keys.size, bool)
    sigs = None
    fn = checked = stray = 0
    for wave, keys in h.launched:
        res = wave.results
        if wave.kind == "insert":
            held[ids(keys[res])] = True
        elif wave.kind == "delete":
            gone = ids(keys[res])
            wild = keys[res][(gone < 0) | ~held[np.maximum(gone, 0)]]
            if wild.size:
                stray += wild.size
                if sigs is None:
                    sigs = filter_signatures(ids.keys, fp_bits, n_buckets)
                exempt |= np.isin(sigs, filter_signatures(wild, fp_bits,
                                                          n_buckets))
            held[gone[gone >= 0]] = False
        elif wave.kind == "lookup":
            i = ids(keys)
            need = (i >= 0) & held[np.maximum(i, 0)] & ~exempt[np.maximum(
                i, 0)]
            checked += int(need.sum())
            fn += int((need & ~res).sum())
    # The final lookups go through a second batcher over the same state
    # (lookups change nothing), so the recorded one keeps its parked waves.
    members = ids.keys[held & ~exempt]
    probe = type(b)(b.ops, b.state, stash=b.stash, wave_slots=b.wave_slots)
    after = [probe.submit("lookup", members[i:i + b.wave_slots])
             for i in range(0, members.size, b.wave_slots)]
    probe.flush()
    fn_after = int(sum((~w.results).sum() for w in after))
    return {"fn": fn, "checked": checked, "fn_after": fn_after,
            "held": int(members.size), "stray_deletes": stray,
            "exempt": int((held & exempt).sum()),
            "check_s": time.perf_counter() - t0}


def ring_false_negatives(h) -> dict:
    """Check (b) for the ring: a key an insert acknowledged must answer
    True at a lookup while the generation it went into is in the ring and
    live at the lookup's clock (an insert call that rotated is not
    counted: its keys may have gone into either generation)."""
    t0 = time.perf_counter()
    ins = [w for w in h.waves if w[0] == "insert"]
    ids = KeyIds([w[1] for w in ins])
    owner = np.full(ids.keys.size, -1, np.int64)
    gens: list = []
    fn = checked = skipped = 0
    for kind, keys, out, extra, _now in h.waves:
        if kind == "insert":
            if extra is None:
                skipped += int(out.sum())
                continue
            owner[ids(keys[out])] = len(gens)
            gens.append(extra)
        else:
            alive = np.array([any(g is x for x in extra) for g in gens]
                             + [False])
            o = owner[ids(keys)]
            need = alive[o] & (o >= 0)
            checked += int(need.sum())
            fn += int((need & ~out).sum())
    return {"fn": fn, "checked": checked, "skipped_inserts": skipped,
            "check_s": time.perf_counter() - t0}


def slo_rows(rows: dict, rep, name: str) -> None:
    rows.update(rep.rows(f"slo_{name}"))
    rows[f"slo_{name}_waves"] = rep.waves
    rows[f"slo_{name}_wall_s"] = rep.wall_s


def slo_node_path(card: str) -> dict:
    """Phase 5e: every scenario at node size (``SLO_NODE``, ``SLO_RING``,
    ``SLO_ADMISSION``), each with its own mix, hit blend, burst pattern
    and load trajectory, composed from ``make_batcher``, ``SloHarness``
    and ``GenerationalFilter``; the burst train through the sync arm and
    the default path (the async arm on a card); the scenario harness's
    telemetry mode at the reference's size, card against CPU; ``uniform``
    once more under a CUDA trace for the device's idle share.  Checks:
    (a) the sync and async arms equal bit for bit; (b) no false negatives;
    (c) adversarial's false positives shrink from the first round to the
    last; (d) ttl_churn's ring turns over and expires; (e) the admission
    arm defers and its signal reaches high water; (f) every kernel of
    ``SLO_KERNELS`` launched; (g) no plain version ran."""
    import tempfile

    import torch
    from repro_torch.kernels import cuda
    from repro_torch.serving.slo import (_warm_generational,
                                         run_scenario_telemetry)
    from repro_torch.serving.workloads import scenario_stream
    from repro_torch.streaming import GenerationalFilter, GenerationConfig
    from repro_torch.streaming.admission import AdmissionConfig

    torch.cuda.synchronize()
    cuda.reset_counts()
    rows: dict = {"slo_seed": SEED}

    def counted(label, fn):
        before = collections.Counter(cuda.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        delta = dict(collections.Counter(cuda.LAUNCHES) - before)
        print(f"   [{card}] {label}: {took!r} s with warm-up and checks "
              f"(checks {out[-1].get('check_s')!r} s), launches {delta}",
              flush=True)
        return out

    def report(label, rep, fn_stats):
        p = rep.percentiles_us
        print(f"   [{card}] {label}: {rep.waves} waves, {rep.ops} ops in "
              f"{rep.wall_s!r} s ({rep.keys_per_s!r} keys/s, "
              f"{rep.waves / rep.wall_s!r} waves/s); p50 {p['p50']!r} us, "
              f"p99 {p['p99']!r} us, p99.9 {p['p999']!r} us; per kind "
              f"{rep.per_kind}; extras {rep.extras}; shed {rep.shed_ops}, "
              f"deferred waves {rep.deferred_waves}, held ticks "
              f"{rep.held_ticks}; false negatives {fn_stats}", flush=True)
        check(fn_stats["fn"] == 0 and fn_stats.get("fn_after", 0) == 0,
              f"{label}: false negatives {fn_stats}")

    for name in ("uniform", "zipfian", "delete_heavy", "adversarial"):
        stack, wave = SLO_NODE[name]

        def arm(name=name, stack=stack, wave=wave):
            rep, h = slo_arm(name, stack=stack, wave=wave)
            fps = 8 if name == "adversarial" else 16
            return rep, h, batcher_false_negatives(h, fp_bits=fps)
        rep, h, fn_stats = counted(name, arm)
        report(name, rep, fn_stats)
        slo_rows(rows, rep, name)
        if name == "adversarial":
            looks = [w for k, _keys, w in h.waves if k == "lookup"]
            pool = len(looks) // 4
            rounds = [int(sum(w.results.sum() for w in looks[i:i + pool]))
                      for i in range(0, len(looks), pool)]
            print(f"   adversarial false positives by round: {rounds} of "
                  f"{sum(w.n for w in looks[:pool])} pool keys", flush=True)
            check(rounds[-1] < rounds[0],
                  f"adversarial: false positives did not shrink: {rounds}")
        del h

    # (a) the burst train through the sync arm and the default path, which
    # on a card is the async (double-buffered) arm: one run serves both
    arms = {}
    for label, flag in (("sync", False), ("async", "auto")):
        stack, wave = SLO_NODE["burst_train"]

        def arm(flag=flag, stack=stack, wave=wave, label=label):
            rep, h = slo_arm("burst_train", stack=stack, wave=wave,
                             double_buffer=flag)
            # the async arm's answers are held equal to the sync arm's
            # below, so one false-negative check serves both
            return rep, h, (batcher_false_negatives(h, fp_bits=16)
                            if label == "sync"
                            else {"fn": 0, "as": "the sync arm"})
        rep, h, fn_stats = counted(f"burst_train {label}", arm)
        report(f"burst_train {label}", rep, fn_stats)
        for pname, v in rep.percentiles_us.items():
            rows[f"slo_burst_train_{label}_{pname}_us"] = round(v, 1)
        rows[f"slo_burst_train_{label}_wall_s"] = rep.wall_s
        arms[label] = h
        if label == "async":
            check(h.target.double_buffer, "the default submit path on the "
                                          "card is not double-buffered")
            rows["slo_submit_double_buffered"] = 1
            slo_rows(rows, rep, "burst_train")
    check(slo_same_waves(arms["sync"], arms["async"])
          and slo_same_stack(arms["sync"].target, arms["async"].target),
          "burst_train: the sync and async arms differ")
    print("   burst_train: sync and async arms equal bit for bit (every "
          "wave, the final table, stash and count)", flush=True)
    del arms

    # ttl_churn on phase 5b's ring at ttl 3.0
    def ring_arm(trace=False):
        cfg = GenerationConfig(**SLO_RING)
        stream = scenario_stream("ttl_churn", SEED, wave_slots=SLO_RING_WAVE)
        _warm_generational(cfg)
        h = slo_recorder()
        gc.collect()
        torch.cuda.synchronize()
        rep = replay(h, lambda: h.run_generational(
            GenerationalFilter(config=cfg, now=0.0), stream,
            scenario="ttl_churn"), trace)
        return rep, h

    def checked_ring_arm():
        rep, h = ring_arm()
        return rep, h, ring_false_negatives(h)
    rep, h, fn_stats = counted("ttl_churn", checked_ring_arm)
    report("ttl_churn", rep, fn_stats)
    slo_rows(rows, rep, "ttl_churn")
    born = sorted({w[3].born for w in h.waves
                   if w[0] == "insert" and w[3] is not None})
    print(f"   ttl_churn: generations born at {born}, stats "
          f"{h.target.stats}", flush=True)
    check(rep.extras["expirations"] >= 1 and len(born) >= 2,
          f"ttl_churn: the ring did not turn over and expire ({born}, "
          f"{rep.extras})")
    del h

    # (e) the admission arm
    hi_w, lo_w = SLO_BAND

    def admission_arm():
        stack, wave = SLO_ADMISSION
        rep, h = slo_arm(
            "burst_train", stack=stack, wave=wave, label="burst_admission",
            double_buffer=True,
            admission=AdmissionConfig(high_water=hi_w, low_water=lo_w))
        return rep, h, batcher_false_negatives(h, fp_bits=16)
    rep, h, fn_stats = counted("burst_admission", admission_arm)
    report("burst_admission", rep, fn_stats)
    admitted = rep.recorder.percentiles(exclude_deferred=True)
    readmitted = sum(1 for x in rep.recorder.samples if x.deferred)
    rows["slo_burst_admission_p99_us"] = round(admitted["p99"], 1)
    rows["slo_burst_admission_shed_ops"] = rep.shed_ops
    rows["slo_burst_admission_deferred_waves"] = rep.deferred_waves
    rows["slo_burst_admission_peak_signal"] = rep.extras.get(
        "peak_signal", 0.0)
    rows["slo_burst_admission_readmitted_waves"] = readmitted
    rows["slo_burst_admission_waves"] = rep.waves
    rows["slo_burst_admission_wall_s"] = rep.wall_s
    print(f"   burst_admission: admitted-op p99 {admitted['p99']!r} us, "
          f"{rep.deferred_waves} waves deferred, {readmitted} re-admitted "
          f"(not fatal), {rep.shed_ops} ops shed, peak signal "
          f"{h.target.admission.peak_signal!r}", flush=True)
    check(rep.deferred_waves >= 1
          and h.target.admission.peak_signal >= hi_w,
          "burst_admission: the gate never deferred a wave or its signal "
          "never reached high water")
    del h

    # the harness's telemetry mode at the reference's sizes; its CPU runs
    # come after the launch counts are read
    def telemetry(device: str, tmp: str) -> dict:
        out = {}
        for name in ("uniform", "adversarial"):
            _rep, paths = run_scenario_telemetry(
                name, f"{tmp}/{device}", device=device, double_buffer=True)
            check(Path(paths["trace"]).stat().st_size > 0,
                  f"telemetry {name}: no trace written")
            with open(paths["metrics"]) as f:
                out[name] = [{k: v for k, v in json.loads(x).items()
                              if k != "ts"} for x in f]
            out[name] = [x for x in out[name] if x["type"] != "wave"
                         and "latency" not in x["metric"]]
        return out

    with tempfile.TemporaryDirectory() as tmp:
        tm_card = telemetry("cuda", tmp)

    # where the time goes: every arm's replay once more, under a trace
    adm = dict(label="burst_admission", double_buffer=True,
               admission=AdmissionConfig(high_water=hi_w, low_water=lo_w))
    for label, run in (
            *((n, lambda n=n: slo_arm(n, stack=SLO_NODE[n][0],
                                      wave=SLO_NODE[n][1], trace=True))
              for n in ("uniform", "zipfian", "delete_heavy", "adversarial",
                        "burst_train")),
            ("ttl_churn", lambda: ring_arm(trace=True)),
            ("burst_admission", lambda: slo_arm(
                "burst_train", stack=SLO_ADMISSION[0],
                wave=SLO_ADMISSION[1], trace=True, **adm))):
        traced, h = run()
        idle = 1 - h.busy_s / traced.wall_s
        rows[f"slo_{label}_traced_idle_share"] = idle
        print(f"   [{card}] {label} traced: device busy {h.busy_s!r} s of "
              f"{traced.wall_s!r} s (idle share {idle!r})", flush=True)
        del h

    torch.cuda.synchronize()
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    print(f"   launches={launches} plain_calls={plain}", flush=True)
    missing = [k for k in SLO_KERNELS if not launches.get(k)]
    check(not missing, f"phase 5e never launched {missing}")
    with tempfile.TemporaryDirectory() as tmp:
        tm_cpu = telemetry("cpu", tmp)
    for name, series in tm_card.items():
        check(series == tm_cpu[name],
              f"telemetry {name}: the counters differ, card vs CPU")
        print(f"   telemetry mode {name}: {len(series)} metric series, "
              f"same as the CPU", flush=True)
    return {"rows": rows, "launches": launches, "plain": plain}


# --------------------------------------------- phase 5b: the streaming path --


def streaming_path(card: str, *, ticks=32, base=600_000, burst=4,
                   burst_ticks=(8, 9, 10, 11), window=4):
    """The dedup stage of one node (examples/streaming_dedup.py at scale):
    per tick of a logical clock, ``new = ~lookup(events)`` then
    ``insert(events[new])``; 60% of a tick's events are fresh 64-bit ids,
    40% repeat ids drawn from the fresh ids of the previous ``window``
    ticks (tick 0 repeats its own).  Then the TTL step."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.streaming import GenerationalFilter, GenerationConfig
    from torch.profiler import ProfilerActivity, profile

    cfg = GenerationConfig(**RING)
    rng = np.random.RandomState(SEED + 6)
    gf = GenerationalFilter(cfg, now=0.0)

    ring_pool = gf.pool

    def pool_ptrs():
        return ring_pool.tables.data_ptr(), ring_pool.stashes.data_ptr()

    def in_pool():
        return all(g.state.table.data_ptr()
                   == ring_pool.tables[g.slot].data_ptr()
                   and g.stash.array.data_ptr()
                   == ring_pool.stashes[g.slot].data_ptr() for g in gf.gens)

    ptrs = pool_ptrs()
    every_in_pool = True
    times = {"lookup": 0.0, "insert": 0.0}
    n_probe = n_ins = n_fresh = fresh_flagged = 0
    fn = missed_unheld = repeats_checked = 0
    all_ok = True
    fresh_hist, held_hist, inserted = [], [], []

    def timed(name, fn_):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn_()
        torch.cuda.synchronize()
        times[name] += time.perf_counter() - t0
        return out

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_counts()
        for t in range(ticks):
            n = base * (burst if t in burst_ticks else 1)
            fresh = random_keys(rng, int(n * 0.6))
            if t == 0:
                pool, pool_held = fresh, None
            else:
                pool = np.concatenate(fresh_hist[-window:])
                pool_held = np.concatenate(held_hist[-window:])
            pick = rng.randint(0, pool.size, n - fresh.size)
            events = np.concatenate([fresh, pool[pick]])
            new = ~timed("lookup", lambda: gf.lookup(events, now=float(t)))
            ok = timed("insert", lambda: gf.insert(events[new],
                                                   now=float(t)))
            all_ok &= bool(ok.all())
            n_probe += events.size
            n_ins += int(new.sum())
            inserted.append(events[new][ok])
            fresh_new = new[: fresh.size]
            held = np.zeros(fresh.size, bool)  # in the filter from now on
            held[fresh_new] = ok[: int(fresh_new.sum())]
            n_fresh += fresh.size
            fresh_flagged += int((~fresh_new).sum())
            if t >= 1:
                found = ~new[fresh.size:]
                was_held = pool_held[pick]
                repeats_checked += int(was_held.sum())
                fn += int((was_held & ~found).sum())
                missed_unheld += int((~was_held & ~found).sum())
            fresh_hist.append(fresh)
            held_hist.append(held)
            every_in_pool &= in_pool()
        torch.cuda.synchronize()
        transient = torch.cuda.max_memory_allocated() - base_bytes
        live = gf._live(float(ticks - 1))
        # A copy for phase 6 (the TTL step below zeroes the pool).
        snap = (ring_pool.tables.clone(), ring_pool.stashes.clone(),
                [g.slot for g in live], cfg.n_buckets)
        stats_end = dataclasses.replace(gf.stats)
        # The TTL step: every generation has expired by now.
        now_end = float(ticks - 1) + RING["ttl"] + 1.0
        every = np.concatenate(inserted)
        stale_hits = int(gf.lookup(every, now=now_end).sum())
        n_gens, exp0 = len(gf.gens), gf.stats.expirations
        retired = gf.advance(now=now_end)
        expired = gf.stats.expirations - exp0
        torch.cuda.synchronize()
        launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)

    device_s = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0) or 0.0
        if us > 0:
            device_s[ev.key] = device_s.get(ev.key, 0.0) + us / 1e6
    fp_share = fresh_flagged / n_fresh
    fp_bound = (4 * RING["generations"] * 2 * RING["bucket_size"]
                * RING["o_max"] / 2 ** RING["fp_bits"])
    wall = sum(times.values())
    busy = sum(device_s.values())
    print(f"   stats at the end of the stream={stats_end} live generations="
          f"{len(live)}", flush=True)
    print(f"   [{card}] dedup probe {n_probe / times['lookup']!r} keys/s "
          f"({n_probe} keys, {times['lookup']!r} s), insert "
          f"{n_ins / times['insert']!r} keys/s ({n_ins} keys, "
          f"{times['insert']!r} s)", flush=True)
    print(f"   fresh ids flagged as duplicates: {fresh_flagged} of {n_fresh}"
          f" (share {fp_share!r}, bound {fp_bound!r}); repeats of held ids "
          f"{repeats_checked}, missed {fn}; repeats of ids never held "
          f"(flagged when fresh) missed: {missed_unheld}", flush=True)
    print(f"   TTL step at now={now_end}: hits of {every.size} inserted ids "
          f"{stale_hits}; advance retired {retired} of {n_gens}, "
          f"expirations +{expired}", flush=True)
    print(f"   launches={launches} plain_calls={plain}", flush=True)
    print(f"   device memory over the ring's pool during the ticks: peak "
          f"{transient} B (the pool's tables: "
          f"{ring_pool.tables.numel() * 4} B)",
          flush=True)
    print(f"   [{card}] device busy {busy!r} s of {wall!r} s of phases "
          f"(idle share {1 - busy / wall!r})", flush=True)
    for kernel, name in (("probe_multi_kernel", "lookup"),
                         ("insert_kernel", "insert"),
                         ("fingerprint_kernel", "insert")):
        k_s = sum(v for key, v in device_s.items() if kernel in key)
        print(f"   {kernel}: {k_s!r} s on the device, {k_s / times[name]!r} "
              f"of the {name} phase ({times[name]!r} s)", flush=True)

    check(fn == 0, f"{fn} repeats of held ids were not found")
    check(fp_share <= fp_bound, f"fresh-flagged share {fp_share} > "
                                f"{fp_bound}")
    check(stats_end.rotations >= 4, f"only {stats_end.rotations} rotations")
    check(pool_ptrs() == ptrs and every_in_pool,
          "a generation's table or stash left the ring's pool")
    # A copy of the live tables (what a stacked fan-out input would cost)
    # would not fit under this: the ticks' keys and answers do.
    check(transient < ring_pool.tables.numel() * 4,
          f"{transient} B of device memory over the pool during the ticks")
    check(all_ok, "an insert was not acknowledged")
    check(stale_hits == 0, f"{stale_hits} hits after every TTL expired")
    check(retired == n_gens and expired == n_gens,
          f"advance retired {retired} and expired {expired} of {n_gens}")
    return snap, inserted[-1], launches, plain, {
        "times": times, "device_s": device_s, "fp_share": fp_share}


def lm_profile(model, toks, card: str, *, prompt: int = 1024,
               steps: int = 3) -> dict:
    """Where the LM path's time goes, from CUDA-activity ``torch.profiler``
    traces: one cache-less forward over ``toks`` (device time of the flash
    kernel, of the matrix products and of everything else; the idle share
    of the host clock), then ``steps`` greedy decode steps after a
    ``prompt``-token prefill in a float32 cache (device kernels launched
    and device busy time per step, against the host clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def trace(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
        kernels = 0
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0.0) or 0.0
            if us <= 0 or ev.key.startswith("aten::"):
                continue
            kernels += ev.count
            key = ev.key.lower()
            kind = ("flash" if "flash_" in key else "matmul"
                    if any(w in key for w in ("gemm", "nvjet", "cutlass",
                                              "xmma")) else "other")
            by[kind] += us / 1e3
        return wall * 1e3, by, kernels

    wall, by, _n = trace(lambda: model.apply(toks))
    busy = sum(by.values())
    print(f"   (a) profile of one forward [{card}]: {wall!r} ms host clock, "
          f"device busy {busy!r} ms (flash {by['flash']!r}, matrix products"
          f" {by['matmul']!r}, other {by['other']!r}), idle share "
          f"{1 - busy / wall!r}", flush=True)
    cache = model.init_cache(1, prompt + steps + 1, dtype=torch.float32)
    model.apply(toks[:, :prompt], cache=cache, cache_pos=0)
    tok = toks[:, prompt:prompt + 1]

    def decode():
        for pos in range(prompt, prompt + steps):
            int(model.decode_step(cache, tok, pos).logits[0, 0].argmax())
    dwall, dby, dn = trace(decode)
    dbusy = sum(dby.values())
    print(f"   (a) profile of {steps} decode steps [{card}]: "
          f"{dwall / steps!r} ms a step host clock, {dn / steps!r} device "
          f"kernels a step, device busy {dbusy / steps!r} ms a step "
          f"(matrix products {dby['matmul'] / steps!r}), idle share "
          f"{1 - dbusy / dwall!r}", flush=True)
    return {"forward_ms": wall, "forward_device_ms": by,
            "decode_ms": dwall / steps, "decode_kernels": dn / steps,
            "decode_device_ms": dbusy / steps}


# -------------------------------------------- phase 5c: the LM serving path --


def lm_path(card: str, *, seq: int = LM_SEQ, check_seq: int = 1024,
            requests: int = 16, prefix_len: int = 1008, block: int = 16,
            gen: int = 16):
    """The LM path of gemma3-1b at full size (26 layers, full width, float32
    weights from SEED): (a) a cache-less forward over ``seq`` tokens in
    bfloat16 (prompt scoring: 22 local and 4 global flash launches); (b)
    the serving consistency check of tests/test_models.py in float32: the
    last position's log-softmax from the flash forward against the cached
    prefill + one decode step (blockwise attention) of the same
    ``check_seq``-token prompt, within 1e-3; (c) ``serve()`` of the port,
    ``requests`` prompts of ``prefix_len + block`` tokens, ``gen`` tokens
    each, through the OCF prefix-cache index."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import serve
    from repro_torch.models import Transformer

    cfg = get_config(LM_ARCH)
    rng = np.random.RandomState(SEED + 11)
    torch.cuda.synchronize()
    cuda.reset_counts()
    out = {}

    # (a) prompt scoring
    model = Transformer(cfg, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq))).cuda()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.apply(toks).logits
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    flash_per_forward = cuda.LAUNCHES["flash_attention"] // len(times)
    out["forward_s"] = min(times)
    print(f"   (a) {cfg.name}: {n_params} parameters, forward over {seq} "
          f"tokens {times!r} s -> {seq / min(times)!r} tokens/s [{card}]; "
          f"logits {shape} finite={finite}; flash launches per forward "
          f"{flash_per_forward}", flush=True)
    check(finite and shape == (1, seq, cfg.vocab_size),
          "the prompt-scoring logits are not finite or of the wrong shape")
    check(flash_per_forward == cfg.n_layers,
          f"{flash_per_forward} flash launches per forward, not "
          f"{cfg.n_layers}")
    out["forward_profile"] = lm_profile(model, toks, card)
    torch.cuda.synchronize()
    bf16_launches = cuda.LAUNCHES["flash_attention"]
    del model
    torch.cuda.empty_cache()

    # (b) the flash forward against the cached serving path, float32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = Transformer(cfg32, seed=SEED, device="cuda")
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                        (1, check_seq))).cuda()
    full = model.apply(toks).logits[:, -1]
    cache = model.init_cache(1, check_seq + 4, dtype=torch.float32)
    model.apply(toks[:, :-1], cache=cache, cache_pos=0)
    dec = model.decode_step(cache, toks[:, -1:], check_seq - 1).logits[:, 0]
    err = float((torch.log_softmax(full, -1)
                 - torch.log_softmax(dec, -1)).abs().max())
    out["serving_err"] = err
    f32_launches = cuda.LAUNCHES["flash_attention"] - bf16_launches
    print(f"   (b) flash forward vs cached prefill + decode, float32, "
          f"S={check_seq}: log-softmax max err {err!r}", flush=True)
    print(f"   flash launches: {bf16_launches} bfloat16 (flash_wgmma_kernel,"
          f" a), {f32_launches} float32 (flash_f32_kernel, b)", flush=True)
    check(err < 1e-3, f"the flash forward and the cached serving path "
                      f"differ by {err}")
    del model, cache
    torch.cuda.empty_cache()

    # (c) the server
    res = serve(LM_ARCH, requests=requests, prefix_len=prefix_len, gen=gen,
                smoke=False, seed=SEED, block=block, device="cuda")
    out["serve"] = res
    print(f"   (c) serve {requests} requests x ({prefix_len} + {block} "
          f"prompt, {gen} generated): latency mean "
          f"{res['latency_mean_s']!r} s p99 {res['latency_p99_s']!r} s, "
          f"prefill {res['prefill_tokens_per_s']!r} tokens/s, decode "
          f"{res['decode_tokens_per_s']!r} tokens/s, prefix hit rate "
          f"{res['prefix_hit_rate']!r}, reused blocks "
          f"{res['reused_blocks']}, index {res['index_stats']} [{card}]",
          flush=True)
    check(res["reused_blocks"] > 0, "serve reused no prefix block")
    torch.cuda.synchronize()
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    print(f"   launches={launches} plain_calls={plain}", flush=True)
    return launches, plain, out


def lm_batcher_path(card: str, *, requests: int = 8, prefix_len: int = 1008,
                    block: int = 16, gen: int = 8, slots: int = 4,
                    cache_len: int = 1040):
    """Phase 5c (d): ``ContinuousBatcher`` over gemma3-1b at full size (26
    layers, full width, float32 weights from SEED, as (a) builds it): a
    burst of ``requests`` prompts of ``prefix_len + block`` tokens (half
    share the system prompt, as ``serve()`` builds them) into ``slots``
    slots, ``gen`` tokens each, a float32 cache of ``cache_len`` a slot and
    the OCF prefix index.  Each request's tokens must equal
    ``engine.generate`` of its prompt on the card; ``SchedStats`` must
    equal those of the same stream through the batcher on the CPU over a
    2-layer smoke model of the same vocabulary (the counts do not depend on
    the depth); the queue must exceed the slots after the burst."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import request_prompts
    from repro_torch.models import Transformer
    from repro_torch.serving import ContinuousBatcher, Request
    from repro_torch.serving.engine import generate

    cfg = get_config(LM_ARCH)
    prompts = request_prompts(np.random.RandomState(SEED), cfg.vocab_size,
                              requests=requests, prefix_len=prefix_len,
                              block=block)

    def burst(model):
        b = ContinuousBatcher(model, slots=slots, cache_len=cache_len,
                              block=block)
        reqs = [Request(rid=i, prompt=p, max_new=gen)
                for i, p in enumerate(prompts)]
        return b, reqs

    model = Transformer(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    cuda.reset_counts()
    b, reqs = burst(model)
    t0 = time.perf_counter()
    for r in reqs:
        b.submit(r)
    congestion = b.congestion
    done, decode_ticks = {}, []
    while b.queue or b.active:
        prefills = b.stats.prefills
        t1 = time.perf_counter()
        live = b.step()
        t2 = time.perf_counter()
        if b.stats.prefills == prefills:
            decode_ticks.append((t2 - t1, live))
        for r in reqs:
            if r.rid not in done and len(r.out) >= gen:
                done[r.rid] = t2 - t0
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    lat = np.array([done[r.rid] for r in reqs])
    dec_s = sum(t for t, _ in decode_ticks)
    dec_toks = sum(n for _, n in decode_ticks)
    stats = dataclasses.asdict(b.stats)
    print(f"   (d) ContinuousBatcher [{card}]: {requests} requests x "
          f"({prefix_len} + {block} prompt, {gen} generated) into {slots} "
          f"slots: {wall!r} s, {requests / wall!r} requests/s, latency "
          f"mean {float(lat.mean())!r} s p99 "
          f"{float(np.percentile(lat, 99))!r} s (from the burst's "
          f"arrival), decode {dec_toks / dec_s!r} tokens/s ({dec_toks} "
          f"tokens in {len(decode_ticks)} ticks without a prefill), "
          f"congestion after the burst {congestion!r}", flush=True)
    print(f"   (d) stats {stats}, launches {launches}", flush=True)
    check(congestion > 1.0, f"(d) congestion {congestion} after the burst")
    for r in reqs:
        want = generate(model, torch.from_numpy(r.prompt)[None, :],
                        gen, cache_len=cache_len).tokens[0].cpu().tolist()
        check(r.out == want, f"(d) request {r.rid}: tokens {r.out} differ "
                             f"from generate's {want}")
    del b, model
    torch.cuda.empty_cache()
    small = dataclasses.replace(get_smoke_config(LM_ARCH), n_layers=2,
                                vocab_size=cfg.vocab_size, dtype="float32",
                                max_seq_len=cache_len)
    cb, creqs = burst(Transformer(small, seed=SEED, device="cpu"))
    for r in creqs:
        cb.submit(r)
    cpu_stats = dataclasses.asdict(cb.run_until_drained())
    check(stats == cpu_stats, f"(d) SchedStats differ from the CPU's: "
                              f"{stats} vs {cpu_stats}")
    check(stats["finished"] == requests
          and stats["prefix_blocks_reused"] > 0,
          "(d) the burst did not drain or reused no prefix block")
    print(f"   (d) tokens equal generate's for all {requests} requests; "
          f"SchedStats equal the CPU's (2-layer smoke model)", flush=True)
    return launches, plain, {"wall": wall, "latency_s": lat.tolist(),
                             "decode_tokens_per_s": dec_toks / dec_s}


# --------------------------------------------------------- phase 6: times --


def time_ms(fn, reps: int, setup=None) -> float:
    """Mean time of ``fn`` on the device's timeline in ms over ``reps``
    calls: CUDA events around each call (``setup`` runs outside the timed
    span).  For a wrapper this includes the host time it takes to enqueue
    its launch."""
    import torch
    for _ in range(2):
        if setup:
            setup()
        fn()
    spans = []
    for _ in range(reps):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        spans.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / reps


def kernel_device_ms(fn, reps: int, setup, symbol: str):
    """Mean device time in ms per launch of the kernels named ``symbol``
    that ``fn`` launches, from a ``torch.profiler`` (CUPTI) trace, averaged
    over the launches the trace holds with a device time (a trace now and
    then holds some launches without one, which would halve a mean over
    all); None when no window of up to six holds any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    for _attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if setup:
                    setup()
                fn()
            torch.cuda.synchronize()
        names = (symbol,) if isinstance(symbol, str) else symbol
        spans = [getattr(ev, "device_time_total", 0.0) or 0.0
                 for ev in prof.events()
                 if any(n in ev.name for n in names)]
        spans = [us for us in spans if us > 0]
        if spans:
            return sum(spans) / len(spans) / 1e3
    return None


def least_ms(nbytes: float, ops: float,
             ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    """The least time the card could take for some work: its bytes over
    the memory rate or its operations over the peak rate, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sectors(buckets) -> int:
    """Distinct 32-byte sectors that hold these 16-byte buckets."""
    import torch
    return int(torch.unique(buckets // (SECTOR // 16)).numel())


def table_work(before, after, hi, lo, valid, nb, *, lane_bytes: int,
               second):
    """(bytes, ops) one call on a table needs for this run's data: each
    key and mask once; the home bucket's sector of every valid lane; the
    alternate bucket's sector of the lanes ``second(fp, i1)`` says the
    home bucket cannot answer; and every sector the call changed, written
    once."""
    from repro_torch.core import hashing
    fp = hashing.fingerprint(hi, lo, 16)
    i1 = hashing.index_hash(hi, lo, nb)
    i2 = hashing.alt_index(i1, fp, nb)
    again = second(fp, i1) & valid
    changed = (before != after).any(dim=1).nonzero().flatten()
    reads = sectors(i1[valid]) + sectors(i2[again])
    nbytes = hi.numel() * lane_bytes + SECTOR * (reads + sectors(changed))
    ops = hi.numel() * HASH_OPS + 2 * before.shape[1] * (
        int(valid.sum()) + int(again.sum()))
    return nbytes, ops


def kernel_times(ocf, resident: np.ndarray) -> dict:
    """Kernel, wrapper, plain and bound times at the main path's final
    state, for one 4096-key call each."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.delete import delete_bulk, delete_bulk_plain
    from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                                 fingerprint_hash_plain)
    from repro_torch.kernels.insert import (insert_bulk, insert_bulk_plain,
                                            insert_bulk_tm)
    from repro_torch.kernels.probe import probe, probe_plain, probe_tm
    from repro_torch.kernels.rank import rank_among_earlier
    from repro_torch.kernels.telemetry import insert_plane

    dev = ocf.state.table.device
    nb = ocf.state.n_buckets
    base = ocf.state.table
    rng = np.random.RandomState(SEED + 2)

    def pair(keys):
        hi, lo = hashing.key_to_u32_pair_np(keys)
        return (torch.from_numpy(hi.view(np.int32)).to(dev),
                torch.from_numpy(lo.view(np.int32)).to(dev))

    look_hi, look_lo = pair(np.concatenate([resident[: CHUNK // 2],
                                            random_keys(rng, CHUNK // 2)]))
    new_hi, new_lo = pair(random_keys(rng, CHUNK))
    del_hi, del_lo = pair(resident[CHUNK: 2 * CHUNK])
    valid = torch.ones(CHUNK, dtype=torch.bool, device=dev)
    rounds = ocf.ops.evict_rounds
    iblock = min(kops.autotune_block("insert", table_bytes=base.numel() * 4,
                                     evict_rounds=rounds, n_keys=CHUNK), CHUNK)
    dblock = min(kops.autotune_block("delete", table_bytes=base.numel() * 4,
                                     n_keys=CHUNK), CHUNK)
    pblock = min(kops.autotune_block("probe", table_bytes=base.numel() * 4),
                 CHUNK)
    work = base.clone()

    def restore():
        work.copy_(base)

    # The lanes the home bucket cannot answer.  For insert and delete this
    # ranks each lane among all earlier lanes of the call against the
    # table it started from; the table only fills (insert) or empties
    # (delete) during a call, so this counts no lane that the kernel's
    # per-block schedule does not also send to its alternate bucket.
    def probe_second(fp, i1):
        return ~(hashing.to_u32(base[i1]) == fp[:, None]).any(dim=1)

    def insert_second(fp, i1):
        free = (base[i1] == 0).sum(dim=1)
        return rank_among_earlier(i1, valid) >= free

    def delete_second(fp, i1):
        copies = (hashing.to_u32(base[i1]) == fp[:, None]).sum(dim=1)
        return rank_among_earlier(i1, valid, fp) >= copies

    def after(kern):
        restore()
        kern()
        return work.clone()

    def probe_k():
        return probe(base, look_hi, look_lo, fp_bits=16, n_buckets=nb,
                     block=pblock)

    def insert_k():
        return insert_bulk(work, new_hi, new_lo, fp_bits=16, n_buckets=nb,
                           valid=valid, evict_rounds=rounds, block=iblock)

    def delete_k():
        return delete_bulk(work, del_hi, del_lo, fp_bits=16, n_buckets=nb,
                           valid=valid, block=dblock)

    def insert_tm_plain():
        ok, stats = insert_bulk_plain(work, new_hi, new_lo, valid, fp_bits=16,
                                      n_buckets=nb, evict_rounds=rounds,
                                      stash=None, block=iblock,
                                      want_stats=True)
        return work, ok, insert_plane(*stats, valid)

    n = CHUNK
    probe_bytes, probe_ops = table_work(base, base, look_hi, look_lo, valid,
                                        nb, lane_bytes=8 + 1,
                                        second=probe_second)
    insert_bytes, insert_ops = table_work(base, after(insert_k), new_hi,
                                          new_lo, valid, nb,
                                          lane_bytes=8 + 1 + 1,
                                          second=insert_second)
    rows = {
        "fingerprint_hash": (
            lambda: fingerprint_hash(new_hi, new_lo, fp_bits=16, n_buckets=nb),
            lambda: fingerprint_hash_plain(new_hi, new_lo, fp_bits=16,
                                           n_buckets=nb),
            None, (n * (8 + 12), n * HASH_OPS), "fingerprint_kernel"),
        "probe": (
            probe_k,
            lambda: probe_plain(base, look_hi, look_lo, fp_bits=16,
                                n_buckets=nb),
            None, (probe_bytes, probe_ops), "probe_kernel"),
        # The telemetry twins: the same work and a 16- or 40-byte plane.
        "probe_tm": (
            lambda: probe_tm(base, look_hi, look_lo, fp_bits=16,
                             n_buckets=nb, block=pblock),
            lambda: probe_stats_plane(probe_plain(
                base, look_hi, look_lo, fp_bits=16, n_buckets=nb,
                want_stats=True)),
            None, (probe_bytes + 16, probe_ops), "probe_kernel"),
        "insert_bulk_tm": (
            lambda: insert_bulk_tm(work, new_hi, new_lo, fp_bits=16,
                                   n_buckets=nb, valid=valid,
                                   evict_rounds=rounds, block=iblock),
            insert_tm_plain, restore, (insert_bytes + 40, insert_ops),
            "insert_kernel"),
        "insert_bulk": (
            insert_k,
            lambda: (work, insert_bulk_plain(work, new_hi, new_lo, valid,
                                             fp_bits=16, n_buckets=nb,
                                             evict_rounds=rounds, stash=None,
                                             block=iblock)),
            restore, (insert_bytes, insert_ops), "insert_kernel"),
        "delete_bulk": (
            delete_k,
            lambda: (work, delete_bulk_plain(work, del_hi, del_lo, valid,
                                             fp_bits=16, n_buckets=nb,
                                             block=dblock)),
            restore, table_work(base, after(delete_k), del_hi, del_lo, valid,
                                nb, lane_bytes=8 + 1 + 1,
                                second=delete_second),
            "delete_kernel"),
    }
    out = time_rows(rows)
    # Where a launch's time goes: one logical block (the fixed cost of a
    # launch and its staging, plus one block's rounds) and, for insert, the
    # two placement rounds alone (no eviction rounds).
    one = slice(0, iblock)
    parts = {
        "insert_bulk, one block": (lambda: insert_bulk(
            work, new_hi[one], new_lo[one], fp_bits=16, n_buckets=nb,
            valid=valid[one], evict_rounds=rounds, block=iblock),
            "insert_kernel"),
        "insert_bulk, no eviction rounds": (lambda: insert_bulk(
            work, new_hi, new_lo, fp_bits=16, n_buckets=nb, valid=valid,
            evict_rounds=0, block=iblock), "insert_kernel"),
        "delete_bulk, one block": (lambda: delete_bulk(
            work, del_hi[:dblock], del_lo[:dblock], fp_bits=16,
            n_buckets=nb, valid=valid[:dblock], block=dblock),
            "delete_kernel"),
    }
    for label, (fn, symbol) in parts.items():
        ms = kernel_device_ms(fn, 20, restore, symbol)
        print(f"   {label}: kernel {ms!r} ms (device)", flush=True)
    return out


def flat_tensors(out) -> list:
    """The tensors of a (nested) kernel or plain result, in order."""
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in flat_tensors(x)]
    return [out]


def hold_row(name: str, kern, plain, setup) -> None:
    """Run ``kern`` and ``plain`` once each from the same ``setup``,
    outside any timed span, and require every output (the tables they
    update in place among them) equal bit for bit (fatal)."""
    import torch
    if setup:
        setup()
    got = [t.clone() for t in flat_tensors(kern())]
    if setup:
        setup()
    want = [t.clone() for t in flat_tensors(plain())]
    check(len(got) == len(want), f"{name}: the kernel gives {len(got)} "
                                 f"outputs, the plain version {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and a.dtype == b.dtype
              and torch.equal(a, b),
              f"{name} at full size: output {i} of the kernel differs from "
              f"the plain version's")
    print(f"   {name}: held at full size, {len(got)} outputs "
          f"({', '.join('x'.join(map(str, t.shape)) or '1' for t in got)}) "
          f"equal to the plain version's bit for bit", flush=True)


def probe_stats_plane(out):
    """(hit, (h1, h2, hs)) of a plain probe with stats -> (hit, the
    depth plane of every lane)."""
    from repro_torch.kernels.telemetry import probe_depth_counts
    hit, hs = out
    return hit, probe_depth_counts(*hs, hit | ~hit)


def time_rows(rows: dict, ops_per_s: float = SCALAR_OPS_PER_S, *,
              hold: bool = True) -> dict:
    """Device, wrapper, plain and bound times of each row
    ``name: (kernel call, plain call, setup, (bytes, ops), symbol)``, each
    held first against its plain version bit for bit (``hold_row``) unless
    ``hold`` is False (flash attention, which phase 2 holds within its
    tolerance at gemma3-1b's shapes).  The plain call returns what the
    kernel call does (the tables the calls update in place among them);
    ``symbol`` is a substring of the kernel's name in the profiler trace,
    or a tuple of them."""
    out = {}
    for name, (kern, plain, setup, (nbytes, ops), symbol) in rows.items():
        if hold:
            hold_row(name, kern, plain, setup)
        bound_ms, bound_by = least_ms(nbytes, ops, ops_per_s)
        # plain, kernel, kernel, plain: compare within one call, in turns.
        p1 = time_ms(plain, 3, setup)
        w1 = time_ms(kern, 20, setup)
        d1 = kernel_device_ms(kern, 20, setup, symbol)
        d2 = kernel_device_ms(kern, 20, setup, symbol)
        w2 = time_ms(kern, 20, setup)
        p2 = time_ms(plain, 3, setup)
        check(d1 is not None and d2 is not None,
              f"{name}: the profiler trace holds no device time for "
              f"{symbol}")
        out[name] = {"ms": (d1 + d2) / 2, "wrapper_ms": (w1 + w2) / 2,
                     "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes, "ops": ops}
        print(f"   {name}: kernel {d1!r} / {d2!r} ms (device), wrapper "
              f"{w1!r} / {w2!r} ms, plain {p1!r} / {p2!r} ms, bound "
              f"{bound_ms!r} ms ({nbytes} B, {ops} ops)", flush=True)
    return out


def sectors_of(index, per_sector: int) -> int:
    """Distinct 32-byte sectors holding rows ``index`` of a plane whose
    rows are ``32 / per_sector`` bytes."""
    import torch
    return int(torch.unique(index // per_sector).numel())


def adaptive_work(before, after, hi, lo, valid, nb, *, lane_bytes: int,
                  second, sel_rows: str, key_ops: int, slot_ops: int):
    """(bytes, ops) of one call on the four adaptive planes, for this run's
    data: keys and masks once; the home bucket's table sector of every
    valid lane and the alternate's for the lanes ``second(i1)`` says the
    home cannot answer; the selector-word sectors of those rows that the
    call must read (``sel_rows``: "none"; "all"; "matching", only the rows
    in which some slot holds one of the key's four family fingerprints,
    the least an exact lookup reads, since no other row can hit whatever
    its selectors); every changed sector of each of the four planes,
    written once.  Distinct sectors are counted once."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels.selector import fp_family
    fp = hashing.fingerprint(hi, lo, 16)
    i1 = hashing.index_hash(hi, lo, nb)
    i2 = hashing.alt_index(i1, fp, nb)
    again = second(i1) & valid
    looked = torch.cat([i1[valid], i2[again]])
    bucket_row = SECTOR // (4 * before[0].shape[1])      # buckets / sector
    reads = sectors_of(looked, bucket_row)
    if sel_rows == "all":
        reads += sectors_of(looked, SECTOR // 4)
    elif sel_rows == "matching":
        fam = [hashing.to_i32(f) for f in fp_family(hi, lo, 16)]

        def matching(rows, lanes):
            row = before[0][rows[lanes]]
            hit = torch.zeros(row.shape[0], dtype=torch.bool,
                              device=row.device)
            for f in fam:
                hit |= (row == f[lanes][:, None]).any(dim=1)
            return rows[lanes][hit]
        reads += sectors_of(torch.cat([matching(i1, valid),
                                       matching(i2, again)]), SECTOR // 4)
    writes = 0
    for plane, old, new in zip(("table", "sels", "khi", "klo"), before,
                               after):
        changed = (old != new).any(dim=1).nonzero().flatten()
        writes += sectors_of(changed, SECTOR // 4 if plane == "sels"
                             else bucket_row)
    nbytes = hi.numel() * lane_bytes + SECTOR * (reads + writes)
    ops = hi.numel() * key_ops + slot_ops * before[0].shape[1] * (
        int(valid.sum()) + int(again.sum()))
    return nbytes, ops


def adaptive_kernel_times(m, remaining: np.ndarray) -> dict:
    """Kernel, wrapper, plain and bound times of the adaptive kernels at
    the adaptive path's final state, for one 4096-key call each."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.delete import (delete_bulk_adaptive,
                                            delete_bulk_adaptive_plain)
    from repro_torch.kernels.fingerprint import (
        fingerprint_hash_family, fingerprint_hash_family_plain)
    from repro_torch.kernels.insert import (insert_bulk_adaptive,
                                            insert_bulk_adaptive_plain,
                                            insert_bulk_adaptive_tm)
    from repro_torch.kernels.probe import (probe_adaptive,
                                           probe_adaptive_plain,
                                           probe_adaptive_tm)
    from repro_torch.kernels.rank import rank_among_earlier
    from repro_torch.kernels.selector import (fp_family, sel_unpack,
                                              select_fp)
    from repro_torch.kernels.telemetry import insert_plane

    st = m.filt.state
    nb, dev = st.n_buckets, st.table.device
    base = [st.table, st.sels, st.khi, st.klo]
    stash = m.filt.stash
    work = [p.clone() for p in base]
    rng = np.random.RandomState(SEED + 5)

    def pair(keys):
        hi, lo = hashing.key_to_u32_pair_np(keys)
        return (torch.from_numpy(hi.view(np.int32)).to(dev),
                torch.from_numpy(lo.view(np.int32)).to(dev))

    look_hi, look_lo = pair(np.concatenate([remaining[: CHUNK // 2],
                                            random_keys(rng, CHUNK // 2)]))
    new_hi, new_lo = pair(random_keys(rng, CHUNK))
    del_hi, del_lo = pair(remaining[CHUNK: 2 * CHUNK])
    valid = torch.ones(CHUNK, dtype=torch.bool, device=dev)
    rounds = m.filt.ops.evict_rounds
    plane_bytes = kops._adaptive_plane_bytes(st.table)
    iblock = min(kops.autotune_block("insert", table_bytes=plane_bytes,
                                     evict_rounds=2 * rounds, n_keys=CHUNK),
                 CHUNK)
    dblock = min(kops.autotune_block("delete", table_bytes=plane_bytes,
                                     n_keys=CHUNK), CHUNK)
    pblock = min(kops.autotune_block("probe", table_bytes=plane_bytes),
                 CHUNK)

    def restore():
        for w, b in zip(work, base):
            w.copy_(b)

    def after(kern):
        restore()
        kern()
        return [w.clone() for w in work]

    def home_hits(hi, lo):
        """Per lane, the copies of its key the home bucket holds under the
        slots' selectors."""
        fam = fp_family(hi, lo, 16)
        i1 = hashing.index_hash(hi, lo, nb)
        exp = hashing.to_i32(select_fp(fam, sel_unpack(base[1][i1], 4)))
        return (base[0][i1] == exp).sum(dim=1), hashing.to_i32(fam[0])

    look_home, _ = home_hits(look_hi, look_lo)
    del_home, del_fp0 = home_hits(del_hi, del_lo)

    def probe_second(i1):
        return look_home == 0

    def insert_second(i1):
        return rank_among_earlier(i1, valid) >= (base[0][i1] == 0).sum(dim=1)

    def delete_second(i1):
        return rank_among_earlier(i1, valid, del_fp0) >= del_home

    # The path's lookups always pass its stash (128 slots, empty there).
    def probe_k(st=stash):
        return probe_adaptive(base[0], base[1], look_hi, look_lo, fp_bits=16,
                              n_buckets=nb, stash=st, block=pblock)

    def probe_work(sel_rows):
        nbytes, ops = adaptive_work(base, base, look_hi, look_lo, valid, nb,
                                    lane_bytes=8 + 1, second=probe_second,
                                    sel_rows=sel_rows, key_ops=FAMILY_OPS,
                                    slot_ops=3)
        return nbytes + stash.numel() * 4, ops

    def insert_k():
        return insert_bulk_adaptive(*work, new_hi, new_lo, fp_bits=16,
                                    n_buckets=nb, valid=valid,
                                    evict_rounds=rounds, block=iblock)

    def delete_k():
        return delete_bulk_adaptive(*work, del_hi, del_lo, fp_bits=16,
                                    n_buckets=nb, valid=valid, block=dblock)

    def insert_tm_plain():
        ok, stats = insert_bulk_adaptive_plain(
            *work, new_hi, new_lo, valid, fp_bits=16, n_buckets=nb,
            evict_rounds=rounds, stash=None, block=iblock, want_stats=True)
        return (*work, ok, insert_plane(*stats, valid))

    n = CHUNK
    insert_bytes, insert_ops = adaptive_work(
        base, after(insert_k), new_hi, new_lo, valid, nb,
        lane_bytes=8 + 1 + 1, second=insert_second, sel_rows="none",
        key_ops=HASH_OPS, slot_ops=2)
    p_bytes, p_ops = probe_work("matching")
    rows = {
        "fingerprint_hash_family": (
            lambda: fingerprint_hash_family(new_hi, new_lo, fp_bits=16,
                                            n_buckets=nb),
            lambda: fingerprint_hash_family_plain(new_hi, new_lo,
                                                  fp_bits=16, n_buckets=nb),
            None, (n * (8 + 24), n * FAMILY_OPS), "family_kernel"),
        "probe_adaptive": (
            probe_k,
            lambda: probe_adaptive_plain(base[0], base[1], look_hi, look_lo,
                                         fp_bits=16, n_buckets=nb,
                                         stash=stash),
            None, (p_bytes, p_ops), "probe_adaptive_kernel"),
        # The telemetry twins: the same work and a 16- or 40-byte plane.
        "probe_adaptive_tm": (
            lambda: probe_adaptive_tm(base[0], base[1], look_hi, look_lo,
                                      fp_bits=16, n_buckets=nb, stash=stash,
                                      block=pblock),
            lambda: probe_stats_plane(probe_adaptive_plain(
                base[0], base[1], look_hi, look_lo, fp_bits=16,
                n_buckets=nb, stash=stash, want_stats=True)),
            None, (p_bytes + 16, p_ops), "probe_adaptive_kernel"),
        "insert_bulk_adaptive_tm": (
            lambda: insert_bulk_adaptive_tm(
                *work, new_hi, new_lo, fp_bits=16, n_buckets=nb,
                valid=valid, evict_rounds=rounds, block=iblock),
            insert_tm_plain, restore, (insert_bytes + 40, insert_ops),
            "insert_adaptive_kernel"),
        "insert_bulk_adaptive": (
            insert_k,
            lambda: (*work, insert_bulk_adaptive_plain(
                *work, new_hi, new_lo, valid, fp_bits=16, n_buckets=nb,
                evict_rounds=rounds, stash=None, block=iblock)),
            restore, (insert_bytes, insert_ops), "insert_adaptive_kernel"),
        "delete_bulk_adaptive": (
            delete_k,
            lambda: (*work, delete_bulk_adaptive_plain(
                *work, del_hi, del_lo, valid, fp_bits=16, n_buckets=nb,
                block=dblock)),
            restore, adaptive_work(base, after(delete_k), del_hi, del_lo,
                                   valid, nb, lane_bytes=8 + 1 + 1,
                                   second=delete_second, sel_rows="all",
                                   key_ops=FAMILY_OPS, slot_ops=3),
            "delete_adaptive_kernel"),
    }
    out = time_rows(rows)
    old_bytes, old_ops = probe_work("all")
    print(f"   probe_adaptive bound, a selector sector for every row looked "
          f"at (the earlier count): {least_ms(old_bytes, old_ops)[0]!r} ms "
          f"({old_bytes} B)", flush=True)
    ms = kernel_device_ms(lambda: probe_k(None), 20, None,
                          "probe_adaptive_kernel")
    print(f"   probe_adaptive, {CHUNK} keys without a stash: {ms!r} ms "
          f"(device)", flush=True)
    out["probe_adaptive"]["no_stash_ms"] = ms
    return out


def flushed_event_ms(fn, reps: int, flush) -> float | None:
    """Mean device ms of ``fn``'s launches by CUDA events around each, with
    ``flush`` (a write larger than the L2) before each.  A spin kernel
    enqueued first keeps the device behind the host, so no host time falls
    inside a span; None when the host took longer to enqueue the launches
    than the spin lasted."""
    import torch
    fn()
    torch.cuda.synchronize()
    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s0.record()
    torch.cuda._sleep(400_000_000)      # ~0.2 s at the H100's clocks
    s1.record()
    t0 = time.perf_counter()
    spans = []
    for _ in range(reps):
        flush()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        spans.append((a, b))
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= s0.elapsed_time(s1):
        print(f"   the host took {host_ms!r} ms to enqueue, longer than the "
              f"spin: the spans may hold host time", flush=True)
        return None
    return sum(a.elapsed_time(b) for a, b in spans) / reps


def probe_adaptive_path_times(m, remaining: np.ndarray,
                              benign: np.ndarray) -> dict:
    """probe_adaptive at the launch size of the adaptive path's lookups, on
    its final state with its stash: the 10M benign keys (the path's stash,
    empty there; then a copy with all 128 slots live) and the remaining
    members.  Each launch is first held against the plain version on the
    same inputs, bit for bit (fatal), outside the timed spans.  Device ms
    by CUDA events with L2 flushed before each launch (and by the profiler
    beside them), with the bound of each launch's data; a reading under
    its bound is a wrong timing, printed as such and not kept."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.probe import (probe_adaptive,
                                           probe_adaptive_plain,
                                           probe_adaptive_tm)
    from repro_torch.kernels.selector import fp_family, sel_unpack, select_fp
    from repro_torch.kernels.telemetry import probe_depth_counts

    st = m.filt.state
    nb, dev = st.n_buckets, st.table.device
    table, sels, stash = st.table, st.sels, m.filt.stash
    planted = stash.clone()
    rng = np.random.RandomState(SEED + 11)
    slots = stash.shape[1]
    planted[0] = torch.from_numpy(rng.randint(1, 1 << 16, slots)
                                  .astype(np.int32)).to(dev)
    planted[1] = torch.from_numpy(rng.randint(0, nb, slots)
                                  .astype(np.int32)).to(dev)
    flush_buf = torch.empty(1 << 25, dtype=torch.int32, device=dev)  # 128 MB

    def pair(keys):
        hi, lo = hashing.key_to_u32_pair_np(keys)
        return (torch.from_numpy(hi.view(np.int32)).to(dev),
                torch.from_numpy(lo.view(np.int32)).to(dev))

    out = {}
    for label, keys, st_ in (("benign", benign, stash),
                             ("benign, 128 live stash entries", benign,
                              planted),
                             ("members", remaining, stash)):
        # Padded to the logical block, as the path's lookups pad them.
        block = min(kops.autotune_block(
            "probe", table_bytes=kops._adaptive_plane_bytes(table),
            stash_slots=slots), keys.size)
        hi, lo = (kops._pad_to(x, block)[0] for x in pair(keys))
        valid = torch.ones(hi.numel(), dtype=torch.bool, device=dev)
        i1 = hashing.index_hash(hi, lo, nb)
        exp = hashing.to_i32(select_fp(fp_family(hi, lo, 16),
                                       sel_unpack(sels[i1], 4)))
        home_miss = ~(table[i1] == exp).any(dim=1)
        del exp
        bounds = {}
        for sel_rows in ("all", "matching"):
            nbytes, ops = adaptive_work(
                [table], [table], hi, lo, valid, nb, lane_bytes=8 + 1,
                second=lambda _i1: home_miss, sel_rows=sel_rows,
                key_ops=FAMILY_OPS, slot_ops=3)
            bounds[sel_rows] = least_ms(nbytes + st_.numel() * 4, ops)

        def call(hi=hi, lo=lo, st_=st_, block=block):
            return probe_adaptive(table, sels, hi, lo, fp_bits=16,
                                  n_buckets=nb, stash=st_, block=block)
        def call_tm(hi=hi, lo=lo, st_=st_, block=block, n=keys.size):
            return probe_adaptive_tm(table, sels, hi, lo, fp_bits=16,
                                     n_buckets=nb, stash=st_, n_valid=n,
                                     block=block)
        got = call()
        want, hs = probe_adaptive_plain(table, sels, hi, lo, fp_bits=16,
                                        n_buckets=nb, stash=st_,
                                        want_stats=True)
        check(got.shape == want.shape and torch.equal(got, want),
              f"probe_adaptive at the path's size, {label}: kernel differs "
              f"from its plain version ({int((got != want).sum())} keys)")
        # The telemetry twin: the flag-off answers and the plain version's
        # depth plane of the path's keys (the padding uncounted).
        hit_tm, plane = call_tm()
        want_plane = probe_depth_counts(
            *hs, torch.arange(hi.numel(), device=dev) < keys.size)
        check(torch.equal(hit_tm, got) and torch.equal(plane, want_plane),
              f"probe_adaptive_tm at the path's size, {label}: differs from "
              f"the plain version with stats ({plane.tolist()} vs "
              f"{want_plane.tolist()})")
        n_hits = int(got.sum())
        del got, want, hs, hit_tm
        ms = flushed_event_ms(call, 20, flush_buf.zero_)
        tm_ms = flushed_event_ms(call_tm, 20, flush_buf.zero_)
        ms2 = flushed_event_ms(call, 20, flush_buf.zero_)
        prof = kernel_device_ms(call, 10, flush_buf.zero_,
                                "probe_adaptive_kernel")
        bound, by = bounds["matching"]
        print(f"   probe_adaptive at the path's size, {label}: "
              f"{hi.numel()} keys, {int(home_miss.sum())} home misses, "
              f"{n_hits} hits, same as the plain version, {ms!r} ms "
              f"(device, CUDA events, L2 flushed), profiler {prof!r} ms, "
              f"bound {bound!r} ms ({by}; with a selector "
              f"sector for every row looked at: {bounds['all'][0]!r} ms)",
              flush=True)
        print(f"   probe_adaptive_tm at the path's size, {label}: depth "
              f"plane {plane.tolist()} (home, alternate, stash, miss), same "
              f"as the plain version; {tm_ms!r} ms against the flag-off "
              f"kernel's {ms!r} / {ms2!r} ms (device, CUDA events, L2 "
              f"flushed; the twin's span holds its plane's zeroing)",
              flush=True)
        if ms is not None and ms < bound:
            print(f"   probe_adaptive {label}: {ms!r} ms is under its bound "
                  f"{bound!r} ms: the timing is wrong, not kept", flush=True)
            ms = None
        out[label] = {"keys": hi.numel(), "ms": ms, "bound_ms": bound,
                      "profiler_ms": prof, "tm_ms": tm_ms, "off_ms_2": ms2}
        del hi, lo, valid, i1, home_miss
    return out


def streaming_kernel_times(snap, present: np.ndarray) -> dict:
    """Kernel, wrapper, plain and bound times of probe_multi on the
    streaming path's final ring (a copy of its pool with the live slots,
    before the TTL step), for one 4096-key call half present, half
    absent."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.probe import probe_multi, probe_multi_plain

    tables, stashes, gens, nb = snap
    dev = tables.device
    b = tables.shape[2]
    slots = stashes.shape[2]
    rng = np.random.RandomState(SEED + 9)
    keys = np.concatenate([present[rng.randint(0, present.size, CHUNK // 2)],
                           random_keys(rng, CHUNK // 2)])
    hi, lo = (torch.from_numpy(x.view(np.int32)).to(dev)
              for x in hashing.key_to_u32_pair_np(keys))
    pblock = min(kops.autotune_block("probe", table_bytes=tables[0].numel()
                                     * 4, stash_slots=slots), CHUNK)

    # Bytes and operations this call's data needs: keys (8 B) and hits
    # (1 B) once; per live generation, in the kernel's (slot) order, the
    # home sector of every lane not yet answered and the alternate sector
    # only where the home bucket misses (distinct sectors once); every
    # live stash byte once, scanned by the lanes no table answered.
    fp = hashing.fingerprint(hi, lo, 16)
    i1 = hashing.index_hash(hi, lo, nb)
    i2 = hashing.alt_index(i1, fp, nb)
    pending = torch.ones(CHUNK, dtype=torch.bool, device=dev)
    reads, compares = 0, 0
    for g in sorted(gens):
        home = (hashing.to_u32(tables[g][i1]) == fp[:, None]).any(dim=1)
        alt = (hashing.to_u32(tables[g][i2]) == fp[:, None]).any(dim=1)
        again = pending & ~home
        reads += sectors(i1[pending]) + sectors(i2[again])
        compares += 2 * b * (int(pending.sum()) + int(again.sum()))
        pending &= ~(home | alt)
    k = len(gens)
    entries = sum(int((stashes[g][0] != 0).sum()) for g in gens)
    print(f"   probe_multi timed call: K={k} live generations, {entries} "
          f"live stash entries of {k * slots} slots, {int(pending.sum())} "
          f"of {CHUNK} keys no table answers", flush=True)
    nbytes = CHUNK * (8 + 1) + SECTOR * reads + k * 2 * slots * 4
    ops = CHUNK * HASH_OPS + compares + 3 * k * slots * int(pending.sum())
    rows = {"probe_multi": (
        lambda: probe_multi(tables, hi, lo, fp_bits=16, n_buckets=nb,
                            stashes=stashes, gens=gens, block=pblock),
        lambda: probe_multi_plain(tables, hi, lo, fp_bits=16, n_buckets=nb,
                                  stashes=stashes, gens=gens),
        None, (nbytes, ops), "probe_multi_kernel")}
    out = time_rows(rows)
    # Where a launch's time goes: the same keys without the stash scan,
    # and over the newest generation alone.
    for label, sts, gs in (("K=%d, no stashes" % k, None, gens),
                           ("K=1, stash", stashes, gens[-1:]),
                           ("K=1, no stash", None, gens[-1:])):
        ms = kernel_device_ms(
            lambda: probe_multi(tables, hi, lo, fp_bits=16, n_buckets=nb,
                                stashes=sts, gens=gs, block=pblock),
            20, None, "probe_multi_kernel")
        print(f"   probe_multi {label}: {ms!r} ms (device)", flush=True)
    return out


def live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave live, queries right-aligned."""
    qpos = np.arange(skv - sq, skv, dtype=np.int64)
    hi = np.minimum(qpos + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def flash_kernel_times() -> dict:
    """Kernel, wrapper, plain, bound and library times of flash_attention
    at gemma3-1b's prompt-scoring shapes (bfloat16, B=1, Hq=4, Hkv=1,
    S=8192, D=256): a global layer (causal) and a local one (window 512).
    The bound is the larger of q, k, v and o moved once over the memory
    rate and 4 * Hq * D operations per live (query, key) pair over the
    bfloat16 tensor-core rate.  The library's yardstick is one
    ``scaled_dot_product_attention`` call on the same inputs (GQA, causal;
    the window as a boolean mask), timed here and used nowhere in the
    port.  The float32 kernel is timed too, at phase 5c (b)'s shape
    (S=1024), with its operations over the float32 CUDA-core rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    cfg_window = 512
    b, hq, hkv, s, d = 1, 4, 1, LM_SEQ, 256
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    q, k, v = (torch.randn(shape, device="cuda", generator=gen)
               .to(torch.bfloat16) for shape in ((b, hq, s, d),
                                                 (b, hkv, s, d),
                                                 (b, hkv, s, d)))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    pos = torch.arange(s, device="cuda")
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - cfg_window)
    out = {}
    for label, window in (("global", None), ("local", cfg_window)):
        ops = 4 * hq * d * live_pairs(s, s, True, window) * b
        rows = {f"flash_attention ({label})": (
            lambda w=window: flash_attention(q, k, v, window=w),
            lambda w=window: flash_attention_plain(q, k, v, window=w),
            None, (nbytes, ops), "flash_wgmma_kernel")}
        row = time_rows(rows, TENSOR_OPS_PER_S, hold=False)[
            f"flash_attention ({label})"]
        mask = (dict(is_causal=True) if window is None
                else dict(attn_mask=band))

        def lib(mask=mask):
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **mask)
        row["library_ms"] = (time_ms(lib, 10) + time_ms(lib, 10)) / 2
        diff = float((lib().float() - flash_attention(
            q, k, v, window=window).float()).abs().max())
        how = ("causal" if window is None else
               "a dense boolean band mask: SDPA has no windowed fast path")
        print(f"   flash_attention ({label}): scaled_dot_product_attention "
              f"{row['library_ms']!r} ms ({how}), max |difference| "
              f"{diff!r}; {ops} operations", flush=True)
        out[label] = row
    # flash_f32_kernel at phase 5c (b)'s shape: float32, S = 1024, on the
    # CUDA cores (bound: the float32 rate outside the tensor cores).
    s32 = 1024
    q, k, v = (x[:, :, :s32].float().contiguous() for x in (q, k, v))
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    for label, window in (("global", None), ("local", cfg_window)):
        ops = 4 * hq * d * live_pairs(s32, s32, True, window) * b
        name = f"flash_attention float32 S={s32} ({label})"
        out[name] = time_rows({name: (
            lambda w=window: flash_attention(q, k, v, window=w),
            lambda w=window: flash_attention_plain(q, k, v, window=w),
            None, (nbytes, ops), "flash_f32_kernel")}, hold=False)[name]
    return out


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel of an ``nvcc -Xptxas -v`` log: its name
    (``name_kernel<D>``, read from the mangled symbol), registers, static
    shared memory and spills.  The flash kernels' tiles are dynamic shared
    memory, sized at launch (``csrc/flash_attention.cu``)."""
    import re
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            # Itanium mangling: _Z, N for a nested name, then each
            # component as its length and identifier (the anonymous
            # namespace's carries digits of its own); the kernel is the
            # last, and a template argument <D> follows as ILi<D>E.
            z = re.match(r"_ZN?", name)
            pos, ident = (z.end() if z else len(name)), None
            while (k := re.match(r"\d+", name[pos:])):
                pos += len(k.group()) + int(k.group())
                ident = name[pos - int(k.group()):pos]
            if ident:
                t = re.match(r"I((?:L[a-z]+\d+E)+)E", name[pos:])
                args = re.findall(r"L[a-z]+(\d+)E", t.group(1)) if t else []
                name = ident + (f"<{','.join(args)}>" if args else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


def wgmma_report(summary: list[str]) -> list[str]:
    """flash_wgmma_kernel's lines of ``ptxas_summary`` for the flash
    library, each with the CTA's dynamic shared memory (from the
    library's ``lm_flash_wgmma_smem_bytes``); raises on any spill."""
    import ctypes
    import re
    from repro_torch.kernels import cuda
    smem = ctypes.CDLL(str(cuda._lib_path("flash_attention"))) \
        .lm_flash_wgmma_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    out = []
    for line in summary:
        m = re.match(r"flash_wgmma_kernel<(\d+)>", line)
        if not m:
            continue
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
        check(spills and not any(spills),
              f"ptxas spills in flash_wgmma_kernel: {line}")
        out.append(f"{line}; {smem(int(m.group(1)))} bytes of dynamic "
                   f"shared memory a CTA")
    check(len(out) == 5, f"ptxas reported {len(out)} of the 5 head dims of "
                         f"flash_wgmma_kernel")
    return out


# ------------------------------------------------------------------ main --


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import cuda  # fails outside a checkout

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = smi
    t_start = time.perf_counter()

    with phase("build"):
        took = cuda.build_all()
        for name, secs in took.items():
            print(f"   nvcc {name}: {secs:.2f} s", flush=True)
        logs = set()
        for name in cuda.KERNELS:
            log = cuda._lib_path(name).with_suffix(".log")
            if log.exists() and log not in logs:
                logs.add(log)
                summary = ptxas_summary(log.read_text())
                for line in summary:
                    print(f"   {name}: {line}", flush=True)
                if name == "flash_attention":
                    for line in wgmma_report(summary):
                        print(f"   ptxas, no spills: {line}", flush=True)
            cuda.kernel_fn(name)

    with phase("kernels vs plain versions"):
        bench = KernelBench("cuda")
        bench.run()
        abench = AdaptiveKernelBench("cuda")
        abench.run()
        sbench = StreamingKernelBench("cuda")
        sbench.run()
        fbench = FlashKernelBench("cuda")
        fbench.run()
        max_err = {**bench.max_err, **abench.max_err, **sbench.max_err,
                   **fbench.max_err}
        torch.cuda.synchronize()

    with phase("slice parity cuda vs cpu"):
        for slots in (0, 64):
            slice_parity(100_000, slots)
        adaptive_parity("adaptive stream", n_buckets=1 << 14,
                        n_members=48 * 1024, n_benign=200_000)
        adaptive_parity("adaptive stream at load 0.95", n_buckets=1 << 12,
                        n_members=12 * 1024, n_benign=100_000,
                        late=int(0.95 * (1 << 14)) - 12 * 1024)
        ring_parity()
        prefix_index_parity()
        for adaptive in (False, True):
            batcher_parity(adaptive)
        slo_parity()
        continuous_batcher_parity(*lm_parity())

    # Each path runs with the counts set to 0 just before it and read just
    # after; its kernels' "launches" come from that run.
    launches, plain = {}, {}
    with phase("main path at full size"):
        ocf, resident, counts, plain["main"], main_times = main_path(
            "cuda", card)
        launches.update({k: counts.get(k, 0) for k in STATIC_KERNELS})

    with phase("adaptive path at full size"):
        m, remaining, counts, plain["adaptive"], adaptive_stats = \
            adaptive_path(card)
        launches.update({k: counts.get(k, 0) for k in ADAPTIVE_KERNELS})

    with phase("streaming path at full size"):
        ring, present, counts, plain["streaming"], _stats = streaming_path(
            card)
        launches.update({k: counts.get(k, 0) for k in STREAMING_KERNELS})
        check(counts.get("insert_bulk", 0) > 0,
              "insert_bulk was never launched on the streaming path")

    with phase("filter-op waves at full size"):
        waves = filter_wave_path(card)
        launches.update({k: waves["launches"].get(k, 0)
                         for k in cuda.TM_KERNELS})
        plain["waves"] = waves["plain"]

    with phase("SLO scenarios at node size"):
        slo = slo_node_path(card)
        plain["slo"] = slo["plain"]

    with phase("LM serving path at full size"):
        counts, plain["lm"], _lm = lm_path(card)
        launches.update({k: counts.get(k, 0) for k in LM_KERNELS})
        counts, plain["lm_batcher"], _lmb = lm_batcher_path(card)
        missing = [k for k in ("fingerprint_hash", "probe", "insert_bulk")
                   if not counts.get(k)]
        check(not missing, f"(d) the prefix index never launched {missing}")

    for name in cuda.KERNELS:
        check(launches.get(name, 0) > 0,
              f"{name} was never launched on its path")
    for path, calls in plain.items():
        check(sum(calls.values()) == 0,
              f"plain versions ran on the {path} path: {calls}")

    with phase("kernel times"):
        perf = kernel_times(ocf, resident)
        perf.update(adaptive_kernel_times(m, remaining))
        path = probe_adaptive_path_times(m, remaining,
                                         adaptive_stats.pop("benign"))
        perf["probe_adaptive"].update(
            path_keys=path["benign"]["keys"], path_ms=path["benign"]["ms"],
            path_bound_ms=path["benign"]["bound_ms"])
        perf["probe_adaptive_tm"].update(
            path_keys=path["benign"]["keys"],
            path_ms=path["benign"]["tm_ms"],
            path_bound_ms=path["benign"]["bound_ms"])
        perf.update(streaming_kernel_times(ring, present))
        flash = flash_kernel_times()
        perf["flash_attention"] = flash["global"]
        # The launch floor: a one-element add's device time, beside the
        # kernels whose launches take about that long.
        one = torch.zeros(1, device="cuda")
        floor = kernel_device_ms(lambda: one.add_(1), 20, None,
                                 "elementwise_kernel")
        check(floor is not None, "the profiler trace holds no device time "
                                 "for a one-element add")
        print(f"   launch floor (one-element torch add): {floor!r} ms "
              f"(device)", flush=True)
        for name in ("fingerprint_hash", "probe", "fingerprint_hash_family",
                     "probe_adaptive", "probe_multi"):
            print(f"   {name}: {perf[name]['ms']!r} ms (device), "
                  f"{perf[name]['ms'] / floor!r} x the launch floor",
                  flush=True)
        print(f"   probe_adaptive without a stash: "
              f"{perf['probe_adaptive']['no_stash_ms']!r} ms (device), "
              f"{perf['probe_adaptive']['no_stash_ms'] / floor!r} x the "
              f"launch floor", flush=True)
        # The telemetry instantiations beside their flag-off kernels.
        for name, off in cuda.TM_KERNELS.items():
            print(f"   {name}: {perf[name]['ms']!r} ms (device) against "
                  f"{off}'s {perf[off]['ms']!r} ms: "
                  f"{(perf[name]['ms'] / perf[off]['ms'] - 1) * 100!r} % "
                  f"more", flush=True)
        # Phase 4's wall time against its kernels' share: launches there
        # times the device time of one 4096-key launch here.
        for name, op in (("insert_bulk", "insert_s"),
                         ("delete_bulk", "delete_s")):
            k_s = launches[name] * perf[name]["ms"] / 1e3
            print(f"   main path {name}: {main_times[op]!r} s wall, "
                  f"{launches[name]} launches x {perf[name]['ms']!r} ms = "
                  f"{k_s!r} s in the kernel (share "
                  f"{k_s / main_times[op]!r})", flush=True)

    rows = []
    for name, (source, replaces, held_by) in KERNEL_ROWS.items():
        t = perf[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": t["ms"],
                     "wrapper_ms": t["wrapper_ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "held_by": held_by,
                     "library_ms": t.get("library_ms"),
                     **{k: t[k] for k in ("path_keys", "path_ms",
                                          "path_bound_ms") if k in t}})
    print(f"total {time.perf_counter() - t_start:.1f} s on {card}", flush=True)
    print(json.dumps({"slo": slo["rows"]}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
