#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each timed, each fatal on failure:

  1. print the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card,
     bit for bit, at main-path shapes (4096-key chunks, 16M-slot tables,
     the parity block): the four OCF kernels, and the four adaptive ones
     on a four-plane state with nonzero selectors;
  3. run seeded streams through the card and the CPU and require
     identical state and answers after every operation: ~100k-key EOF
     streams through ``OCF`` (with and without a stash), and two
     ``AdaptiveMembership`` streams (inserts, lookups, reports, deletes;
     one at load ~0.95 with kicks of adapted slots);
  4. the OCF main path at full size: one node's membership filter of a
     distributed store (capacity 2^22 slots, 8 bursts of 1M inserts, 3M
     verified + 100k blind deletes, lookups of every resident key plus 5M
     absent ones), with its kernels' launch counts read around it;
  5. the adaptive path at full size: an abuse-detection denylist of one
     node (2^22 buckets of 4, 12 bursts of 1M members, 4 feedback rounds
     over 10M replayed benign keys, 3M deletes), launch counts read
     around it;
  6. time each kernel, its plain version and its bound, and print them as
     one JSON line.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
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
                       "src/repro/kernels/probe.py:264", "not measured"),
    "insert_bulk_adaptive": ("src/repro_torch/csrc/insert_adaptive.cu",
                             "src/repro/kernels/insert.py:929",
                             "serial_cta_loop"),
    "delete_bulk_adaptive": ("src/repro_torch/csrc/delete_adaptive.cu",
                             "src/repro/kernels/delete.py:245",
                             "serial_cta_loop"),
}
STATIC_KERNELS = ("fingerprint_hash", "probe", "insert_bulk", "delete_bulk")
ADAPTIVE_KERNELS = ("fingerprint_hash_family", "probe_adaptive",
                    "insert_bulk_adaptive", "delete_bulk_adaptive")


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
        from repro_torch.core.scheduling import dispatch_order_from_buckets
        from repro_torch.kernels.fingerprint import fingerprint_hash_plain
        from repro_torch.kernels.insert import insert_bulk_plain
        inv = None
        if schedule and hi.shape[0] > block:
            _fp, i1, _i2 = fingerprint_hash_plain(
                hi, lo, fp_bits=16, n_buckets=self.n_buckets)
            perm, inv = dispatch_order_from_buckets(i1, valid)
            hi, lo, valid = hi[perm], lo[perm], valid[perm]
        ok = insert_bulk_plain(table, hi, lo, valid, fp_bits=16,
                               n_buckets=self.n_buckets, evict_rounds=rounds,
                               stash=stash, block=block)
        return ok if inv is None else ok[inv]

    def run(self) -> None:
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.delete import delete_bulk, delete_bulk_plain
        from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                                     fingerprint_hash_plain)
        from repro_torch.kernels.insert import insert_bulk
        from repro_torch.kernels.probe import probe, probe_plain

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
            tk, tp = base.clone(), base.clone()
            sk = (torch.zeros((2, 128), dtype=torch.int32, device=self.dev)
                  if with_stash else None)
            sp = None if sk is None else sk.clone()
            out = insert_bulk(tk, hi, lo, fp_bits=16, n_buckets=nb,
                              valid=valid, evict_rounds=rounds, stash=sk,
                              block=block, schedule=schedule)
            okp = self.plain_insert(tp, hi, lo, valid, stash=sp,
                                    rounds=rounds, block=block,
                                    schedule=schedule)
            pairs = [(tk, tp), (out[-1], okp)]
            if sk is not None:
                pairs.append((sk, sp))
            self.record("insert_bulk", pairs)
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
        return int(((planes[0] != 0) & (sel_unpack(planes[1], 4) != 0)).sum())

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


# --------------------------------------------------- phase 3: slice parity --


def snapshot(ocf) -> dict:
    from repro_torch.convert import state_to_numpy
    d = state_to_numpy(ocf.state, ocf.stash)
    d["capacity_history"] = list(ocf.capacity_history)
    d["stats"] = dataclasses.asdict(ocf.stats)
    return d


def same_snapshot(a: dict, b: dict) -> bool:
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
        "device_s": device_s}


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
    over the launches the trace holds; None when no window of up to three
    holds any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if setup:
                    setup()
                fn()
            torch.cuda.synchronize()
        total_us, calls = 0.0, 0
        for ev in prof.key_averages():
            if symbol in ev.key:
                total_us += getattr(ev, "device_time_total", 0.0) or 0.0
                calls += ev.count
        if calls and total_us > 0:
            return total_us / calls / 1e3
    return None


def least_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take for some work: its bytes over
    the memory rate or its operations over the peak rate, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
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
    from repro_torch.kernels.insert import insert_bulk, insert_bulk_plain
    from repro_torch.kernels.probe import probe, probe_plain
    from repro_torch.kernels.rank import rank_among_earlier

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

    n = CHUNK
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
            None, table_work(base, base, look_hi, look_lo, valid, nb,
                             lane_bytes=8 + 1, second=probe_second),
            "probe_kernel"),
        "insert_bulk": (
            insert_k,
            lambda: insert_bulk_plain(work, new_hi, new_lo, valid,
                                      fp_bits=16, n_buckets=nb,
                                      evict_rounds=rounds, stash=None,
                                      block=iblock),
            restore, table_work(base, after(insert_k), new_hi, new_lo, valid,
                                nb, lane_bytes=8 + 1 + 1,
                                second=insert_second),
            "insert_kernel"),
        "delete_bulk": (
            delete_k,
            lambda: delete_bulk_plain(work, del_hi, del_lo, valid,
                                      fp_bits=16, n_buckets=nb,
                                      block=dblock),
            restore, table_work(base, after(delete_k), del_hi, del_lo, valid,
                                nb, lane_bytes=8 + 1 + 1,
                                second=delete_second),
            "delete_kernel"),
    }
    return time_rows(rows)


def time_rows(rows: dict) -> dict:
    """Device, wrapper, plain and bound times of each row
    ``name: (kernel call, plain call, setup, (bytes, ops), symbol)``."""
    out = {}
    for name, (kern, plain, setup, (nbytes, ops), symbol) in rows.items():
        bound_ms, bound_by = least_ms(nbytes, ops)
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
                  second, reads_sels: bool, key_ops: int, slot_ops: int):
    """(bytes, ops) of one call on the four adaptive planes, for this run's
    data: keys and masks once; the home bucket's table sector (and, where
    the kernel reads it, its selector-word sector) of every valid lane; the
    alternate's for the lanes ``second(i1)`` says the home cannot answer;
    every changed sector of each of the four planes, written once.
    Distinct sectors are counted once."""
    import torch
    from repro_torch.core import hashing
    fp = hashing.fingerprint(hi, lo, 16)
    i1 = hashing.index_hash(hi, lo, nb)
    i2 = hashing.alt_index(i1, fp, nb)
    again = second(i1) & valid
    looked = torch.cat([i1[valid], i2[again]])
    bucket_row = SECTOR // (4 * before[0].shape[1])      # buckets / sector
    reads = sectors_of(looked, bucket_row)
    if reads_sels:
        reads += sectors_of(looked, SECTOR // 4)
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
                                            insert_bulk_adaptive_plain)
    from repro_torch.kernels.probe import (probe_adaptive,
                                           probe_adaptive_plain)
    from repro_torch.kernels.rank import rank_among_earlier
    from repro_torch.kernels.selector import (fp_family, sel_unpack,
                                              select_fp)

    st = m.filt.state
    nb, dev = st.n_buckets, st.table.device
    base = [st.table, st.sels, st.khi, st.klo]
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

    def probe_k():
        return probe_adaptive(base[0], base[1], look_hi, look_lo, fp_bits=16,
                              n_buckets=nb, block=pblock)

    def insert_k():
        return insert_bulk_adaptive(*work, new_hi, new_lo, fp_bits=16,
                                    n_buckets=nb, valid=valid,
                                    evict_rounds=rounds, block=iblock)

    def delete_k():
        return delete_bulk_adaptive(*work, del_hi, del_lo, fp_bits=16,
                                    n_buckets=nb, valid=valid, block=dblock)

    n = CHUNK
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
                                         fp_bits=16, n_buckets=nb),
            None, adaptive_work(base, base, look_hi, look_lo, valid, nb,
                                lane_bytes=8 + 1, second=probe_second,
                                reads_sels=True, key_ops=FAMILY_OPS,
                                slot_ops=3),
            "probe_adaptive_kernel"),
        "insert_bulk_adaptive": (
            insert_k,
            lambda: insert_bulk_adaptive_plain(
                *work, new_hi, new_lo, valid, fp_bits=16, n_buckets=nb,
                evict_rounds=rounds, stash=None, block=iblock),
            restore, adaptive_work(base, after(insert_k), new_hi, new_lo,
                                   valid, nb, lane_bytes=8 + 1 + 1,
                                   second=insert_second, reads_sels=False,
                                   key_ops=HASH_OPS, slot_ops=2),
            "insert_adaptive_kernel"),
        "delete_bulk_adaptive": (
            delete_k,
            lambda: delete_bulk_adaptive_plain(
                *work, del_hi, del_lo, valid, fp_bits=16, n_buckets=nb,
                block=dblock),
            restore, adaptive_work(base, after(delete_k), del_hi, del_lo,
                                   valid, nb, lane_bytes=8 + 1 + 1,
                                   second=delete_second, reads_sels=True,
                                   key_ops=FAMILY_OPS, slot_ops=3),
            "delete_adaptive_kernel"),
    }
    return time_rows(rows)


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
        for name in cuda.KERNELS:
            log = cuda._lib_path(name).with_suffix(".log")
            if log.exists():
                for line in log.read_text().splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"   {name}: {line.strip()}", flush=True)
            cuda.kernel_fn(name)

    with phase("kernels vs plain versions"):
        bench = KernelBench("cuda")
        bench.run()
        abench = AdaptiveKernelBench("cuda")
        abench.run()
        max_err = {**bench.max_err, **abench.max_err}
        torch.cuda.synchronize()

    with phase("slice parity cuda vs cpu"):
        for slots in (0, 64):
            slice_parity(100_000, slots)
        adaptive_parity("adaptive stream", n_buckets=1 << 14,
                        n_members=48 * 1024, n_benign=200_000)
        adaptive_parity("adaptive stream at load 0.95", n_buckets=1 << 12,
                        n_members=12 * 1024, n_benign=100_000,
                        late=int(0.95 * (1 << 14)) - 12 * 1024)

    # Each path runs with the counts set to 0 just before it and read just
    # after; its kernels' "launches" come from that run.
    launches, plain = {}, {}
    with phase("main path at full size"):
        ocf, resident, counts, plain["main"], _times = main_path("cuda",
                                                                 card)
        launches.update({k: counts.get(k, 0) for k in STATIC_KERNELS})

    with phase("adaptive path at full size"):
        m, remaining, counts, plain["adaptive"], _stats = adaptive_path(card)
        launches.update({k: counts.get(k, 0) for k in ADAPTIVE_KERNELS})

    for name in cuda.KERNELS:
        check(launches.get(name, 0) > 0,
              f"{name} was never launched on its path")
    for path, calls in plain.items():
        check(sum(calls.values()) == 0,
              f"plain versions ran on the {path} path: {calls}")

    with phase("kernel times"):
        perf = kernel_times(ocf, resident)
        perf.update(adaptive_kernel_times(m, remaining))

    rows = []
    for name, (source, replaces, held_by) in KERNEL_ROWS.items():
        t = perf[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": t["ms"],
                     "wrapper_ms": t["wrapper_ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "held_by": held_by, "library_ms": None})
    print(f"total {time.perf_counter() - t_start:.1f} s on {card}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
