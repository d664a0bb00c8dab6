"""Helpers shared by the ``test_torch_*`` files: numpy <-> torch key and
table conversions, and snapshots of an OCF's full state for comparing the
port with the reference."""
import dataclasses

import numpy as np
import torch

from repro_torch.convert import state_to_numpy


def random_keys(rng, n):
    return rng.randint(0, 2 ** 63, size=n, dtype=np.int64).astype(np.uint64)


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


# ------------------------------------------------------------- adaptive --


def adaptive_planes(rng, n_buckets, buffer, load, *, fp_bits=16,
                    bucket_size=4, sel_share=0.25):
    """A consistent four-plane adaptive state, uint32 numpy: keys placed in
    their home buckets up to ``load``, and a ``sel_share`` of the occupied
    slots given a nonzero selector with the fingerprint rewritten under it
    -> (table, sels, khi, klo, resident keys)."""
    from repro_torch.core import hashing
    keys = random_keys(rng, int(n_buckets * bucket_size * load * 1.6))
    hi, lo = split(keys)
    home = hashing.index_hash_np(hi, lo, n_buckets).astype(np.int64)
    order = np.argsort(home, kind="stable")
    start = np.searchsorted(home[order], home[order], side="left")
    rank = np.empty_like(home)
    rank[order] = np.arange(keys.size) - start
    take = np.nonzero(rank < bucket_size)[0][: int(n_buckets * bucket_size
                                                   * load)]
    shape = (buffer, bucket_size)
    khi, klo = np.zeros(shape, np.uint32), np.zeros(shape, np.uint32)
    sel = np.zeros(shape, np.uint32)
    b, s = home[take], rank[take]
    khi[b, s], klo[b, s] = hi[take], lo[take]
    adapt = rng.rand(take.size) < sel_share
    sel[b[adapt], s[adapt]] = rng.randint(1, 4, size=int(adapt.sum()))
    table = np.zeros(shape, np.uint32)
    table[b, s] = hashing.fingerprint_sel_np(khi[b, s], klo[b, s], sel[b, s],
                                             fp_bits)
    sels = (sel << (2 * np.arange(bucket_size, dtype=np.uint32))).sum(
        axis=1, keepdims=True, dtype=np.uint32)
    return table, sels, khi, klo, keys[take]


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
