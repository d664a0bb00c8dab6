"""The schedules of ``csrc/scan.cu`` as numpy models, held against the
sequential walks (``scan_insert_plain`` / ``scan_delete_plain``) on every
``SCAN_CASE``.

Insert: windows of W lanes; every lane of a window speculates on the table
the earlier windows left (its direct placement, or a chain of at most
``CHAIN_STEPS`` evictions through a private overlay, while a small pool of
chain records lasts, and for a direct lane whose i2 is full and whose i1
the earlier lanes of that i1 fill); then the lanes commit in order, 32 at
a time: the prefix of direct lanes with clean rows places from their
empty-slot masks (less the slots earlier lanes of the prefix take), and
the lane that ends it either applies its chain record (its rows clean,
its i1 still full) or walks the live table.  The dirty set is a
deliberately tiny bitmap (rows alias), as the kernel's is above 2^20 rows.

Delete: the lanes grouped by ``kernels/scan.py::delete_groups`` (the sort
the kernel's launch uses), the groups walked in a shuffled order, each
group's lanes in order.
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.kernels import scan
from repro_torch.kernels.staging_cases import SCAN_CASES, scan_inputs

from torch_port_util import t32, u32

pytestmark = pytest.mark.tier1

CHUNK = 32            # the committing warp's lanes
CHAIN_STEPS = 8       # csrc/scan.cu's kChainSteps
MASK_BITS = 15        # csrc/scan.cu's kMaskBits: widest row taken direct
POOL = 4              # chain records a window (the kernel: 256)
MIN_WINDOW = 32       # csrc/scan.cu's kMinWindow: the adaptive window's floor
DIRTY_BITS = 64       # rows of the model's dirty set, aliased mod 64
WINDOWS = (1, 2, 32, 1024)
INSERT_CASES = [k for k, v in SCAN_CASES.items() if v[0] != "delete"]
DELETE_CASES = [k for k, v in SCAN_CASES.items() if v[0] == "delete"]


def _first_empty(row) -> int:
    z = np.flatnonzero(row == 0)
    return int(z[0]) if z.size else -1


class _Dirty:
    def __init__(self, bits):
        self.bits = np.zeros(bits, bool)

    def test(self, row) -> bool:
        return bool(self.bits[row % self.bits.size])

    def mark(self, row) -> None:
        self.bits[row % self.bits.size] = True


def _speculate_chain(t, f, i2, n, max_disp):
    """The chain of a lane whose rows are full, on the snapshot ``t``
    through its own overlay, within the walk's budget -> (rows, values,
    final slot) or None."""
    bs = t.shape[1]
    rows, vals = [], []

    def view(r, j):
        for q in range(len(rows) - 1, -1, -1):
            if rows[q] == r and q % bs == j:
                return vals[q]
        return int(t[r, j])
    i, cur = i2, f
    for step in range(min(CHAIN_STEPS, max_disp)):
        old = view(i, step % bs)
        rows.append(i)
        vals.append(cur)
        cur = old
        i = scan._alt(i, cur, n)
        for j in range(bs):
            if view(i, j) == 0:
                return rows + [i], vals + [cur], j
    return None


def _walk(t, st, f, i1, i2, n, max_disp, dirty):
    """The sequential walk of one lane, marking each row it writes ->
    (ok, spilled)."""
    bs = t.shape[1]
    for r in (i1, i2):
        j = _first_empty(t[r])
        if j >= 0:
            t[r, j] = f
            dirty.mark(r)
            return True, False
    hist, i, cur = [], i2, f
    while len(hist) < max_disp:
        j = len(hist) % bs
        old = int(t[i, j])
        t[i, j] = cur
        dirty.mark(i)
        hist.append(i)
        cur = old
        i = scan._alt(i, cur, n)
        j = _first_empty(t[i])
        if j >= 0:
            t[i, j] = cur
            dirty.mark(i)
            return True, False
    for idx in range(len(hist) - 1, -1, -1):
        bi, bj = hist[idx], idx % bs
        old = int(t[bi, bj])
        t[bi, bj] = cur
        cur = old
    spilled = st is not None and scan._spill(st, f, i2)
    return spilled, spilled


def model_insert(t, st, fp, i1, i2, n, max_disp, window, stats):
    """One shard's lanes through the insert kernel's schedule -> ok."""
    m = len(fp)
    ok = np.zeros(m, bool)
    base, size = 0, window
    while base < m:
        cnt = min(size, m - base)
        lanes = range(base, base + cnt)
        chains = 0
        spec, used = {}, 0
        for k in lanes:                   # speculate: the table only read
            e1 = np.flatnonzero(t[i1[k]] == 0).tolist()
            e2 = np.flatnonzero(t[i2[k]] == 0).tolist()
            if (e1 or e2) and t.shape[1] <= MASK_BITS:
                spec[k] = ("direct", e1, e2)
            elif e1 or e2:
                spec[k] = ("walk",)
            elif used < POOL:
                used += 1
                chains += 1
                rec = _speculate_chain(t, fp[k], i2[k], n, max_disp)
                spec[k] = ("walk",) if rec is None else ("chain", rec)
            else:
                chains += 1
                spec[k] = ("walk",)
        # decide: a direct lane whose i2 is full and whose i1 the earlier
        # lanes of its i1 among its 31 neighbours fill gets a chain record
        stuck = {}
        for k in lanes:
            if spec[k][0] != "direct" or spec[k][2]:
                continue
            rank = sum(i1[y] == i1[k] for y in range(max(base, k - 31), k))
            if rank >= len(spec[k][1]):
                chains += 1
                if used < POOL:
                    used += 1
                    rec = _speculate_chain(t, fp[k], i2[k], n, max_disp)
                    if rec is not None:
                        stuck[k] = rec
        dirty = _Dirty(DIRTY_BITS)
        pos = base
        while pos < base + cnt:
            chunk = range(pos, min(pos + CHUNK, base + cnt))
            prefix = []
            for k in chunk:
                if (spec[k][0] != "direct" or dirty.test(i1[k])
                        or dirty.test(i2[k])):
                    break
                prefix.append(k)
            # in order, from the snapshot's masks less the slots that
            # earlier lanes of the prefix take in the same row
            masks = {k: (set(spec[k][1]), set(spec[k][2])) for k in prefix}
            placed = []
            for x, k in enumerate(prefix):
                m1, m2 = masks[k]
                if not (m1 or m2):
                    break
                row, j = (i1[k], min(m1)) if m1 else (i2[k], min(m2))
                placed.append((k, row, j))
                for later in prefix[x + 1:]:
                    for r, empty in zip((i1[later], i2[later]),
                                        masks[later]):
                        if r == row:
                            empty.discard(j)
            # a run of one i1 that goes on past the chunk waits whole
            cut = False
            if len(placed) == CHUNK and pos + CHUNK < base + cnt:
                run = 0
                while run < CHUNK and i1[pos + CHUNK - 1 - run] == \
                        i1[pos + CHUNK]:
                    run += 1
                if 0 < run < CHUNK:
                    placed, cut = placed[:CHUNK - run], True
            for k, row, j in placed:
                t[row, j] = fp[k]
                dirty.mark(row)
                ok[k] = True
            stats["direct"] += len(placed)
            pos += len(placed)
            if cut or len(placed) == CHUNK or pos == base + cnt:
                continue
            k, s = pos, spec[pos]
            pos += 1
            rec = s[1] if s[0] == "chain" else stuck.get(k)
            if rec is not None:
                rows, vals, jf = rec
                clean = not any(map(dirty.test, rows))
                if clean and (s[0] == "direct" or dirty.test(i1[k])):
                    clean = not (t[i1[k]] == 0).any()    # i1 full, live
                if clean:
                    bs = t.shape[1]
                    for q in range(len(rows) - 1):
                        t[rows[q], q % bs] = vals[q]
                        dirty.mark(rows[q])
                    t[rows[-1], jf] = vals[-1]
                    dirty.mark(rows[-1])
                    ok[k] = True
                    stats["chain"] += 1
                    continue
            stats["walked" if s[0] == "walk" else "dirty"] += 1
            ok[k], spilled = _walk(t, st, fp[k], i1[k], i2[k], n, max_disp,
                                   dirty)
            # a spill with later lanes in its window
            stats["spill_inside"] += spilled and k < base + cnt - 1
        # more chains than records shrink the next window, few grow it
        if chains > POOL:
            size = max(min(window, MIN_WINDOW), cnt * POOL // chains)
        elif 2 * chains <= POOL:
            size = min(window, 2 * size)
        base += cnt
    return ok


_PLAIN = {}


def _plain(label):
    """The sequential walk's tables, stashes and ok of a case (cached)."""
    if label not in _PLAIN:
        tables, stashes, a, b, valid, kw = scan_inputs(label)
        tt = t32(tables)
        st = None if stashes is None else t32(stashes)
        vt = torch.from_numpy(valid)
        if kw["mode"] == "delete":
            ok = scan.scan_delete_plain(tt, t32(a), t32(b), vt,
                                        n_buckets=kw["n_buckets"],
                                        fp_bits=kw["fp_bits"])
        else:
            ok = scan.scan_insert_plain(
                tt, t32(a), t32(b), vt, stashes=st, mode=kw["mode"],
                n_buckets=kw["n_buckets"], fp_bits=kw["fp_bits"],
                max_disp=kw["max_disp"])
        _PLAIN[label] = (u32(tt), None if st is None else u32(st),
                         ok.numpy())
    return _PLAIN[label]


def run_insert_model(label, window):
    tables, stashes, a, b, valid, kw = scan_inputs(label)
    n = kw["n_buckets"]
    stats = collections.Counter()
    ok = np.zeros(valid.shape, bool)
    for s in range(tables.shape[0]):
        lanes = np.flatnonzero(valid[s])
        fp, i1, i2 = scan._lanes(kw["mode"], t32(a[s][lanes]),
                                 t32(b[s][lanes]), n, kw["fp_bits"])
        st = None if stashes is None else stashes[s]
        ok[s, lanes] = model_insert(tables[s], st, fp.tolist(), i1.tolist(),
                                    i2.tolist(), n, kw["max_disp"], window,
                                    stats)
    return tables, stashes, ok, stats


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("label", INSERT_CASES)
def test_insert_schedule_matches_plain(label, window):
    """The window schedule with a tiny dirty set and chain pool leaves
    the tables, stashes and ok mask of the sequential walk."""
    tables, stashes, ok, stats = run_insert_model(label, window)
    want_t, want_st, want_ok = _plain(label)
    np.testing.assert_array_equal(tables, want_t)
    if stashes is not None:
        np.testing.assert_array_equal(stashes, want_st)
    np.testing.assert_array_equal(ok, want_ok)
    assert sum(stats[k] for k in scan.SCHEDULE_FIELDS) == int(
        scan_inputs(label)[4].sum())


def model_delete(label, seed):
    """The delete kernel's schedule: ``delete_groups``' groups in a
    shuffled order, each group's lanes in order -> (tables, ok, groups)."""
    tables, _st, a, b, valid, kw = scan_inputs(label)
    n, fp_bits = kw["n_buckets"], kw["fp_bits"]
    idx, _off, hi_c, lo_c, keys, perm = scan.delete_groups(
        t32(a), t32(b), torch.from_numpy(valid), n_buckets=n,
        fp_bits=fp_bits)
    keys, perm = keys.numpy(), perm.numpy()
    starts = np.r_[0, np.flatnonzero(keys[1:] != keys[:-1]) + 1]
    ends = np.r_[starts[1:], keys.size]
    fp, i1, i2 = scan._lanes("key", hi_c, lo_c, n, fp_bits)
    shard = idx[:, 0].numpy()
    ok = np.zeros(valid.shape, bool)
    rng = np.random.RandomState(seed)
    for g in rng.permutation(starts.size):
        for q in range(starts[g], ends[g]):
            k = perm[q]
            t = tables[shard[k]]
            for i in (i1[k], i2[k]):
                hit = np.flatnonzero(t[i] == fp[k])
                if hit.size:
                    t[i, hit[0]] = 0
                    ok[idx[k, 0], idx[k, 1]] = True
                    break
    return tables, ok, (shard, fp, np.minimum(i1, i2), perm, starts, ends)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("label", DELETE_CASES)
def test_delete_groups_match_plain(label, seed):
    """Conflict groups walked in any order leave the sequential walk's
    tables and ok mask; every conflict key's lanes form one group, in lane
    order."""
    tables, ok, (shard, fp, low, perm, starts, ends) = model_delete(label,
                                                                   seed)
    want_t, _st, want_ok = _plain(label)
    np.testing.assert_array_equal(tables, want_t)
    np.testing.assert_array_equal(ok, want_ok)
    group = np.empty(perm.size, np.int64)
    for g, (s, e) in enumerate(zip(starts, ends)):
        group[perm[s:e]] = g
        assert (np.diff(perm[s:e]) > 0).all(), "a group out of lane order"
    seen = {}
    for k in range(perm.size):
        key = (int(shard[k]), int(fp[k]), int(low[k]))
        assert seen.setdefault(key, group[k]) == group[k], \
            f"{label}: lanes of one conflict key in two groups"


def test_scan_cases_hit_the_schedules():
    """The cases reach every branch of both schedules: direct lanes taken,
    chain records applied, lanes walked because a row was dirty or as
    chains, spills inside a window, self-pairs, deletes of one fingerprint
    whose home is another lane's alternate, absent keys and repeats."""
    total = collections.Counter()
    for label in INSERT_CASES:
        total.update(run_insert_model(label, 32)[3])
    assert all(total[k] > 0 for k in ("direct", "chain", "dirty", "walked"))
    _t, _st, _ok, crowded = run_insert_model("pair-crowded", 1024)
    assert crowded["dirty"] > crowded["direct"], "speculations mostly dirty"
    assert run_insert_model("key-spill-window", 32)[3]["spill_inside"] > 0
    assert SCAN_CASES["pair-windows"][6] > 2 * 1024, "two windows and more"
    windows = run_insert_model("pair-windows", 1024)[3]
    assert windows["chain"] + windows["walked"] + windows["dirty"] > 0
    for label in ("key-tiny-n", "pair-self-bs2", "delete-fp4"):
        tables, stashes, a, b, valid, kw = scan_inputs(label)
        mode = "key" if kw["mode"] == "delete" else kw["mode"]
        fp, i1, i2 = scan._lanes(mode, t32(a.reshape(-1)),
                                 t32(b.reshape(-1)), kw["n_buckets"],
                                 kw["fp_bits"])
        assert (i1[valid.reshape(-1)] == i2[valid.reshape(-1)]).any(), \
            f"{label}: no self-pair"
    tables, _st, a, b, valid, kw = scan_inputs("delete-fp4")
    fp, i1, i2 = scan._lanes("key", t32(a[0]), t32(b[0]), kw["n_buckets"],
                             kw["fp_bits"])
    home = {(int(f), int(h)) for f, h, g in zip(fp, i1, i2) if h != g}
    assert any((int(f), int(g)) in home for f, h, g in zip(fp, i1, i2)
               if h != g), "no fingerprint whose home is another's alternate"
    for label in DELETE_CASES:
        _t, _st, want_ok = _plain(label)
        assert not want_ok[scan_inputs(label)[4]].all(), \
            f"{label}: every delete found its key (no absent or repeat)"
