#!/usr/bin/env python3
"""scan_insert's and scan_delete's designs against each other and against
another commit's ``scan.cu``, at the launch shapes of the sharded node's
phase (``chip_smoke.py`` 5f), on one GPU.

    python3 tools/scan_probe.py --export-parent DIR [--rev REV]
    python3 tools/scan_probe.py [--parent DIR] [--json PATH] [--scale K]

The first form runs where the git repository is (no GPU needed): it writes
``src/repro_torch/csrc/scan.cu`` and every ``*.cuh`` of commit REV (default
HEAD) into DIR, a directory under ``build/`` (ignored by git), so that a
copy of the checkout without ``.git`` can build them.

The second runs from the root of a checkout on a machine with an NVIDIA GPU
and nvcc.  It prints the card's name and power limit, then builds, all in
parallel into ``build/scan_probe/``, ``scan.cu`` as it is and each
design of ``DESIGNS`` (edits of the source at fixed anchors: CTA sizes,
chain speculation off or longer, twice the chain records, the window kept
at W, the commit inlined; an anchor the source no longer holds stops the
tool), with ``--parent DIR`` the parent's ``scan.cu`` (its own C entry
points: no window, no grouping), and ``SECTIONS``: the kept source with
clock64() counters at fixed anchors (cycles a lane speculating and
committing, and a 32-lane step of the commit; held bit for bit, not
timed).  It prints each build's ptxas registers and spills.

The launches are those of phase 5f, from seeded inputs of its sizes and
loads (2 shards of 2^20 buckets of 4 at load 0.75, fp_bits 16, 128-slot
stashes), made by the port's own code with each ``scan_insert`` call of
interest captured: the split 2 -> 4's receive walk (``split_state``, 4
shards, 2 walking), the merge 4 -> 2's (``merge_state``, 2 of 4 shards
walking, after 2^19 more keys were written to the 4 shards in routed
waves, as phase 5f's parked stream is), the scan backend's key-mode
residue (``bulk_insert_hybrid`` of a 2^17-key wave into a shard at load
0.72) and a delete of 2^19 resident keys from a shard at load 0.75.
``--scale K`` divides the buckets and keys by K (a quick run).

Each build and window is held bit for bit (tables, stashes, ok) against
the plain version before it is timed; the kept build also reports its
schedule counts (``kernels/scan.py::SCHEDULE_FIELDS``) at each window and
the delete's group count.  Times are CUDA events around each launch alone
(the lanes compacted and, for the delete, grouped beforehand), the tables
restored and the L2 flushed (a 128 MB read) before each, the device kept
behind the host by a spin kernel; the builds are taken in turns, forward
then backward, and averaged.  The delete's grouping
(``kernels/scan.py::delete_groups``) is timed apart, and its device time
by op printed from a profiler trace.  With ``--json PATH`` every reading
also goes to PATH as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "scan_probe"
NB = 1 << 20
FP_BITS = 16
LOAD = 0.75
RESIDUE_LOAD = 0.72
RESIDUE_KEYS = 1 << 17
DELETE_KEYS = 1 << 19
PARKED_KEYS = 1 << 19       # written between the split and the merge
WAVE = 1 << 18
STASH_SLOTS = 128
REPS = 3
# design -> edits (anchor, replacement) of the source; "kept" is scan.cu as
# it is.
THREADS = "constexpr int kThreads = 1024;"
DESIGNS = {"kept": [],
           "256 threads": [(THREADS, "constexpr int kThreads = 256;")],
           "512 threads": [(THREADS, "constexpr int kThreads = 512;")],
           "no chain speculation": [(
               "    const int r = atomicAdd(next, 1);\n",
               "    const int r = kChainPool;\n")],
           "chains of 16 steps": [(
               "constexpr int kChainSteps = 8;",
               "constexpr int kChainSteps = 16;")],
           "512 chain records": [(
               "constexpr int kChainPool = 256;",
               "constexpr int kChainPool = 512;")],
           "fixed window": [("        const int chains = chain_next;\n",
                             "        const int chains = 0;\n")],
           "commit inlined": [("__device__ void commit_window(",
                               "__device__ __forceinline__ void "
                               "commit_window(")]}
WINDOWS = (256, 512, 1024, 2048, 4096)
# "sections": the kept source timed by clock64() at fixed anchors (a
# moved anchor stops the tool: update SECTIONS with the source).  Its
# stats buffer holds 8 counters: the four schedule counts, then cycles
# from a window's first barrier to its commit (speculation, thread 0),
# cycles of the commit, of the commit's single-lane part (chain records
# and walks), the commit's 32-lane steps, and the steps' cycles in four
# parts: lane loads and dirty tests, reading the decided placements, the
# placement, the stores and marks.  Speculation's cycles include the
# decide step.
PRE_LINE = ("    const int pre = w < cnt ? s_pre[w] & ((1 << kPreRec) - 1) "
            ": kPreStuck;\n")
SECTIONS = [
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long* g_prof;\n"),
    ("    const int cnt = (int)min((long long)window, last - base);\n",
     "    const int cnt = (int)min((long long)window, last - base);\n"
     "    const long long t_spec = clock64();\n"),
    ("    __syncthreads();\n    if (tid < 32) {\n      commit_window(",
     "    __syncthreads();\n    if (stats && tid == 0) {\n"
     "      g_prof = stats;\n"
     "      atomicAdd(stats + 4, (unsigned long long)(clock64() - t_spec));\n"
     "    }\n    const long long t_commit = clock64();\n"
     "    if (tid < 32) {\n      commit_window("),
    ("    base += cnt;\n",
     "    if (stats && tid == 0)\n"
     "      atomicAdd(stats + 5,\n"
     "                (unsigned long long)(clock64() - t_commit));\n"
     "    base += cnt;\n"),
    ("    if (cut || take == 32 || pos >= cnt) continue;\n",
     "    if (lane == 0 && g_prof) atomicAdd(g_prof + 7, 1ull);\n"
     "    if (cut || take == 32 || pos >= cnt) continue;\n"
     "    const long long t_one = clock64();\n"),
    ("    __syncwarp();\n    pos += 1;\n",
     "    __syncwarp();\n    if (lane == 0 && g_prof)\n"
     "      atomicAdd(g_prof + 6, (unsigned long long)(clock64() - t_one));\n"
     "    pos += 1;\n"),
    ("    const int w = pos + lane;\n",
     "    const long long t_step = clock64();\n"
     "    const int w = pos + lane;\n"),
    (PRE_LINE, "    const long long t_pairs = clock64();\n" + PRE_LINE),
    ("    uint32_t row = kFull;\n",
     "    const long long t_place = clock64();\n"
     "    uint32_t row = kFull;\n"),
    ("    if (lane < take) {\n",
     "    const long long t_store = clock64();\n"
     "    if (lane < take) {\n"),
    ("    n_direct += take;\n",
     "    if (lane == 0 && g_prof) {\n"
     "      atomicAdd(g_prof + 8, (unsigned long long)(t_pairs - t_step));\n"
     "      atomicAdd(g_prof + 9, (unsigned long long)(t_place - t_pairs));\n"
     "      atomicAdd(g_prof + 10, (unsigned long long)(t_store - t_place));\n"
     "      atomicAdd(g_prof + 11,\n"
     "                (unsigned long long)(clock64() - t_store));\n"
     "    }\n"
     "    n_direct += take;\n"),
]
SECTION_NAMES = ("speculate_cycles", "commit_cycles", "one_lane_cycles",
                 "steps", "load_test_cycles", "decision_read_cycles",
                 "place_cycles", "store_cycles")
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# The parent's C entry points (one thread a shard).
PARENT_ARGTYPES = {
    "scan_insert": [_P, _I, _I, _U, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                    _P],
    "scan_delete": [_P, _I, _I, _U, _P, _P, _P, _P, _I, _I, _P]}


def export_parent(dest: Path, rev: str) -> None:
    """Write rev's scan.cu and headers into ``dest``."""
    dest.mkdir(parents=True, exist_ok=True)
    csrc = "src/repro_torch/csrc"
    names = subprocess.run(["git", "ls-tree", "--name-only", f"{rev}:{csrc}"],
                           cwd=ROOT, check=True, capture_output=True,
                           text=True).stdout.split()
    for name in names:
        if name.endswith(".cuh") or name == "scan.cu":
            (dest / name).write_bytes(subprocess.run(
                ["git", "show", f"{rev}:{csrc}/{name}"], cwd=ROOT,
                check=True, capture_output=True).stdout)
            print(f"{rev}:{csrc}/{name} -> {dest / name}")


def build(parent: Path | None) -> dict:
    """{design: library path}, one nvcc each, all at once; prints each
    build's ptxas registers and spills."""
    from repro_torch.kernels import cuda
    OUT.mkdir(parents=True, exist_ok=True)
    source = (cuda.CSRC / "scan.cu").read_text()

    def edited(name, edits):
        text = source
        for anchor, repl in edits:
            if text.count(anchor) != 1:
                raise RuntimeError(f"{name}: anchor {anchor!r} is not in "
                                   f"scan.cu once: update its edits")
            text = text.replace(anchor, repl)
        path = OUT / f"scan_{name.replace(' ', '_')}.cu"
        path.write_text(text)
        return path
    jobs = {}
    for name, edits in {**DESIGNS, "sections": SECTIONS}.items():
        jobs[name] = edited(name, edits) if edits else cuda.CSRC / "scan.cu"
    if parent is not None:
        jobs["parent"] = parent / "scan.cu"
    procs = {}
    for i, (name, src) in enumerate(jobs.items()):
        lib = OUT / f"scan_{i}.so"
        inc = parent if name == "parent" else cuda.CSRC
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(inc), "-o",
               str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line]
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line})
        print(f"   {name}: {' | '.join(regs)}; {' | '.join(spills)}",
              flush=True)
        libs[name] = lib
    return libs


def _fill(table, hi, lo, n_buckets):
    """Place keys home bucket else alternate, in order, into a zero uint32
    [n_buckets, 4] table (each key in its bucket's next free slot) -> the
    placed keys' mask."""
    from repro_torch.core import hashing
    fp = hashing.fingerprint_np(hi, lo, FP_BITS)
    i1 = hashing.index_hash_np(hi, lo, n_buckets)
    i2 = hashing.alt_index_np(i1, fp, n_buckets)

    def ranks(v):
        order = np.argsort(v, kind="stable")
        s = v[order]
        start = np.r_[0, np.nonzero(s[1:] != s[:-1])[0] + 1]
        first = np.repeat(start, np.diff(np.r_[start, s.size]))
        r = np.empty(v.size, np.int64)
        r[order] = np.arange(v.size) - first
        return r
    r1 = ranks(i1)
    home = r1 < 4
    table[i1[home], r1[home]] = fp[home]
    rest = np.nonzero(~home)[0]
    r2 = ranks(i2[rest]) + np.minimum(np.bincount(i1, minlength=n_buckets),
                                      4)[i2[rest]]
    alt = r2 < 4
    table[i2[rest[alt]], r2[alt]] = fp[rest[alt]]
    placed = home.copy()
    placed[rest[alt]] = True
    return placed


def launch_inputs(nb: int, device) -> dict:
    """{launch: (tables, stashes or None, a, b, valid, kwargs)} of phase
    5f's four launch shapes at ``nb`` buckets a shard, built by the port's
    own split, merge, hybrid insert and the delete's inputs."""
    import torch
    from repro_torch.core import distributed as dist
    from repro_torch.core import filter as tfilter
    from repro_torch.core import hashing
    from repro_torch.distributed import elastic
    from repro_torch.kernels.staging_cases import random_keys
    rng = np.random.RandomState(25)
    captured = {}

    def spy(module, label):
        fn = getattr(module, "scan_insert")

        def wrapped(tables, a, b, **kw):
            valid = kw["valid"]
            if label not in captured or int(valid.sum()) > int(
                    captured[label][4].sum()):
                st = kw.get("stashes")
                captured[label] = (tables.clone(), None if st is None
                                   else st.clone(), a.clone(), b.clone(),
                                   valid.clone(),
                                   {k: kw[k] for k in ("n_buckets", "mode",
                                                       "fp_bits",
                                                       "max_disp")
                                    if k in kw})
            return fn(tables, a, b, **kw)
        setattr(module, "scan_insert", wrapped)
        return fn

    # two shards at load 0.75, each key on its pair owner's shard
    keys = random_keys(rng, int(2 * nb * 4 * LOAD * 1.3))
    hi, lo = hashing.key_to_u32_pair_np(keys)
    owner = hashing.owner_shard_key_pair_np(hi, lo, nb, FP_BITS, 2)
    state = dist.make_sharded_state(2, nb, 4, stash_slots=STASH_SLOTS,
                                    device=device)
    tables = np.zeros((2, nb, 4), np.uint32)
    for s in range(2):
        mine = np.flatnonzero(owner == s)[:int(nb * 4 * LOAD)]
        _fill(tables[s], hi[mine], lo[mine], nb)
    state = state._replace(table_parts=(torch.from_numpy(
        tables.view(np.int32)).to(device),))
    mesh4 = elastic.filter_mesh(4, device=device)
    fn = spy(elastic, "split")
    try:
        split, _rep = elastic.split_state(mesh4, "data", state)
        elastic.scan_insert = fn
        # the keys parked during the split, written to the 4 shards
        keys = random_keys(rng, PARKED_KEYS)
        hi, lo = hashing.key_to_u32_pair_np(keys)
        for s in range(0, keys.size, WAVE):
            split, ok, _dfr, _ov = dist.distributed_insert(
                mesh4, "data", split,
                torch.from_numpy(hi[s:s + WAVE].view(np.int32)).to(device),
                torch.from_numpy(lo[s:s + WAVE].view(np.int32)).to(device),
                fp_bits=FP_BITS, backend="cuda", route="pair",
                capacity_factor=4.0)
        spy(elastic, "merge")
        elastic.merge_state(mesh4, "data", split)
    finally:
        elastic.scan_insert = fn
    # the scan backend's residue: a 2^17-key wave into a shard at 0.72
    table = np.zeros((nb, 4), np.uint32)
    keys = random_keys(rng, int(nb * 4 * RESIDUE_LOAD * 1.2) + RESIDUE_KEYS)
    hi, lo = hashing.key_to_u32_pair_np(keys)
    fill = int(nb * 4 * RESIDUE_LOAD)
    _fill(table, hi[:fill], lo[:fill], nb)
    wave = slice(keys.size - RESIDUE_KEYS, keys.size)
    fn = spy(tfilter, "key")
    try:
        tfilter.bulk_insert_hybrid(
            tfilter.table_state(torch.from_numpy(table.view(np.int32)).to(
                device), nb),
            torch.from_numpy(hi[wave].view(np.int32)).to(device),
            torch.from_numpy(lo[wave].view(np.int32)).to(device),
            fp_bits=FP_BITS)
    finally:
        tfilter.scan_insert = fn
    # a delete of 2^19 resident keys from a shard at load 0.75
    table = np.zeros((nb, 4), np.uint32)
    keys = random_keys(rng, int(nb * 4 * LOAD * 1.2))
    hi, lo = hashing.key_to_u32_pair_np(keys)
    placed = np.flatnonzero(_fill(table, hi, lo, nb))
    pick = rng.permutation(placed)[:min(DELETE_KEYS, placed.size)]
    t = torch.from_numpy(table.view(np.int32)).to(device)
    dh = torch.from_numpy(hi[pick].view(np.int32)).to(device)
    dl = torch.from_numpy(lo[pick].view(np.int32)).to(device)
    captured["delete"] = (t[None], None, dh[None], dl[None],
                          torch.ones((1, pick.size), dtype=torch.bool,
                                     device=device),
                          {"n_buckets": nb, "mode": "delete",
                           "fp_bits": FP_BITS})
    for label, (tb, st, a, b, v, kw) in captured.items():
        if tb.dim() == 2:       # one table: one shard
            captured[label] = (tb[None], None if st is None else st[None],
                               a[None], b[None], v[None], kw)
    return captured


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="another commit's csrc directory to time beside")
    ap.add_argument("--export-parent", type=Path, default=None,
                    help="write REV's sources into this directory and stop")
    ap.add_argument("--rev", default="HEAD")
    ap.add_argument("--json", type=Path, default=None,
                    help="write every reading to this file as JSON")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide the buckets and keys by this")
    args = ap.parse_args()
    if args.export_parent is not None:
        export_parent(args.export_parent, args.rev)
        return 0
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda, scan
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    global RESIDUE_KEYS, DELETE_KEYS, PARKED_KEYS
    RESIDUE_KEYS //= args.scale
    DELETE_KEYS //= args.scale
    PARKED_KEYS //= args.scale
    nb = NB // args.scale
    fns = {}
    for name, lib in build(args.parent).items():
        so = ctypes.CDLL(str(lib))
        for kern in ("scan_insert", "scan_delete"):
            fn = getattr(so, cuda.KERNELS[kern][1])
            fn.argtypes = (PARENT_ARGTYPES[kern] if name == "parent"
                           else cuda.KERNELS[kern][2])
            fn.restype = ctypes.c_int
            fns[(name, kern)] = fn
    cuda.build_all(["scan_insert"])
    t0 = time.perf_counter()
    launches = launch_inputs(nb, "cuda")
    torch.cuda.synchronize()
    print(f"   inputs built in {time.perf_counter() - t0:.1f} s", flush=True)
    flush_buf = torch.ones(1 << 25, dtype=torch.int32, device="cuda")
    sink = torch.zeros((), dtype=torch.int64, device="cuda")

    def flush():
        torch.sum(flush_buf, 0, dtype=torch.int64, out=sink)
    stream = torch.cuda.current_stream().cuda_stream
    readings = []
    for label, (tables0, stashes0, a, b, valid, kw) in launches.items():
        kind = "scan_delete" if kw["mode"] == "delete" else "scan_insert"
        tables = tables0.clone()
        stashes = None if stashes0 is None else stashes0.clone()

        def restore():
            tables.copy_(tables0)
            if stashes is not None:
                stashes.copy_(stashes0)
        restore()
        t_plain = time.perf_counter()
        if kind == "scan_delete":
            ok = scan.scan_delete_plain(tables, a, b, valid,
                                        n_buckets=kw["n_buckets"],
                                        fp_bits=kw["fp_bits"])
        else:
            ok = scan.scan_insert_plain(tables, a, b, valid,
                                        stashes=stashes, mode=kw["mode"],
                                        n_buckets=kw["n_buckets"],
                                        fp_bits=kw.get("fp_bits"),
                                        max_disp=kw["max_disp"])
        plain_s = time.perf_counter() - t_plain
        want = [tables.clone(), None if stashes is None else stashes.clone(),
                ok.clone()]
        walked = int(valid.sum())
        idx, offsets, (a_c, b_c) = scan._compact(valid, a, b)
        groups = None
        if kind == "scan_delete":
            g = scan.delete_groups(a, b, valid, n_buckets=kw["n_buckets"],
                                   fp_bits=kw["fp_bits"])
            keys, perm = g[4], g[5]
            groups = int((keys[1:] != keys[:-1]).sum()) + 1
        ok_c = torch.zeros(walked, dtype=torch.bool, device="cuda")
        print(f"   {label}: {tables.shape[0]} shards, {walked} walked lanes "
              f"of {valid.numel()}; plain walk {plain_s:.1f} s"
              + ("" if groups is None else f"; {groups} conflict groups"),
              flush=True)

        def runner(design, window, stats=None):
            fn = fns[(design, kind)]
            ts = (tables.data_ptr(), tables.shape[1], tables.shape[2],
                  kw["n_buckets"])
            if kind == "scan_insert":
                head = (*ts, cuda.ptr(stashes),
                        0 if stashes is None else stashes.shape[2],
                        a_c.data_ptr(), b_c.data_ptr(), offsets.data_ptr(),
                        ok_c.data_ptr(), tables.shape[0],
                        scan.MODES.index(kw["mode"]),
                        int(kw.get("fp_bits") or 0), kw["max_disp"])
                tail = () if design == "parent" else (window, cuda.ptr(stats))
                return lambda: fn(*head, *tail, stream)
            if design == "parent":
                return lambda: fn(*ts, a_c.data_ptr(), b_c.data_ptr(),
                                  offsets.data_ptr(), ok_c.data_ptr(),
                                  tables.shape[0], kw["fp_bits"], stream)
            return lambda: fn(*ts, a_c.data_ptr(), b_c.data_ptr(),
                              offsets.data_ptr(), tables.shape[0],
                              keys.data_ptr(), perm.data_ptr(), walked,
                              ok_c.data_ptr(), kw["fp_bits"], stream)

        configs = [(d, scan.DEFAULT_WINDOW) for d in fns_designs(fns)
                   if d != "sections" or kind == "scan_insert"]
        if kind == "scan_insert":
            configs += [("kept", w) for w in WINDOWS
                        if w != scan.DEFAULT_WINDOW]
        else:
            configs = [(d, 0) for d in ("kept", "parent")
                       if (d, kind) in fns]
        shares = {}
        for design, window in configs:
            restore()
            ok_c.zero_()
            stats = torch.zeros(12, dtype=torch.int64, device="cuda")
            err = runner(design, window, stats)()
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"{label} {design} W={window}: cudaError "
                                   f"{err}")
            got_ok = torch.zeros_like(ok)
            got_ok[idx[:, 0], idx[:, 1]] = ok_c
            same = torch.equal(tables, want[0]) and torch.equal(
                got_ok, want[2]) and (stashes is None
                                      or torch.equal(stashes, want[1]))
            if not same:
                raise RuntimeError(f"{label} {design} W={window}: differs "
                                   f"from the plain version")
            if design == "kept" and kind == "scan_insert":
                shares[window] = dict(zip(scan.SCHEDULE_FIELDS,
                                          stats.tolist()))
            if design == "sections" and kind == "scan_insert":
                sec = dict(zip(SECTION_NAMES, stats.tolist()[4:]))
                lane = {k: sec[k] / walked for k in (
                    "speculate_cycles", "commit_cycles", "one_lane_cycles")}
                step = {k: sec[k] / max(sec["steps"], 1) for k in (
                    "commit_cycles", "load_test_cycles",
                    "decision_read_cycles", "place_cycles", "store_cycles")}
                print(f"   {label} | sections (clock64, W={window}): "
                      f"{sec}; a lane: {lane}; a step: {step}", flush=True)
                readings.append(dict(launch=label, design="sections",
                                     window=window, **sec, card=card))
        print(f"   {label}: every build and window equals the plain "
              f"version bit for bit", flush=True)
        configs = [c for c in configs if c[0] != "sections"]
        times = {c: [] for c in configs}
        for order in (configs, configs[::-1]):
            for design, window in order:
                times[(design, window)] += timed(runner(design, window),
                                                 restore, flush)
        group_ms = None
        if kind == "scan_delete":
            group_ms = timed(lambda: scan.delete_groups(
                a, b, valid, n_buckets=kw["n_buckets"],
                fp_bits=kw["fp_bits"]), None, flush)
            group_ms = sum(group_ms) / len(group_ms)
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                scan.delete_groups(a, b, valid, n_buckets=kw["n_buckets"],
                                   fp_bits=kw["fp_bits"])
                torch.cuda.synchronize()
            print(prof.key_averages().table(
                sort_by="device_time_total", row_limit=12), flush=True)
        for (design, window), spans in times.items():
            ms = sum(spans) / len(spans)
            row = dict(launch=label, kernel=kind, design=design,
                       window=window, ms=ms, lanes=walked,
                       us_per_lane=ms * 1e3 / max(walked, 1),
                       shards=tables.shape[0], spans=spans,
                       schedule=shares.get(window) if design == "kept"
                       else None, groups=groups, group_ms=group_ms,
                       plain_s=plain_s, card=card)
            readings.append(row)
            extra = ""
            if row["schedule"]:
                extra = "; " + ", ".join(
                    f"{k} {v / max(walked, 1):.4f}"
                    for k, v in row["schedule"].items())
            if group_ms is not None:
                extra = f"; grouping {group_ms!r} ms, {groups} groups"
            print(f"   {label} | {design} | W={window}: {ms!r} ms "
                  f"({row['us_per_lane']!r} us a lane){extra}", flush=True)
        del tables, stashes, ok_c
        torch.cuda.empty_cache()
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card,
                                         "readings": readings}, indent=1))
    return 0


def fns_designs(fns) -> list:
    """The built designs, the kept one first."""
    return list(dict.fromkeys(d for d, _k in fns))


def timed(fn, restore, flush, reps: int = REPS) -> list:
    """Device ms of each of ``reps`` calls of ``fn`` by CUDA events around
    the call alone, ``restore`` and ``flush`` before each, the device kept
    behind the host by a spin kernel."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    spans = []
    for _ in range(reps):
        if restore:
            restore()
        flush()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        spans.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in spans]


if __name__ == "__main__":
    sys.exit(main())
