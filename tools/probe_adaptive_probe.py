#!/usr/bin/env python3
"""probe_adaptive's launch shapes and designs against each other, at the
adaptive path's launch size, on one GPU.

    python3 tools/probe_adaptive_probe.py [--parent DIR]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
It prints the card's name and power limit, then builds
``src/repro_torch/csrc/probe_adaptive.cu`` once for each CTA size (its
``kThreads``: 64, 128, 256), and once for each design in ``ALTERNATIVES``
(an edit of the source at fixed anchors, at the kept CTA size: both rows
and both words at once, the two halves of the lazy loads alone, a
persistent grid, the full stash scan), all in parallel, into
``build/probe/`` (ignored by git).
``--parent DIR`` adds a build of ``DIR/probe_adaptive.cu`` (another
commit's ``csrc``, with the same C entry point) as one more design.
For each build it prints its ptxas registers and spills and checks
that it answers as ``probe_adaptive_plain`` does on every call below.

The calls run on a seeded adaptive table like the adaptive path's at its
end: 2^22 buckets of 4 at load 0.7153 (residents in their home buckets,
5% of them on a nonzero selector), its empty 128-slot stash, and:

* 10M absent keys (the path's benign lookups), with the empty stash and
  with all 128 stash slots live;
* the 12M residents (the path's member lookups), with the empty stash;
* 4096 keys, half residents, with the empty stash and without a stash.

The 10M and 12M calls are timed by CUDA events around each launch with the
L2 flushed (a 128 MB write) before each, the device kept behind the host by
a spin kernel; the 4096-key calls by ``torch.profiler`` (the mean over the
launches a trace holds with a device time).  The builds are taken in turns
(forward, then backward) and averaged; beside them the device time of a
one-element add, the launch floor.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "probe"
CHUNK = 4096
NB = 1 << 22
LOAD = 0.7153
BENIGN = 10_000_000
SHAPES = (64, 128, 256)
KEPT = 128
# Designs, as edits of the source: name -> [(text of the source, text put
# in its place)].
HOME_DECL = "  uint4 home = make_uint4(0u, 0u, 0u, 0u);\n"
HOME_LOAD = "    if (kVec) home = __ldg(rows + ks.i1[0]);\n"
ANSWER = ("      ks.h[0] = in_row4(home, sels, i1, fam) ||\n"
          "                in_row4(__ldg(rows + i2), sels, i2, fam);\n")
SCAN = """    for (int s = 0; s < stash_slots && ks.live[0] && !ks.h[0]; ++s)
      ks.h[0] = __ldg(stash + s) == ks.fp[0] &&
                (__ldg(stash + stash_slots + s) == ks.i1[0] ||
                 __ldg(stash + stash_slots + s) == ks.i2[0]);
    if (false && count > 0)"""
WALK = ("    if (count > 0) stash_pf::probe_list(smem, list_cap, count, ks);\n"
        "    // More slots")
STAGE = "  if (stash_slots > 0)\n    count = stash_pf::stage_pass("
TILE = "  const int k = blockIdx.x * kThreads + threadIdx.x;\n"
STORE = "  if (ks.live[0]) hit[k] = ks.h[0] ? 1 : 0;\n"
PERSISTENT = """  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, probe_adaptive_kernel<kVec>, kThreads, smem);
  const int blocks = min((n + kThreads - 1) / kThreads, max(sms * per_sm, 1));
"""
ALTERNATIVES = {
    # One round trip: both rows and both words issued before any compare.
    "both rows and their words at once": [
        (HOME_DECL,
         HOME_DECL[:-2] + ", alt = home;\n  uint32_t w1 = 0u, w2 = 0u;\n"),
        (HOME_LOAD, "    if (kVec) {\n      home = __ldg(rows + ks.i1[0]);\n"
                    "      alt = __ldg(rows + ks.i2[0]);\n"
                    "      w1 = __ldg(sels + ks.i1[0]);\n"
                    "      w2 = __ldg(sels + ks.i2[0]);\n    }\n"),
        (ANSWER, "      ks.h[0] = resolve(match4(home, fam), w1, 4) ||\n"
                 "                resolve(match4(alt, fam), w2, 4);\n")],
    "both rows before any compare": [
        (HOME_DECL, HOME_DECL[:-2] + ", alt = home;\n"),
        (HOME_LOAD, "    if (kVec) {\n      home = __ldg(rows + ks.i1[0]);\n"
                    "      alt = __ldg(rows + ks.i2[0]);\n    }\n"),
        (ANSWER, "      ks.h[0] = in_row4(home, sels, i1, fam) ||\n"
                 "                in_row4(alt, sels, i2, fam);\n")],
    "selector words with every row": [
        (HOME_DECL, HOME_DECL + "  uint32_t w1 = 0u;\n"),
        (HOME_LOAD, "    if (kVec) {\n      home = __ldg(rows + ks.i1[0]);\n"
                    "      w1 = __ldg(sels + ks.i1[0]);\n    }\n"),
        (ANSWER, "      ks.h[0] = resolve(match4(home, fam), w1, 4) ||\n"
                 "                resolve(match4(__ldg(rows + i2), fam),\n"
                 "                        __ldg(sels + i2), 4);\n")],
    # A grid-stride loop over tiles whose CTAs stage a one-pass stash once
    # (a larger stash is restaged, pass 0 first, for every tile).
    "a persistent grid (SMs x resident CTAs)": [
        (TILE, "  for (long long t = blockIdx.x; t * kThreads < n; "
               "t += gridDim.x) {\n"
               "  const int k = (int)(t * kThreads) + threadIdx.x;\n"),
        (STAGE, "  if (stash_slots > 0 && (t == blockIdx.x || "
                "stash_slots > list_cap))\n"
                "    count = stash_pf::stage_pass("),
        (STORE, STORE + "  }\n"),
        ("  const int blocks = (n + kThreads - 1) / kThreads;\n",
         PERSISTENT)],
    "every stash slot scanned by each unanswered key": [
        (WALK, SCAN + WALK[len("    if (count > 0)"):])],
}


def build(parent: Path | None) -> dict:
    """{name: library path} for every shape and design, one nvcc each, all
    at once."""
    from repro_torch.kernels import cuda
    OUT.mkdir(parents=True, exist_ok=True)
    src = (cuda.CSRC / "probe_adaptive.cu").read_text()

    def edit(name, text, edits):
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new, 1)
        return text

    jobs = {}
    for t in SHAPES:
        name = f"threads={t}" + (" (kept)" if t == KEPT else "")
        jobs[name] = (edit(name, src, [
            ("constexpr int kThreads = 128;",
             f"constexpr int kThreads = {t};")]), cuda.CSRC)
    for name, edits in ALTERNATIVES.items():
        jobs[name] = (edit(name, src, edits), cuda.CSRC)
    if parent is not None:
        jobs["parent"] = ((parent / "probe_adaptive.cu").read_text(), parent)
    procs = {}
    for i, (name, (text, inc)) in enumerate(jobs.items()):
        cu = OUT / f"probe_adaptive_{i}.cu"
        cu.write_text(text)
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(inc), "-o",
               str(cu.with_suffix(".so")), str(cu)]
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line]
        spills = [line.strip() for line in log.splitlines() if "spill" in line]
        print(f"   {name}: {' | '.join(regs)}; {' | '.join(spills)}",
              flush=True)
        libs[name] = lib
    return libs


def device_ms(fn, reps: int, symbol: str) -> float:
    """Mean device ms a launch of ``symbol`` over ``reps`` calls of ``fn``
    from a profiler trace (up to six windows until one holds a time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [getattr(ev, "device_time_total", 0.0) or 0.0
                 for ev in prof.events() if symbol in ev.name]
        spans = [us for us in spans if us > 0]
        if spans:
            return sum(spans) / len(spans) / 1e3
    raise RuntimeError(f"no device time for {symbol} in six windows")


def flushed_ms(fn, reps: int, flush) -> float:
    """Mean device ms of ``fn`` by CUDA events around each call, ``flush``
    before each, behind a spin kernel that keeps the device behind the
    host."""
    import torch
    fn()
    torch.cuda.synchronize()
    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s0.record()
    torch.cuda._sleep(400_000_000)
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
        raise RuntimeError(f"enqueueing took {host_ms} ms, longer than the "
                           f"spin")
    return sum(a.elapsed_time(b) for a, b in spans) / reps


def state(rng):
    """The seeded table, selector plane, empty and full stashes, and the
    key sets as (hi, lo) int32 tensors on the card."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels.staging_cases import adaptive_planes, random_keys
    table, sels, _khi, _klo, members = adaptive_planes(
        rng, NB, NB, LOAD, sel_share=0.05)
    members = members[rng.permutation(members.size)]
    benign = random_keys(rng, BENIGN)
    full = np.zeros((2, 128), np.int64)
    full[0] = rng.randint(1, 1 << 16, 128)
    full[1] = rng.randint(0, NB, 128)
    small = np.concatenate([members[: CHUNK // 2], benign[: CHUNK // 2]])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32)
                                .view(np.int32)).cuda()

    def pair(keys):
        return tuple(dev(x) for x in hashing.key_to_u32_pair_np(keys))
    return (dev(table), dev(sels), dev(np.zeros((2, 128))), dev(full),
            {"benign": pair(benign), "members": pair(members),
             "4096": pair(small)})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_adaptive_probe: no CUDA device is available",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="another commit's csrc directory to time beside")
    args = ap.parse_args()
    from repro_torch.kernels import cuda
    from repro_torch.kernels.probe import probe_adaptive_plain
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    fns = {}
    for name, lib in build(args.parent).items():
        fn = getattr(ctypes.CDLL(str(lib)), cuda.KERNELS["probe_adaptive"][1])
        fn.argtypes = cuda.KERNELS["probe_adaptive"][2]
        fn.restype = ctypes.c_int
        fns[name] = fn
    t0 = time.perf_counter()
    table, sels, empty, full, keys = state(np.random.RandomState(0))
    print(f"   seeded state in {time.perf_counter() - t0:.1f} s: "
          f"{keys['members'][0].numel()} residents", flush=True)
    flush_buf = torch.empty(1 << 25, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    hits = {k: torch.empty(v[0].numel(), dtype=torch.bool, device="cuda")
            for k, v in keys.items()}
    calls = {"10M benign, empty stash": ("benign", empty),
             "10M benign, 128 live stash entries": ("benign", full),
             "members, empty stash": ("members", empty),
             "4096 keys, empty stash": ("4096", empty),
             "4096 keys, no stash": ("4096", None)}

    def call(fn, which, st):
        hi, lo = keys[which]
        return lambda: fn(table.data_ptr(), sels.data_ptr(), 4,
                          None if st is None else st.data_ptr(), 128,
                          hi.data_ptr(), lo.data_ptr(),
                          hits[which].data_ptr(), hi.numel(), 16, NB, stream)

    wants = {}
    for label, (which, st) in calls.items():
        hi, lo = keys[which]
        wants[label] = probe_adaptive_plain(table, sels, hi, lo, fp_bits=16,
                                            n_buckets=NB, stash=st)
        print(f"   {label}: {hi.numel()} keys, {int(wants[label].sum())} "
              f"hits", flush=True)
    for name, fn in fns.items():
        for label, (which, st) in calls.items():
            if call(fn, which, st)() != 0:
                raise RuntimeError(f"{name} {label}: launch failed")
            if not torch.equal(hits[which], wants[label]):
                raise RuntimeError(f"{name} {label}: differs from plain")
    del wants
    print("   every build answers as the plain version does", flush=True)
    one = torch.zeros(1, device="cuda")
    times = {(name, c): [] for name in fns for c in calls}
    floor = []
    names = list(fns)
    for order in (names, names[::-1]):
        floor.append(device_ms(lambda: one.add_(1), 50, "elementwise_kernel"))
        for name in order:
            for label, (which, st) in calls.items():
                fn = call(fns[name], which, st)
                times[(name, label)].append(
                    device_ms(fn, 50, "probe_adaptive_kernel")
                    if which == "4096" else flushed_ms(fn, 10,
                                                       flush_buf.zero_))
    print(f"   launch floor (one-element add): {floor} ms (device)",
          flush=True)
    for name in names:
        for label in calls:
            ts = times[(name, label)]
            print(f"   {name} | {label}: {sum(ts) / len(ts)!r} ms ({ts})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
