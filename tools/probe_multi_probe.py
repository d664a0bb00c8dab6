#!/usr/bin/env python3
"""probe_multi's launch shapes and lost designs against each other, on one
GPU.

    python3 tools/probe_multi_probe.py

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
It prints the card's name and power limit, then builds
``src/repro_torch/csrc/probe_multi.cu`` once for each CTA size (its
``kThreads``: 64, 128, 256) and keys a thread (``kKeys``: 1, 2), and once
for each design in ``ALTERNATIVES`` (an edit of the source with
``stash_prefilter.cuh`` inlined, at its own shape), all in parallel, into
``build/probe/`` (ignored by git).  For each build it prints its ptxas
registers and spills, checks that it answers as ``probe_multi_plain`` does,
and times 4096-key calls on a seeded ring like the streaming path's at its
end: four generations of 2^20 buckets of 4 at loads 0.85, 0.85, 0.85 and
0.4, 24 live entries in each 128-slot stash, half the keys held (planted
in a random generation's home or alternate bucket), half absent.  The
calls: the four generations with their stashes, without, with every stash
slot full (512 entries), and the newest generation with and without its
stash.  Times are device ms a launch from ``torch.profiler`` (the mean over
the launches a trace holds with a device time), the builds taken in turns
(forward, then backward) and averaged; beside them the device time of a
one-element add, the launch floor.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "probe"
CHUNK = 4096
BUF = 1 << 20
SHAPES = [(t, k) for t in (64, 128, 256) for k in (1, 2)]
# Designs that lost, as edits of the source: name -> [(text of the source,
# text put in its place)].  A lane that walks the list alone (the first
# version) keeps the rest of the kernel; the warp's walk never runs.
LONE_WALK = """    if (want) {
      bool h = false;
      for (int s = 0; s < count && !h; ++s)
        h = list_fp[s] == ks.fp[q] &&
            (list_bkt[s] == ks.i1[q] || list_bkt[s] == ks.i2[q]);
      ks.h[q] = h;
    }
    for (uint32_t walkers = 0u; walkers;
"""
ALTERNATIVES = {
    "an atomic a staged entry": [(
        "    uint32_t live[kBatch];", "#if 0\n    uint32_t live[kBatch];"),
        ("      at += __popc(live[i]);\n    }\n", """      at += __popc(live[i]);
    }
#endif
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const uint32_t live = __ballot_sync(~0u, f[i] != 0);
      int at = 0;
      if (lane == 0 && live) at = atomicAdd(count, __popc(live));
      at = __shfl_sync(~0u, at, 0);
      if (f[i]) {
        const int p = at + __popc(live & lt);
        list_fp[p] = f[i];
        list_bkt[p] = b[i];
      }
    }
""")],
    "the stash staged before the bucket loads": [
        ("  Group gr;\n  issue<kVec>(gr, rest, tables, stride, ks);\n",
         "  Group gr;\n"),
        ("  }\n\n  compare<kVec>(gr, bucket_size, ks);\n",
         "  }\n\n  issue<kVec>(gr, rest, tables, stride, ks);\n"
         "  compare<kVec>(gr, bucket_size, ks);\n")],
    "each lane walks the list alone": [
        ("    for (uint32_t walkers = __ballot_sync(~0u, want); walkers;\n",
         LONE_WALK)],
}


def build() -> dict:
    """{name: library path} for every shape and alternative, one nvcc
    each, all at once."""
    from repro_torch.kernels import cuda
    OUT.mkdir(parents=True, exist_ok=True)
    # The prefilter's header inlined, so that the designs can edit it too.
    header = (cuda.CSRC / "stash_prefilter.cuh").read_text().replace(
        "#pragma once\n", "")
    src = (cuda.CSRC / "probe_multi.cu").read_text().replace(
        '#include "stash_prefilter.cuh"\n', header)

    def edit(name, text, edits):
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new, 1)
        return text

    jobs = {}
    for t, k in SHAPES:
        name = f"threads={t} keys={k}"
        jobs[name] = edit(name, src, [
            ("constexpr int kThreads = 128;", f"constexpr int kThreads = {t};"),
            ("constexpr int kKeys = 1;", f"constexpr int kKeys = {k};")])
    for name, edits in ALTERNATIVES.items():
        jobs[name] = edit(name, src, edits)
    procs = {}
    for i, (name, text) in enumerate(jobs.items()):
        cu = OUT / f"probe_multi_{i}.cu"
        cu.write_text(text)
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o",
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


def ring(rng):
    """The seeded ring: tables, stashes with 24 entries each, full
    stashes, and the probe keys' (hi, lo) as int32 tensors on the card."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels.staging_cases import random_keys
    loads = (0.85, 0.85, 0.85, 0.4)
    tables = np.where(rng.rand(4, BUF, 4) < np.array(loads)[:, None, None],
                      rng.randint(1, 1 << 16, size=(4, BUF, 4)), 0)
    keys = random_keys(rng, CHUNK)
    hi, lo = hashing.key_to_u32_pair_np(keys)
    fp = hashing.fingerprint_np(hi, lo, 16)
    i1 = hashing.index_hash_np(hi, lo, BUF)
    i2 = hashing.alt_index_np(i1, fp, BUF)
    held = np.arange(CHUNK // 2)
    tables[rng.randint(0, 4, held.size),
           np.where(rng.rand(held.size) < 0.5, i1[held], i2[held]),
           rng.randint(0, 4, held.size)] = fp[held]
    full = np.zeros((4, 2, 128), np.int64)
    full[:, 0] = rng.randint(1, 1 << 16, size=(4, 128))
    full[:, 1] = rng.randint(0, BUF, size=(4, 128))
    some = full.copy()
    some[:, :, 24:] = 0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32)
                                .view(np.int32)).cuda()
    return dev(tables), dev(some), dev(full), dev(hi), dev(lo)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_multi_probe: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda
    from repro_torch.kernels.probe import probe_multi_plain
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    fns = {}
    for name, lib in build().items():
        fn = getattr(ctypes.CDLL(str(lib)), cuda.KERNELS["probe_multi"][1])
        fn.argtypes, fn.restype = cuda.KERNELS["probe_multi"][2], ctypes.c_int
        fns[name] = fn
    tables, some, full, hi, lo = ring(np.random.RandomState(0))
    hit = torch.empty(CHUNK, dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    calls = {"K=4, 96 stash entries": (some, 0b1111),
             "K=4, no stashes": (None, 0b1111),
             "K=4, 512 stash entries": (full, 0b1111),
             "K=1, stash": (some, 0b1000),
             "K=1, no stash": (None, 0b1000)}

    def call(fn, st, mask):
        return lambda: fn(tables.data_ptr(), 4, mask, BUF, 4,
                          None if st is None else st.data_ptr(), 128,
                          hi.data_ptr(), lo.data_ptr(), hit.data_ptr(),
                          CHUNK, 16, BUF, 0, stream)

    for name, fn in fns.items():
        for label, (st, mask) in calls.items():
            if call(fn, st, mask)() != 0:
                raise RuntimeError(f"{name} {label}: launch failed")
            gens = [g for g in range(4) if (mask >> g) & 1]
            want = probe_multi_plain(tables, hi, lo, fp_bits=16,
                                     n_buckets=BUF, stashes=st, gens=gens)
            if not torch.equal(hit, want):
                raise RuntimeError(f"{name} {label}: differs from plain")
    print("   every build answers as the plain version does", flush=True)
    one = torch.zeros(1, device="cuda")
    times = {(name, c): [] for name in fns for c in calls}
    floor = []
    names = list(fns)
    for order in (names, names[::-1]):
        floor.append(device_ms(lambda: one.add_(1), 50, "elementwise_kernel"))
        for name in order:
            for label, args in calls.items():
                times[(name, label)].append(device_ms(
                    call(fns[name], *args), 50, "probe_multi_kernel"))
    print(f"   launch floor (one-element add): {floor} ms (device)",
          flush=True)
    for name in names:
        for label in calls:
            ts = times[(name, label)]
            print(f"   {name} {label}: {sum(ts) / len(ts)!r} ms ({ts})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
