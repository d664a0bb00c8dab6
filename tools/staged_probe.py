#!/usr/bin/env python3
"""Where the staged insert and delete kernels spend a launch, on one GPU.

    python3 tools/staged_probe.py

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
It prints the card's name and power limit, then:

  1. the costs of the shared-memory primitives a rank round can be built
     from: one CTA of 8 warps, 4 of them active (a 128-lane block), 2000
     iterations each of a barrier, __match_any_sync on 64- and 32-bit
     keys, a 64-bit CAS plus an add on a 24-byte-strided hash map, a
     32-bit CAS on a dense array, and plain loads and stores (cycles an
     iteration, barrier included);
  2. copies of ``src/repro_torch/csrc/insert.cu``,
     ``insert_adaptive.cu`` and ``delete_adaptive.cu`` with their sections
     timed by ``clock64()`` on thread 0 after a barrier, for one 4096-key
     call at block 128 and 32 eviction rounds on 2^22 buckets of 4 (seeded;
     the static table at load 0.3, the adaptive planes at load 0.5 with one
     slot in 10^4 on a nonzero selector, the order of the adaptive path's
     852 adapted slots in ~9M, the deletes of keys the planes hold): cycles
     a logical block per section.  Every mark adds a
     barrier, so the sections add up to more than the uninstrumented
     kernel takes;
  3. the uninstrumented kernels (``insert_bulk``, ``delete_bulk``,
     ``insert_bulk_adaptive``, ``delete_bulk_adaptive``) on the same
     calls: the median of 30 launches by CUDA events, launch included;
  4. the adaptive path's large calls on planes at load 0.5 plus 3M resident
     keys (load ~0.68): one 1M-key insert and one delete of the 3M keys,
     each split into launches of ``cuda.SPLIT_KEYS`` keys (the wrappers'
     default ``split_keys``) and as one launch, in turns (split, one, one,
     split), by CUDA events.

Everything is built into ``build/probe/`` (ignored by git).  The copies in
step 2 are made by inserting timing marks at fixed places of the sources;
the script stops if a place is not found.
"""
from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "probe"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

PRIMITIVES = r"""
#include <cstdio>
#include <cstdint>
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16; x *= 0x85EBCA6Bu; x ^= x >> 13; x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}
template <int V>
__global__ void k(long long* out, int iters) {
  __shared__ __align__(16) uint32_t m[257 * 6];
  __shared__ uint32_t d[512];
  for (int i = threadIdx.x; i < 257 * 6; i += blockDim.x) m[i] = ~0u;
  for (int i = threadIdx.x; i < 512; i += blockDim.x) d[i] = 0;
  __syncthreads();
  const bool act = threadIdx.x < 128;
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const uint32_t key = mix(threadIdx.x * 977u + it * 131u) % 100000u;
    if (V == 1) acc += __match_any_sync(~0u, (unsigned long long)key);
    if (V == 2) acc += __match_any_sync(~0u, key);
    if (V == 3 && act) {
      const uint32_t pos = __umulhi(mix(key), 257u);
      unsigned long long* e =
          reinterpret_cast<unsigned long long*>(m + pos * 6);
      acc += (uint32_t)atomicCAS(e, ~0ull, (unsigned long long)key);
      atomicAdd(m + pos * 6 + 3, 1u);
    }
    if (V == 4 && act) acc += atomicCAS(&d[__umulhi(mix(key), 509u)], 0u, key);
    if (V == 5 && act) {
      const uint32_t pos = __umulhi(mix(key), 509u);
      acc += d[pos];
      d[pos] = key;
    }
    __syncthreads();
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) out[V] = (t1 - t0) / iters;
  if (acc == 12345u) out[7] = acc;
}
int main() {
  long long* dv;
  long long h[8];
  cudaMalloc(&dv, sizeof(h));
  k<0><<<1, 256>>>(dv, 2000); k<1><<<1, 256>>>(dv, 2000);
  k<2><<<1, 256>>>(dv, 2000); k<3><<<1, 256>>>(dv, 2000);
  k<4><<<1, 256>>>(dv, 2000); k<5><<<1, 256>>>(dv, 2000);
  cudaMemcpy(h, dv, sizeof(h), cudaMemcpyDeviceToHost);
  const char* names[] = {"barrier", "match_any u64", "match_any u32",
                         "CAS64 + add, strided map", "CAS32, dense array",
                         "load + store, dense array"};
  for (int v = 0; v < 6; ++v)
    printf("   %-28s %lld cycles an iteration\n", names[v], h[v]);
  return 0;
}
"""

# (file, anchor, text put in its place): the anchor's barrier, or a point
# after it, becomes a mark.
MARK = ("#define MARK(i) do { __syncthreads(); if (threadIdx.x == 0) { "
        "long long t_ = clock64(); s_prof[i] += t_ - s_t0; s_t0 = t_; } "
        "} while (0)")
HEADER = ("__shared__ long long s_prof[24];\n__shared__ long long s_t0;\n" +
          MARK + '\n#include "staged_probe.cuh"\n'
          "__device__ unsigned long long g_prof[24];")
INIT = ("  if (threadIdx.x == 0) { for (int i = 0; i < 24; ++i) s_prof[i] = 0; "
        "s_t0 = clock64(); }\n")
SAVE = "  if (threadIdx.x == 0) for (int i = 0; i < 24; ++i) g_prof[i] = s_prof[i];\n"
# The static insert's marks; insert_adaptive.cu has the same anchors.
PATCHES = [
    ("insert.cu", '#include "staged.cuh"', HEADER),
    ("insert.cu", "    place_round(kAct);\n    for",
     "    MARK(0);\n    place_round(kAct);\n    MARK(1);\n    for"),
    ("insert.cu", "    any = __syncthreads_or(any);\n    for (int r = 0;",
     "    any = __syncthreads_or(any);\n    MARK(2);\n    for (int r = 0;"),
    ("insert.cu", "    if (A.stash != nullptr && any) {",
     "    MARK(3);\n    if (A.stash != nullptr && any) {"),
    ("insert.cu", "    if (threadIdx.x == 0) *n_dirty = 0u;\n    __syncthreads();",
     "    if (threadIdx.x == 0) *n_dirty = 0u;\n    MARK(4);"),
    ("insert.cu", "A.bsz, 0u, r);\n        });\n    __syncthreads();",
     "A.bsz, 0u, r);\n        });\n    MARK(5);"),
    ("insert.cu", "walk_back(j, false);\n    }\n    __syncthreads();",
     "walk_back(j, false);\n    }\n    MARK(6);"),
    ("insert.cu", "  for (int i = threadIdx.x; i < 2 * C.cap;",
     INIT + "  for (int i = threadIdx.x; i < 2 * C.cap;"),
    ("insert.cu", "    stg::stage_window(", "    MARK(7);\n    stg::stage_window("),
    ("insert.cu", "    for (int base = w0; base < w1; base += A.block) {",
     "    MARK(8);\n    for (int base = w0; base < w1; base += A.block) {"),
    ("insert.cu", "    stg::write_back(S, w1 - w0);",
     "    MARK(9);\n    stg::write_back(S, w1 - w0);\n    MARK(10);"),
    ("insert.cu", "    A.stash[i] = L.stash[i];\n}",
     "    A.stash[i] = L.stash[i];\n" + SAVE + "}"),
    ("staged.cuh", "    atomicAdd(&C.cnt[s1], 1u);\n  }\n  __syncthreads();",
     "    atomicAdd(&C.cnt[s1], 1u);\n  }\n  MARK(11);"),
    ("staged.cuh", "    then(j, r);\n  }\n}", "    then(j, r);\n  }\n  MARK(12);\n}"),
    ("staged.cuh", "  __syncthreads();\n  for (int w = threadIdx.x; w < nw;",
     "  MARK(13);\n  for (int w = threadIdx.x; w < nw;"),
    ("staged.cuh", "  __syncthreads();\n  // The claimed rows' copies",
     "  MARK(14);\n  // The claimed rows' copies"),
    ("staged.cuh", "  cp_async_wait_all();\n  __syncthreads();\n  // Lanes whose",
     "  MARK(15);\n  cp_async_wait_all();\n  MARK(16);\n  // Lanes whose"),
]
# The adaptive insert's: the same places (their text as it stands there),
# and the kick's decide pass (phase B takes no ranks there).
TO_ADAPTIVE = [
    ("place_round(kAct);", "place_round(kAct, false);"),
    ("A.bsz, 0u, r);", "L.slot[j] = slot >= 0 ? slot : r == empty ? -2 : -1;"),
    ("any = __syncthreads_or(any);\n    for (int r = 0;",
     "any = __syncthreads_or(any);\n    // Round 0's"),
    ("MARK(2);\n    for (int r = 0;", "MARK(2);\n    // Round 0's")]


def to_adaptive(text: str) -> str:
    for old, new in TO_ADAPTIVE:
        text = text.replace(old, new)
    return text


ADAPTIVE_PATCHES = [(f, to_adaptive(a), to_adaptive(n))
                    for f, a, n in PATCHES] + [
    ("insert_adaptive.cu", "    __syncthreads();\n    int still = 0;",
     "    MARK(17);\n    int still = 0;")]
# The adaptive delete's marks (clear_round's two barriers are marks 5, 6).
DELETE_PATCHES = [
    ("delete_adaptive.cu", '#include "staged.cuh"', HEADER),
    ("delete_adaptive.cu", "  for (int i = threadIdx.x; i < 2 * C.cap;",
     INIT + "  for (int i = threadIdx.x; i < 2 * C.cap;"),
    ("delete_adaptive.cu", "    stg::stage_window(",
     "    MARK(7);\n    stg::stage_window("),
    ("delete_adaptive.cu",
     "    for (int base = w0; base < w1; base += A.block) {",
     "    MARK(8);\n    for (int base = w0; base < w1; base += A.block) {"),
    ("delete_adaptive.cu",
     "      clear_round(A, S, C, L, nl, base, wb);\n      for (int j = "
     "threadIdx.x; j < nl; j += blockDim.x) {",
     "      MARK(0);\n      clear_round(A, S, C, L, nl, base, wb);\n      "
     "MARK(1);\n      for (int j = threadIdx.x; j < nl; j += blockDim.x) {"),
    ("delete_adaptive.cu",
     "      clear_round(A, S, C, L, nl, base, wb);\n      for (int j = "
     "threadIdx.x; j < nl; j += blockDim.x)\n        A.ok[base + j] = "
     "(L.flags[j] & kOk) ? 1 : 0;\n",
     "      clear_round(A, S, C, L, nl, base, wb);\n      MARK(2);\n      "
     "for (int j = threadIdx.x; j < nl; j += blockDim.x)\n        "
     "A.ok[base + j] = (L.flags[j] & kOk) ? 1 : 0;\n      MARK(3);\n"),
    ("delete_adaptive.cu", "    L.slot[j] = s;\n  });\n  __syncthreads();",
     "    L.slot[j] = s;\n  });\n  MARK(5);"),
    ("delete_adaptive.cu", "    L.flags[j] = kOk;\n  }\n  __syncthreads();",
     "    L.flags[j] = kOk;\n  }\n  MARK(6);"),
    ("delete_adaptive.cu", "    stg::write_back(S, w1 - w0);\n  }\n}",
     "    MARK(9);\n    stg::write_back(S, w1 - w0);\n    MARK(10);\n  }\n"
     + SAVE + "}"),
]
SECTIONS = [
    "block: lane init", "block: home round", "block: alternate round, "
    "residue check", "block: eviction rounds", "block: spill, rollback, ok",
    "round: decide -> barrier", "round: write pass", "window: before staging",
    "window: duplicate-row lookups", "window: -> write-back",
    "window: write-back", "round: rank counts", "round: rank + decide",
    "window: clear map, hash lanes", "window: claim rows",
    "window: issue copies", "window: wait for copies"]


ADAPTIVE_SECTIONS = [*SECTIONS, "kick: decide"]
DELETE_SECTIONS = [
    "block: lane init", "block: home round",
    "block: alternate round", "block: ok", "-", "round: decide -> barrier",
    "round: write pass", *SECTIONS[7:]]
STAGED = [x for x in PATCHES if x[0] == "staged.cuh"]


def build_probe(nvcc: list, src: str, patches: list) -> Path:
    """A copy of ``src`` (and staged.cuh) with timing marks, built into a
    library that also exports ``ocf_prof`` (the marks' cycle sums)."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = {src: (CSRC / src).read_text(),
            "staged.cuh": (CSRC / "staged.cuh").read_text()}
    for f, anchor, new in patches:
        f = src if f != "staged.cuh" else f
        if anchor not in text[f]:
            raise SystemExit(f"staged_probe: {f} has no {anchor!r}")
        text[f] = text[f].replace(anchor, new, 1)
    stem = src.removesuffix(".cu")
    text[src] += (
        '\nextern "C" int ocf_prof(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}\n")
    (OUT / f"{stem}_probe.cu").write_text(text[src])
    (OUT / "staged_probe.cuh").write_text(text["staged.cuh"])
    (OUT / "ocf_common.cuh").write_text((CSRC / "ocf_common.cuh").read_text())
    lib = OUT / f"lib{stem}_probe.so"
    subprocess.run([*nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(OUT / f"{stem}_probe.cu")], check=True)
    return lib


def report(lib, what: str, sections: list, blocks: int) -> None:
    """Print the cycle sums of a probed launch, a logical block each."""
    prof = (ctypes.c_ulonglong * 24)()
    lib.ocf_prof(prof)
    print(f"2. {what}: {sum(prof)} cycles, {sum(prof) // blocks} a block",
          flush=True)
    for i, name in enumerate(sections):
        if name != "-":
            print(f"   {name:34s} {prof[i]:9d} cycles, "
                  f"{prof[i] / blocks:8.1f} a block", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("staged_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import hashing
    from repro_torch.kernels import cuda
    from repro_torch.kernels.delete import delete_bulk, delete_bulk_adaptive
    from repro_torch.kernels.insert import insert_bulk, insert_bulk_adaptive
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    nvcc = [cuda._nvcc(), *NVCC_FLAGS]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "primitives.cu").write_text(PRIMITIVES)
    subprocess.run([*nvcc, "-o", str(OUT / "primitives"),
                    str(OUT / "primitives.cu")], check=True)
    print("1. shared-memory primitives (1 CTA, 8 warps, 4 active):",
          flush=True)
    print(subprocess.run([str(OUT / "primitives")], capture_output=True,
                         text=True, check=True).stdout, end="", flush=True)

    rng = np.random.RandomState(0)
    nb, n, block = 1 << 22, 4096, 128
    fill = rng.rand(nb, 4) < 0.3
    table = torch.from_numpy(np.where(
        fill, rng.randint(1, 1 << 16, (nb, 4)), 0).astype(np.int32)).cuda()

    def keys(count=n):
        k = rng.randint(0, 2**63, count, dtype=np.int64).astype(np.uint64)
        return (torch.from_numpy(x.view(np.int32)).cuda()
                for x in hashing.key_to_u32_pair_np(k))

    hi, lo = keys()
    dhi, dlo = keys()
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    ok = torch.empty(n, dtype=torch.bool, device="cuda")
    blocks = n // block
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint

    # Adaptive planes at load 0.5, one slot in 10^4 adapted.
    fill = rng.rand(nb, 4) < 0.5
    sel = np.where(fill & (rng.rand(nb, 4) < 1e-4), rng.randint(1, 4, (nb, 4)),
                   0).astype(np.uint32)
    planes = [np.where(fill, rng.randint(1, 1 << 16, (nb, 4)), 0),
              (sel << np.arange(0, 8, 2, dtype=np.uint32)).sum(
                  axis=1, keepdims=True, dtype=np.uint32),
              np.where(fill, rng.randint(-2**31, 2**31, (nb, 4)), 0),
              np.where(fill, rng.randint(-2**31, 2**31, (nb, 4)), 0)]
    planes = [torch.from_numpy(np.ascontiguousarray(x).astype(np.uint32)
                               .view(np.int32)).cuda() for x in planes]
    a_base = [x.clone() for x in planes]
    insert_bulk_adaptive(*a_base, dhi, dlo, fp_bits=16, n_buckets=nb,
                         block=block)
    a_work = [x.clone() for x in planes]

    def probe(src, patches, symbol, argtypes, args, what, sections):
        lib = ctypes.CDLL(str(build_probe(nvcc, src, patches)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        lib.ocf_prof.argtypes = [P]
        err = fn(*args)
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"staged_probe: {src} failed to launch "
                             f"(cudaError {err})")
        report(lib, what, sections, blocks)

    work = table.clone()
    probe("insert.cu", PATCHES, "ocf_insert_bulk",
          [P, I, U, P, I, P, P, P, P, I, I, I, I, P, P],
          (work.data_ptr(), 4, nb, None, 0, hi.data_ptr(), lo.data_ptr(),
           valid.data_ptr(), ok.data_ptr(), n, block, 16, 32, None, None),
          f"insert_bulk sections, {n} keys, block {block}, load 0.3",
          SECTIONS)
    ptrs = [x.data_ptr() for x in a_work]
    probe("insert_adaptive.cu", ADAPTIVE_PATCHES, "ocf_insert_bulk_adaptive",
          [P, P, P, P, I, U, P, I, P, P, P, P, I, I, I, I, P, P],
          (*ptrs, 4, nb, None, 0, hi.data_ptr(), lo.data_ptr(),
           valid.data_ptr(), ok.data_ptr(), n, block, 16, 32, None, None),
          f"insert_bulk_adaptive sections, {n} keys, block {block}, "
          f"load 0.5", ADAPTIVE_SECTIONS)
    for w, b in zip(a_work, a_base):
        w.copy_(b)
    probe("delete_adaptive.cu", DELETE_PATCHES + STAGED,
          "ocf_delete_bulk_adaptive",
          [P, P, P, P, I, U, P, P, P, P, I, I, I, P, P],
          (*ptrs, 4, nb, dhi.data_ptr(), dlo.data_ptr(), valid.data_ptr(),
           ok.data_ptr(), n, block, 16, None, None),
          f"delete_bulk_adaptive sections, {n} resident keys, block "
          f"{block}", DELETE_SECTIONS)

    # Deletes of keys that the table holds.
    base = table.clone()
    insert_bulk(base, dhi, dlo, fp_bits=16, n_buckets=nb, block=block)

    def median_ms(fn, pairs, reps=30):
        spans = []
        for _ in range(reps + 3):
            for w, b in pairs:
                w.copy_(b)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            spans.append((a, b))
        torch.cuda.synchronize()
        return sorted(a.elapsed_time(b) for a, b in spans[3:])[reps // 2]

    static = [(work, base)]
    adaptive = list(zip(a_work, a_base))
    times = {
        "insert_bulk": median_ms(lambda: insert_bulk(
            work, hi, lo, fp_bits=16, n_buckets=nb, block=block), static),
        "delete_bulk": median_ms(lambda: delete_bulk(
            work, dhi, dlo, fp_bits=16, n_buckets=nb, block=block), static),
        "insert_bulk_adaptive": median_ms(lambda: insert_bulk_adaptive(
            *a_work, hi, lo, fp_bits=16, n_buckets=nb, block=block),
            adaptive),
        "delete_bulk_adaptive": median_ms(lambda: delete_bulk_adaptive(
            *a_work, dhi, dlo, fp_bits=16, n_buckets=nb, block=block),
            adaptive)}
    print(f"3. {n} keys, block {block}, median of 30 launches (CUDA events): "
          + ", ".join(f"{k} {v!r} ms" for k, v in times.items()), flush=True)

    big_hi, big_lo = keys(1 << 20)
    res_hi, res_lo = keys(3 << 20)
    big = [x.clone() for x in planes]
    insert_bulk_adaptive(*big, res_hi, res_lo, fp_bits=16, n_buckets=nb,
                         block=block, stash=torch.zeros(
                             (2, 128), dtype=torch.int32, device="cuda"))
    pairs = list(zip(a_work, big))
    calls = {
        "insert 1M": lambda k: insert_bulk_adaptive(
            *a_work, big_hi, big_lo, fp_bits=16, n_buckets=nb, block=block,
            split_keys=k),
        "delete 3M": lambda k: delete_bulk_adaptive(
            *a_work, res_hi, res_lo, fp_bits=16, n_buckets=nb, block=block,
            split_keys=k)}
    split = cuda.SPLIT_KEYS
    for what, fn in calls.items():
        got = {}
        for keys_per_launch in (split, 1 << 30, 1 << 30, split):
            got.setdefault(keys_per_launch, []).append(median_ms(
                functools.partial(fn, keys_per_launch), pairs, reps=3))
        print(f"4. adaptive {what}, block {block}: launches of {split} keys "
              f"{got[split]!r} ms; one launch {got[1 << 30]!r} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
