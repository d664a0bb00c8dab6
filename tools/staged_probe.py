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
  2. a copy of ``src/repro_torch/csrc/insert.cu`` with its sections timed
     by ``clock64()`` on thread 0 after a barrier, for one 4096-key call at
     block 128 on a 2^22-bucket table filled to load 0.3 (seeded): cycles
     a logical block per section.  Every mark adds a barrier, so the
     sections add up to more than the uninstrumented kernel takes;
  3. the uninstrumented kernels (``insert_bulk``, ``delete_bulk``) on the
     same call: the median of 30 launches by CUDA events, launch included.

Everything is built into ``build/probe/`` (ignored by git).  The copy in
step 2 is made by inserting timing marks at fixed places of the sources;
the script stops if a place is not found.
"""
from __future__ import annotations

import ctypes
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
PATCHES = [
    ("insert.cu", '#include "staged.cuh"',
     "__shared__ long long s_prof[24];\n__shared__ long long s_t0;\n" + MARK +
     '\n#include "staged_probe.cuh"\n__device__ unsigned long long g_prof[24];'),
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
     "  if (threadIdx.x == 0) { for (int i = 0; i < 24; ++i) s_prof[i] = 0; "
     "s_t0 = clock64(); }\n  for (int i = threadIdx.x; i < 2 * C.cap;"),
    ("insert.cu", "    stg::stage_window(", "    MARK(7);\n    stg::stage_window("),
    ("insert.cu", "    for (int base = w0; base < w1; base += A.block) {",
     "    MARK(8);\n    for (int base = w0; base < w1; base += A.block) {"),
    ("insert.cu", "    stg::write_back(S, w1 - w0);",
     "    MARK(9);\n    stg::write_back(S, w1 - w0);\n    MARK(10);"),
    ("insert.cu", "    A.stash[i] = L.stash[i];\n}",
     "    A.stash[i] = L.stash[i];\n  if (threadIdx.x == 0) "
     "for (int i = 0; i < 24; ++i) g_prof[i] = s_prof[i];\n}"),
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
SECTIONS = [
    "block: lane init", "block: home round", "block: alternate round, "
    "residue check", "block: eviction rounds", "block: spill, rollback, ok",
    "round: decide -> barrier", "round: write pass", "window: before staging",
    "window: duplicate-row lookups", "window: -> write-back",
    "window: write-back", "round: rank counts", "round: rank + decide",
    "window: clear map, hash lanes", "window: claim rows",
    "window: issue copies", "window: wait for copies"]


def build_probe(nvcc: list) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    text = {f: (CSRC / f).read_text() for f in ("insert.cu", "staged.cuh")}
    for f, anchor, new in PATCHES:
        if anchor not in text[f]:
            raise SystemExit(f"staged_probe: {f} has no {anchor!r}")
        text[f] = text[f].replace(anchor, new, 1)
    text["insert.cu"] += (
        '\nextern "C" int ocf_prof(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}\n")
    (OUT / "insert_probe.cu").write_text(text["insert.cu"])
    (OUT / "staged_probe.cuh").write_text(text["staged.cuh"])
    (OUT / "ocf_common.cuh").write_text((CSRC / "ocf_common.cuh").read_text())
    lib = OUT / "libinsert_probe.so"
    subprocess.run([*nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(OUT / "insert_probe.cu")], check=True)
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("staged_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import hashing
    from repro_torch.kernels import cuda
    from repro_torch.kernels.delete import delete_bulk
    from repro_torch.kernels.insert import insert_bulk
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

    def keys():
        k = rng.randint(0, 2**63, n, dtype=np.int64).astype(np.uint64)
        return (torch.from_numpy(x.view(np.int32)).cuda()
                for x in hashing.key_to_u32_pair_np(k))

    hi, lo = keys()
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    lib = ctypes.CDLL(str(build_probe(nvcc)))
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.ocf_insert_bulk.argtypes = [P, I, U, P, I, P, P, P, P, I, I, I, I,
                                    P, P]
    lib.ocf_prof.argtypes = [P]
    ok = torch.empty(n, dtype=torch.bool, device="cuda")
    work = table.clone()
    err = lib.ocf_insert_bulk(work.data_ptr(), 4, nb, None, 0, hi.data_ptr(),
                              lo.data_ptr(), valid.data_ptr(), ok.data_ptr(),
                              n, block, 16, 32, None, None)
    torch.cuda.synchronize()
    if err:
        raise SystemExit(f"staged_probe: launch failed (cudaError {err})")
    prof = (ctypes.c_ulonglong * 24)()
    lib.ocf_prof(prof)
    blocks = n // block
    print(f"2. insert_bulk sections, {n} keys, block {block}, load 0.3: "
          f"{sum(prof)} cycles, {sum(prof) // blocks} a block", flush=True)
    for i, name in enumerate(SECTIONS):
        print(f"   {name:34s} {prof[i]:9d} cycles, "
              f"{prof[i] / blocks:8.1f} a block", flush=True)

    # Deletes of keys that the table holds.
    base = table.clone()
    dhi, dlo = keys()
    insert_bulk(base, dhi, dlo, fp_bits=16, n_buckets=nb, block=block)

    def median_ms(fn, reps=30):
        spans = []
        for _ in range(reps + 3):
            work.copy_(base)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            spans.append((a, b))
        torch.cuda.synchronize()
        return sorted(a.elapsed_time(b) for a, b in spans[3:])[reps // 2]

    ins = median_ms(lambda: insert_bulk(work, hi, lo, fp_bits=16,
                                        n_buckets=nb, block=block))
    dele = median_ms(lambda: delete_bulk(work, dhi, dlo, fp_bits=16,
                                         n_buckets=nb, block=block))
    print(f"3. {n} keys, block {block}, median of 30 launches (CUDA events): "
          f"insert_bulk {ins!r} ms, delete_bulk {dele!r} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
