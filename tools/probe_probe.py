#!/usr/bin/env python3
"""probe's and fingerprint_hash's launch shapes and designs against each
other and against another commit's kernels, at the launch sizes of their
serving paths, on one GPU.

    python3 tools/probe_probe.py --export-parent DIR [--rev REV]
    python3 tools/probe_probe.py [--parent DIR] [--json PATH]

The first form runs where the git repository is (no GPU needed): it writes
``src/repro_torch/csrc/probe.cu``, ``fingerprint.cu`` and every ``*.cuh``
of commit REV (default HEAD) into DIR, a directory under ``build/`` (ignored
by git), so that a copy of the checkout without ``.git`` can build them.

The second runs from the root of a checkout on a machine with an NVIDIA
GPU and nvcc.  It prints the card's name and power limit, then builds, all
in parallel into ``build/probe_probe/``:

* ``probe.cu`` at each CTA size (its ``kThreads``: 64, 128, 256) with one
  key a thread and with two (``TWO_KEYS``: the per-key body with each
  key's state in arrays), and each design of ``PROBE_ALTERNATIVES`` (at
  the kept shape: both buckets loaded before any compare at every launch
  size, the alternate bucket after the home bucket at every size, every
  stash slot scanned by each key the buckets did not answer, the hash's
  modulos by a per-launch multiply constant);
* ``fingerprint.cu`` as it is (one key a thread), with a 16-byte path
  from 2^19 keys at each CTA size and keys a thread (64, 128, 256 threads;
  4, 8 keys: ``fp_vec``), and each design of ``FP_ALTERNATIVES`` (the
  16-byte path at every size and from 2^17 and 2^18 keys, the modulos by
  a per-launch multiply constant);
* with ``--parent DIR``, ``DIR/probe.cu`` and ``DIR/fingerprint.cu`` (the
  same C entry points) as one more design each.

Every shape and design is an edit of the source at fixed anchors; an
anchor the source no longer holds stops the tool.

For each build it prints its ptxas registers and spills and checks that it
answers as ``probe_plain`` / ``fingerprint_hash_plain`` do on every call
below (and, for the probe builds, that the telemetry instantiation's depth
plane is the plain version's).

The calls run on a seeded table like the SLO scenarios' node filter: 2^20
buckets of 4 at load 0.5 (each key in its home bucket's next free slot,
else its alternate's), fp_bits 16.  ``probe`` takes N = 4096, 16384,
65536, 131072, 262144 and 524288 keys (half held, half absent) with no
stash, an empty 128-slot stash, and one whose every slot is live (half of
them an absent key's fingerprint at its home bucket); ``fingerprint_hash``
takes N = 4096, 131072, 262144 and 524288.  Each call is timed as the
path runs it, by ``torch.profiler`` (``chip_smoke.kernel_device_ms``), and with the L2 flushed (a 128 MB read, which leaves no dirty
line to write back) before each launch, by CUDA events, the device kept
behind the host by a spin kernel.  The builds
are taken in turns (forward, then backward) and averaged.  Beside them: the
device time of a one-element add (the launch floor) and each call's bound,
counted as ``chip_smoke.py`` phase 6 counts it.  With ``--json PATH``
every reading also goes to PATH as JSON.
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
OUT = ROOT / "build" / "probe_probe"
NB = 1 << 20
LOAD = 0.5
PROBE_SIZES = (4096, 1 << 14, 1 << 16, 1 << 17, 1 << 18, 1 << 19)
FP_SIZES = (4096, 1 << 17, 1 << 18, 1 << 19)
PROBE_SHAPES = [(t, k) for t in (64, 128, 256) for k in (1, 2)]
PROBE_KEPT = (128, 1)
PROBE_THREADS = "constexpr int kThreads = 128;"
FP_SHAPES = [(t, v) for t in (64, 128, 256) for v in (4, 8)]
# x % d for every uint32 x and d >= 1 by two multiplies, from m =
# ceil(2^64 / d) computed once a launch on the host (Lemire, Kaser and
# Kurz, "Faster remainder by direct computation", 2019), and the hash's
# index_hash and alt_index (for i < n) on it.
FAST_MOD = """struct FastMod {
  unsigned long long m;
  uint32_t d;
};
__host__ __device__ inline FastMod fast_mod(uint32_t d) {
  return FastMod{~0ull / d + 1ull, d};
}
__device__ __forceinline__ uint32_t fm_mod(uint32_t x, const FastMod& f) {
  return (uint32_t)__umul64hi(f.m * x, (unsigned long long)f.d);
}
__device__ __forceinline__ uint32_t fm_index(uint32_t hi, uint32_t lo,
                                             const FastMod& n) {
  return fm_mod(ocf::splitmix32(lo) ^ ocf::murmur3_mix(hi + 0x51ED270Bu), n);
}
__device__ __forceinline__ uint32_t fm_alt(uint32_t i, uint32_t fp,
                                           const FastMod& n) {
  const uint32_t x = fm_mod(ocf::splitmix32(fp), n) + n.d - i;
  return x >= n.d ? x - n.d : x;
}
"""
EAGER = "constexpr int kEagerKeys = 16384;"
# Two keys a thread: the kernel's per-key body, from the key's index to
# the telemetry's last barrier, with each key's state in arrays, both
# keys' loads issued before any compare.
TWO_KEYS_BODY = """  constexpr int kKeys = 2;
  const int k0 = blockIdx.x * (kKeys * kThreads) + threadIdx.x;
  const bool eager = n <= kEagerKeys;
  Keys ks;
  uint4 home[kKeys], alt[kKeys];
#pragma unroll
  for (int q = 0; q < kKeys; ++q) {
    const int k = k0 + q * kThreads;
    ks.live[q] = k < n;
    ks.h[q] = false;
    ks.fp[q] = ks.i1[q] = ks.i2[q] = 0u;
    home[q] = alt[q] = make_uint4(0u, 0u, 0u, 0u);
    if (ks.live[q]) {
      const uint32_t h32 = __ldg(hi + k), l32 = __ldg(lo + k);
      ks.fp[q] = ocf::fingerprint(h32, l32, fp_bits);
      ks.i1[q] = ocf::index_hash(h32, l32, n_buckets);
      ks.i2[q] = ocf::alt_index(ks.i1[q], ks.fp[q], n_buckets);
      if (kVec) {
        home[q] = __ldg(rows + ks.i1[q]);
        if (eager) alt[q] = __ldg(rows + ks.i2[q]);
      }
    }
  }
  int count = 0, pass = 0;
  if (stash_slots > 0)
    count = stash_pf::stage_pass(stash, stash_slots, s_slot, 0, list_cap,
                                 smem, list_cap, s_counts, pass++ & 1);
  bool h1[kKeys], hb[kKeys];
#pragma unroll
  for (int q = 0; q < kKeys; ++q) {
    h1[q] = false;
    if (ks.live[q]) {
      const uint32_t fp = ks.fp[q];
      h1[q] = kVec ? has4(home[q], fp)
                   : row_has(table, bucket_size, ks.i1[q], fp);
      ks.h[q] = h1[q] ||
                (kVec ? has4(eager ? alt[q] : __ldg(rows + ks.i2[q]), fp)
                      : row_has(table, bucket_size, ks.i2[q], fp));
    }
    hb[q] = ks.h[q];
  }
  if (stash_slots > 0) {
    if (count > 0) stash_pf::probe_list(smem, list_cap, count, ks);
    for (int base = list_cap; base < stash_slots; base += list_cap) {
      count = stash_pf::stage_pass(stash, stash_slots, s_slot, base,
                                   min(base + list_cap, stash_slots), smem,
                                   list_cap, s_counts, pass++ & 1);
      if (count > 0) stash_pf::probe_list(smem, list_cap, count, ks);
    }
  }
#pragma unroll
  for (int q = 0; q < kKeys; ++q)
    if (ks.live[q]) hit[k0 + q * kThreads] = ks.h[q] ? 1 : 0;
  if constexpr (kTm) {
    __shared__ uint32_t s_depth[4];
    if (threadIdx.x < 4) s_depth[threadIdx.x] = 0u;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kKeys; ++q) {
      const bool counted = k0 + q * kThreads < n_count;
      const int d = h1[q] ? 0 : hb[q] ? 1 : ks.h[q] ? 2 : 3;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t m = __ballot_sync(0xFFFFFFFFu, counted && d == j);
        if ((threadIdx.x & 31) == 0 && m) atomicAdd(&s_depth[j], __popc(m));
      }
    }
    __syncthreads();
"""
TWO_KEYS = [
    ("using Keys = stash_pf::Keys<1>;", "using Keys = stash_pf::Keys<2>;"),
    ("  const int k = blockIdx.x * kThreads + threadIdx.x;\n",
     "    if (threadIdx.x < 4 && s_depth[threadIdx.x])", TWO_KEYS_BODY),
    ("(n + kThreads - 1) / kThreads, kThreads, smem,",
     "(n + 2 * kThreads - 1) / (2 * kThreads), kThreads, smem,")]
# Designs, as edits of the source: name -> [(text of the source, text put
# in its place) or (first text, text after the last, what goes between)].
PROBE_ALTERNATIVES = {
    # One round trip: the alternate bucket issued beside the home bucket.
    "both buckets before any compare, at every size": [
        (EAGER, "constexpr int kEagerKeys = 1 << 30;")],
    "the alternate bucket after the home bucket, at every size": [
        (EAGER, "constexpr int kEagerKeys = 0;")],
    # The parent's stash arm on the new body: S compares a key.
    "every stash slot scanned by each unanswered key": [
        ("    if (count > 0) stash_pf::probe_list(smem, list_cap, count, ks);"
         "\n    // More slots",
         "    for (int s = 0; s < stash_slots && ks.live[0] && !ks.h[0];"
         " ++s)\n"
         "      ks.h[0] = __ldg(stash + s) == ks.fp[0] &&\n"
         "                (__ldg(stash + stash_slots + s) == ks.i1[0] ||\n"
         "                 __ldg(stash + stash_slots + s) == ks.i2[0]);\n"
         "    if (false && count > 0)\n"
         "      stash_pf::probe_list(smem, list_cap, count, ks);\n"
         "    // More slots"),
        ("    for (int base = list_cap; base < stash_slots; "
         "base += list_cap) {",
         "    for (int base = list_cap; false; base += list_cap) {")],
    "a modulo by a per-launch multiply constant": [
        ("using Keys = stash_pf::Keys<1>;\n",
         "using Keys = stash_pf::Keys<1>;\n" + FAST_MOD),
        ("int n, int fp_bits, uint32_t n_buckets, int list_cap,",
         "int n, int fp_bits, FastMod nb, int list_cap,"),
        ("    ks.i1[0] = ocf::index_hash(h32, l32, n_buckets);\n"
         "    ks.i2[0] = ocf::alt_index(ks.i1[0], ks.fp[0], n_buckets);\n",
         "    ks.i1[0] = fm_index(h32, l32, nb);\n"
         "    ks.i2[0] = fm_alt(ks.i1[0], ks.fp[0], nb);\n"),
        ("n, fp_bits, n_buckets, list_cap,",
         "n, fp_bits, fast_mod(n_buckets), list_cap,")],
}
# fingerprint.cu's 16-byte path: from kVecMin keys, where all five arrays
# are 16-byte aligned, a thread of a kVecThreads CTA takes kVecKeys keys
# in 16-byte words, every load issued before any hashing; word w of the
# launch holds keys 4w..4w+3, and the thread past the last whole word
# hashes the 1-3 keys left one at a time.  Smaller or unaligned launches
# keep the source's one-key-a-thread kernel.
FP_VEC_KERNEL = """constexpr int kVecThreads = {threads};
constexpr int kWords = {keys} / 4;
constexpr int kVecMin = {vec_min};

__device__ __forceinline__ void hash1(uint32_t h, uint32_t l, int fp_bits,
                                      uint32_t nb, uint32_t& f, uint32_t& a,
                                      uint32_t& b) {{
  f = ocf::fingerprint(h, l, fp_bits);
  a = ocf::index_hash(h, l, nb);
  b = ocf::alt_index(a, f, nb);
}}

__global__ void __launch_bounds__(kVecThreads)
    fingerprint_vec_kernel(const uint4* __restrict__ hi,
                           const uint4* __restrict__ lo,
                           uint4* __restrict__ fp, uint4* __restrict__ i1,
                           uint4* __restrict__ i2, int n, int fp_bits,
                           uint32_t nb) {{
  const int words = n >> 2;
  const int w0 = blockIdx.x * (kWords * kVecThreads) + threadIdx.x;
  uint4 h[kWords], l[kWords];
#pragma unroll
  for (int g = 0; g < kWords; ++g) {{
    const int w = w0 + g * kVecThreads;
    if (w < words) {{
      h[g] = __ldg(hi + w);
      l[g] = __ldg(lo + w);
    }}
  }}
#pragma unroll
  for (int g = 0; g < kWords; ++g) {{
    const int w = w0 + g * kVecThreads;
    if (w < words) {{
      uint4 f, a, b;
      hash1(h[g].x, l[g].x, fp_bits, nb, f.x, a.x, b.x);
      hash1(h[g].y, l[g].y, fp_bits, nb, f.y, a.y, b.y);
      hash1(h[g].z, l[g].z, fp_bits, nb, f.z, a.z, b.z);
      hash1(h[g].w, l[g].w, fp_bits, nb, f.w, a.w, b.w);
      fp[w] = f;
      i1[w] = a;
      i2[w] = b;
    }} else if (w == words) {{
      const uint32_t* hs = reinterpret_cast<const uint32_t*>(hi);
      const uint32_t* ls = reinterpret_cast<const uint32_t*>(lo);
      for (int k = 4 * words; k < n; ++k)
        hash1(hs[k], ls[k], fp_bits, nb, reinterpret_cast<uint32_t*>(fp)[k],
              reinterpret_cast<uint32_t*>(i1)[k],
              reinterpret_cast<uint32_t*>(i2)[k]);
    }}
  }}
}}

bool aligned16(const void* p) {{ return ((uintptr_t)p & 15u) == 0; }}

}}  // namespace
"""
FP_VEC_LAUNCH = """  if (n >= kVecMin && aligned16(hi) && aligned16(lo) && aligned16(fp) &&
      aligned16(i1) && aligned16(i2)) {
    const int slots = (n >> 2) + ((n & 3) != 0);  // whole words + the rest
    const int per_cta = kWords * kVecThreads;
    fingerprint_vec_kernel<<<(slots + per_cta - 1) / per_cta, kVecThreads,
                             0, (cudaStream_t)stream>>>(
        (const uint4*)hi, (const uint4*)lo, (uint4*)fp, (uint4*)i1,
        (uint4*)i2, n, fp_bits, n_buckets);
  } else if (n > 0) {
"""


def fp_vec(threads: int, keys: int, vec_min: int) -> list:
    """Edits that add the 16-byte path to fingerprint.cu."""
    return [("}  // namespace\n", FP_VEC_KERNEL.format(
        threads=threads, keys=keys, vec_min=vec_min)),
        ("  if (n > 0) {\n", FP_VEC_LAUNCH)]


FP_ALTERNATIVES = {
    "the 16-byte path (64 x 4) at every size": fp_vec(64, 4, 1),
    "the 16-byte path (64 x 4) from 2^17 keys": fp_vec(64, 4, 1 << 17),
    "the 16-byte path (64 x 4) from 2^18 keys": fp_vec(64, 4, 1 << 18),
    "a modulo by a per-launch multiply constant": [
        ("namespace {\n", "namespace {\n" + FAST_MOD),
        ("int fp_bits, uint32_t n_buckets) {",
         "int fp_bits, FastMod n_buckets) {"),
        ("ocf::index_hash(hi[k], lo[k], n_buckets)",
         "fm_index(hi[k], lo[k], n_buckets)"),
        ("ocf::alt_index(h, f, n_buckets)", "fm_alt(h, f, n_buckets)"),
        ("(uint32_t*)i2, n, fp_bits, n_buckets);",
         "(uint32_t*)i2, n, fp_bits, fast_mod(n_buckets));")],
}


def edit(name: str, text: str, edits) -> str:
    for e in edits:
        if any(anchor not in text for anchor in e[:-1]):
            raise RuntimeError(f"{name}: the source no longer holds {e[:-1]!r}")
        if len(e) == 2:
            text = text.replace(e[0], e[1], 1)
        else:   # (first, after the last, between): splice first..after
            a = text.index(e[0])
            text = text[:a] + e[2] + text[text.index(e[1], a):]
    return text


def variants(csrc: Path) -> dict:
    """{(kind, name): source text} of every shape and design built from
    ``csrc``'s probe.cu (kind "probe") and fingerprint.cu ("fp")."""
    probe = (csrc / "probe.cu").read_text()
    fp = (csrc / "fingerprint.cu").read_text()
    out = {}
    for t, k in PROBE_SHAPES:
        name = f"threads={t} keys={k}" + (" (kept)" if (t, k) == PROBE_KEPT
                                          else "")
        edits = [(PROBE_THREADS, f"constexpr int kThreads = {t};")]
        out[("probe", name)] = edit(name, probe,
                                    edits + (TWO_KEYS if k == 2 else []))
    for name, edits in PROBE_ALTERNATIVES.items():
        out[("probe", name)] = edit(name, probe, edits)
    out[("fp", "one key a thread (kept)")] = fp
    for t, v in FP_SHAPES:
        name = f"the 16-byte path ({t} x {v}) from 2^19 keys"
        out[("fp", name)] = edit(name, fp, fp_vec(t, v, 1 << 19))
    for name, edits in FP_ALTERNATIVES.items():
        out[("fp", name)] = edit(name, fp, edits)
    return out


def export_parent(dest: Path, rev: str) -> None:
    """Write rev's probe.cu, fingerprint.cu and headers into ``dest``."""
    dest.mkdir(parents=True, exist_ok=True)
    csrc = "src/repro_torch/csrc"
    names = subprocess.run(["git", "ls-tree", "--name-only", f"{rev}:{csrc}"],
                           cwd=ROOT, check=True, capture_output=True,
                           text=True).stdout.split()
    for name in names:
        if name.endswith(".cuh") or name in ("probe.cu", "fingerprint.cu"):
            (dest / name).write_bytes(subprocess.run(
                ["git", "show", f"{rev}:{csrc}/{name}"], cwd=ROOT,
                check=True, capture_output=True).stdout)
            print(f"{rev}:{csrc}/{name} -> {dest / name}")


def build(parent: Path | None) -> dict:
    """{(kind, name): library path} for every build, one nvcc each, all at
    once; prints each build's ptxas registers and spills."""
    from repro_torch.kernels import cuda
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {key: (text, cuda.CSRC) for key, text in
            variants(cuda.CSRC).items()}
    if parent is not None:
        jobs[("probe", "parent")] = ((parent / "probe.cu").read_text(),
                                     parent)
        jobs[("fp", "parent")] = ((parent / "fingerprint.cu").read_text(),
                                  parent)
    procs = {}
    for i, (key, (text, inc)) in enumerate(jobs.items()):
        cu = OUT / f"{key[0]}_{i}.cu"
        cu.write_text(text)
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(inc), "-o",
               str(cu.with_suffix(".so")), str(cu)]
        procs[key] = (cu.with_suffix(".so"), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line]
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line})
        print(f"   {key[0]} {key[1]}: {' | '.join(regs)}; "
              f"{' | '.join(spills)}", flush=True)
        libs[key] = lib
    return libs


def node_state(rng):
    """The seeded table (uint32 [NB, 4]) and its held keys."""
    from repro_torch.core import hashing
    from repro_torch.kernels.staging_cases import random_keys
    keys = random_keys(rng, int(NB * 4 * LOAD))
    hi, lo = hashing.key_to_u32_pair_np(keys)
    fp = hashing.fingerprint_np(hi, lo, 16)
    i1 = hashing.index_hash_np(hi, lo, NB)
    i2 = hashing.alt_index_np(i1, fp, NB)

    def ranks(v):
        order = np.argsort(v, kind="stable")
        s = v[order]
        start = np.r_[0, np.nonzero(s[1:] != s[:-1])[0] + 1]
        first = np.repeat(start, np.diff(np.r_[start, s.size]))
        r = np.empty(v.size, np.int64)
        r[order] = np.arange(v.size) - first
        return r
    table = np.zeros((NB, 4), np.uint32)
    r1 = ranks(i1)
    home = r1 < 4
    table[i1[home], r1[home]] = fp[home]
    rest = np.nonzero(~home)[0]
    r2 = ranks(i2[rest]) + np.minimum(np.bincount(i1, minlength=NB), 4)[
        i2[rest]]
    ok = r2 < 4
    table[i2[rest[ok]], r2[ok]] = fp[rest[ok]]
    held = np.zeros(keys.size, bool)
    held[home] = True
    held[rest[ok]] = True
    return table, keys[held]


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
    args = ap.parse_args()
    if args.export_parent is not None:
        export_parent(args.export_parent, args.rev)
        return 0
    if not torch.cuda.is_available():
        print("probe_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core import hashing
    from repro_torch.kernels import cuda
    from repro_torch.kernels.fingerprint import fingerprint_hash_plain
    from repro_torch.kernels.probe import probe_plain
    from repro_torch.kernels.staging_cases import random_keys
    from repro_torch.kernels.telemetry import probe_depth_counts
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    fns = {}
    for key, lib in build(args.parent).items():
        so = ctypes.CDLL(str(lib))
        names = (("probe", "probe_tm") if key[0] == "probe"
                 else ("fingerprint_hash",))
        for kern in names:
            fn = getattr(so, cuda.KERNELS[kern][1])
            fn.argtypes = cuda.KERNELS[kern][2]
            fn.restype = ctypes.c_int
            fns[(kern, key[1])] = fn
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    table_np, held = node_state(rng)
    held = held[rng.permutation(held.size)]
    absent = random_keys(rng, max(PROBE_SIZES))
    a_hi, a_lo = hashing.key_to_u32_pair_np(absent[:64])
    planted = np.stack([rng.randint(1, 1 << 16, 128),
                        rng.randint(0, NB, 128)]).astype(np.uint32)
    planted[0, :64] = hashing.fingerprint_np(a_hi, a_lo, 16)
    planted[1, :64] = hashing.index_hash_np(a_hi, a_lo, NB)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32)
                                .view(np.int32)).cuda()

    def pair(keys):
        return tuple(dev(x) for x in hashing.key_to_u32_pair_np(keys))
    table = dev(table_np)
    stashes = {"no stash": None, "empty 128-slot stash": dev(
        np.zeros((2, 128))), "128 live stash entries": dev(planted)}
    print(f"   seeded state in {time.perf_counter() - t0:.1f} s: "
          f"{held.size} keys held of {table_np.size} slots", flush=True)
    keys = {n: pair(np.concatenate([held[: n // 2], absent[: n - n // 2]]))
            for n in PROBE_SIZES}
    fkeys = {n: pair(absent[:n]) for n in FP_SIZES}
    stream = torch.cuda.current_stream().cuda_stream
    hit = torch.empty(max(PROBE_SIZES), dtype=torch.bool, device="cuda")
    plane = torch.zeros(4, dtype=torch.int32, device="cuda")
    outs = [torch.empty(max(FP_SIZES), dtype=torch.int32, device="cuda")
            for _ in range(3)]
    # A 128 MB read empties the L2 and leaves no dirty line to write back.
    flush_buf = torch.ones(1 << 25, dtype=torch.int32, device="cuda")
    sink = torch.empty((), dtype=torch.int64, device="cuda")

    def flush():
        torch.sum(flush_buf, 0, dtype=torch.int64, out=sink)

    def probe_call(fn, n, st, tm=False):
        hi, lo = keys[n]
        sp = None if st is None else st.data_ptr()
        if tm:
            return lambda: (plane.zero_(), fn(
                table.data_ptr(), 4, sp, 128, hi.data_ptr(), lo.data_ptr(),
                hit.data_ptr(), n, 16, NB, plane.data_ptr(), n,
                stream))[1]
        return lambda: fn(table.data_ptr(), 4, sp, 128, hi.data_ptr(),
                          lo.data_ptr(), hit.data_ptr(), n, 16, NB, stream)

    def fp_call(fn, n):
        hi, lo = fkeys[n]
        return lambda: fn(hi.data_ptr(), lo.data_ptr(),
                          *(o.data_ptr() for o in outs), n, 16, NB, stream)

    calls = {}   # (kernel, label) -> (fn maker, symbol, work)
    for n in PROBE_SIZES:
        hi, lo = keys[n]
        for label, st in stashes.items():
            work = chip_smoke.probe_work(table, st, hi, lo, NB)
            calls[("probe", f"{n} keys, {label}")] = (
                lambda fn, n=n, st=st: probe_call(fn, n, st), "probe_kernel",
                work)
            if label == "empty 128-slot stash":
                calls[("probe_tm", f"{n} keys, {label}")] = (
                    lambda fn, n=n, st=st: probe_call(fn, n, st, True),
                    "probe_kernel", (work[0] + 16, work[1]))
    for n in FP_SIZES:
        calls[("fingerprint_hash", f"{n} keys")] = (
            lambda fn, n=n: fp_call(fn, n), "fingerprint",
            (n * (8 + 12), n * chip_smoke.HASH_OPS))
    # Every build against the plain versions on every call.
    for (kern, label), (make, _sym, _w) in calls.items():
        n = int(label.split()[0])
        if kern == "fingerprint_hash":
            want = fingerprint_hash_plain(*fkeys[n], fp_bits=16,
                                          n_buckets=NB)
        else:
            st = stashes[label.split(", ", 1)[1]]
            want, hs = probe_plain(table, *keys[n], fp_bits=16,
                                   n_buckets=NB, stash=st, want_stats=True)
            want_plane = probe_depth_counts(*hs, hs[0] | ~hs[0])
        for (k, name), fn in fns.items():
            if k != kern:
                continue
            if make(fn)() != 0:
                raise RuntimeError(f"{kern} {name} {label}: launch failed")
            if kern == "fingerprint_hash":
                ok = all(torch.equal(o[:n], w) for o, w in zip(outs, want))
            else:
                ok = torch.equal(hit[:n], want)
                if kern == "probe_tm":
                    ok = ok and torch.equal(plane.long(), want_plane)
            if not ok:
                raise RuntimeError(f"{kern} {name} {label}: differs from "
                                   f"the plain version")
    print("   every build answers as the plain version does", flush=True)
    one = torch.zeros(1, device="cuda")
    floor = []
    times = {}
    names = list(fns)
    for order in (names, names[::-1]):
        floor.append(chip_smoke.kernel_device_ms(
            lambda: one.add_(1), 50, None, "elementwise_kernel"))
        for kern, name in order:
            for (k, label), (make, sym, _w) in calls.items():
                if k != kern:
                    continue
                fn = make(fns[(kern, name)])
                warm = chip_smoke.kernel_device_ms(fn, 20, None, sym)
                if warm is None:
                    raise RuntimeError(f"{kern} {name} {label}: no device "
                                       f"time for {sym} in six windows")
                cold = chip_smoke.flushed_event_ms(fn, 10, flush)
                times.setdefault((kern, name, label), []).append(
                    (warm, cold))
    fl = sum(floor) / len(floor)
    print(f"   launch floor (one-element add): {floor} ms (device)",
          flush=True)
    rows = []
    for (kern, name, label), ts in times.items():
        warm = [w for w, _c in ts]
        cold = [c for _w, c in ts if c is not None]
        bound, by = chip_smoke.least_ms(*calls[(kern, label)][2])
        mw = sum(warm) / len(warm)
        mc = sum(cold) / len(cold) if cold else None
        rows.append(dict(kernel=kern, build=name, call=label, warm_ms=warm,
                         flushed_ms=cold, bound_ms=bound, bound_by=by,
                         floor_ms=fl))
        print(f"   {kern} | {name} | {label}: {mw!r} ms ({warm}); flushed "
              f"{mc!r} ms ({cold}); bound {bound!r} ms ({by}); x bound "
              f"{mw / bound:.2f} / {(mc or 0) / bound:.2f} flushed; x floor "
              f"{mw / fl:.3f}", flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"card": card, "floor_ms": floor, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
