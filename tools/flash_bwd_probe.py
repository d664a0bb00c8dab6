#!/usr/bin/env python3
"""flash attention's backward kernels (and its forward) against another
commit's, in one run on one GPU, at gemma3-1b's training shapes.

    python3 tools/flash_bwd_probe.py --export-parent DIR [--rev REV]
    python3 tools/flash_bwd_probe.py --parent DIR [--json PATH]
    python3 tools/flash_bwd_probe.py --sections [--json PATH]

The first form runs where the git repository is (no GPU needed): it writes
``flash_attention_bwd.cu``, ``flash_attention.cu`` and every ``*.cuh`` of
``src/repro_torch/csrc`` at commit REV (default HEAD) into DIR, a
directory under ``build/`` (ignored by git), so that a copy of the
checkout without ``.git`` can build them.

The second runs from the root of a checkout on a machine with an NVIDIA
GPU and nvcc.  It prints the card's name and power limit, builds this
tree's two libraries (``kernels/cuda.py``) and DIR's, all at once, and
loads DIR's through the same C entry points.  Then, for gemma3-1b's
training heads (bfloat16, Hq 4, Hkv 1, S = 4096, D 256), at B 1 and at B
2 (a training microbatch), for a global layer and a 512-window one, on the
same seeded inputs (o and lse from this tree's forward, D_i from its
pre-pass):

* it holds the parent's dq, dk and dv and this tree's against
  ``flash_attention_bwd_plain`` (chip_smoke.py's FLASH_BWD_TOL and
  FLASH_BWD_ROW_TOL) and this tree's against a second run of itself (the
  same bits);
* it times each backward kernel (dk/dv, dq) of both builds by the
  profiler's device time (chip_smoke.py's ``kernel_device_ms``, 20
  launches a window, L2 warm) in turns: parent, this tree, this tree,
  parent;
* it times the forward kernel of both builds the same way at S 4096 and
  8192, global and 512-window, without ``lse``.

The third builds a copy of this tree's ``flash_attention_bwd.cu`` with
clock64() counters at fixed anchors (``SECTIONS``: an anchor the source no
longer holds stops the tool) and runs dk/dv and dq once at each of the
shapes above.  It prints, for the first CTA of each kernel (dk/dv: key
tile 0 of cluster rank 0, the heaviest under the causal mask; dq: the last
q tile of head 0) and thread 0 of each warpgroup, the cycles spent in each
section of its loop: waiting for a stage, the tile product (S^T / dP^T, or
S / dP), the named barriers of the exchange, forming p or dS (the
elementwise work and the exchange), the accumulating product, and the
whole loop; for the producer, its waits for a free stage.

With ``--json PATH`` every reading also goes to PATH as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "flash_bwd_probe"
SOURCES = ("flash_attention_bwd.cu", "flash_attention.cu")
HQ, HKV, S, D, WINDOW = 4, 1, 4096, 256, 512
REPS = 20
# (kernel, [(anchor, replacement)]) of the sections build: each anchor is
# found once in the kernel's part of the source.  T0 starts a span; T1(k)
# adds it to counter k of this warpgroup (or of the producer).
SECTIONS = {
    "dkdv": [
        ("    const int r0 = 16 * warp + g;  // this thread's keys k0 + r0, + 8\n",
         "    const int r0 = 16 * warp + g;  // this thread's keys k0 + r0, + 8\n"
         "    const bool prof = blockIdx.x == 0 && blockIdx.y == 0 && "
         "blockIdx.z == 0 && tid == 0;\n    const int slot = 8 * w;\n"
         "    long long t_loop = clock64();\n"),
        ("      mbar_wait(full + 8 * s, (j / L::kStages) & 1);\n",
         "      T0 mbar_wait(full + 8 * s, (j / L::kStages) & 1); T1(0)\n"),
        ("      tile_product<T, D>(x, w == 0 ? sK : sV, w == 0 ? sQ(s) : "
         "sdO(s));\n",
         "      T0 tile_product<T, D>(x, w == 0 ? sK : sV, w == 0 ? sQ(s) : "
         "sdO(s)); T1(1) T0\n"),
        ("        if (j > 0) named_sync(kXEmpty, 256);",
         "        { T0 if (j > 0) named_sync(kXEmpty, 256); T1(2) }"),
        ("        named_sync(kXFull, 256);\n",
         "        { T0 named_sync(kXFull, 256); T1(2) }\n"),
        ("      pack_a(x, pa);\n", "      T1(3) T0 pack_a(x, pa);\n"),
        ("      accumulate<T>(acc, pa, w == 0 ? sdO(s) : sQ(s));\n",
         "      accumulate<T>(acc, pa, w == 0 ? sdO(s) : sQ(s)); T1(4)\n"),
        ("    // Epilogue: every product of the CTA is done",
         "    if (prof) g_prof[slot + 7] += clock64() - t_loop;\n"
         "    // Epilogue: every product of the CTA is done"),
        ("      for (int j = 0; j < m; ++j) {\n        const int s = j % "
         "L::kStages, i = part + kParts * j;\n",
         "      const bool prof = blockIdx.x == 0 && blockIdx.y == 0 && "
         "blockIdx.z == 0 && lane == 0;\n      const int slot = 16;\n"
         "      for (int j = 0; j < m; ++j) {\n        const int s = j % "
         "L::kStages, i = part + kParts * j;\n"),
        ("        mbar_wait(empty + 8 * s, ((j / L::kStages) & 1) ^ 1);\n",
         "        T0 mbar_wait(empty + 8 * s, ((j / L::kStages) & 1) ^ 1); "
         "T1(0)\n"),
    ],
    "dq": [
        ("    const int r0 = 16 * warp + g;  // this thread's rows q0 + r0, + 8\n",
         "    const int r0 = 16 * warp + g;  // this thread's rows q0 + r0, + 8\n"
         "    const bool prof = blockIdx.x == 0 && blockIdx.y == 0 && "
         "tid == 0;\n    const int slot = 24 + 8 * w;\n"
         "    long long t_loop = clock64();\n"),
        ("      mbar_wait(full + 8 * s, (i / L::kStages) & 1);\n",
         "      T0 mbar_wait(full + 8 * s, (i / L::kStages) & 1); T1(0)\n"),
        ("      tile_product<T, D>(x, w == 0 ? sQ : sdO, w == 0 ? sK(s) : "
         "sV(s));\n",
         "      T0 tile_product<T, D>(x, w == 0 ? sQ : sdO, w == 0 ? sK(s) : "
         "sV(s)); T1(1) T0\n"),
        ("      named_sync(kXFull, 256);\n",
         "      T1(3) T0 named_sync(kXFull, 256); T1(2) T0\n"),
        ("      named_sync(kXEmpty, 256);  // both exchanges read\n",
         "      T1(3) T0 named_sync(kXEmpty, 256); T1(2) T0\n"),
        ("      accumulate<T>(acc, pa, sK(s) + w * (T::kCB / 2) * "
         "T::kBlock);\n",
         "      accumulate<T>(acc, pa, sK(s) + w * (T::kCB / 2) * "
         "T::kBlock); T1(4)\n"),
        ("    // Epilogue: q is free once both warpgroups are done",
         "    if (prof) g_prof[slot + 7] += clock64() - t_loop;\n"
         "    // Epilogue: q is free once both warpgroups are done"),
    ],
}
# dk/dv's "form" span holds its named barriers' waits; dq's does not.
SECTION_NAMES = ("wait for a stage", "tile product", "named barriers",
                 "form p / dS", "accumulate", "", "", "loop")
SECTION_HEADER = """
__device__ unsigned long long g_prof[48];
#define T0 { long long t_span = clock64();
#define T1(k) if (prof) g_prof[slot + (k)] += clock64() - t_span; }
extern "C" int lm_bwd_prof(void* out, int zero) {
  if (zero) {
    unsigned long long z[48] = {0};
    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
"""


def export_parent(dest: Path, rev: str) -> None:
    """Write rev's two flash sources and its headers into ``dest``."""
    dest.mkdir(parents=True, exist_ok=True)
    csrc = "src/repro_torch/csrc"
    names = subprocess.run(["git", "ls-tree", "--name-only", f"{rev}:{csrc}"],
                           cwd=ROOT, check=True, capture_output=True,
                           text=True).stdout.split()
    for name in names:
        if name.endswith(".cuh") or name in SOURCES:
            (dest / name).write_bytes(subprocess.run(
                ["git", "show", f"{rev}:{csrc}/{name}"], cwd=ROOT,
                check=True, capture_output=True).stdout)
            print(f"{rev}:{csrc}/{name} -> {dest / name}")


def build(parent: Path) -> dict:
    """{source: the parent's library}, built beside this tree's libraries,
    one nvcc each, all at once."""
    from repro_torch.kernels import cuda
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in SOURCES:
        lib = OUT / f"parent_{Path(src).stem}.so"
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(parent), "-o",
               str(lib), str(parent / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    cuda.build_all(["flash_attention", "flash_attention_bwd_pre"])
    libs = {}
    for src, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {src}:\n{log}")
        libs[src] = lib
    return libs


def sections_source() -> str:
    """This tree's flash_attention_bwd.cu with the SECTIONS counters."""
    from repro_torch.kernels import cuda
    text = (cuda.CSRC / "flash_attention_bwd.cu").read_text()
    cut = text.index("flash_bwd_dq_wgmma_kernel(const")
    parts = {"dkdv": text[:cut], "dq": text[cut:]}
    for kernel, edits in SECTIONS.items():
        for anchor, repl in edits:
            if parts[kernel].count(anchor) != 1:
                raise RuntimeError(f"{kernel}: anchor {anchor!r} is not in "
                                   f"its kernel once: update SECTIONS")
            parts[kernel] = parts[kernel].replace(anchor, repl)
    text = parts["dkdv"] + parts["dq"]
    head = text.index("namespace {")
    return text[:head] + SECTION_HEADER + text[head:]


def run_sections() -> dict:
    """Build the SECTIONS copy and read its counters at each shape."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.flash_attention import _flash_cuda, bwd_delta
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "flash_attention_bwd_sections.cu"
    src.write_text(sections_source())
    lib_path = OUT / "sections.so"
    proc = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I",
                           str(cuda.CSRC), "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the sections copy:\n"
                           f"{proc.stdout}{proc.stderr}")
    cuda.build_all(["flash_attention", "flash_attention_bwd_pre"])
    lib = ctypes.CDLL(str(lib_path))
    prof = lib.lm_bwd_prof
    prof.argtypes, prof.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    fns = {}
    for name in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        _src, symbol, argtypes = cuda.KERNELS[name]
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = launcher(fn)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    out = {}
    for b in (1, 2):
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen)
                       .to(torch.bfloat16) for shape in ((b, HQ, S, D),
                                                         (b, HKV, S, D),
                                                         (b, HKV, S, D),
                                                         (b, HQ, S, D)))
        for label, window in (("global", None), ("local", WINDOW)):
            with torch.no_grad():
                o, lse = _flash_cuda(q, k, v, causal=True, window=window,
                                     logit_softcap=None, scale=None,
                                     with_lse=True)
            delta = bwd_delta(o, do)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            mask = (1, -1 if window is None else window, 0.0, D ** -0.5)
            shape = (b, HQ, HKV, S, S, D, 1)
            common = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), delta.data_ptr())
            # one warm launch of each, then the counted ones
            for _ in range(2):
                torch.cuda.synchronize()
                if prof(None, 1) != 0:
                    raise RuntimeError("could not zero the counters")
                fns["flash_attention_bwd_dkdv"](
                    *common, dk.data_ptr(), dv.data_ptr(), *shape, *mask)
                fns["flash_attention_bwd_dq"](*common, dq.data_ptr(), *shape,
                                              *mask)
                torch.cuda.synchronize()
            got = (ctypes.c_ulonglong * 48)()
            if prof(ctypes.addressof(got), 0) != 0:
                raise RuntimeError("could not read the counters")
            tag = f"{label}, B {b}"
            rows = {}
            for who, base in (("dk/dv warpgroup 1 (S^T, p, dv)", 0),
                              ("dk/dv warpgroup 2 (dP^T, dS, dk)", 8),
                              ("dk/dv producer", 16),
                              ("dq warpgroup 1 (S, p)", 24),
                              ("dq warpgroup 2 (dP)", 32)):
                rows[who] = {n: got[base + i] for i, n in
                             enumerate(SECTION_NAMES) if n and got[base + i]}
                print(f"   {tag}: {who}: " + ", ".join(
                    f"{n} {c}" for n, c in rows[who].items()) + " cycles",
                    flush=True)
            out[tag] = rows
    return out


def parent_fn(libs: dict, name: str):
    """The parent library's C entry point of kernel ``name``."""
    from repro_torch.kernels import cuda
    src, symbol, argtypes = cuda.KERNELS[name]
    fn = getattr(ctypes.CDLL(str(libs[src])), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def launcher(fn):
    """A launch of C entry point ``fn`` on the current stream that raises
    on a refused launch."""
    import torch

    def run(*args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed (cudaError {err})")
    return run


def in_turns(label: str, calls: dict, symbol) -> dict:
    """Device ms a launch of each of ``calls`` ("parent", "this tree"),
    timed parent, this tree, this tree, parent."""
    from chip_smoke import kernel_device_ms
    times = {k: [] for k in calls}
    for k in ("parent", "this tree", "this tree", "parent"):
        times[k].append(kernel_device_ms(calls[k], REPS, None, symbol))
    row = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"   {label}: parent {times['parent']} ms, this tree "
          f"{times['this tree']} ms (device): "
          f"{row['parent'] / row['this tree']!r} x", flush=True)
    return {"parent_ms": times["parent"], "ms": times["this tree"],
            "speedup": row["parent"] / row["this tree"]}


def backward_rows(libs: dict, b: int, gen) -> dict:
    import torch
    from chip_smoke import FLASH_BWD_ROW_TOL, FLASH_BWD_TOL, grad_errs
    from repro_torch.kernels import cuda
    from repro_torch.kernels.flash_attention import (
        _flash_cuda, bwd_delta, flash_attention_bwd_plain)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen)
                   .to(torch.bfloat16) for shape in ((b, HQ, S, D),
                                                     (b, HKV, S, D),
                                                     (b, HKV, S, D),
                                                     (b, HQ, S, D)))
    out = {}
    for label, window in (("global", None), ("local", WINDOW)):
        tag = f"{label}, B {b}"
        kw = dict(causal=True, window=window, logit_softcap=None)
        with torch.no_grad():
            o, lse = _flash_cuda(q, k, v, scale=None, with_lse=True, **kw)
        delta = bwd_delta(o, do)
        mask = (1, -1 if window is None else window, 0.0, D ** -0.5)
        shape = (b, HQ, HKV, S, S, D, 1)
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr())
        grads = {}
        for who, dkdv, dq in (
                ("this tree", launcher(cuda.kernel_fn(
                    "flash_attention_bwd_dkdv")), launcher(cuda.kernel_fn(
                        "flash_attention_bwd_dq"))),
                ("parent", launcher(parent_fn(
                    libs, "flash_attention_bwd_dkdv")), launcher(parent_fn(
                        libs, "flash_attention_bwd_dq")))):
            g = [torch.empty_like(t) for t in (q, k, v)]
            grads[who] = (g, (lambda dkdv=dkdv, g=g: dkdv(
                *common, g[1].data_ptr(), g[2].data_ptr(), *shape, *mask)),
                (lambda dq=dq, g=g: dq(*common, g[0].data_ptr(), *shape,
                                       *mask)))
            grads[who][1]()
            grads[who][2]()
        torch.cuda.synchronize()
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        for who, (g, _a, _b) in grads.items():
            print(f"   {tag}: {who} against the plain version", flush=True)
            for name, got, w in zip(("dq", "dk", "dv"), g, want):
                grad_errs(got, w, FLASH_BWD_TOL["bfloat16"],
                          FLASH_BWD_ROW_TOL["bfloat16"], name)
        first = [t.clone() for t in grads["this tree"][0]]
        grads["this tree"][1]()
        grads["this tree"][2]()
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in
                   zip(first, grads["this tree"][0]))
        print(f"   {tag}: this tree's second run gives the same bits: "
              f"{same}", flush=True)
        if not same:
            raise RuntimeError(f"{tag}: two runs differ")
        out[f"flash_attention_bwd_dkdv ({tag})"] = in_turns(
            f"flash_attention_bwd_dkdv ({tag})",
            {who: grads[who][1] for who in grads}, ("flash_bwd_dkdv",))
        out[f"flash_attention_bwd_dq ({tag})"] = in_turns(
            f"flash_attention_bwd_dq ({tag})",
            {who: grads[who][2] for who in grads}, ("flash_bwd_dq",))
        del want, grads, first
    return out


def forward_rows(libs: dict, gen) -> dict:
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.flash_attention import byte_strides
    out = {}
    for seq in (S, 2 * S):
        q, k, v = (torch.randn((1, h, seq, D), device="cuda", generator=gen)
                   .to(torch.bfloat16) for h in (HQ, HKV, HKV))
        o = torch.empty_like(q)
        strides = (ctypes.c_longlong * 9)(*byte_strides(q, "q"),
                                          *byte_strides(k, "k"),
                                          *byte_strides(v, "v"))
        for window in (None, WINDOW):
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    None, 1, HQ, HKV, seq, seq, D, 1, 1,
                    -1 if window is None else window, 0.0, D ** -0.5,
                    ctypes.addressof(strides))
            calls = {"this tree": cuda.kernel_fn("flash_attention"),
                     "parent": parent_fn(libs, "flash_attention")}
            calls = {who: (lambda run=launcher(fn): run(*args))
                     for who, fn in calls.items()}
            label = f"flash_attention forward S={seq} window {window}"
            out[label] = in_turns(label, calls, "flash_wgmma_kernel")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="a directory written by --export-parent")
    ap.add_argument("--export-parent", type=Path, default=None)
    ap.add_argument("--rev", default="HEAD")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--sections", action="store_true",
                    help="clock64 sections of this tree's kernels")
    args = ap.parse_args()
    if args.export_parent is not None:
        export_parent(args.export_parent, args.rev)
        return 0
    if args.parent is None and not args.sections:
        ap.error("--parent DIR or --sections is needed")
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.sections:
        result = {"card": smi, "sections": run_sections()}
        if args.json is not None:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(result, indent=1))
        return 0
    t0 = time.perf_counter()
    libs = build(args.parent)
    print(f"   built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    rows = {}
    for b in (1, 2):
        rows.update(backward_rows(libs, b, gen))
    rows.update(forward_rows(libs, gen))
    result = {"card": smi, "rows": rows}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
