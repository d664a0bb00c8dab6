"""Build, load and count the hand-written CUDA kernels.

Each source in ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, and
loaded with ``ctypes``.  Builds happen at first use, from the package's
sources only, into ``build/`` at the root of the checkout; a library's
file name carries a hash of its sources, so an edited source is rebuilt.
``build_all`` starts one ``nvcc`` per source at once and waits for all.

Every kernel wrapper counts its launches in ``LAUNCHES`` (one per kernel
launch, nowhere else), and every plain PyTorch version counts its calls in
``PLAIN_CALLS``, so a run can show which path it went through.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
HEADER = "ocf_common.cuh"

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_U64 = ctypes.c_uint64
# kernel name -> (source, C function, argtypes)
KERNELS = {
    "fingerprint_hash": ("fingerprint.cu", "ocf_fingerprint_hash",
                         [_P, _P, _P, _P, _P, _I, _I, _U, _P]),
    "probe": ("probe.cu", "ocf_probe",
              [_P, _I, _P, _I, _P, _P, _P, _I, _I, _U, _P]),
    "insert_bulk": ("insert.cu", "ocf_insert_bulk",
                    [_P, _I, _U, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                     _P, _P, _P, _P, _P]),
    "delete_bulk": ("delete.cu", "ocf_delete_bulk",
                    [_P, _I, _U, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P]),
    "fingerprint_hash_family": ("fingerprint_family.cu",
                                "ocf_fingerprint_hash_family",
                                [_P, _P, _P, _I, _I, _U, _P]),
    "probe_adaptive": ("probe_adaptive.cu", "ocf_probe_adaptive",
                       [_P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _U, _P]),
    "insert_bulk_adaptive": ("insert_adaptive.cu", "ocf_insert_bulk_adaptive",
                             [_P, _P, _P, _P, _I, _U, _P, _I, _P, _P, _P, _P,
                              _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "delete_bulk_adaptive": ("delete_adaptive.cu", "ocf_delete_bulk_adaptive",
                             [_P, _P, _P, _P, _I, _U, _P, _P, _P, _P, _I, _I,
                              _I, _P, _P, _P]),
    "probe_multi": ("probe_multi.cu", "ocf_probe_multi",
                    [_P, _I, _U64, _I, _I, _P, _I, _P, _P, _P, _I, _I, _U,
                     _P]),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()
PLAIN_CALLS: collections.Counter = collections.Counter()
_FUNCS: dict = {}


def reset_counts() -> None:
    """Zero every launch and plain-call count."""
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = KERNELS[name][0]
    digest = hashlib.sha256()
    for f in (HEADER, src):
        digest.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{Path(src).stem}-{digest.hexdigest()[:12]}.so"


def build_all(names=None) -> dict:
    """Compile the named kernels' libraries (all by default) in parallel.

    Returns ``{name: seconds}`` for the libraries built now (those already
    in ``build/`` are skipped).  Raises with nvcc's output on failure; the
    ptxas report (registers, shared memory, spills) of each build is kept
    beside its library as ``.log``.
    """
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def kernel_fn(name: str):
    """The loaded C entry point of a kernel, building it at first use."""
    fn = _FUNCS.get(name)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, KERNELS[name][1])
        fn.argtypes = KERNELS[name][2]
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Launch a kernel on the current stream; raise if CUDA refused it."""
    stream = torch.cuda.current_stream().cuda_stream
    err = kernel_fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")
    LAUNCHES[name] += 1


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for an absent optional tensor)."""
    return None if t is None else t.data_ptr()


def check_cuda(name: str, **tensors) -> None:
    """Wrapper-side checks: every tensor on one CUDA device, contiguous."""
    devs = {t.device for t in tensors.values() if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, got "
                         f"{sorted(str(d) for d in devs)}")
    for key, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def check_table(name: str, table, n_buckets: int, stash=None, *,
                sels=None, khi=None, klo=None) -> None:
    """A [buffer, bucket_size] table whose active region fits, a [2, S]
    stash when one is given, and, for the adaptive kernels, a packed
    [buffer, 1] selector plane and mirror key planes of the table's shape.
    """
    if table.dim() != 2 or not 0 < n_buckets <= table.shape[0]:
        raise ValueError(f"{name}: table must be [buffer, bucket_size] "
                         f"with 0 < n_buckets <= buffer, got "
                         f"{tuple(table.shape)} and {n_buckets}")
    if stash is not None and (stash.dim() != 2 or stash.shape[0] != 2):
        raise ValueError(f"{name}: stash must be [2, slots], got "
                         f"{tuple(stash.shape)}")
    if sels is not None and tuple(sels.shape) != (table.shape[0], 1):
        raise ValueError(f"{name}: sels must be [buffer, 1], got "
                         f"{tuple(sels.shape)}")
    if sels is not None and table.shape[1] > 16:
        raise ValueError(f"{name}: a packed selector word holds at most "
                         f"16 slots, got bucket_size {table.shape[1]}")
    for key, plane in (("khi", khi), ("klo", klo)):
        if plane is not None and plane.shape != table.shape:
            raise ValueError(f"{name}: {key} must have the table's shape "
                             f"{tuple(table.shape)}, got "
                             f"{tuple(plane.shape)}")


def check_dtype(name: str, dtype, **tensors) -> None:
    for key, t in tensors.items():
        if t is not None and t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
