"""Build, load and count the hand-written CUDA kernels.

Each source in ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, and
loaded with ``ctypes``.  Builds happen at first use, from the package's
sources only, into ``build/`` at the root of the checkout; a library's
file name carries a hash of its source and the shared headers, so an
edited source is rebuilt.
``build_all`` starts one ``nvcc`` per source at once and waits for all.

Every kernel wrapper counts its launches in ``LAUNCHES`` (one per kernel
launch, nowhere else), and every plain PyTorch version counts its calls in
``PLAIN_CALLS``, so a run can show which path it went through;
``CARD_LAUNCHES`` counts the same launches by (kernel, card index).  The
telemetry instantiations (``TM_KERNELS``) are entries of their own, with
the sources of their kernels: ``LAUNCHES`` counts them under their own
names, so a run shows which of the two arms it took.
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

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_U64, _F = ctypes.c_uint64, ctypes.c_float
# kernel name -> (source, C function, argtypes)
KERNELS = {
    "fingerprint_hash": ("fingerprint.cu", "ocf_fingerprint_hash",
                         [_P, _P, _P, _P, _P, _I, _I, _U, _P]),
    "probe": ("probe.cu", "ocf_probe",
              [_P, _I, _P, _I, _P, _P, _P, _I, _I, _U, _P]),
    "probe_tm": ("probe.cu", "ocf_probe_tm",
                 [_P, _I, _P, _I, _P, _P, _P, _I, _I, _U, _P, _I, _P]),
    "insert_bulk": ("insert.cu", "ocf_insert_bulk",
                    [_P, _I, _U, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                     _P, _P]),
    "insert_bulk_tm": ("insert.cu", "ocf_insert_bulk_tm",
                       [_P, _I, _U, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                        _P, _P, _P]),
    "delete_bulk": ("delete.cu", "ocf_delete_bulk",
                    [_P, _I, _U, _P, _P, _P, _P, _I, _I, _I, _P, _P]),
    "fingerprint_hash_family": ("fingerprint_family.cu",
                                "ocf_fingerprint_hash_family",
                                [_P, _P, _P, _I, _I, _U, _P]),
    "probe_adaptive": ("probe_adaptive.cu", "ocf_probe_adaptive",
                       [_P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _U, _P]),
    "probe_adaptive_tm": ("probe_adaptive.cu", "ocf_probe_adaptive_tm",
                          [_P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _U, _P,
                           _I, _P]),
    "insert_bulk_adaptive": ("insert_adaptive.cu", "ocf_insert_bulk_adaptive",
                             [_P, _P, _P, _P, _I, _U, _P, _I, _P, _P, _P, _P,
                              _I, _I, _I, _I, _P, _P]),
    "insert_bulk_adaptive_tm": ("insert_adaptive.cu",
                                "ocf_insert_bulk_adaptive_tm",
                                [_P, _P, _P, _P, _I, _U, _P, _I, _P, _P, _P,
                                 _P, _I, _I, _I, _I, _P, _P, _P]),
    "delete_bulk_adaptive": ("delete_adaptive.cu", "ocf_delete_bulk_adaptive",
                             [_P, _P, _P, _P, _I, _U, _P, _P, _P, _P, _I, _I,
                              _I, _P, _P]),
    "probe_multi": ("probe_multi.cu", "ocf_probe_multi",
                    [_P, _I, _U64, _I, _I, _P, _I, _P, _P, _P, _I, _I, _U,
                     _I, _P]),
    "scan_insert": ("scan.cu", "ocf_scan_insert",
                    [_P, _I, _I, _U, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _P, _P]),
    "scan_delete": ("scan.cu", "ocf_scan_delete",
                    [_P, _I, _I, _U, _P, _P, _P, _I, _P, _P, ctypes.c_longlong,
                     _P, _I, _P]),
    "flash_attention": ("flash_attention.cu", "lm_flash_attention",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _F, _F, _P, _P]),
    "flash_attention_bwd_pre": ("flash_attention_bwd.cu", "lm_flash_bwd_pre",
                                [_P, _P, _P, ctypes.c_longlong, _I, _I, _P]),
    "flash_attention_bwd_dkdv": ("flash_attention_bwd.cu",
                                 "lm_flash_bwd_dkdv",
                                 [_P] * 8 + [_I] * 9 + [_F, _F, _P]),
    "flash_attention_bwd_dq": ("flash_attention_bwd.cu", "lm_flash_bwd_dq",
                               [_P] * 7 + [_I] * 9 + [_F, _F, _P]),
}
# The telemetry twins: kernel name -> the kernel they instantiate.
TM_KERNELS = {"probe_tm": "probe", "insert_bulk_tm": "insert_bulk",
              "probe_adaptive_tm": "probe_adaptive",
              "insert_bulk_adaptive_tm": "insert_bulk_adaptive"}
# kernel name -> (C function, argtypes) giving the bytes of device memory a
# launch needs beside its shared memory (0 on the main path).
SPILL_SIZES = {
    "insert_bulk": ("ocf_insert_bulk_spill_bytes", [_I, _I, _I, _I, _I]),
    "insert_bulk_tm": ("ocf_insert_bulk_spill_bytes", [_I, _I, _I, _I, _I]),
    "delete_bulk": ("ocf_delete_bulk_spill_bytes", [_I, _I, _I]),
    "insert_bulk_adaptive": ("ocf_insert_bulk_adaptive_spill_bytes",
                             [_I, _I, _I, _I, _I]),
    "insert_bulk_adaptive_tm": ("ocf_insert_bulk_adaptive_spill_bytes",
                                [_I, _I, _I, _I, _I]),
    "delete_bulk_adaptive": ("ocf_delete_bulk_adaptive_spill_bytes",
                             [_I, _I, _I]),
}
# Keys a launch of the adaptive insert and delete takes at most, unless
# the caller passes another ``split_keys`` to their wrappers: a larger
# call is split at logical-block boundaries into launches in order (the
# same result, since the blocks run in order and carry the planes and the
# stash).  Each launch's L2-warming CTAs prefetch its keys' rows at once:
# 2^17 keys bring ~9 MB of row and selector sectors into the 50 MB L2, so
# they are still there when the one working CTA reaches them.
SPLIT_KEYS = 1 << 17
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()
CARD_LAUNCHES: collections.Counter = collections.Counter()
PLAIN_CALLS: collections.Counter = collections.Counter()
_FUNCS: dict = {}


def reset_counts() -> None:
    """Zero every launch and plain-call count."""
    LAUNCHES.clear()
    CARD_LAUNCHES.clear()
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
    for f in (*sorted(p.name for p in CSRC.glob("*.cuh")), src):
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
    procs, outs = {}, set()
    for name in names:
        out = _lib_path(name)
        if out.exists() or out in outs:   # a twin shares its source
            continue
        outs.add(out)
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


def _c_function(name: str, symbol: str, argtypes, restype):
    fn = _FUNCS.get(symbol)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _FUNCS[symbol] = fn
    return fn


def kernel_fn(name: str):
    """The loaded C entry point of a kernel, building it at first use."""
    _src, symbol, argtypes = KERNELS[name]
    return _c_function(name, symbol, argtypes, ctypes.c_int)


def spill_buffer(name: str, device, *args):
    """The device-memory buffer a launch of ``name`` needs beside its shared
    memory (``SPILL_SIZES``), or None when it needs none."""
    symbol, argtypes = SPILL_SIZES[name]
    with torch.cuda.device(device):
        nbytes = _c_function(name, symbol, argtypes,
                             ctypes.c_longlong)(*args)
    if nbytes == 0:
        return None
    return torch.empty((nbytes,), dtype=torch.uint8, device=device)


def spans(n: int, block: int, split_keys: int = SPLIT_KEYS):
    """(start, stop) of each launch of a call over ``n`` keys: at most
    ``split_keys`` keys (at least one block), at block boundaries."""
    step = max(block, split_keys // block * block)
    return [(s, min(n, s + step)) for s in range(0, n, step)]


def launch(name: str, device, *args) -> None:
    """Launch a kernel on ``device``, the card its tensors lie on, and on
    that card's current stream; raise if CUDA refused it.  The C entry
    point runs with ``device`` current, whichever card the caller had
    current, so its launch and its per-card queries reach that card."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = kernel_fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")
    LAUNCHES[name] += 1
    CARD_LAUNCHES[name, torch.device(device).index] += 1


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for an absent optional tensor)."""
    return None if t is None else t.data_ptr()


def check_cuda(name: str, *, contiguous: bool = True,
               **tensors) -> torch.device:
    """Wrapper-side checks: every tensor on one CUDA device and, unless the
    kernel takes strides (``contiguous=False``), contiguous -> that
    device."""
    devs = {t.device for t in tensors.values() if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, got "
                         f"{sorted(str(d) for d in devs)}")
    for key, t in tensors.items():
        if contiguous and t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return next(iter(devs))


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
