"""Atomic, restart-safe checkpoints of arrays, filter states and the OCF.

Counterpart of ``repro.checkpoint.ckpt``, in the same on-disk format, so a
checkpoint written by either package restores in the other:

    <dir>/step_<n>.tmp/  -> one fsync'd .npy per leaf + manifest.json,
    atomically renamed to <dir>/step_<n>/ (a crash mid-write leaves only a
    .tmp, which restore ignores).

A tree is nested dicts, lists, tuples and NamedTuples of leaves (tensors,
numpy arrays, numbers); ``None`` holds no leaf.  Leaves are named by their
path as the reference names them (``['tables']``, ``[0]``, ``.field``) and
numbered in sorted name order.  A tensor is written as its numpy array;
bfloat16 leaves (which ``.npy`` cannot hold) as their uint16 bits under
their logical dtype.  The sharded filter's int32 tables and stashes are
written as uint32, the reference's dtype, and read back as int32 bit for
bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> list:
    """[(path, leaf)] in the reference's leaf order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(like, leaves: dict, prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``leaves[path]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, f"{prefix}[{k!r}]")
                for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves,
                                       f"{prefix}.{f}")
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves, f"{prefix}[{i}]")
                          for i, x in enumerate(like))
    if prefix not in leaves:
        raise KeyError(f"checkpoint missing leaf {prefix}")
    return leaves[prefix]


def _to_numpy(v) -> tuple[np.ndarray, str]:
    """A leaf -> (array to write, logical dtype name)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        v = v.numpy()
    arr = np.asarray(v)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, *, ocf=None,
         extra: Optional[dict] = None) -> str:
    """Write ``tree`` (and optionally an OCF's table and keys) as step
    ``step`` -> the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names = {}
    for i, (k, v) in enumerate(sorted(_flatten(tree), key=lambda kv: kv[0])):
        fn = f"leaf_{i:05d}.npy"
        arr, dtype_name = _to_numpy(v)
        np.save(os.path.join(tmp, fn), arr)
        names[k] = {"file": fn, "dtype": dtype_name}
    if ocf is not None:
        table = ocf.state.table.detach().cpu().numpy().view(np.uint32)
        np.save(os.path.join(tmp, "ocf_table.npy"), table)
        np.save(os.path.join(tmp, "ocf_keys.npy"), ocf.keystore.materialize())
    manifest = {"step": step, "leaves": names, "extra": extra or {},
                "has_ocf": ocf is not None}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree, *,
            device=None) -> tuple[Any, dict]:
    """Restore into the structure of ``like_tree`` -> (tree, manifest).

    Leaves come back as numpy arrays (bfloat16 ones as bfloat16 tensors,
    which numpy cannot hold), or, with ``device``, as tensors there.
    """
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for k, _v in _flatten(like_tree):
        rec = manifest["leaves"].get(k)
        if rec is None:
            raise KeyError(f"checkpoint missing leaf {k}")
        arr = np.load(os.path.join(path, rec["file"]))
        if rec["dtype"] == "bfloat16":
            arr = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        elif str(arr.dtype) != rec["dtype"]:
            raise TypeError(f"leaf {k}: stored {arr.dtype}, manifest "
                            f"{rec['dtype']}")
        if device is not None:
            arr = torch.as_tensor(arr).to(device)
        leaves[k] = arr
    return _unflatten(like_tree, leaves), manifest


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


def save_sharded(ckpt_dir: str, step: int, state) -> str:
    """Checkpoint a ``ShardedFilterState`` (the fault-recovery snapshot):
    tables (and stashes) stacked over every shard as uint32 leaves,
    whatever the state's parts, ``n_buckets`` in the manifest."""
    tables, stashes = state.stacked("cpu")
    tree = {"tables": _u32(tables)}
    if stashes is not None:
        tree["stashes"] = _u32(stashes)
    extra = {"sharded_filter": {"n_buckets": state.n_buckets,
                                "has_stashes": stashes is not None}}
    return save(ckpt_dir, step, tree, extra=extra)


def restore_sharded(ckpt_dir: str, step: Optional[int] = None, *,
                    device="cuda", mesh=None, devices=None):
    """Restore a ``ShardedFilterState`` saved by ``save_sharded`` (by either
    package), each shard on its device: laid out as ``mesh`` is, or one
    part a shard on ``devices``, or one part on ``device``; ``step=None``
    takes the latest."""
    from repro_torch.core.distributed import place_shards, shard_layout
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)["extra"]["sharded_filter"]
    like = {"tables": 0}
    if meta["has_stashes"]:
        like["stashes"] = 0
    tree, _ = restore(ckpt_dir, step, like)

    def i32(a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
        return torch.from_numpy(a.view(np.int32).copy())

    tables = i32(tree["tables"])
    parts = (mesh.parts if mesh is not None else
             shard_layout(tables.shape[0], device=device, devices=devices))
    return place_shards(parts, tables,
                        i32(tree["stashes"]) if meta["has_stashes"] else None,
                        meta["n_buckets"])


def restore_ocf(ckpt_dir: str, step: int, ocf):
    """Refill ``ocf`` from a checkpoint's keystore (a rebuild)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    keys = np.load(os.path.join(path, "ocf_keys.npy"))
    ocf.keystore.clear()
    if keys.size:
        ocf.insert(keys)
    return ocf


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread; ``join()`` before exit."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree, **kw):
        self.join()
        host = _unflatten(tree, {k: _host_copy(v)
                                 for k, v in _flatten(tree)})

        def work():
            save(self.ckpt_dir, step, host, **kw)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _host_copy(v):
    """A snapshot of a leaf taken before the save runs in the background."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().clone()
    return np.array(v, copy=True)
