"""Production meshes as ``torch.distributed`` ``DeviceMesh``es.

Counterpart of ``repro.launch.mesh``.  One pod is 16 x 16 = 256 ranks,
``("data", "model")``; two pods are 2 x 16 x 16 = 512 ranks with a
leading ``"pod"`` axis.  Functions, never module-level meshes: importing
this module starts no process group.

A mesh needs a process group of its size; its device type is the CPU's
(the dry-run's DTensors hold ``meta`` blocks).  Where no such cluster exists
(the dry-run on one host) ``init_fake_process_group`` starts PyTorch's
``fake`` backend, whose collectives return tensors of the right shape and
move nothing: one process stands for one rank (rank 0) of the world.  A
process holds one process group; run each fake world in its own process,
as the reference's dry-run runs in its own process for its device-count
flag.
"""
from __future__ import annotations

import torch


def init_fake_process_group(world_size: int, rank: int = 0) -> None:
    """Start the ``fake`` backend at ``world_size`` (a no-op where this
    process already has a group of that size)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"this process already has a group of "
                f"{dist.get_world_size()} ranks; a fake world of "
                f"{world_size} needs a process of its own")
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:   # the module is internal to PyTorch
        raise RuntimeError(
            "the dry-run needs torch.testing._internal.distributed.fake_pg "
            f"(the 'fake' process-group backend), missing from torch "
            f"{torch.__version__}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def _mesh(shape: tuple, axes: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = 1
    for s in shape:
        need *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs a process group of {need} ranks: call "
            f"init_fake_process_group({need}) (the dry-run does) or start "
            f"one")
    have = dist.get_world_size()
    if have != need:
        raise RuntimeError(f"mesh {shape} needs {need} ranks, the process "
                           f"group has {have}")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int | None = None):
    """A small mesh for tests ((pod,) data, model)."""
    shape = (pod, data, model) if pod else (data, model)
    axes = ("pod", "data", "model") if pod else ("data", "model")
    return _mesh(shape, axes)
