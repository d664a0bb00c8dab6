"""The port stands alone and runs on the card unless asked otherwise:
no import of JAX or of the reference package, entry points that raise
without a card, and a chip smoke script that refuses to run without one."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.adaptive import (AdaptiveConfig, AdaptiveFilter,
                                  AdaptiveMembership, make_adaptive_state)
from repro_torch.convert import (adaptive_state_from_numpy,
                                 generational_from_numpy, ocf_from_numpy,
                                 state_from_numpy)
from repro_torch.core.filter import make_state
from repro_torch.core.filter_ops import FilterOps
from repro_torch.core.ocf import OCF, OcfConfig
from repro_torch.kernels import cuda
from repro_torch.kernels.delete import _delete_adaptive_cuda
from repro_torch.kernels.fingerprint import _family_cuda
from repro_torch.kernels.insert import _insert_adaptive_cuda
from repro_torch.kernels.probe import _probe_adaptive_cuda, _probe_multi_cuda
from repro_torch.kernels.stash import make_stash
from repro_torch.serving import GenerationalPrefixIndex, PrefixCacheIndex
from repro_torch.streaming import (GenerationalFilter, GenerationConfig,
                                   OverflowStash)
from repro_torch.streaming.stash import make_sharded_stashes

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_or_reference_imports_in_source():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()[:-1]}
    for sub in ("streaming/generations.py", "streaming/stash.py",
                "obs/registry.py", "obs/trace.py", "obs/recovery.py",
                "serving/kvcache.py"):
        assert sub in files, sub
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert len(mods) >= 35, mods\n"
        "for m in ('streaming.generations', 'streaming.stash', 'obs.trace',"
        " 'obs.registry', 'obs.recovery', 'serving.kvcache'):\n"
        "    assert 'repro_torch.' + m in mods, m\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = np.zeros((1024, 4), np.uint32)
    for call in (lambda: OCF(),
                 lambda: OCF(OcfConfig(capacity=4096)),
                 lambda: make_state(256),
                 lambda: make_stash(8),
                 lambda: state_from_numpy(table, 0, 1024),
                 lambda: ocf_from_numpy(OcfConfig(), table=table, count=0,
                                        n_buckets=1024,
                                        keys=np.zeros(0, np.uint64)),
                 lambda: make_adaptive_state(256),
                 lambda: AdaptiveFilter(AdaptiveConfig(n_buckets=256)),
                 lambda: AdaptiveMembership(AdaptiveConfig(n_buckets=256)),
                 lambda: adaptive_state_from_numpy(
                     table, np.zeros((1024, 1), np.uint32), table, table, 0,
                     1024),
                 lambda: GenerationalFilter(),
                 lambda: GenerationalFilter(GenerationConfig(capacity=4096)),
                 lambda: generational_from_numpy(
                     GenerationConfig(capacity=4096),
                     gens=[dict(table=table, stash=np.zeros((2, 128),
                                                            np.uint32),
                                count=0, born=0.0, expires=None)],
                     last_now=0.0),
                 lambda: GenerationalPrefixIndex(),
                 lambda: PrefixCacheIndex(),
                 lambda: OverflowStash(8),
                 lambda: make_sharded_stashes(2, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asking for the CPU is what makes it run there
    ocf = OCF(OcfConfig(capacity=4096, device="cpu"))
    ocf.insert(np.arange(100, dtype=np.uint64))
    assert ocf.lookup(np.arange(100, dtype=np.uint64)).all()
    ring = GenerationalFilter(GenerationConfig(capacity=4096, device="cpu"),
                              now=0.0)
    assert ring.insert(np.arange(100, dtype=np.uint64), now=0.0).all()
    assert ring.lookup(np.arange(100, dtype=np.uint64), now=0.0).all()


def test_backends():
    assert FilterOps().backend == "auto"
    assert FilterOps(backend="cuda").evict_rounds == 32
    with pytest.raises(NotImplementedError):
        FilterOps(backend="torch")
    with pytest.raises(ValueError):
        FilterOps(backend="pallas")


def test_kernel_wrappers_refuse_non_cuda_tensors():
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda.check_cuda("probe", table=t, hi=t)
    with pytest.raises(TypeError):
        cuda.check_dtype("probe", torch.int32, hi=t.float())
    table = torch.zeros((16, 4), dtype=torch.int32)
    cuda.check_table("insert_bulk", table, 16, torch.zeros((2, 4)))
    for bad in (0, 17):
        with pytest.raises(ValueError):
            cuda.check_table("insert_bulk", table, bad)
    with pytest.raises(ValueError):
        cuda.check_table("probe", table, 8, torch.zeros((3, 4)))
    sels = torch.zeros((16, 1), dtype=torch.int32)
    cuda.check_table("insert_bulk_adaptive", table, 16, sels=sels, khi=table,
                     klo=table)
    for bad in (dict(sels=sels[:8]), dict(sels=table),
                dict(khi=table[:8]), dict(klo=table[:, :2])):
        with pytest.raises(ValueError):
            cuda.check_table("insert_bulk_adaptive", table, 16, **bad)
    # the four adaptive wrappers' and probe_multi's CUDA paths refuse CPU
    # tensors
    keys = torch.zeros(128, dtype=torch.int32)
    valid = torch.ones(128, dtype=torch.bool)
    kw = dict(fp_bits=16, n_buckets=16)
    for call in (
            lambda: _family_cuda(keys, keys, **kw),
            lambda: _probe_adaptive_cuda(table, sels, keys, keys, stash=None,
                                         **kw),
            lambda: _insert_adaptive_cuda(table, sels, table, table, keys,
                                          keys, valid, evict_rounds=8,
                                          stash=None, block=128, **kw),
            lambda: _delete_adaptive_cuda(table, sels, table, table, keys,
                                          keys, valid, block=128, **kw),
            lambda: _probe_multi_cuda(table[None], keys, keys,
                                      stashes=None, **kw)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()


def test_build_names_a_library_per_source():
    names = {cuda._lib_path(k).name for k in cuda.KERNELS}
    assert len(names) == 9
    assert all(n.startswith("lib") and n.endswith(".so") for n in names)
    assert cuda.BUILD_DIR == ROOT / "build"
    for src, _fn, _args in cuda.KERNELS.values():
        assert (PORT / "csrc" / src).exists()
    text = (PORT / "csrc" / "ocf_common.cuh").read_text()
    assert "__host__ __device__" in text


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
