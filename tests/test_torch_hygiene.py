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
                                 sharded_state_from_numpy, state_from_numpy)
from repro_torch.core.distributed import make_sharded_state
from repro_torch.distributed.elastic import filter_mesh
from repro_torch.core.filter import make_state
from repro_torch.core.filter_ops import FilterOps
from repro_torch.core.ocf import OCF, OcfConfig
from repro_torch.kernels import cuda
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.delete import _delete_adaptive_cuda
from repro_torch.kernels.flash_attention import _flash_cuda
from repro_torch.kernels.fingerprint import _family_cuda
from repro_torch.kernels.insert import _insert_adaptive_cuda
from repro_torch.kernels.probe import _probe_adaptive_cuda, _probe_multi_cuda
from repro_torch.kernels.scan import _scan_delete_cuda, _scan_insert_cuda
from repro_torch.kernels.stash import make_stash
from repro_torch.launch.serve import serve
from repro_torch.models import Transformer
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
                "serving/kvcache.py", "serving/engine.py",
                "models/transformer.py", "models/attention.py",
                "models/layers.py", "models/config.py",
                "kernels/flash_attention.py", "kernels/ref.py",
                "configs/registry.py", "launch/serve.py",
                "kernels/scan.py", "core/distributed.py",
                "distributed/elastic.py", "distributed/fault.py",
                "distributed/sharding.py", "checkpoint/ckpt.py",
                "launch/dryrun.py", "launch/mesh.py", "launch/specs.py",
                "roofline/analysis.py"):
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
        "assert len(mods) >= 50, mods\n"
        "for m in ('streaming.generations', 'streaming.stash', 'obs.trace',"
        " 'obs.registry', 'obs.recovery', 'serving.kvcache',"
        " 'serving.engine', 'models.transformer', 'kernels.flash_attention',"
        " 'configs.gemma3_1b', 'launch.serve', 'kernels.scan',"
        " 'core.distributed', 'distributed.elastic', 'distributed.fault',"
        " 'distributed.sharding', 'checkpoint.ckpt', 'launch.dryrun',"
        " 'launch.mesh', 'launch.specs', 'roofline.analysis'):\n"
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
                 lambda: make_sharded_stashes(2, 8),
                 lambda: Transformer(get_smoke_config("gemma3-1b")),
                 lambda: serve("gemma3-1b", requests=1, prefix_len=16,
                               gen=2),
                 lambda: filter_mesh(2),
                 lambda: make_sharded_state(2, 64),
                 lambda: sharded_state_from_numpy(table[None], None, 1024)):
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
    mesh = filter_mesh(2, device="cpu")
    assert mesh.device.type == "cpu" and mesh.shape == {"data": 2}
    assert make_sharded_state(2, 64, device="cpu").tables.device.type == \
        "cpu"


def test_meta_reaches_construction_only(monkeypatch):
    """``"meta"`` (the dry-run's abstract model) builds a model and a
    cache, and nothing else: ``resolve_device`` refuses it unless a
    constructor asks, no entry point takes it, and ``"cuda"`` still
    raises without a card rather than resolve to anything."""
    from repro_torch.core.hashing import resolve_device
    from repro_torch.launch.specs import abstract_init, batch_specs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for construct in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda", construct=construct)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("meta", construct=True).type == "meta"
    assert resolve_device("cpu", construct=True).type == "cpu"
    table = np.zeros((1024, 4), np.uint32)
    for call in (lambda: OCF(OcfConfig(capacity=4096, device="meta")),
                 lambda: make_state(256, device="meta"),
                 lambda: make_stash(8, device="meta"),
                 lambda: state_from_numpy(table, 0, 1024, device="meta"),
                 lambda: GenerationalFilter(GenerationConfig(
                     capacity=4096, device="meta")),
                 lambda: filter_mesh(2, device="meta"),
                 lambda: make_sharded_state(2, 64, device="meta"),
                 lambda: serve("gemma3-1b", requests=1, prefix_len=16,
                               gen=2, device="meta")):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    cfg = get_smoke_config("gemma3-1b")
    model = Transformer(cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    cache = model.init_cache(2, 16)
    assert cache["blocks"][0].k.is_meta
    assert model.init_cache(2, 16, device="cpu")["blocks"][0].k.device.type \
        == "cpu"
    shapes, specs = abstract_init(cfg)
    assert set(shapes) == set(specs) and all(t.is_meta
                                             for t in shapes.values())
    assert all(t.is_meta for t in batch_specs(cfg, "train_4k").values())
    # a model that does compute holds real weights
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(cfg)


def test_backends():
    assert FilterOps().backend == "auto"
    assert FilterOps(backend="cuda").evict_rounds == 32
    scan = FilterOps(backend="torch")     # the scan backend, ported
    assert scan.scan and scan.max_disp == 500
    assert not FilterOps(backend="cuda").scan
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
                                      stashes=None, **kw),
            lambda: _scan_insert_cuda(table[None], keys[None], keys[None],
                                      valid[None], n_buckets=16, mode="key",
                                      fp_bits=16, max_disp=8, stashes=None),
            lambda: _scan_delete_cuda(table[None], keys[None], keys[None],
                                      valid[None], n_buckets=16,
                                      fp_bits=16),
            lambda: _flash_cuda(torch.zeros((1, 4, 64, 16)),
                                torch.zeros((1, 1, 64, 16)),
                                torch.zeros((1, 1, 64, 16)), causal=True,
                                window=None, logit_softcap=None,
                                scale=None)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()


def test_build_names_a_library_per_source():
    names = {cuda._lib_path(k).name for k in cuda.KERNELS}
    assert len(names) == 12
    assert all(n.startswith("lib") and n.endswith(".so") for n in names)
    assert cuda.BUILD_DIR == ROOT / "build"
    for src, _fn, _args in cuda.KERNELS.values():
        assert (PORT / "csrc" / src).exists()
    text = (PORT / "csrc" / "ocf_common.cuh").read_text()
    assert "__host__ __device__" in text


def test_no_library_attention_compile_or_fallback():
    """The port computes attention with its own kernel: no module calls
    ``scaled_dot_product_attention`` (only ``chip_smoke.py`` times it as a
    yardstick) or ``torch.compile``, and no wrapper catches an error to
    fall back to a plain version."""
    bad = []
    for path in _port_files()[:-1]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in (
                    "scaled_dot_product_attention", "compile"):
                bad.append(f"{path.relative_to(ROOT)}: .{node.attr}")
            if isinstance(node, ast.Try) and path.parent.name == "kernels":
                bad.append(f"{path.relative_to(ROOT)}: try at {node.lineno}")
    assert not bad, bad


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
