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
    assert [d.type for d in mesh.devices] == ["cpu"] * 2
    assert mesh.shape == {"data": 2}
    assert make_sharded_state(2, 64, device="cpu").devices == \
        (torch.device("cpu"),) * 2


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


# ------------------------------------------------ the reference's surface --

REF = ROOT / "src" / "repro"

# Names of the reference that the port leaves out by design (docs/PORT.md,
# "Left out by design"), by the reference module that defines them.
LEFT_OUT = {
    # the oracles: the tests import them from the reference
    "core": {"PyCuckooFilter"},
    "streaming": {"PyStashFilter"},
    # the XLA grid emulation arms; the kernels' plain versions take their
    # place
    "kernels.probe": {"probe_emulated", "probe_emulated_tm",
                      "probe_adaptive_emulated",
                      "probe_adaptive_emulated_tm"},
    # the off-TPU attention stand-ins
    "kernels.ref": {"attention_ref", "local_attention"},
    # the TPU's VMEM budget (the parity block rule keeps its value as
    # PARITY_VMEM_TABLE_BUDGET)
    "kernels.ops": {"VMEM_TABLE_BUDGET"},
    # the HLO text parser and the TPU interconnect rates
    "roofline.analysis": {"parse_collectives", "ICI_BW", "DCN_BW"},
    # the alias of jax.ShapeDtypeStruct (``meta`` tensors take its place)
    "launch.specs": {"SDS"},
}


def _ref_public_names(path: Path) -> set:
    """Public names a reference module defines at its top level or lists
    in ``__all__``, read with ``ast`` (nothing of it is imported); a
    package ``__init__``'s imports are its re-exports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                for n in ast.walk(target):
                    if not isinstance(n, ast.Name):
                        continue
                    if n.id == "__all__":
                        names.update(ast.literal_eval(node.value))
                    else:
                        names.add(n.id)
        elif path.name == "__init__.py" and isinstance(
                node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _ported_modules() -> list:
    """Dotted names (below the package) of the reference's modules that
    have a counterpart file in the port."""
    out = []
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF)
        if (PORT / rel).exists():
            out.append(".".join(rel.with_suffix("").parts)
                       .removesuffix("__init__").rstrip("."))
    return out


def _ref_path(mod: str) -> Path:
    base = REF.joinpath(*mod.split(".")) if mod else REF
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


@pytest.mark.parametrize("mod", _ported_modules(), ids=lambda m: m or "repro")
def test_port_has_the_reference_modules_names(mod):
    """Every public name of a ported reference module exists on its
    counterpart, but the exclusions of ``LEFT_OUT``, each of which the
    reference defines and the port does not."""
    import importlib
    names = _ref_public_names(_ref_path(mod))
    port = importlib.import_module(f"repro_torch.{mod}".rstrip("."))
    left = LEFT_OUT.get(mod, set())
    assert left <= names, left - names
    assert not [n for n in left if hasattr(port, n)]
    missing = sorted(n for n in names - left if not hasattr(port, n))
    assert not missing, missing


def test_package_names_and_ops_all():
    """The package-level names of the reference's two ``__init__``s and
    ``kernels.ops.__all__`` (but its TPU budget) import from the port;
    ``kernels.probe`` is the function, as in the reference, and its module
    still imports by its dotted name."""
    import repro_torch.kernels.ops as ops_mod
    from repro_torch.core import OCF as ocf_cls
    from repro_torch.core import FilterOps as ops_cls
    from repro_torch.core import OcfConfig as cfg_cls
    from repro_torch.core import make_state as make_state_fn
    from repro_torch.kernels import (flash_attention, fingerprint_hash,
                                     insert_once, make_stash, ops, probe,
                                     ref, stash_occupancy)
    from repro_torch.kernels.probe import probe_multi
    assert (ocf_cls, cfg_cls, ops_cls, make_state_fn) == (
        OCF, OcfConfig, FilterOps, make_state)
    assert ops is ops_mod and ref.__name__ == "repro_torch.kernels.ref"
    for fn in (probe, flash_attention, fingerprint_hash, insert_once,
               make_stash, stash_occupancy, probe_multi):
        assert callable(fn) and not isinstance(fn, type(ops)), fn
    want = set(ast.literal_eval(next(
        node.value for node in ast.parse(
            (REF / "kernels" / "ops.py").read_text()).body
        if isinstance(node, ast.Assign)
        and getattr(node.targets[0], "id", "") == "__all__")))
    assert set(ops.__all__) == want - {"VMEM_TABLE_BUDGET"}
    assert all(hasattr(ops, n) for n in ops.__all__)


def _quickstart(core, metrics, n_keys):
    """``examples/quickstart.py``'s lines on ``core``'s OCF -> every
    number it prints, every answer, and the filter."""
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 2 ** 63, size=n_keys,
                       dtype=np.int64).astype(np.uint64)
    ocf = core.OCF(core.OcfConfig(capacity=4096, mode="EOF", **(
        {"backend": "pallas"} if core.__name__ == "repro.core"
        else {"device": "cpu"})))
    seen = [(ocf.capacity, ocf.occupancy)]
    for i in range(0, keys.size, 4096):
        seen.append(np.asarray(ocf.insert(keys[i:i + 4096])))
    seen.append((ocf.capacity, ocf.occupancy, ocf.stats.resizes,
                 ocf.stats.grows))
    probes = rng.randint(0, 2 ** 63, size=n_keys,
                         dtype=np.int64).astype(np.uint64)
    seen.append((metrics.measure_false_negatives(ocf, keys),
                 metrics.measure_false_positives(ocf, probes)))
    foreign = rng.randint(0, 2 ** 63, size=1000,
                          dtype=np.int64).astype(np.uint64)
    seen.append(np.asarray(ocf.delete(foreign)))
    seen.append(ocf.stats.blind_deletes_blocked)
    seen.append(np.asarray(ocf.lookup(keys)))
    for i in range(0, n_keys * 9 // 10, 2048):
        seen.append(np.asarray(ocf.delete(keys[i:i + 2048])))
    seen.append((ocf.capacity, ocf.occupancy, ocf.stats.shrinks,
                 list(ocf.capacity_history)))
    return seen, ocf


def test_quickstart_through_the_package_names_matches_reference():
    """``from repro_torch.core import OCF, OcfConfig`` runs the
    quickstart's lines on the CPU and answers as the reference's
    ``repro.core.OCF(backend="pallas")`` does, bit for bit: every answer,
    every printed number and the filter it leaves."""
    import repro.core as ref_core
    import repro.core.metrics as ref_metrics

    import repro_torch.core as port_core
    import repro_torch.core.metrics as port_metrics
    from torch_port_util import (assert_same_state, port_snapshot,
                                 ref_snapshot)
    want, ref_ocf = _quickstart(ref_core, ref_metrics, 12000)
    got, port_ocf = _quickstart(port_core, port_metrics, 12000)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=str(i))
        else:
            assert g == w, (i, g, w)
    assert want[-1][2] >= 1 and len(want[-1][3]) >= 3  # grew and shrank
    assert_same_state(ref_snapshot(ref_ocf), port_snapshot(port_ocf))
