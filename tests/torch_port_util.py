"""Helpers shared by the ``test_torch_*`` files: numpy <-> torch key and
table conversions, and snapshots of an OCF's full state for comparing the
port with the reference."""
import dataclasses

import numpy as np
import torch

from repro_torch.convert import state_to_numpy
from repro_torch.kernels.staging_cases import (  # noqa: F401 (re-exported)
    ADAPTIVE_STAGING_CASES, STAGING_CASES, adaptive_planes,
    adaptive_staging_inputs, random_keys, staging_inputs)


def split(keys):
    """uint64 keys -> (hi, lo) uint32 numpy halves."""
    k = np.asarray(keys, dtype=np.uint64)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def t32(a):
    """uint32 (or bool) numpy -> the port's tensor (int32 bit pattern)."""
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32).copy())


def u32(t):
    """The port's int32 tensor -> uint32 numpy (same bits)."""
    return t.detach().cpu().numpy().view(np.uint32)


def ref_snapshot(ocf):
    st = ocf.stash
    return {"table": np.asarray(ocf.state.table),
            "count": int(ocf.state.count),
            "n_buckets": int(ocf.state.n_buckets),
            "stash": None if st is None else np.asarray(st),
            "capacity_history": list(ocf.capacity_history),
            "stats": dataclasses.asdict(ocf.stats)}


def port_snapshot(ocf):
    d = state_to_numpy(ocf.state, ocf.stash)
    d["capacity_history"] = list(ocf.capacity_history)
    d["stats"] = dataclasses.asdict(ocf.stats)
    return d


def assert_same_state(ref, port, where=""):
    assert ref.keys() == port.keys()
    for key, rv in ref.items():
        pv = port[key]
        if isinstance(rv, np.ndarray) or isinstance(pv, np.ndarray):
            assert rv is not None and pv is not None, (where, key)
            np.testing.assert_array_equal(rv, pv, err_msg=f"{where} {key}")
        else:
            assert rv == pv, (where, key, rv, pv)


def ocf_stream(seed, n_keys=40_000):
    """A seeded op stream: insert bursts of growing size (grows, and
    failed inserts that force emergency grows), lookups of present and
    absent keys, verified deletes mixed with blind ones, and deletes down
    to a shrink, then a re-insert burst."""
    rng = np.random.RandomState(seed)
    keys = random_keys(rng, n_keys)
    absent = random_keys(rng, 4000)
    ops, i = [], 0
    for frac in (0.075, 0.125, 0.3, 0.2, 0.3):
        size = int(n_keys * frac)
        ops.append(("insert", keys[i:i + size]))
        i += size
        ops.append(("lookup", np.concatenate([keys[max(0, i - 3000):i],
                                              absent[:1000]])))
    ops.append(("delete", np.concatenate([keys[:500], absent[:300],
                                          keys[:100]])))
    for j in range(500, int(n_keys * 0.9), 6000):
        ops.append(("delete", keys[j:j + 6000]))
    ops.append(("lookup", np.concatenate([keys[-4000:], absent])))
    ops.append(("insert", keys[:5000]))
    ops.append(("lookup", np.concatenate([keys[:6000], absent])))
    return ops


def run_ocf_parity(ref_ocf, port_ocf, ops):
    """Drive both OCFs through ``ops``; compare answers and full state
    after every operation."""
    for step, (op, keys) in enumerate(ops):
        ra = np.asarray(getattr(ref_ocf, op)(keys))
        pa = np.asarray(getattr(port_ocf, op)(keys))
        np.testing.assert_array_equal(pa, ra, err_msg=f"{step} {op}")
        assert_same_state(ref_snapshot(ref_ocf), port_snapshot(port_ocf),
                          f"after op {step} ({op})")


# ------------------------------------------------------------ streaming --


def ref_ring_snapshot(ring):
    """The reference ``GenerationalFilter``'s state in the form of
    ``repro_torch.convert.generational_to_numpy``."""
    return {"gens": [{"table": np.asarray(g.state.table),
                      "stash": np.asarray(g.stash.array),
                      "count": int(g.state.count), "born": g.born,
                      "expires": g.expires} for g in ring.gens],
            "last_now": ring._last_now,
            "stats": dataclasses.asdict(ring.stats)}


def assert_same_ring(ref_ring, port_ring, where=""):
    from repro_torch.convert import generational_to_numpy
    ref, port = ref_ring_snapshot(ref_ring), generational_to_numpy(port_ring)
    assert ref["last_now"] == port["last_now"], where
    assert ref["stats"] == port["stats"], (where, ref["stats"],
                                           port["stats"])
    assert len(ref["gens"]) == len(port["gens"]), where
    for i, (rg, pg) in enumerate(zip(ref["gens"], port["gens"])):
        assert_same_state(rg, pg, f"{where} gen {i}")


# ------------------------------------------------------------- LM stack --

# name -> (arch, ModelConfig overrides) of the smoke configs the LM tests
# hold against the reference; gemma3 at 14 layers runs 2 periods + a tail.
LM_CONFIGS = {"gemma3": ("gemma3_1b", {}),
              "gemma3-14": ("gemma3_1b", dict(n_layers=14)),
              "gemma2": ("gemma2_27b", {}),
              "mistral-nemo": ("mistral_nemo_12b", {})}
_REF_PARAMS = {}


def lm_configs(name, dtype="float32"):
    """(reference config, port config) of ``LM_CONFIGS[name]``."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro_torch.configs import get_smoke_config
    arch, over = LM_CONFIGS[name]
    return (dataclasses.replace(ref_smoke(arch), dtype=dtype, **over),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over))


def lm_params_np(name, seed=0):
    """Weights for ``LM_CONFIGS[name]`` in the reference's parameter pytree,
    made with numpy from ``seed``: fan-in scaled normals for the matrices
    and the embedding, 1 + 0.1 N(0, 1) for the norm weights (so that a
    norm weight read from the wrong place shows).  The pytree's structure
    and shapes are the reference init's (``jax.eval_shape``)."""
    import jax
    from repro.models import Transformer as RefTransformer
    rcfg, _ = lm_configs(name)
    shapes = jax.eval_shape(lambda k: RefTransformer(rcfg).init(k)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        key = str(path[-1])
        if "norm" in key:
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[-1] if "embed" in key else leaf.shape[-2]
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def lm_models(name, dtype="float32"):
    """-> (reference Transformer, its params as jax arrays, the port's
    Transformer on the CPU holding the same weights), the weights from
    ``lm_params_np`` (made once per config and process)."""
    import jax
    import jax.numpy as jnp
    from repro.models import Transformer as RefTransformer
    from repro_torch.convert import transformer_params_from_numpy
    rcfg, pcfg = lm_configs(name, dtype)
    if name not in _REF_PARAMS:
        _REF_PARAMS[name] = lm_params_np(name)
    pnp = _REF_PARAMS[name]
    return (RefTransformer(rcfg), jax.tree.map(jnp.asarray, pnp),
            transformer_params_from_numpy(pnp, pcfg, device="cpu"))


def ref_logits(ref, params, toks):
    """The reference's cache-less forward logits of numpy token ids."""
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.jit(lambda p, t: ref.apply(p, t).logits)(
        params, jnp.asarray(toks)))


def lm_tokens(cfg, shape, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


def row_rel_err(got, want):
    """Per output row (the last axis) ||got - want|| / ||want|| over the
    rows whose ``want`` is not all 0 -> a float tensor of those rows."""
    num = (got.float() - want.float()).norm(dim=-1)
    den = want.float().norm(dim=-1)
    live = den > 0
    return num[live] / den[live]


# -------------------------------------------------------------- serving --

# Short scenario streams (tests/test_slo.py's SMALL) for waves of 64 keys.
SLO_WS = 64
SLO_SMALL = {
    "uniform": dict(waves=8),
    "zipfian": dict(waves=8),
    "adversarial": dict(rounds=2),
    "burst_train": dict(bursts=2, burst_waves=2, gap_waves=2),
    "ttl_churn": dict(waves=8),
    "delete_heavy": dict(waves=9),
}


def recording_harness(base):
    """An instance of a subclass of ``base`` (the reference's or the port's
    ``SloHarness``) that keeps what a replay drove: ``target`` (the
    batcher or the ring) and ``waves`` (every submitted ``OpWave``, report
    waves included, or every ring call's host answer), in order."""
    class Recording(base):
        def run(self, batcher, stream, **kw):
            self.target, self.waves = batcher, []
            submit = batcher.submit

            def recorded(kind, keys):
                wave = submit(kind, keys)
                self.waves.append(wave)
                return wave
            batcher.submit = recorded
            return super().run(batcher, stream, **kw)

        def run_generational(self, filt, stream, **kw):
            self.target, self.waves = filt, []
            for op in ("insert", "lookup"):
                def recorded(keys, now=None, _fn=getattr(filt, op)):
                    out = _fn(keys, now=now)
                    self.waves.append(out)
                    return out
                setattr(filt, op, recorded)
            return super().run_generational(filt, stream, **kw)
    return Recording()


def report_fields(report):
    """An ``SloReport``'s fields that are no host time: counts, extras and
    each sample's (kind, ops, burst, deferred)."""
    return {"ops": report.ops, "waves": report.waves,
            "shed_ops": report.shed_ops,
            "deferred_waves": report.deferred_waves,
            "held_ticks": report.held_ticks, "extras": report.extras,
            "kinds": sorted(report.per_kind),
            "samples": [(s.kind, s.ops, s.burst, s.deferred)
                        for s in report.recorder.samples]}
