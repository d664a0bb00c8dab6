"""The port's Griffin recurrent block (``repro_torch.models.rglru``)
against the reference's (``repro.models.rglru``) on the same weights and
inputs, made with numpy from a seed, at the recurrentgemma-2b smoke config
(d_model 64, d_rnn 64, conv 4).

Cases: the log-depth scan against the reference's ``associative_scan`` at
S = 1, 7 and 4096, with and without an initial state; ``apply_rglru``'s
three arms (no cache, prefill from a cached state, decode steps) with the
caches they write, in float32 and bfloat16; the init's values.

Tolerances.  float32: outputs and scans within 1e-5 relative by row
(||got - want|| / ||want|| over the last axis; observed <= 1e-6: the two
scans combine the same pairs in another tree), caches within 1e-5
absolute.  bfloat16: outputs within 2e-2 x (1 + |want|) elementwise (both
sides round the projections and the gate products to bfloat16 and keep
the gates and the scan in float32; a rounding moved by a float32 ulp
flips one bfloat16 ulp, 2^-8 relative; observed <= 7.4e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import rglru as rrg
from repro_torch.configs import get_smoke_config
from repro_torch.models import rglru as prg

from torch_port_util import row_rel_err

pytestmark = pytest.mark.tier1

ROW_TOL, CACHE_TOL, BF16_TOL = 1e-5, 1e-5, 2e-2
ARCH = "recurrentgemma_2b"


def _cfgs(dtype="float32"):
    return [dataclasses.replace(get(ARCH), dtype=dtype)
            for get in (ref_smoke, get_smoke_config)]


def _weights(rcfg, seed=0):
    """The reference's block pytree from numpy: fan-in scaled normals for
    the matrices, Λ of the init plus 0.1 N(0, 1), 0.1 N(0, 1) for the
    biases."""
    ref_init, _ = rrg.init_rglru(jax.random.PRNGKey(0), rcfg)
    rng = np.random.RandomState(seed)
    out = {}
    for name, leaf in ref_init.items():
        shape = leaf.shape
        if leaf.ndim == 2:
            out[name] = rng.randn(*shape) / np.sqrt(shape[0])
        else:
            out[name] = np.asarray(leaf) + 0.1 * rng.randn(*shape)
        out[name] = out[name].astype(np.float32)
    return out


def _np(t):
    return np.array(jnp.asarray(t).astype(jnp.float32))


def _check_rows(got, want):
    err = row_rel_err(got, torch.from_numpy(_np(want)))
    assert float(err.max()) <= ROW_TOL, float(err.max())


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 7, 4096])
def test_scan_matches_associative_scan(s, with_h0):
    """Decays a in [0.9, 1) (the init's span, so that 4096 steps keep
    most of the history) and inputs of N(0, 1)."""
    rng = np.random.RandomState(s)
    x = rng.randn(2, s, 32).astype(np.float32)
    a = rng.uniform(0.9, 1.0, (2, s, 32)).astype(np.float32)
    h0 = rng.randn(2, 32).astype(np.float32) if with_h0 else None
    want = jax.jit(lambda x, a, h: rrg._rglru_scan(x, a, h0=h))(
        jnp.asarray(x), jnp.asarray(a),
        None if h0 is None else jnp.asarray(h0))
    got = prg._rglru_scan(torch.from_numpy(x), torch.from_numpy(a),
                          h0=None if h0 is None else torch.from_numpy(h0))
    assert got.shape == want.shape
    _check_rows(got, want)
    # the scan is the recurrence, step by step (float64 loop)
    h = np.zeros((2, 32)) if h0 is None else h0.astype(np.float64)
    for t in range(min(s, 64)):
        h = a[:, t] * h + x[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rglru_without_cache_matches_reference(dtype):
    rcfg, pcfg = _cfgs(dtype)
    w = _weights(rcfg)
    x = np.random.RandomState(1).randn(2, 48, rcfg.d_model).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xr = jnp.asarray(x).astype(jdt)
    want = jax.jit(lambda p, x: rrg.apply_rglru(p, rcfg, x)[0])(
        {k: jnp.asarray(v) for k, v in w.items()}, xr)
    xp = torch.from_numpy(_np(xr)).to(torch.bfloat16 if dtype == "bfloat16"
                                      else torch.float32)
    got, cache = prg.apply_rglru({k: torch.from_numpy(v)
                                  for k, v in w.items()}, pcfg, xp)
    assert cache is None and got.dtype == xp.dtype
    if dtype == "float32":
        _check_rows(got, want)
    else:
        want = _np(want)
        err = np.abs(got.float().numpy() - want)
        assert (err <= BF16_TOL * (1 + np.abs(want))).all(), err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rglru_prefill_and_decode_match_reference(dtype):
    """A prefill of 20 tokens into a fresh cache, a second of 9 from the
    state it left, then 3 decode steps: each call's output and the cache
    it wrote, against the reference's chain on the same inputs (caches
    float32 in both dtypes)."""
    rcfg, pcfg = _cfgs(dtype)
    w = _weights(rcfg, seed=2)
    rp = {k: jnp.asarray(v) for k, v in w.items()}
    pp = {k: torch.from_numpy(v) for k, v in w.items()}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = jnp.asarray(np.random.RandomState(3).randn(
        2, 32, rcfg.d_model).astype(np.float32)).astype(jdt)
    rc = rrg.init_rglru_cache(rcfg, 2)
    pc = prg.init_rglru_cache(pcfg, 2)
    step = jax.jit(lambda p, x, c: rrg.apply_rglru(p, rcfg, x, cache=c))
    for a, b in ((0, 20), (20, 29), (29, 30), (30, 31), (31, 32)):
        want, rc = step(rp, x[:, a:b], rc)
        got, pc2 = prg.apply_rglru(pp, pcfg, torch.from_numpy(
            _np(x[:, a:b])).to(tdt), cache=pc)
        assert pc2 is pc                     # written in place
        if dtype == "float32":
            _check_rows(got, want)
            tol = CACHE_TOL
        else:
            wn = _np(want)
            err = np.abs(got.float().numpy() - wn)
            assert (err <= BF16_TOL * (1 + np.abs(wn))).all(), err.max()
            tol = BF16_TOL
        for field in ("conv", "h"):
            np.testing.assert_allclose(getattr(pc, field).numpy(),
                                       _np(getattr(rc, field)), atol=tol,
                                       rtol=tol, err_msg=f"{a} {field}")


def test_init_matches_reference_values():
    """The init's keys in the reference's order, its shapes and its
    vectors (Λ, the zero biases) within float32 rounding."""
    rcfg, pcfg = _cfgs()
    want, _ = rrg.init_rglru(jax.random.PRNGKey(0), rcfg)
    gen = torch.Generator().manual_seed(0)
    got = prg.init_rglru(pcfg, generator=gen, device="cpu")
    assert list(got) == list(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        if leaf.ndim == 1:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(leaf),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    # the decay a = sigmoid(Λ)^8 spans [0.9, 0.999]
    a = torch.sigmoid(got["lam"]) ** 8
    assert abs(float(a[0]) - 0.9) < 1e-5 and abs(float(a[-1]) - 0.999) < 1e-5
    cache = prg.init_rglru_cache(pcfg, 3, stacked=(2,))
    ref_cache = rrg.init_rglru_cache(rcfg, 3)
    assert tuple(cache.conv.shape) == (2, *ref_cache.conv.shape)
    assert tuple(cache.h.shape) == (2, *ref_cache.h.shape)
