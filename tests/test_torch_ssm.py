"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the same weights and inputs, made
with numpy from a seed, at the mamba2-1.3b smoke config (d_model 64, 8
heads of 16, d_state 16, chunk 32) and at a 2-group variant.

Cases: ``ssd_chunked`` with chunk < S and chunk = S, with and without an
initial state; ``apply_ssm``'s three arms (no cache, prefill from a cached
state, decode steps) with the caches they write; the reference's assert
on a sequence that is no multiple of the chunk, a ``ValueError`` here;
the init's values.

Tolerances.  float32: outputs within 1e-5 relative by row (||got - want||
/ ||want|| over the last axis; observed <= 1e-6: the same float32
operations, the products summed in another order and taken once per B / C
group), caches within 1e-5 absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import ssm as rssm
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm as pssm

from torch_port_util import row_rel_err

pytestmark = pytest.mark.tier1

ROW_TOL, CACHE_TOL = 1e-5, 1e-5
ARCH = "mamba2_1p3b"
GROUPS = (1, 2)


def _cfgs(groups=1):
    out = []
    for get in (ref_smoke, get_smoke_config):
        cfg = dataclasses.replace(get(ARCH), dtype="float32")
        out.append(dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, n_groups=groups)))
    return out


def _weights(rcfg, seed=0):
    """The reference's mixer pytree from numpy: fan-in scaled normals for
    the matrices, the init's vectors plus 0.1 N(0, 1), 0.1 N(0, 1) for
    the conv bias."""
    ref_init, _ = rssm.init_ssm(jax.random.PRNGKey(0), rcfg)
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


def _ssd_inputs(seed, b=2, s=64, h=8, p=16, g=2, n=16):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(b, s, h, p), dt=np.abs(rng.randn(b, s, h)) * 0.1,
                A=-np.abs(rng.randn(h)) - 0.5, B=rng.randn(b, s, g, n),
                C=rng.randn(b, s, g, n),
                init_state=rng.randn(b, h, p, n))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (64, 64), (32, 8)])
def test_ssd_chunked_matches_reference(s, chunk, with_state):
    arrs = {k: v.astype(np.float32)
            for k, v in _ssd_inputs(s + chunk, s=s).items()}
    init = arrs.pop("init_state") if with_state else None
    arrs.pop("init_state", None)
    want_y, want_f = jax.jit(lambda kw, st: rssm.ssd_chunked(
        **kw, chunk=chunk, init_state=st))(
        {k: jnp.asarray(v) for k, v in arrs.items()},
        None if init is None else jnp.asarray(init))
    got_y, got_f = pssm.ssd_chunked(
        **{k: torch.from_numpy(v) for k, v in arrs.items()}, chunk=chunk,
        init_state=None if init is None else torch.from_numpy(init))
    assert got_y.shape == want_y.shape and got_f.shape == want_f.shape
    _check_rows(got_y, want_y)
    _check_rows(got_f, want_f)


@pytest.mark.parametrize("groups", GROUPS)
def test_apply_ssm_without_cache_matches_reference(groups):
    rcfg, pcfg = _cfgs(groups)
    w = _weights(rcfg)
    x = np.random.RandomState(1).randn(2, 64, rcfg.d_model).astype(
        np.float32)
    want = jax.jit(lambda p, x: rssm.apply_ssm(p, rcfg, x)[0])(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    got, cache = pssm.apply_ssm({k: torch.from_numpy(v)
                                 for k, v in w.items()}, pcfg,
                                torch.from_numpy(x))
    assert cache is None and got.shape == want.shape
    _check_rows(got, want)


@pytest.mark.parametrize("groups", GROUPS)
def test_apply_ssm_prefill_and_decode_match_reference(groups):
    """A prefill of 32 tokens into a fresh cache, a second prefill of 24
    from the state it left (chunk = 24 there), then 4 decode steps: each
    call's output and the cache it wrote, against the reference's chain
    on the same inputs."""
    rcfg, pcfg = _cfgs(groups)
    w = _weights(rcfg, seed=2)
    rp = {k: jnp.asarray(v) for k, v in w.items()}
    pp = {k: torch.from_numpy(v) for k, v in w.items()}
    x = np.random.RandomState(3).randn(2, 60, rcfg.d_model).astype(
        np.float32)
    rc = rssm.init_ssm_cache(rcfg, 2)
    pc = pssm.init_ssm_cache(pcfg, 2)
    step = jax.jit(lambda p, x, c: rssm.apply_ssm(p, rcfg, x, cache=c))
    for a, b in ((0, 32), (32, 56), (56, 57), (57, 58), (58, 59),
                 (59, 60)):
        want, rc = step(rp, jnp.asarray(x[:, a:b]), rc)
        got, pc2 = pssm.apply_ssm(pp, pcfg, torch.from_numpy(x[:, a:b]),
                                  cache=pc)
        assert pc2 is pc                     # written in place
        _check_rows(got, want)
        for field in ("conv", "state"):
            np.testing.assert_allclose(getattr(pc, field).numpy(),
                                       _np(getattr(rc, field)),
                                       atol=CACHE_TOL, err_msg=f"{a} {field}")


def test_sequence_off_the_chunk_raises():
    """S = 48 with chunk 32: the reference asserts, the port raises
    ``ValueError``; S <= chunk takes the chunk S."""
    rcfg, pcfg = _cfgs()
    w = _weights(rcfg)
    x = np.zeros((1, 48, rcfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        rssm.apply_ssm({k: jnp.asarray(v) for k, v in w.items()}, rcfg,
                       jnp.asarray(x))
    pp = {k: torch.from_numpy(v) for k, v in w.items()}
    with pytest.raises(ValueError, match="no multiple of the chunk"):
        pssm.apply_ssm(pp, pcfg, torch.from_numpy(x))
    y, _ = pssm.apply_ssm(pp, pcfg, torch.from_numpy(x[:, :24]))
    assert y.shape == (1, 24, pcfg.d_model)


def test_init_matches_reference_values():
    """The init's keys in the reference's order, its shapes and its
    vectors (A_log, D, dt_bias, conv_b, norm) within float32 rounding."""
    rcfg, pcfg = _cfgs()
    want, _ = rssm.init_ssm(jax.random.PRNGKey(0), rcfg)
    gen = torch.Generator().manual_seed(0)
    got = pssm.init_ssm(pcfg, generator=gen, device="cpu")
    assert list(got) == list(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        if leaf.ndim == 1:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(leaf),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    cache = pssm.init_ssm_cache(pcfg, 3, stacked=(2,))
    ref_cache = rssm.init_ssm_cache(rcfg, 3)
    assert tuple(cache.conv.shape) == (2, *ref_cache.conv.shape)
    assert tuple(cache.state.shape) == (2, *ref_cache.state.shape)
