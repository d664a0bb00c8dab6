"""The LM stack's layer primitives and the cached attention path against the
reference (``repro.models.layers``, ``repro.kernels.ref``) on the same
inputs made with numpy.

Tolerances: float32 results agree to 1e-6 (the same float32 operations,
summed in another order); bfloat16 results agree to one bfloat16 rounding
(relative 2^-8) where both sides round the same float32 value, and to two
where the reference rounds an intermediate the port keeps in float32.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ref as jref
from repro.models import layers as jl
from repro.models.config import ModelConfig as RefModelConfig
from repro_torch.configs import get_config
from repro_torch.kernels import cuda, ops
from repro_torch.kernels.ref import blockwise_attention
from repro_torch.models import layers as pl
from repro_torch.models.config import ModelConfig

pytestmark = pytest.mark.tier1

F32 = dict(atol=1e-6, rtol=1e-6)


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=96, vocab_size=128)
    base.update(kw)
    return RefModelConfig(**base), ModelConfig(**base)


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def test_config_files_match_the_reference():
    """Every architecture's config and smoke config, field for field; the
    registry's shapes and dry-run cells."""
    from repro.configs import registry as ref_registry
    from repro.configs.registry import get_smoke_config as ref_smoke
    from repro_torch.configs import registry
    from repro_torch.configs import get_smoke_config
    assert registry.ARCHS == ref_registry.ARCHS
    for arch in registry.ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            ref_get_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(ref_smoke(arch))
        assert get_config(arch).param_count() == \
            ref_get_config(arch).param_count()
    assert registry.SHAPES == ref_registry.SHAPES
    assert registry.LONG_CONTEXT_ARCHS == ref_registry.LONG_CONTEXT_ARCHS
    assert registry.cells(True) == ref_registry.cells(True)
    assert registry.cells() == ref_registry.cells()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 64).astype(np.float32) * 3
    w = rng.rand(64).astype(np.float32) + 0.5
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(_np(jx)).to(getattr(torch, dtype))
    want = _np(jl.rmsnorm(jx, jnp.asarray(w), 1e-6))
    got = pl.rmsnorm(tx, torch.from_numpy(w), 1e-6)
    assert got.dtype == tx.dtype
    tol = F32 if dtype == "float32" else dict(atol=0, rtol=2 ** -8)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(theta, dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 40, 32).astype(np.float32)
    pos = np.stack([np.arange(40), np.arange(7, 47)]).astype(np.int32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(_np(jx)).to(getattr(torch, dtype))
    want = _np(jl.rope(jx, jnp.asarray(pos)[:, None, :], theta))
    got = pl.rope(tx, torch.from_numpy(pos)[:, None, :], theta)
    tol = (dict(atol=2e-5, rtol=1e-5) if dtype == "float32"
           else dict(atol=2 ** -8, rtol=2 ** -7))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_casts_then_scales_by_rounded_sqrt_d(dtype):
    rcfg, pcfg = _cfgs(d_model=1152, vocab_size=64, embed_scale=True,
                       dtype=dtype)
    rng = np.random.RandomState(2)
    table = rng.randn(64, 1152).astype(np.float32)
    toks = rng.randint(0, 64, (2, 9)).astype(np.int32)
    want = _np(jl.embed(jnp.asarray(table), jnp.asarray(toks), rcfg))
    got = pl.embed(torch.from_numpy(table), torch.from_numpy(toks), pcfg)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == "bfloat16":
        # sqrt(1152) = 33.94 rounds to 34.0 in bfloat16, as gemma3 scales
        np.testing.assert_array_equal(
            got.float().numpy(),
            torch.from_numpy(table[toks]).bfloat16().float().mul(34.0)
            .bfloat16().float().numpy())
        assert math.sqrt(1152) != 34.0


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("tied", [True, False])
def test_unembed_with_final_softcap(softcap, tied):
    rcfg, pcfg = _cfgs(final_logit_softcap=softcap, dtype="float32")
    rng = np.random.RandomState(3)
    w = rng.randn(128, 64) if tied else rng.randn(64, 128)
    w = w.astype(np.float32)
    x = (rng.randn(2, 5, 64) * 4).astype(np.float32)
    want = _np(jl.unembed(jnp.asarray(w), jnp.asarray(x), rcfg))
    got = pl.unembed(torch.from_numpy(w), torch.from_numpy(x), pcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-6)
    if softcap:
        assert np.abs(got.numpy()).max() < softcap


@pytest.mark.parametrize("act", ["silu_glu", "gelu_glu", "squared_relu",
                                 "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_activations(act, dtype):
    rcfg, pcfg = _cfgs(activation=act, dtype=dtype)
    params, _ = jl.init_mlp(jax.random.PRNGKey(4), rcfg, 96)
    pnp = {k: np.array(v) for k, v in params.items()}
    gen = torch.Generator().manual_seed(0)
    mine = pl.init_mlp(pcfg, 96, generator=gen, device="cpu")
    assert {k: v.shape for k, v in mine.items()} == {
        k: torch.Size(v.shape) for k, v in pnp.items()}
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(2, 6, 64), dtype)
    want = _np(jl.apply_mlp(params, rcfg, x))
    got = pl.apply_mlp({k: torch.from_numpy(v) for k, v in pnp.items()},
                       pcfg, torch.from_numpy(_np(x)).to(getattr(torch,
                                                                 dtype)))
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "float32"
           else dict(atol=2 ** -6, rtol=2 ** -6))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_dense_init_is_a_truncated_fan_in_normal():
    gen = torch.Generator().manual_seed(0)
    w = pl.dense_init((512, 256), generator=gen, device="cpu")
    std = 1 / math.sqrt(512)
    assert w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * std
    # a N(0, 1) cut at +-2 has standard deviation 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01
    again = pl.dense_init((512, 256), generator=torch.Generator()
                          .manual_seed(0), device="cpu")
    assert torch.equal(w, again)


BLOCKWISE_CASES = [
    # hq, hkv, sq, skv, window, softcap, q_chunk, cache args
    (4, 2, 64, 64, None, None, 512, {}),
    (4, 1, 96, 96, 16, 30.0, 32, {}),
    (4, 2, 24, 40, None, None, 512, dict(qpos_start=0, valid_len=24)),
    (4, 2, 1, 40, 16, None, 512, dict(qpos_start=30, valid_len=31)),
    (2, 2, 1, 16, 16, 50.0, 512, dict(qpos_start=37)),   # ring
]


@pytest.mark.parametrize("case", BLOCKWISE_CASES)
def test_blockwise_attention(case):
    hq, hkv, sq, skv, window, cap, q_chunk, cache = case
    rng = np.random.RandomState(6)
    q = rng.randn(2, hq, sq, 16).astype(np.float32)
    k = rng.randn(2, hkv, skv, 16).astype(np.float32)
    v = rng.randn(2, hkv, skv, 16).astype(np.float32)
    kw = dict(cache)
    if "valid_len" not in kw and "qpos_start" in kw:
        newest = kw["qpos_start"] + sq - 1
        slot = np.arange(skv)
        kw["key_positions"] = newest - ((newest - slot) % skv)
    jkw = {k_: jnp.asarray(v_) for k_, v_ in kw.items()}
    tkw = {k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    want = jref.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=window,
                                    logit_softcap=cap, q_chunk=q_chunk,
                                    **jkw)
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window,
                              logit_softcap=cap, q_chunk=q_chunk, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)


def test_attention_dispatch_rule():
    """No cache arguments -> the flash kernel (its plain version on a CPU
    tensor); any cache argument -> blockwise."""
    rng = np.random.RandomState(7)
    q = torch.from_numpy(rng.randn(1, 4, 32, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 2, 32, 16).astype(np.float32))
    cuda.reset_counts()
    full = ops.attention(q, k, k, window=8)
    assert cuda.PLAIN_CALLS["flash_attention"] == 1
    cached = ops.attention(q, k, k, window=8, qpos_start=0, valid_len=32)
    assert cuda.PLAIN_CALLS["flash_attention"] == 1
    np.testing.assert_allclose(full.numpy(), cached.numpy(), **F32)
