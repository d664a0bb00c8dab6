"""The port's MLA mixer (``repro_torch.models.attention.apply_mla``) against
the reference's (``repro.models.attention.apply_mla``) on the same weights
and inputs, made with numpy from a seed, at deepseek-v2-lite-16b's smoke
widths (4 heads, kv_lora 32, nope 16, rope 8, v 16), on all three paths:

  * cache-less: q and k of width nope + rope = 24 and v of 16 reach the
    flash kernel (its plain version here) zero-padded to 32, once, and
    never ``blockwise_attention``;
  * a cached prefill of more than 8 tokens (the non-absorbed path over the
    whole cache, ``valid_len``);
  * chunks of at most 8 tokens over the cache (the absorbed path: attention
    against the latent itself), here 4 tokens and then 1;

with the latent cache compared in the reference's layout ([B, 1, S,
kv_lora + rope]) after every step, for float32 activations and cache,
bfloat16 activations over a float32 cache (what ``serve()`` runs) and
bfloat16 over a bfloat16 cache.  And ``kernels.ops.attention``'s padding
on its own: Dk != Dv and Dk outside ``HEAD_DIMS``.

Tolerances.  float32: outputs and caches within 1e-5 absolute (observed
<= 1e-6): the same float32 operations in another order (the flash
schedule's online softmax against the reference's blockwise softmax).
bfloat16 activations: outputs within 2^-6 absolute on values of magnitude
up to ~2 (one or two bfloat16 roundings; observed <= 2^-9), caches within
2^-7 (one rounding; observed 0).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.kernels import ref as jref
from repro.models import attention as ratt
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import cuda, ops
from repro_torch.models import Transformer
from repro_torch.models import attention as patt
from repro_torch.models.attention import KVCache

pytestmark = pytest.mark.tier1

F32_TOL, BF16_TOL, BF16_CACHE_TOL = 1e-5, 2.0 ** -6, 2.0 ** -7
ARCH = "deepseek_v2_lite_16b"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _setup(dtype, seed=0):
    rcfg = dataclasses.replace(ref_smoke(ARCH), dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    shapes = jax.eval_shape(lambda k: ratt.init_mla(k, rcfg)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    w = {k: ((1 + 0.1 * rng.randn(*s.shape)) if "norm" in k else
             rng.randn(*s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
         for k, s in shapes.items()}
    model = Transformer(pcfg, device="cpu")    # for its rotation table
    return rcfg, pcfg, w, model


def _to_torch(a, dt):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))) \
        .to(dt)


def _err(got, want):
    return float(np.abs(got.float().numpy() - np.asarray(
        jnp.asarray(want).astype(jnp.float32))).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cacheless_mla_reaches_flash_padded(dtype, monkeypatch):
    rcfg, pcfg, w, model = _setup(dtype)
    jdt, tdt = DT[dtype]
    b, s = 2, 32
    x = jnp.asarray(np.random.RandomState(1).randn(b, s, rcfg.d_model)
                    ).astype(jdt)
    positions = jnp.arange(s)[None].repeat(b, 0)
    want, _ = jax.jit(lambda p, x: ratt.apply_mla(
        p, rcfg, x, positions=positions))(jax.tree.map(jnp.asarray, w), x)

    def no_blockwise(*a, **k):
        raise AssertionError("cache-less MLA went to blockwise_attention")
    monkeypatch.setattr(ops, "blockwise_attention", no_blockwise)
    p = {k: torch.from_numpy(v) for k, v in w.items()}
    cuda.reset_counts()
    got, cache = patt.apply_mla(p, pcfg, _to_torch(x, tdt),
                                rot=model.rotation(b, s))
    assert cache is None and cuda.PLAIN_CALLS["flash_attention"] == 1
    assert got.dtype == tdt and got.shape == want.shape
    assert _err(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("act,cache_dt", [("float32", "float32"),
                                          ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16")])
def test_cached_mla_paths_match_reference(act, cache_dt):
    """Prefill 20 tokens (non-absorbed), then 4 tokens and 1 token
    (absorbed) into a 32-long cache; outputs and the latent cache after
    every step."""
    rcfg, pcfg, w, model = _setup(act, seed=2)
    jdt, tdt = DT[act]
    jcdt, tcdt = DT[cache_dt]
    b, smax, width = 2, 32, 32 + 8
    xs = np.random.RandomState(3).randn(b, 25, rcfg.d_model)
    rcache = ratt.KVCache(jnp.zeros((b, 1, smax, width), jcdt),
                          jnp.zeros((1, 1, 1, 1), jcdt))
    pcache = KVCache(torch.zeros((b, 1, smax, width), dtype=tcdt),
                     torch.zeros((1, 1, 1, 1), dtype=tcdt))
    p = {k: torch.from_numpy(v) for k, v in w.items()}
    wj = jax.tree.map(jnp.asarray, w)
    step = jax.jit(lambda p, x, c, pos, positions: ratt.apply_mla(
        p, rcfg, x, positions=positions, cache=c, cache_pos=pos))
    out_tol = F32_TOL if act == "float32" else BF16_TOL
    cache_tol = F32_TOL if act == "float32" else BF16_CACHE_TOL
    cuda.reset_counts()
    for start, n in ((0, 20), (20, 4), (24, 1)):
        x = jnp.asarray(xs[:, start:start + n]).astype(jdt)
        positions = (start + jnp.arange(n))[None].repeat(b, 0)
        want, rcache = step(wj, x, rcache, jnp.int32(start), positions)
        got, pcache = patt.apply_mla(p, pcfg, _to_torch(x, tdt),
                                     rot=model.rotation(b, n, start),
                                     cache=pcache, cache_pos=start)
        assert got.dtype == tdt
        assert _err(got, want) <= out_tol, (start, _err(got, want))
        assert pcache.k.dtype == tcdt
        assert _err(pcache.k, rcache.k) <= cache_tol, start
    # the cached paths never reach the flash kernel, as in the reference
    assert cuda.PLAIN_CALLS["flash_attention"] == 0


@pytest.mark.parametrize("dk,dv,d", [(24, 16, 32), (192, 128, 256),
                                     (48, 48, 64)])
def test_attention_pads_heads_for_the_flash_kernel(dk, dv, d, monkeypatch):
    """Dk != Dv, or Dk not in ``HEAD_DIMS``: q, k, v are zero-padded to
    the smallest D in ``HEAD_DIMS`` that holds both, at the scale of the
    unpadded Dk, and the output cut back to Dv; the reference's blockwise
    attention on the unpadded heads agrees within 1e-6."""
    rng = np.random.RandomState(dk)
    q, k = rng.randn(1, 4, 40, dk), rng.randn(1, 2, 40, dk)
    v = rng.randn(1, 2, 40, dv)
    want = jref.blockwise_attention(*(jnp.asarray(a, jnp.float32)
                                      for a in (q, k, v)), window=24)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: calls.append(
        (a[0].shape[-1], kw["scale"])) or real(*a, **kw))
    cuda.reset_counts()
    got = ops.attention(*(torch.from_numpy(a.astype(np.float32))
                          for a in (q, k, v)), window=24)
    assert calls == [(d, dk ** -0.5)]
    assert cuda.PLAIN_CALLS["flash_attention"] == 1
    assert got.shape == (1, 4, 40, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_attention_refuses_heads_wider_than_the_kernel():
    q = torch.zeros((1, 1, 8, 320))
    with pytest.raises(ValueError, match="exceed"):
        ops.attention(q, q, q)
