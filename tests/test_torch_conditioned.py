"""Conditioned decoding in the port against the reference on the same
weights (``torch_port_util.lm_params_np``, numpy from a seed): musicgen's
cross-attention over a text-encoder memory and llava's prefix embeddings
(image patches), at their smoke configs.

Cases: ``apply_cross_attention`` alone (float32 and bfloat16); the
cache-less forward with a memory and with a prefix (logits over the token
positions only); greedy generation with a memory against the reference's
``generate``; prefill of a prefix and tokens, then decode steps, against
the reference's steps; the forward's last position against a prefill of
all but the last token and one decode step, with the memory or the
prefix (tests/test_models.py's consistency check).

Tolerances.  float32: logits within 5e-5 absolute (observed <= 5e-6),
layer outputs within 1e-5 relative by row, the forward against prefill +
decode within 1e-3 in log-softmax (observed <= 1e-6); greedy tokens
equal.  bfloat16: cross-attention outputs within 2e-2 x (1 + |want|) and
logits within ``test_torch_transformer.py``'s 0.25 absolute, 0.02 mean.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as rattn
from repro.serving import engine as reng
from repro_torch.kernels import cuda
from repro_torch.models import attention as pattn
from repro_torch.serving import engine as peng

from torch_port_util import lm_configs, lm_models, lm_tokens, row_rel_err

pytestmark = pytest.mark.tier1

F32_TOL, BF16_TOL, BF16_MEAN_TOL = 5e-5, 0.25, 0.02


def _memory(cfg, batch, seed=7):
    return np.random.RandomState(seed).randn(
        batch, cfg.cross_attn_memory_len, cfg.cross_attn_memory_dim
    ).astype(np.float32)


def _prefix(cfg, batch, seed=8):
    return (0.5 * np.random.RandomState(seed).randn(
        batch, cfg.prefix_embed_len, cfg.d_model)).astype(np.float32)


def _act(a, dtype):
    """numpy -> (jax array, torch tensor) of the same values in dtype."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                              else jnp.float32)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_cross_attention_matches_reference(dtype):
    rcfg, pcfg = lm_configs("musicgen", dtype)
    shapes = jax.eval_shape(
        lambda k: rattn.init_cross_attention(k, rcfg)[0],
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    w = {k: (rng.randn(*s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
         for k, s in shapes.items()}
    xj, xt = _act(rng.randn(2, 24, rcfg.d_model), dtype)
    mj, mt = _act(_memory(rcfg, 2), dtype)
    want = np.array(jax.jit(lambda p, x, m: rattn.apply_cross_attention(
        p, rcfg, x, m))({k: jnp.asarray(v) for k, v in w.items()}, xj,
                        mj).astype(jnp.float32))
    cuda.reset_counts()
    got = pattn.apply_cross_attention(
        {k: torch.from_numpy(v) for k, v in w.items()}, pcfg, xt, mt)
    assert cuda.PLAIN_CALLS["flash_attention"] == 1     # non-causal flash
    assert got.dtype == xt.dtype and got.shape == want.shape
    if dtype == "float32":
        assert float(row_rel_err(got, torch.from_numpy(want)).max()) <= 1e-5
    else:
        err = np.abs(got.float().numpy() - want)
        assert (err <= 2e-2 * (1 + np.abs(want))).all(), err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["musicgen", "llava"])
def test_conditioned_forward_matches_reference(name, dtype):
    """musicgen with a memory (each global block: self-attention, then
    cross-attention, two flash calls), llava with a prefix of
    ``prefix_embed_len`` embeddings (logits over the 24 tokens only)."""
    ref, params, model = lm_models(name, dtype)
    cfg = ref.cfg
    toks = lm_tokens(cfg, (2, 24), seed=2)
    if name == "musicgen":
        cj, ct = _act(_memory(cfg, 2), dtype)
        kw_ref, kw_port, per_layer = dict(memory=cj), dict(memory=ct), 2
    else:
        cj, ct = _act(_prefix(cfg, 2), dtype)
        kw_ref, kw_port = dict(prefix_embeds=cj), dict(prefix_embeds=ct)
        per_layer = 1
    want = np.asarray(jax.jit(lambda p, t, c: ref.apply(
        p, t, **{next(iter(kw_ref)): c}).logits)(params, jnp.asarray(toks),
                                                 cj))
    cuda.reset_counts()
    got = model.apply(torch.from_numpy(toks), **kw_port).logits
    assert cuda.PLAIN_CALLS["flash_attention"] == per_layer * cfg.n_layers
    assert got.shape == want.shape == (2, 24, cfg.vocab_size)
    err = np.abs(got.numpy() - want)
    if dtype == "float32":
        assert err.max() < F32_TOL, err.max()
    else:
        assert err.max() < BF16_TOL and err.mean() < BF16_MEAN_TOL, (
            err.max(), err.mean())
    # the condition changes the answer
    plain = model.apply(torch.from_numpy(toks)).logits
    assert float((plain - got).abs().max()) > 100 * F32_TOL


def test_generate_with_memory_matches_reference():
    """Greedy generation with a memory: the memory goes to the prefill and
    to every decode step (cross-attention recomputes k, v from it each
    call, as the reference does, through the flash kernel)."""
    ref, params, model = lm_models("musicgen")
    prompt = lm_tokens(ref.cfg, (2, 16), seed=3)
    mem = _memory(ref.cfg, 2)
    want = reng.generate(ref, params, jnp.asarray(prompt), 6,
                         memory=jnp.asarray(mem))
    cuda.reset_counts()
    got = peng.generate(model, torch.from_numpy(prompt), 6,
                        memory=torch.from_numpy(mem))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    # prefill and 5 decode steps, one cross-attention call a layer each
    assert cuda.PLAIN_CALLS["flash_attention"] == 6 * ref.cfg.n_layers


def test_prefill_with_prefix_then_decode_matches_reference():
    """llava: a prefill of the prefix and 16 tokens into a float32 cache,
    then 6 greedy decode steps at positions P + 16 ..: logits within the
    float32 tolerance of the reference's steps, tokens equal, the cache's
    k and v too."""
    ref, params, model = lm_models("llava")
    cfg = ref.cfg
    toks = lm_tokens(cfg, (2, 16), seed=4)
    pre = _prefix(cfg, 2)
    n = cfg.prefix_embed_len + 16
    rc = ref.init_cache(2, n + 6, dtype=jnp.float32)
    pc = model.init_cache(2, n + 6, dtype=torch.float32)
    rpre = jax.jit(lambda p, c, t, e: reng.make_prefill_step(ref)(
        p, c, t, prefix_embeds=e))
    rdec = jax.jit(reng.make_decode_step(ref))
    ppre, pdec = peng.make_prefill_step(model), peng.make_decode_step(model)
    rl, rc = rpre(params, rc, jnp.asarray(toks), jnp.asarray(pre))
    pl, pc = ppre(pc, torch.from_numpy(toks),
                  prefix_embeds=torch.from_numpy(pre))
    assert pl.shape == (2, 16, cfg.vocab_size)
    errs = [np.abs(np.asarray(rl) - pl.numpy()).max()]
    rt, pt = reng.greedy_sample(rl), peng.greedy_sample(pl)
    for pos in range(n, n + 6):
        assert np.array_equal(np.asarray(rt), pt.numpy()), pos
        rl, rc = rdec(params, rc, rt, jnp.int32(pos))
        pl, pc = pdec(pc, pt, pos)
        errs.append(np.abs(np.asarray(rl) - pl.numpy()).max())
        rt, pt = reng.greedy_sample(rl), peng.greedy_sample(pl)
    assert np.array_equal(np.asarray(rt), pt.numpy())
    assert max(errs) < F32_TOL, errs
    for rslot, pslot in zip(rc["blocks"], pc["blocks"]):
        for want, got in zip(rslot, pslot):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=F32_TOL)


@pytest.mark.parametrize("name", ["musicgen", "llava"])
def test_decode_matches_full_f32_conditioned(name):
    """The last position's log-softmax of the cache-less forward (flash)
    against a prefill of all but the last token and one decode step
    (blockwise over the cache), with the memory or the prefix, within
    1e-3."""
    _ref, _params, model = lm_models(name)
    cfg = model.cfg
    toks = torch.from_numpy(lm_tokens(cfg, (2, 32), seed=5))
    if name == "musicgen":
        kw = dict(memory=torch.from_numpy(_memory(cfg, 2)))
        dec_kw, p = kw, 0
    else:
        kw = dict(prefix_embeds=torch.from_numpy(_prefix(cfg, 2)))
        dec_kw, p = {}, cfg.prefix_embed_len
    full = model.apply(toks, **kw).logits[:, -1]
    cache = model.init_cache(2, p + 36, dtype=torch.float32)
    model.apply(toks[:, :-1], cache=cache, cache_pos=0, **kw)
    dec = model.decode_step(cache, toks[:, -1:], p + 31,
                            **dec_kw).logits[:, 0]
    err = float((torch.log_softmax(full, -1)
                 - torch.log_softmax(dec, -1)).abs().max())
    assert err < 1e-3, err
