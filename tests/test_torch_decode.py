"""The port's serving steps against the reference's on the same weights
(numpy-made weights in the reference's pytree, loaded into the port by
``convert.transformer_params_from_numpy``):
prefill, then greedy decode steps, with the full cache and with the
window-bound ring, on the smoke configs of ``torch_port_util.LM_CONFIGS``.
All in float32.

Tolerance: logits and caches within 5e-5 absolute (observed <= 4e-6):
the port writes its cache in place and sums its matrix products in another
order than XLA, so they differ by float32 rounding carried through up to
14 layers.  Greedy tokens are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import engine as reng
from repro_torch.convert import cache_to_numpy
from repro_torch.kernels import cuda
from repro_torch.serving import engine as peng

from torch_port_util import LM_CONFIGS, lm_models, lm_tokens

pytestmark = pytest.mark.tier1

F32_TOL = 5e-5


@pytest.mark.parametrize("name", list(LM_CONFIGS))
def test_prefill_and_decode_match_reference(name):
    """Prefill 24 tokens, then 8 greedy decode steps, in float32: logits
    and caches within the float32 tolerance, greedy tokens equal."""
    ref, params, model = lm_models(name)
    toks = lm_tokens(ref.cfg, (2, 24), seed=1)
    rc = ref.init_cache(2, 40, dtype=jnp.float32)
    pc = model.init_cache(2, 40, dtype=torch.float32)
    rpre = jax.jit(reng.make_prefill_step(ref))
    rdec = jax.jit(reng.make_decode_step(ref))
    ppre, pdec = peng.make_prefill_step(model), peng.make_decode_step(model)
    cuda.reset_counts()
    rl, rc = rpre(params, rc, jnp.asarray(toks))
    pl, pc = ppre(pc, torch.from_numpy(toks))
    rt, pt = reng.greedy_sample(rl), peng.greedy_sample(pl)
    errs = [np.abs(np.asarray(rl) - pl.numpy()).max()]
    for pos in range(24, 32):
        assert np.array_equal(np.asarray(rt), pt.numpy()), pos
        rl, rc = rdec(params, rc, rt, jnp.int32(pos))
        pl, pc = pdec(pc, pt, pos)
        errs.append(np.abs(np.asarray(rl) - pl.numpy()).max())
        rt, pt = reng.greedy_sample(rl), peng.greedy_sample(pl)
    assert np.array_equal(np.asarray(rt), pt.numpy())
    assert max(errs) < F32_TOL, errs
    # the cached path never reaches the flash kernel, as in the reference
    assert cuda.PLAIN_CALLS["flash_attention"] == 0
    mine = cache_to_numpy(pc)
    for group in rc:
        # the dense prefix's cache is one slot, the others lists of slots;
        # a slot's fields: k, v (KV), conv, state (SSM) or conv, h (RG-LRU)
        rslots, pslots = ((rc[group],), (mine[group],)) if group == \
            "prefix" else (rc[group], mine[group])
        assert len(rslots) == len(pslots)
        for rslot, pslot in zip(rslots, pslots):
            assert len(rslot) == len(pslot)
            for want, got in zip(rslot, pslot):
                np.testing.assert_allclose(got, np.asarray(want),
                                           atol=F32_TOL)


@pytest.mark.parametrize("name", ["deepseek", "qwen3-moe", "mamba2",
                                  "recurrentgemma"])
def test_decode_matches_full_f32(name):
    """tests/test_models.py's serving consistency check on the port: the
    last position's log-softmax of the cache-less forward (flash) against
    a prefill of all but the last token plus one decode step (blockwise
    over the cache; MLA's absorbed path; exact MoE routing; the SSM's
    chunked form against its one-step recurrence, the RG-LRU's scan
    against its step), within 1e-3 (observed <= 1e-6)."""
    _ref, _params, model = lm_models(name)
    toks = torch.from_numpy(lm_tokens(model.cfg, (2, 32), seed=5))
    full = model.apply(toks).logits[:, -1]
    cache = model.init_cache(2, 36, dtype=torch.float32)
    model.apply(toks[:, :-1], cache=cache, cache_pos=0)
    dec = model.decode_step(cache, toks[:, -1:], 31).logits[:, 0]
    err = float((torch.log_softmax(full, -1)
                 - torch.log_softmax(dec, -1)).abs().max())
    assert err < 1e-3, err


def test_generate_matches_reference():
    ref, params, model = lm_models("gemma2")
    prompt = lm_tokens(ref.cfg, (2, 16), seed=2)
    want = reng.generate(ref, params, jnp.asarray(prompt), 6)
    got = peng.generate(model, torch.from_numpy(prompt), 6)
    assert got.steps == want.steps == 6
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_window_ring_cache_matches_full_cache():
    """A window-long ring for the local layers (``window_bound``) decodes
    the same logits as the full cache (tests/test_models.py:97, here on
    gemma3's window of 16 over 48 steps), and as the reference's ring."""
    ref, params, model = lm_models("gemma3")
    toks = lm_tokens(ref.cfg, (1, 48), seed=3)
    full = model.init_cache(1, 48, dtype=torch.float32)
    ring = model.init_cache(1, 48, dtype=torch.float32, window_bound=True)
    assert ring["blocks"][0].k.shape[3] == ref.cfg.window
    assert ring["blocks"][5].k.shape[3] == 48          # the global slot
    rring = ref.init_cache(1, 48, dtype=jnp.float32, window_bound=True)
    rstep = jax.jit(lambda p, c, t, pos: (lambda o: (o.logits, o.cache))(
        ref.decode_step(p, c, t, pos)))
    for t in range(48):
        tok = torch.from_numpy(toks[:, t:t + 1])
        lf = model.decode_step(full, tok, t).logits
        lr = model.decode_step(ring, tok, t).logits
        rlogits, rring = rstep(params, rring, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t))
    np.testing.assert_allclose(lr.numpy(), lf.numpy(), atol=1e-4)
    np.testing.assert_allclose(lr.numpy(), np.asarray(rlogits),
                               atol=F32_TOL)
