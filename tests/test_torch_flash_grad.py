"""The gradient of the port's flash attention on the CPU (its plain
backward, ``flash_attention_bwd_plain``, and autograd through
``flash_attention``'s ``FlashAttentionFn``) against ``jax.vjp`` of the
reference's ``repro.kernels.ref.blockwise_attention`` (what the
reference's training step differentiates off the TPU), on the same inputs
made with numpy: causal, window, soft-cap, GQA, ragged lengths, rows with
no live key, and MLA's heads through ``ops.attention``.

Tolerances.  float32: 1e-5 absolute + 1e-4 relative (observed ~1e-6:
the same float32 function, summed in another order).  bfloat16: 2e-2
absolute and relative, the reference kernel sweep's bfloat16 tolerance
(both sides compute in float32 and round the gradient to bfloat16 once).

Rows with no live key: the port's forward gives 0 there (the flash
kernel's rule) and the reference's blockwise path the mean of v, so the
comparison zeroes dO on those rows; the port's own rule is checked
directly (dq 0 there, and dk, dv independent of dO there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import blockwise_attention as ref_blockwise
from repro_torch.kernels import cuda, ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)

pytestmark = pytest.mark.tier1

GRAD_CASES = {
    # b, hq, hkv, sq, skv, d, causal, window, softcap
    "causal": (2, 4, 2, 64, 64, 16, True, None, None),
    "window": (1, 8, 1, 96, 96, 32, True, 24, None),
    "softcap": (2, 2, 2, 48, 80, 64, True, None, 30.0),
    "gqa": (1, 8, 2, 40, 40, 16, True, None, None),
    "ragged": (1, 4, 1, 70, 70, 16, True, 33, 20.0),
    "noncausal": (1, 2, 1, 24, 50, 32, False, None, None),
    "dead_rows": (1, 2, 1, 80, 40, 16, True, None, None),
}
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case, dtype, seed=0):
    b, hq, hkv, sq, skv, d, causal, _w, _c = case
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, hq, sq, d), rng.randn(b, hkv, skv, d),
            rng.randn(b, hkv, skv, d), rng.randn(b, hq, sq, d)]
    if causal and sq > skv:
        arrs[3][:, :, :sq - skv] = 0.0    # the reference's dead rows differ
    ref = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    port = [torch.from_numpy(np.array(r.astype(jnp.float32))).to(
        TORCH[dtype]) for r in ref]
    return ref, port


def _ref_grads(case, ref):
    _b, _hq, _hkv, _sq, _skv, _d, causal, window, cap = case
    q, k, v, do = ref
    out, vjp = jax.vjp(lambda q, k, v: ref_blockwise(
        q, k, v, causal=causal, window=window, logit_softcap=cap), q, k, v)
    return [np.asarray(g.astype(jnp.float32)) for g in (out, *vjp(do))]


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_autograd_matches_reference_vjp(name, dtype):
    case = GRAD_CASES[name]
    _b, _hq, _hkv, sq, skv, _d, causal, window, cap = case
    ref, (q, k, v, do) = _inputs(case, dtype)
    want = _ref_grads(case, ref)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    cuda.reset_counts()
    out = flash_attention(q, k, v, causal=causal, window=window,
                          logit_softcap=cap, bk=32)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert cuda.PLAIN_CALLS["flash_attention"] == 1
    assert cuda.PLAIN_CALLS["flash_attention_bwd"] == 1
    assert not cuda.LAUNCHES
    live = slice(sq - skv, None) if causal and sq > skv else slice(None)
    _close(out[:, :, live], want[0][:, :, live], dtype)
    for got, w in zip(grads, want[1:]):
        assert got.dtype == TORCH[dtype]
        _close(got, w, dtype)


@pytest.mark.parametrize("name", ["causal", "softcap", "ragged"])
def test_plain_backward_matches_reference_vjp(name):
    """``flash_attention_bwd_plain`` from the plain forward's output and
    ``lse``, at the backward kernels' own 64-key tiles."""
    case = GRAD_CASES[name]
    _b, _hq, _hkv, _sq, _skv, _d, causal, window, cap = case
    ref, (q, k, v, do) = _inputs(case, "float32", seed=1)
    want = _ref_grads(case, ref)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    for got, w in zip(flash_attention_bwd_plain(q, k, v, out, lse, do, **kw),
                      want[1:]):
        _close(got, w, "float32")


def test_lse_is_the_row_logsumexp():
    """``lse`` = log sum_j exp(scale q.k_j) over the live keys; -1e30 for a
    row with none."""
    case = GRAD_CASES["dead_rows"]
    _ref, (q, k, v, _do) = _inputs(case, "float32")
    _out, lse = flash_attention_plain(q, k, v, return_lse=True, bk=16)
    sq, skv = q.shape[2], k.shape[2]
    s = (q @ k.repeat_interleave(2, 1).transpose(-1, -2)) \
        * q.shape[-1] ** -0.5
    qpos = torch.arange(skv - sq, skv)[:, None]
    s = s.masked_fill(torch.arange(skv)[None, :] > qpos, float("-inf"))
    want = torch.logsumexp(s, dim=-1)
    dead = qpos[:, 0] < 0
    torch.testing.assert_close(lse[..., ~dead], want[..., ~dead],
                               atol=1e-5, rtol=1e-5)
    assert bool((lse[..., dead] == -1e30).all())


def test_dead_rows_get_no_gradient():
    """A row with no live key (Sq > Skv, causal) has output 0 and dq 0, and
    its dO reaches neither dk nor dv."""
    case = GRAD_CASES["dead_rows"]
    _ref, (q, k, v, do) = _inputs(case, "float32")
    dead = q.shape[2] - k.shape[2]
    do_dead = do.clone()
    do_dead[:, :, :dead] = torch.randn(do_dead[:, :, :dead].shape)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v)
    assert float(out[:, :, :dead].detach().abs().max()) == 0.0
    g0 = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    g1 = torch.autograd.grad(out, (q, k, v), do_dead)
    assert float(g1[0][:, :, :dead].abs().max()) == 0.0
    for a, b in zip(g0[1:], g1[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_heads_through_ops_attention(dtype):
    """MLA's cache-less heads (q, k of 192, v of 128) reach the flash
    kernel zero-padded to 256 in ``ops.attention``; the gradient comes
    back through the pad and the slice."""
    rng = np.random.RandomState(3)
    shapes = ((1, 4, 40, 192), (1, 4, 40, 192), (1, 4, 40, 128),
              (1, 4, 40, 128))
    ref = [jnp.asarray(rng.randn(*s), JNP[dtype]) for s in shapes]
    q, k, v, do = (torch.from_numpy(np.array(r.astype(jnp.float32))).to(
        TORCH[dtype]) for r in ref)
    scale = 192 ** -0.5
    out_r, vjp = jax.vjp(lambda q, k, v: ref_blockwise(
        q, k, v, causal=True, scale=scale), *ref[:3])
    want = [np.asarray(g.astype(jnp.float32)) for g in (out_r, *vjp(ref[3]))]
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = ops.attention(q, k, v, causal=True, scale=scale)
    assert out.shape == (1, 4, 40, 128) and out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), do)
    _close(out, want[0], dtype)
    for got, w in zip(grads, want[1:]):
        assert got.shape == w.shape
        _close(got, w, dtype)


def test_no_grad_call_stays_off_the_graph():
    """Without grad the call takes today's path: no ``FlashAttentionFn``,
    no ``lse``, no backward."""
    _ref, (q, k, v, _do) = _inputs(GRAD_CASES["causal"], "float32")
    q.requires_grad_()
    cuda.reset_counts()
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert out.grad_fn is None and not out.requires_grad
    assert cuda.PLAIN_CALLS == {"flash_attention": 1}
