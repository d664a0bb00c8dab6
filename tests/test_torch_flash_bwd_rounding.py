"""A torch model of the bfloat16 backward kernels' roundings
(``csrc/flash_attention_bwd.cu``: ``flash_bwd_dkdv_wgmma_kernel``,
``flash_bwd_dq_wgmma_kernel``), held before any card run against what the
kernels will be held to.

The kernels read bfloat16 q, k, v and dO, compute the scores, dP, p and
dS in float32, round p^T and dS^T to bfloat16 as the register A operands
of dv += p^T dO, dk += dS^T q and dq += dS k, sum every product in
float32 and round each gradient to bfloat16 once.  ``rounded_bwd`` does
the same in torch ops (one pass over all keys: the kernels' order of
float32 sums is not modelled).  At D 64, 128 and 256 (gemma3-1b's heads
among them, and a soft-capped, windowed, ragged case) it is held

* against ``jax.vjp`` of the reference's ``blockwise_attention`` within
  the bfloat16 tolerance of ``test_torch_flash_grad.py`` (2e-2 absolute
  and relative), and
* against ``flash_attention_bwd_plain`` (no intermediate rounding) within
  ``chip_smoke.py``'s ``FLASH_BWD_TOL`` / ``FLASH_BWD_ROW_TOL``, the
  tolerances phase 2 holds the kernels to: elementwise |got - want| <=
  tol (1 + |want|), and row by row ||got - want|| / ||want|| over the rows
  whose norm is above 1e-3 of the largest and above 1e-3.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import blockwise_attention as ref_blockwise
from repro_torch.kernels.flash_attention import (_live,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)

pytestmark = pytest.mark.tier1

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
_chip = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_chip)
TOL = _chip.FLASH_BWD_TOL["bfloat16"]
ROW_TOL = _chip.FLASH_BWD_ROW_TOL["bfloat16"]

CASES = {
    # b, hq, hkv, sq, skv, d, causal, window, softcap
    "d64_gqa": (1, 4, 2, 130, 130, 64, True, None, None),
    "d64_dead_rows": (1, 2, 1, 160, 100, 64, True, None, None),
    "d128_softcap": (1, 2, 2, 96, 160, 128, True, None, 30.0),
    "d128_noncausal": (1, 2, 1, 70, 90, 128, False, None, None),
    "d256_gemma_global": (1, 4, 1, 200, 200, 256, True, None, None),
    "d256_gemma_local": (1, 4, 1, 200, 200, 256, True, 64, None),
    "d256_capped_windowed_ragged": (1, 4, 1, 150, 150, 256, True, 50,
                                    20.0),
}


def rounded_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                logit_softcap=None, scale=None):
    """(dq, dk, dv) in bfloat16 with the kernels' roundings: float32
    arithmetic on the bfloat16 inputs, p and dS rounded to bfloat16 before
    their products, float32 sums, one rounding of each gradient."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, hkv, group, sq, d)
    dof = do.float().reshape(b, hkv, group, sq, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    lse_ = lse.float().reshape(b, hkv, group, sq, 1)
    delta = (do.float() * o.float()).sum(-1).reshape(b, hkv, group, sq, 1)
    qpos = (skv - sq + torch.arange(sq))[:, None]
    mask = _live(qpos, 0, skv, causal, window)
    x = (qf @ kf.transpose(-1, -2)) * scale
    dcap = 1.0
    if logit_softcap is not None:
        t = torch.tanh(x / logit_softcap)
        x, dcap = logit_softcap * t, 1 - t * t
    p = torch.where(mask, torch.exp(x - lse_), 0.0)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * dcap * scale * (dp - delta)
    pb, dsb = (t.to(torch.bfloat16).float() for t in (p, ds))
    dv = (pb.transpose(-1, -2) @ dof).sum(2)
    dk = (dsb.transpose(-1, -2) @ qf).sum(2)
    dq = (dsb @ kf).reshape(b, hq, sq, d)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _inputs(case, seed):
    b, hq, hkv, sq, skv, d, causal, _w, _c = case
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, hq, sq, d), rng.randn(b, hkv, skv, d),
            rng.randn(b, hkv, skv, d), rng.randn(b, hq, sq, d)]
    if causal and sq > skv:
        arrs[3][:, :, :sq - skv] = 0.0    # the reference's dead rows differ
    ref = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    port = [torch.from_numpy(np.array(r.astype(jnp.float32))).to(
        torch.bfloat16) for r in ref]
    return ref, port


def _model(case, port):
    _b, _hq, _hkv, _sq, _skv, _d, causal, window, cap = case
    q, k, v, do = port
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    return (rounded_bwd(q, k, v, o, lse, do, **kw),
            flash_attention_bwd_plain(q, k, v, o, lse, do, **kw))


@pytest.mark.parametrize("name", list(CASES))
def test_rounded_model_matches_reference_vjp(name):
    case = CASES[name]
    _b, _hq, _hkv, _sq, _skv, _d, causal, window, cap = case
    ref, port = _inputs(case, seed=len(name))
    _out, vjp = jax.vjp(lambda q, k, v: ref_blockwise(
        q, k, v, causal=causal, window=window, logit_softcap=cap), *ref[:3])
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(ref[3])]
    got, _plain = _model(case, port)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("name", list(CASES))
def test_rounded_model_within_the_kernels_tolerance_of_plain(name):
    case = CASES[name]
    _ref, port = _inputs(case, seed=len(name) + 1)
    got, want = _model(case, port)
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        assert float((err - TOL * (1 + w.abs())).max()) <= 0
        num, den = (g - w).norm(dim=-1), w.norm(dim=-1)
        rows = den > 1e-3 * max(float(den.max()), 1.0)
        assert float((num[rows] / den[rows]).max()) <= ROW_TOL
        # the roundings are there: the model is not the plain version
        assert float(err.max()) > 0
