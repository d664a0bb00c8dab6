"""The port's train step (``repro_torch.train.step``) against the
reference's (``repro.train.step``) on the CPU: ``cross_entropy`` with and
without a mask, ``quantize_int8`` at exact .5 ties (both round half to
even) and the pod compressions; one step of ``make_train_step`` on the
same seeded weights, batch and AdamW state (step 3, nonzero moments, so
the bias corrections and the clip act) for gemma3 (dense, local and
global layers), deepseek (MLA, MoE, the aux loss) and mamba2 (SSD): loss,
aux loss, grad_norm, every gradient and every parameter after the step;
the port's ``microbatches=2`` and remat ``"full"`` / ``"dots"`` against
one batch without remat; and one finite step that changes the parameters
for every ``LM_CONFIGS`` entry (``tests/test_models.py::
test_one_train_step_loss_finite``'s check).

Tolerances (float32).  Loss, aux and grad_norm 1e-5 relative (observed
~1e-7); each gradient leaf ||got - want|| / ||want|| <= 1e-4 (observed
<= 3e-6: float32 sums in other orders through the layers' backward);
each parameter after the step within 2e-6 absolute at lr 1e-3 (observed
<= 4e-7).  Remat recomputes the same operations: equal bit for bit.
Two microbatches sum the gradient in another order: 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import ParallelConfig as RefParallel
from repro.optim.adamw import AdamW as RefAdamW
from repro.optim.adamw import AdamWState as RefState
from repro.train import step as ref_step
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (adamw_state_from_numpy, named_to_numpy,
                                 transformer_params_to_numpy)
from repro_torch.distributed.sharding import ParallelConfig
from repro_torch.kernels import cuda
from repro_torch.models import Transformer
from repro_torch.models.transformer import DENSE_KINDS
from repro_torch.optim.adamw import AdamW
from repro_torch.train import step as port_step

from torch_port_util import LM_CONFIGS, lm_models, lm_tokens

pytestmark = pytest.mark.tier1

LR = 1e-3


def _rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    return (np.linalg.norm(np.asarray(got, dtype=np.float64) - want)
            / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(2, 7, 11)).astype(np.float32)
    targets = rng.randint(0, 11, (2, 7)).astype(np.int32)
    mask = (rng.rand(2, 7) < 0.6) if masked else None
    want = float(ref_step.cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets),
        None if mask is None else jnp.asarray(mask)))
    got = float(port_step.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask)))
    assert got == pytest.approx(want, rel=1e-6)


def test_cross_entropy_empty_mask_is_finite():
    logits = torch.zeros(1, 3, 5)
    got = port_step.cross_entropy(logits, torch.zeros(1, 3, dtype=torch.long),
                                  torch.zeros(1, 3, dtype=torch.bool))
    assert float(got) == 0.0


def test_quantize_int8_rounds_ties_to_even():
    """Values at exact .5 multiples of the scale (max |g| = 127 -> scale
    1): half to even, as ``jnp.round``; the clip at +-127."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49, -127.0],
                 dtype=np.float32)
    qr, sr = ref_step.quantize_int8(jnp.asarray(g))
    qp, sp = port_step.quantize_int8(torch.from_numpy(g))
    assert qp.dtype == torch.int8 and float(sp) == float(sr) == 1.0
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qr))
    assert qp.tolist()[1:7] == [0, 2, 2, 0, -2, -2]
    np.testing.assert_array_equal(
        port_step.dequantize_int8(qp, sp).numpy(),
        np.asarray(ref_step.dequantize_int8(qr, sr)))


def test_pod_compressions_match_reference():
    rng = np.random.RandomState(1)
    g = {"a": rng.randn(5, 3).astype(np.float32),
         "b": (1e-3 * rng.randn(9)).astype(np.float32)}
    for ref_fn, port_fn in (
            (ref_step._compress_pod_grads, port_step._compress_pod_grads),
            (ref_step._compress_pod_grads_int8,
             port_step._compress_pod_grads_int8)):
        want = ref_fn({k: jnp.asarray(v) for k, v in g.items()}, None)
        got = port_fn({k: torch.from_numpy(v) for k, v in g.items()}, None)
        for k in g:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _state_np(params, seed=5):
    rng = np.random.RandomState(seed)
    m = jax.tree.map(
        lambda p: (0.01 * rng.randn(*p.shape)).astype(np.float32), params)
    v = jax.tree.map(
        lambda p: (1e-4 * np.abs(rng.randn(*p.shape))).astype(np.float32),
        params)
    return m, v


@pytest.mark.parametrize("name", ["gemma3", "deepseek", "mamba2"])
def test_one_step_matches_reference(name):
    ref, params, model = lm_models(name, "float32")
    cfg = ref.cfg
    toks, tgts = lm_tokens(cfg, (2, 32)), lm_tokens(cfg, (2, 32), seed=1)
    m, v = _state_np(params)
    batch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}

    # the reference's gradient, of its own loss function
    def loss(p):
        out = ref.apply(p, batch["tokens"])
        return ref_step.cross_entropy(out.logits, batch["targets"]) \
            + out.aux_loss
    want_g = jax.jit(jax.grad(loss))(params)
    rstate = RefState(step=jnp.asarray(3, jnp.int32),
                      m=jax.tree.map(jnp.asarray, m),
                      v=jax.tree.map(jnp.asarray, v))
    want_p, want_s, want_m = jax.jit(ref_step.make_train_step(
        ref, RefAdamW(lr=LR), RefParallel()))(params, rstate, batch)

    step = port_step.make_train_step(model, AdamW(lr=LR), ParallelConfig())
    pp = dict(model.named_parameters())
    assert all(p.requires_grad for p in pp.values())
    out = model(torch.from_numpy(toks))
    tot = port_step.cross_entropy(out.logits, torch.from_numpy(tgts)) \
        + out.aux_loss
    got_g = named_to_numpy(model, dict(zip(
        pp, torch.autograd.grad(tot, list(pp.values())))))
    for path, err in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(_rel, got_g, want_g)):
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)

    cuda.reset_counts()
    pp, ps, metrics = step(pp, adamw_state_from_numpy(model, 3, m, v),
                           {"tokens": torch.from_numpy(toks),
                            "targets": torch.from_numpy(tgts)})
    n_attn = sum(kind in DENSE_KINDS for kind in model.kinds)
    assert cuda.PLAIN_CALLS["flash_attention"] == n_attn
    assert cuda.PLAIN_CALLS["flash_attention_bwd"] == n_attn
    for key in ("loss", "aux_loss", "grad_norm"):
        assert metrics[key].dtype == torch.float32
        assert float(metrics[key]) == pytest.approx(float(want_m[key]),
                                                    rel=1e-5, abs=1e-7)
    assert (float(metrics["aux_loss"]) > 0) == (cfg.moe is not None)
    assert int(ps.step) == int(want_s.step) == 4
    diff = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - b).max()),
                        want_p, transformer_params_to_numpy(model))
    assert max(jax.tree.leaves(diff)) <= 2e-6


def _step_grads(model, parallel, toks, tgts):
    """The port's gradient as ``make_train_step`` takes it (through a
    zero-learning-rate step the metrics come from the same code), ->
    (grads, loss)."""
    captured = {}

    class Capture(AdamW):
        def update(self, grads, state, params):
            captured.update({k: g.clone() for k, g in grads.items()})
            return super().update(grads, state, params)
    tx = Capture(lr=0.0, weight_decay=0.0)
    step = port_step.make_train_step(model, tx, parallel)
    params = dict(model.named_parameters())
    _p, _s, metrics = step(params, tx.init(params),
                           {"tokens": torch.from_numpy(toks),
                            "targets": torch.from_numpy(tgts)})
    return captured, float(metrics["loss"])


@pytest.mark.parametrize("name", ["gemma3", "deepseek"])
def test_remat_and_microbatches_match_one_batch(name):
    _ref, _params, model = lm_models(name, "float32")
    toks = lm_tokens(model.cfg, (4, 32), seed=2)
    tgts = lm_tokens(model.cfg, (4, 32), seed=3)
    base, loss = _step_grads(model, ParallelConfig(), toks, tgts)
    for remat in ("full", "dots"):
        cuda.reset_counts()
        got, got_loss = _step_grads(model, ParallelConfig(remat=remat), toks,
                                    tgts)
        n_attn = sum(kind in DENSE_KINDS for kind in model.kinds)
        # the forward runs again in the backward
        assert cuda.PLAIN_CALLS["flash_attention"] == 2 * n_attn
        assert got_loss == loss
        for k in base:
            assert torch.equal(got[k], base[k]), (remat, k)
    if model.cfg.moe is None:        # MoE routes per microbatch group
        got, got_loss = _step_grads(model, ParallelConfig(microbatches=2),
                                    toks, tgts)
        assert got_loss == pytest.approx(loss, rel=1e-5)
        for k in base:
            assert got[k].dtype == torch.float32
            assert _rel(got[k].numpy(), base[k].numpy()) <= 1e-5, k


@pytest.mark.parametrize("name", list(LM_CONFIGS))
def test_one_train_step_loss_finite(name):
    arch, over = LM_CONFIGS[name]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **over)
    model = Transformer(cfg, seed=0, device="cpu")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tx = AdamW(lr=1e-3)
    step = port_step.make_train_step(model, tx, ParallelConfig())
    params = dict(model.named_parameters())
    rng = np.random.RandomState(0)
    b, s = 2, 16
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                    (b, s))),
             "targets": torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                     (b, s)))}
    if cfg.prefix_embed_len:
        batch["prefix_embeds"] = torch.from_numpy(0.01 * rng.randn(
            b, cfg.prefix_embed_len, cfg.d_model).astype(np.float32))
    if cfg.cross_attn_memory_len:
        batch["memory"] = torch.from_numpy(0.01 * rng.randn(
            b, cfg.cross_attn_memory_len,
            cfg.cross_attn_memory_dim).astype(np.float32))
    params, _state, metrics = step(params, tx.init(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    delta = max(float((p.detach() - before[k]).abs().max())
                for k, p in params.items())
    assert delta > 0
