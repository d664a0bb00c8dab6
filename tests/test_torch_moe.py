"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the same weights and inputs, made with numpy
from a seed, at the smoke configs of deepseek-v2-lite-16b (8 experts, top
2, two shared) and qwen3-moe-235b-a22b (8 experts, top 2, no shared).

Cases: the grouped path at the configs' capacity factor of 1.25 and
groups of 16 tokens (tokens drop: the test asserts some do), the one-group
path, and ``exact=True`` (decode: capacity = tokens, nothing drops), each
in float32 and bfloat16, output and aux loss.  The routing itself is held
bit for bit: fed the reference's router logits, ``moe.route`` gives the
reference's expert indices, in-group ranks, ``keep`` and capacity
(reference side: the lines of ``repro.models.moe.apply_moe`` that compute
them, in jax), including exactly tied gates, which go to the lower index.

Tolerances.  float32: outputs within 1e-5 absolute, aux within 1e-7
(observed <= 1.5e-6 and 3e-10): the same float32 operations summed in
another order.  bfloat16: outputs within 2^-6 absolute on values of
magnitude up to ~4 (one bfloat16 rounding there; observed 0: the port
rounds where XLA rounds, the SiLU one operation at a time), aux within
1e-7 (the router logits agree bit for bit).  Gates within 1e-6 relative (two softmax
implementations); everything else of the routing exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import moe as rmoe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as pmoe

pytestmark = pytest.mark.tier1

F32_TOL, BF16_TOL, AUX_TOL = 1e-5, 2.0 ** -6, 1e-7
ARCHS = ("deepseek_v2_lite_16b", "qwen3_moe_235b_a22b")
# (label, MoeConfig overrides, batch, seq, exact)
CASES = [("grouped", dict(capacity_factor=1.25, group_size=16), 2, 32,
          False),
         ("one-group", {}, 2, 24, False),
         ("exact", dict(capacity_factor=1.25), 1, 40, True)]


def _cfgs(arch, over, dtype):
    out = []
    for get in (ref_smoke, get_smoke_config):
        cfg = get(arch)
        out.append(dataclasses.replace(
            cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **over)))
    return out


def _weights(rcfg, seed=0):
    """The reference's MoE pytree, fan-in scaled normals from numpy."""
    shapes = jax.eval_shape(lambda k: rmoe.init_moe(k, rcfg)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: (rng.randn(*s.shape) / np.sqrt(
        s.shape[-2])).astype(np.float32), shapes)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _ref_routing(logits, m, exact):
    """``repro.models.moe.apply_moe``'s routing lines, from its float32
    router logits [G, T, E]."""
    g, t, e = logits.shape
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, m.top_k)
    if m.norm_topk:
        gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    capacity = t if exact else max(1, int(t * m.top_k * m.capacity_factor
                                          / m.n_experts))
    onehot = jax.nn.one_hot(expert_idx, m.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(g, t * m.top_k, m.n_experts)
    pos = (jnp.cumsum(flat, axis=1) * flat - 1).reshape(g, t, m.top_k,
                                                        m.n_experts)
    pos_tk = jnp.take_along_axis(pos, expert_idx[..., None], axis=3)[..., 0]
    keep = (pos_tk >= 0) & (pos_tk < capacity)
    return gate_vals, expert_idx, pos_tk, keep, capacity


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, case, dtype):
    label, over, b, s, exact = case
    rcfg, pcfg = _cfgs(arch, over, dtype)
    w = _weights(rcfg)
    x = np.random.RandomState(1).randn(b, s, rcfg.d_model).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xr = jnp.asarray(x).astype(jdt)
    want, want_aux = jax.jit(lambda p, x: rmoe.apply_moe(
        p, rcfg, x, exact=exact))(jax.tree.map(jnp.asarray, w), xr)
    xp = torch.from_numpy(np.array(xr.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    routes = []
    got, aux = pmoe.apply_moe(_torch_tree(w), pcfg, xp, exact=exact,
                              routes=routes)
    (r,) = routes
    n_groups = 1 if label != "grouped" else b * s // 16
    assert r.keep.shape == (n_groups, b * s // n_groups, pcfg.moe.top_k)
    if label == "grouped":
        assert not bool(r.keep.all())              # tokens dropped
    else:
        assert bool(r.keep.all())
    assert got.dtype == xp.dtype and aux.dtype == torch.float32
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert err.max() <= (BF16_TOL if dtype == "bfloat16" else F32_TOL), \
        err.max()
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_routing_matches_reference_bit_for_bit(case, ties):
    """The reference's router logits of a seeded input through both
    routings; with ``ties``, rows of exactly equal logits (all equal,
    pairs equal at the top-k boundary, a repeated maximum)."""
    label, over, b, s, exact = case
    rcfg, pcfg = _cfgs("deepseek_v2_lite_16b", over, "float32")
    w = _weights(rcfg)
    x = np.random.RandomState(2).randn(b * s, rcfg.d_model).astype(
        np.float32)
    n_groups = 1 if label != "grouped" else b * s // 16
    logits = np.asarray(jnp.asarray(x) @ jnp.asarray(w["router"])).reshape(
        n_groups, b * s // n_groups, -1)
    if ties:
        logits = logits.copy()
        logits[0, 0] = 0.5                          # all 8 gates equal
        logits[0, 1, 3] = logits[0, 1, 6] = logits[0, 1].max() + 1.0
        top = np.sort(logits[0, 2])[::-1]
        logits[0, 2][logits[0, 2] == top[2]] = top[1]   # tie at the boundary
        logits[-1, -1, ::2] = 2.0
    gate, expert, rank, keep, capacity = _ref_routing(jnp.asarray(logits),
                                                      rcfg.moe, exact)
    r = pmoe.route(torch.from_numpy(np.array(logits)), pcfg, exact=exact)
    assert r.capacity == capacity
    np.testing.assert_array_equal(r.expert.numpy(), np.asarray(expert))
    np.testing.assert_array_equal(r.rank.numpy(), np.asarray(rank))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    np.testing.assert_allclose(r.gate.numpy(), np.asarray(gate), rtol=1e-6)
    assert (np.asarray(rank) >= 0).all()
    if ties:
        # equal gates resolve to the lower expert index, as top_k does
        assert r.expert[0, 0].tolist() == [0, 1]
        assert r.expert[0, 1].tolist() == [3, 6]
        assert r.expert[-1, -1].tolist() == [0, 2]
    if label == "grouped":
        assert not bool(r.keep.all())


def test_groups_follow_the_reference_rule():
    """One group at most ``group_size`` tokens or when exact; beyond it
    the token count must divide by ``group_size`` (the reference asserts,
    the port raises ValueError)."""
    rcfg, pcfg = _cfgs("qwen3_moe_235b_a22b", dict(group_size=16),
                       "float32")
    assert pmoe.groups(pcfg, 16, False) == (1, 16)
    assert pmoe.groups(pcfg, 48, False) == (3, 16)
    assert pmoe.groups(pcfg, 40, True) == (1, 40)
    w = _weights(rcfg)
    x = np.zeros((1, 40, rcfg.d_model), np.float32)
    with pytest.raises(ValueError, match="not divisible by group 16"):
        pmoe.apply_moe(_torch_tree(w), pcfg, torch.from_numpy(x))
    with pytest.raises(AssertionError, match="not divisible by group 16"):
        rmoe.apply_moe(jax.tree.map(jnp.asarray, w), rcfg, jnp.asarray(x))
