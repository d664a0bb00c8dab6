"""The port's AdamW and cosine schedule against the reference's
(``repro.optim.adamw``), mirroring ``tests/test_optim.py``: convergence on
a quadratic, gradient clipping (the raw norm reported), decoupled weight
decay, the schedule's shape, and float32 moments for bfloat16 parameters;
then ``update`` against the reference's on the same seeded parameters,
gradients and state (float32 and bfloat16 parameters, clipping on and
off, weight decay, the schedule as the learning rate).

Tolerances.  Parameters, m and v within 1 float32 ulp-scale (rtol 1e-6,
atol 1e-7; observed 0 or one rounding) in float32; a bfloat16 parameter
within one bfloat16 ulp (the float32 update before the cast may round
the other way); the global norm within 1e-6 relative (float32 sums in
another leaf order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamW as RefAdamW
from repro.optim.adamw import AdamWState as RefState
from repro.optim.adamw import cosine_schedule as ref_cosine
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule

pytestmark = pytest.mark.tier1


def test_adamw_converges_quadratic():
    tx = AdamW(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = tx.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = tx.update(grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip_caps_norm():
    tx = AdamW(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(4)}
    _, state, gn = tx.update({"w": torch.full((4,), 100.0)},
                             tx.init(params), params)
    assert float(gn) == 200.0  # raw norm reported
    # after clip, m == grads * scale * (1 - b1) => |m| <= clip * (1 - b1)
    assert float(torch.linalg.norm(state.m["w"])) <= 1.0 * 0.1 + 1e-6


def test_weight_decay_decoupled():
    tx = AdamW(lr=0.1, weight_decay=0.5, grad_clip=0.0)
    params = {"w": torch.tensor([1.0])}
    p2, _, _ = tx.update({"w": torch.tensor([0.0])}, tx.init(params), params)
    assert float(p2["w"][0]) < 1.0  # decays with zero gradient


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    at = lambda s: float(lr(torch.tensor(s, dtype=torch.int32)))  # noqa
    assert at(0) == 0.0
    assert abs(at(10) - 1e-3) < 1e-9
    assert at(100) < at(50)
    assert at(1000) >= 1e-4 * 0.99  # floor


def test_state_dtype_f32_for_bf16_params():
    tx = AdamW(lr=1e-3)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = tx.init(params)
    assert st.m["w"].dtype == torch.float32 and st.step.dtype == torch.int32
    p2, st2, _ = tx.update({"w": torch.ones(4, dtype=torch.bfloat16)}, st,
                           params)
    assert p2["w"].dtype == torch.bfloat16 and st2.v["w"].dtype == \
        torch.float32
    assert int(st2.step) == 1


@pytest.mark.parametrize("step", [0, 5, 20, 21, 500, 10000, 20000])
def test_cosine_schedule_matches_reference(step):
    want = float(ref_cosine(3e-4, 20, 10000)(jnp.asarray(step, jnp.int32)))
    got = float(cosine_schedule(3e-4, 20, 10000)(
        torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def _tree(seed, dtype):
    rng = np.random.RandomState(seed)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    out = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    if dtype == "bfloat16":   # the same rounded values on both sides
        out = {k: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
            jnp.float32)) for k, a in out.items()}
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(), dict(grad_clip=0.0),
                                dict(weight_decay=0.0, grad_clip=0.5),
                                dict(schedule=True)],
                         ids=["default", "no_clip", "clip_0.5", "schedule"])
def test_update_matches_reference(dtype, kw):
    kw = dict(kw)
    if kw.pop("schedule", False):
        kw["lr"] = None
    p_np, g_np = _tree(0, dtype), _tree(1, dtype)
    g_np = {k: 3 * g for k, g in g_np.items()}      # a norm that clips
    rng = np.random.RandomState(2)
    m_np = {k: (0.01 * rng.randn(*a.shape)).astype(np.float32)
            for k, a in p_np.items()}
    v_np = {k: (1e-3 * np.abs(rng.randn(*a.shape))).astype(np.float32)
            for k, a in p_np.items()}
    rlr = ref_cosine(3e-4, 20, 10000) if "lr" in kw else 1e-2
    plr = cosine_schedule(3e-4, 20, 10000) if "lr" in kw else 1e-2
    kw.pop("lr", None)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = RefAdamW(lr=rlr, **kw)
    port = AdamW(lr=plr, **kw)
    rstate = RefState(step=jnp.asarray(25, jnp.int32),
                      m=jax.tree.map(jnp.asarray, m_np),
                      v=jax.tree.map(jnp.asarray, v_np))
    pstate = AdamWState(step=torch.tensor(25, dtype=torch.int32),
                        m={k: torch.from_numpy(a.copy())
                           for k, a in m_np.items()},
                        v={k: torch.from_numpy(a.copy())
                           for k, a in v_np.items()})
    rp, rs, rgn = ref.update({k: jnp.asarray(g, jdt) for k, g in g_np.items()},
                             rstate, {k: jnp.asarray(p, jdt)
                                      for k, p in p_np.items()})
    params = {k: torch.from_numpy(p.copy()).to(tdt) for k, p in p_np.items()}
    pp, ps, pgn = port.update({k: torch.from_numpy(g.copy()).to(tdt)
                               for k, g in g_np.items()}, pstate, params)
    assert pp is params                       # updated in place
    assert float(pgn) == pytest.approx(float(rgn), rel=1e-6)
    assert int(ps.step) == int(rs.step) == 26
    for k in p_np:
        for got, want in ((ps.m[k], rs.m[k]), (ps.v[k], rs.v[k])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)
        assert pp[k].dtype == tdt
        want = np.asarray(rp[k].astype(jnp.float32))
        got = pp[k].float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
