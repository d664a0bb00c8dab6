"""The port's ``Transformer`` forward against the reference's on the same
weights: weights in the reference's parameter pytree and token ids are
made with numpy from a seed (``torch_port_util.lm_params_np``), and the
weights reach the port through ``convert.transformer_params_from_numpy``.

Configs: the smoke configs of gemma3-1b (one period of 5 local + 1 global),
gemma2-27b (2 periods of local, global; soft-caps) and mistral-nemo-12b
(global only), and gemma3 smoke at 14 layers (2 periods + a 2-layer local
tail), where the reference's slot-major layer order shows.

Prefill, decode and the ring cache are held in ``test_torch_decode.py``.

Tolerances.  float32 logits: 5e-5 absolute (observed <= 5e-6).
The port's cache-less forward runs the flash schedule, the reference's
off-TPU forward its local/blockwise attention, and matrix products sum in
another order: float32 rounding, carried through up to 14 layers.
bfloat16 logits: 0.25 absolute with logits of magnitude up to ~4 (16
bfloat16 ulps there; observed <= 0.09), and a mean error under 0.02: both
frameworks round every bfloat16 product and activation, but XLA keeps
some fused intermediates in float32 that torch rounds (and the other way),
and each such rounding (2^-8 relative) is carried through every layer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Transformer as RefTransformer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import transformer_params_to_numpy
from repro_torch.kernels import cuda
from repro_torch.models import Transformer
from repro_torch.models.transformer import DENSE_KINDS

from torch_port_util import LM_CONFIGS, lm_models, lm_tokens, ref_logits

pytestmark = pytest.mark.tier1

F32_TOL = 5e-5
BF16_TOL, BF16_MEAN_TOL = 0.25, 0.02
AUX_TOL = {"float32": 1e-7, "bfloat16": 1e-6}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LM_CONFIGS))
def test_apply_logits_match_reference(name, dtype):
    ref, params, model = lm_models(name, dtype)
    toks = lm_tokens(ref.cfg, (2, 32))
    want, want_aux = (np.asarray(a) for a in jax.jit(
        lambda p, t: (lambda o: (o.logits, o.aux_loss))(ref.apply(p, t)))(
            params, jnp.asarray(toks)))
    cuda.reset_counts()
    out = model.apply(torch.from_numpy(toks))
    got = out.logits
    # every attention layer went to the flash kernel (its plain version);
    # SSM and RG-LRU layers launch none
    assert cuda.PLAIN_CALLS["flash_attention"] == sum(
        kind in DENSE_KINDS for kind in model.kinds)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want)
    if dtype == "float32":
        assert err.max() < F32_TOL, err.max()
    else:
        assert err.max() < BF16_TOL and err.mean() < BF16_MEAN_TOL, (
            err.max(), err.mean())
    # the MoE load-balance loss, summed over the blocks; 0 without MoE
    assert out.aux_loss.dtype == torch.float32
    assert abs(float(out.aux_loss) - float(want_aux)) <= AUX_TOL[dtype]
    assert (float(want_aux) > 0) == (model.cfg.moe is not None)


def test_ragged_length_matches_reference():
    """S = 200 is no multiple of the flash kernel's 128-row tiles: the
    cache-less forward stays on the kernel (its plain version here), with
    ragged last tiles, and matches the reference's apply."""
    ref, params, model = lm_models("gemma3", "float32")
    toks = lm_tokens(ref.cfg, (1, 200))
    want = np.asarray(ref_logits(ref, params, toks))
    cuda.reset_counts()
    got = model.apply(torch.from_numpy(toks)).logits
    assert cuda.PLAIN_CALLS["flash_attention"] == model.cfg.n_layers
    assert got.shape == want.shape == (1, 200, ref.cfg.vocab_size)
    assert np.abs(got.numpy() - want).max() < F32_TOL


def test_layers_run_slot_major():
    """The reference runs every period of pattern slot 0, then of slot 1,
    ..., then the tail.  Run in the interleaved order (L,L,L,L,L,G, L,...)
    the same layers give other logits, far outside the tolerance that the
    slot-major order meets."""
    ref, params, model = lm_models("gemma3-14")
    assert model.kinds == ["local"] * 10 + ["global"] * 2 + ["local"] * 2
    assert model.slots[:3] == [("blocks", 0, 0), ("blocks", 0, 1),
                               ("blocks", 1, 0)]
    toks = lm_tokens(ref.cfg, (2, 32), seed=4)
    want = np.asarray(ref_logits(ref, params, toks))
    got = model.apply(torch.from_numpy(toks)).logits.numpy()
    assert np.abs(got - want).max() < F32_TOL
    interleaved = sorted(range(len(model.slots)),
                         key=lambda n: (model.slots[n][0] != "blocks",
                                        model.slots[n][2],
                                        model.slots[n][1]))
    assert [model.kinds[n] for n in interleaved][:6] == \
        ["local"] * 5 + ["global"]
    model.layers = torch.nn.ModuleList(model.layers[n] for n in interleaved)
    model.slots = [model.slots[n] for n in interleaved]
    wrong = model.apply(torch.from_numpy(toks)).logits.numpy()
    assert np.abs(wrong - want).max() > 100 * F32_TOL


@pytest.mark.parametrize("name", ["gemma3-14", "deepseek", "qwen3-moe",
                                  "mamba2", "recurrentgemma", "musicgen",
                                  "llava"])
def test_params_round_trip(name):
    _ref, params, model = lm_models(name)
    back = transformer_params_to_numpy(model)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, want)))


def test_own_init_is_seeded_and_forward_only():
    cfg = get_smoke_config("gemma3-1b")
    a = Transformer(cfg, seed=3, device="cpu")
    b = Transformer(cfg, seed=3, device="cpu")
    c = Transformer(cfg, seed=4, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    assert not torch.equal(a.emb["embed"], c.emb["embed"])
    assert not any(p.requires_grad for p in a.parameters())
    n = sum(p.numel() for p in a.parameters())
    assert n == cfg.param_count()
    out = a.apply(torch.zeros((1, 16), dtype=torch.int64))
    assert not out.logits.requires_grad
    assert out.logits.dtype == torch.float32


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_own_moe_init_has_the_reference_params(arch):
    """The own init holds the reference init's parameters, leaf for leaf:
    ``param_count()`` plus each MLA layer's ``kv_norm``, which it omits
    (the reference's count does too); the dense prefix comes first."""
    cfg = get_smoke_config(arch)
    model = Transformer(cfg, seed=0, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    want = jax.eval_shape(lambda k: RefTransformer(
        ref_smoke_config(arch)).init(k)[0], jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(want))
    norms = cfg.n_layers * cfg.mla.kv_lora_rank if cfg.mla else 0
    assert n == cfg.param_count() + norms
    prefix = cfg.moe.first_k_dense
    assert [layer.moe for layer in model.layers] == \
        [False] * prefix + [True] * (cfg.n_layers - prefix)
    assert model.slots[0] == (("prefix", 0, 0) if prefix
                              else ("blocks", 0, 0))
    out = model.apply(torch.zeros((1, 16), dtype=torch.int64))
    assert out.logits.shape == (1, 16, cfg.vocab_size)
    assert float(out.aux_loss) > 0


def test_unported_configs_raise():
    """Every architecture of the reference is ported; what raises now is
    what the reference does not know: an unknown architecture name, and a
    pattern kind other than global, local, rglru and ssm (or a recurrent
    kind without its sub-config)."""
    for arch in ("mamba2-1.3b", "recurrentgemma-2b", "musicgen-large",
                 "llava-next-mistral-7b", "nemotron-4-15b"):
        assert get_config(arch).name == arch
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("no-such-model")
    with pytest.raises(ValueError, match="unknown architecture"):
        get_smoke_config("no-such-model")
    cfg = get_smoke_config("mistral-nemo-12b")
    with pytest.raises(ValueError, match="unknown block kinds"):
        Transformer(dataclasses.replace(cfg, pattern=("global", "conv")),
                    device="cpu")
    with pytest.raises(ValueError, match="cfg.rglru"):
        Transformer(dataclasses.replace(cfg, pattern=("rglru",)),
                    device="cpu")
