"""The port's ``ContinuousBatcher`` over every cache kind: an MLA latent
cache a slot (deepseek-v2-lite: exact MoE routing at decode) and the
constant-size recurrent caches (mamba2's conv window and SSM state,
recurrentgemma's conv window and RG-LRU state beside its local-attention
ring).  Held against the reference's batcher on the same weights (carried
over by ``convert.transformer_params_from_numpy``) and the same burst:
equal greedy tokens for every request and equal ``SchedStats``, field by
field; and against ``generate`` of each request alone."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.serving import ContinuousBatcher, Request, generate

from torch_port_util import lm_models

pytestmark = pytest.mark.tier1

# every prompt is 64 tokens: a multiple of mamba2's smoke chunk (32)
PROMPT = 64
CACHES = ["deepseek", "mamba2", "recurrentgemma"]


def _burst(vocab, seed, n=4):
    """n prompts of 64 tokens, the even ones sharing a 48-token prefix."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, 48).astype(np.int32)
    return [np.concatenate([shared, rng.randint(0, vocab, 16)]).astype(
        np.int32) if i % 2 == 0 else rng.randint(0, vocab, PROMPT).astype(
        np.int32) for i in range(n)]


@pytest.mark.parametrize("name", CACHES)
def test_batcher_matches_reference_batcher(name):
    from repro.serving.scheduler import ContinuousBatcher as RefBatcher
    from repro.serving.scheduler import Request as RefRequest
    ref_model, params, port_model = lm_models(name)
    prompts = _burst(port_model.cfg.vocab_size, seed=7)
    ref = RefBatcher(ref_model, params, slots=2, cache_len=80, block=16)
    port = ContinuousBatcher(port_model, slots=2, cache_len=80, block=16)
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(prompts)]
    port_reqs = [Request(rid=i, prompt=p, max_new=4)
                 for i, p in enumerate(prompts)]
    for r, p in zip(ref_reqs, port_reqs):
        assert ref.submit(r) == port.submit(p)
    ref_stats, port_stats = ref.run_until_drained(), port.run_until_drained()
    assert dataclasses.asdict(port_stats) == dataclasses.asdict(ref_stats)
    assert port_stats.finished == len(prompts)
    assert port_stats.prefix_blocks_reused > 0
    for r, p in zip(ref_reqs, port_reqs):
        assert p.out == r.out, p.rid
        assert p.prefix_hit_blocks == r.prefix_hit_blocks
    # each slot's cache is the model's own kind, one sequence long
    assert port.caches == [None] * 2
    # the batcher's tokens are each request's own greedy generation
    for p in port_reqs:
        want = generate(port_model, torch.from_numpy(p.prompt)[None, :],
                        p.max_new, cache_len=80)
        assert p.out == want.tokens[0].tolist(), p.rid


@pytest.mark.parametrize("name", CACHES)
def test_slot_cache_kind(name):
    """One slot's cache is the config's kind: an MLA latent of [n, 1, 1,
    S, kv_lora + rope], an SSM (conv, state) or RG-LRU (conv, h) of
    constant size beside attention's k, v."""
    _ref_model, _params, model = lm_models(name)
    cache = model.init_cache(1, 80, dtype=torch.float32)
    kinds = {type(c).__name__ for c in cache["blocks"]}
    cfg = model.cfg
    if cfg.mla is not None:
        k = cache["blocks"][0].k
        assert k.shape[1:] == (1, 1, 80, cfg.mla.kv_lora_rank
                               + cfg.mla.qk_rope_dim)
    elif cfg.ssm is not None:
        assert kinds == {"SsmCache"}
    else:
        assert "RglruCache" in kinds and "KVCache" in kinds
