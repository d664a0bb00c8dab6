"""The port's ``ContinuousBatcher`` (``repro_torch.serving.scheduler``) on
the CPU: the contracts of ``tests/test_scheduler.py`` and of the scheduler
cases of ``tests/test_streaming.py`` held on the port, and the reference's
batcher and the port's on the same weights (carried over by
``convert.transformer_params_from_numpy``) and the same burst: equal
greedy tokens and ``SchedStats``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import Transformer
from repro_torch.obs import MetricsRegistry
from repro_torch.serving import (BackpressureController, ContinuousBatcher,
                                 Request, generate)
from repro_torch.streaming import GenerationalFilter, GenerationConfig
from repro_torch.streaming.admission import (AdmissionConfig,
                                             AdmissionController)

from torch_port_util import lm_models, random_keys

pytestmark = pytest.mark.tier1


@pytest.fixture(scope="module")
def small_model():
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"), dtype="float32")
    return cfg, Transformer(cfg, seed=0, device="cpu")


def _burst(vocab, seed=0, n=7):
    """tests/test_scheduler.py's burst: 7 prompts of 64 tokens, the even
    ones sharing a 48-token prefix."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, 48).astype(np.int32)
    out = []
    for i in range(n):
        if i % 2 == 0:
            p = np.concatenate([shared,
                                rng.randint(0, vocab, 16).astype(np.int32)])
        else:
            p = rng.randint(0, vocab, 64).astype(np.int32)
        out.append(p)
    return out


def test_burst_drains_and_reuses_prefixes(small_model):
    """tests/test_scheduler.py::test_burst_drains_and_reuses_prefixes."""
    cfg, model = small_model
    b = ContinuousBatcher(model, slots=3, cache_len=128, block=16)
    for i, p in enumerate(_burst(cfg.vocab_size)):
        assert b.submit(Request(rid=i, prompt=p, max_new=4))
    assert b.congestion > 1.0, "burst exceeds slot capacity (backpressure)"
    stats = b.run_until_drained()
    assert stats.finished == 7
    assert stats.prefills == 7
    assert stats.prefix_blocks_reused > 0, "shared prefixes must hit the OCF"
    assert stats.decode_steps > 0
    assert stats.peak_queue == 7
    assert not b.queue and not b.active
    assert b.caches == [None] * 3


def test_scheduler_output_matches_unbatched(small_model):
    """tests/test_scheduler.py::test_scheduler_output_matches_unbatched."""
    cfg, model = small_model
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab_size, 32).astype(np.int32)
    b = ContinuousBatcher(model, slots=2, cache_len=64, block=16)
    req = Request(rid=0, prompt=prompt, max_new=6)
    b.submit(req)
    b.run_until_drained()
    ref = generate(model, torch.from_numpy(prompt)[None, :], 6, cache_len=64)
    np.testing.assert_array_equal(np.array(req.out), ref.tokens[0].numpy())


def test_matches_reference_batcher():
    """The reference's ``ContinuousBatcher`` and the port's over the same
    weights and the same burst: equal greedy tokens for every request and
    equal ``SchedStats``, field by field."""
    from repro.serving.scheduler import ContinuousBatcher as RefBatcher
    from repro.serving.scheduler import Request as RefRequest
    ref_model, params, port_model = lm_models("gemma3")
    prompts = _burst(port_model.cfg.vocab_size, seed=3)
    ref = RefBatcher(ref_model, params, slots=3, cache_len=96, block=16)
    port = ContinuousBatcher(port_model, slots=3, cache_len=96, block=16)
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new=5)
                for i, p in enumerate(prompts)]
    port_reqs = [Request(rid=i, prompt=p, max_new=5)
                 for i, p in enumerate(prompts)]
    for r, p in zip(ref_reqs, port_reqs):
        assert ref.submit(r) == port.submit(p)
    assert port.congestion == ref.congestion
    ref_stats, port_stats = ref.run_until_drained(), port.run_until_drained()
    assert dataclasses.asdict(port_stats) == dataclasses.asdict(ref_stats)
    for r, p in zip(ref_reqs, port_reqs):
        assert p.out == r.out, p.rid
        assert p.prefix_hit_blocks == r.prefix_hit_blocks
    assert len({tuple(p.out) for p in port_reqs}) > 1


def test_admission_defers_and_drains():
    """tests/test_streaming.py::test_scheduler_admission_defers_and_drains:
    submits defer while the filter is congested, and a fully starved
    batcher recovers on its own by aging the filter (advance, else
    rotate)."""
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"), dtype="float32")
    model = Transformer(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    gcfg = GenerationConfig(generations=2, capacity=512, stash_slots=64,
                            evict_rounds=4, o_max=0.97, stash_high=2.0,
                            device="cpu")
    gf = GenerationalFilter(gcfg, now=0.0)
    ctl = AdmissionController(gf, AdmissionConfig(high_water=0.35,
                                                  low_water=0.1))
    b = ContinuousBatcher(model, slots=2, cache_len=64, block=16,
                          admission=ctl)
    gf.insert(random_keys(rng, 480), now=0.0)    # congest the filter
    prompt = rng.randint(0, cfg.vocab_size, 32).astype(np.int32)
    assert not b.submit(Request(rid=0, prompt=prompt, max_new=2))
    assert b.stats.deferred == 1 and len(b.deferred) == 1
    assert b.congestion > 0.35
    stats = b.run_until_drained()
    assert stats.finished == 1
    assert gf.stats.rotations >= 1, "starved drain must rotate the filter"
    assert not b.deferred and not b.queue
    assert ctl.deferred == 1          # polling added no per-request count


def test_backpressure_defers_sheds_and_readmits(small_model):
    """A registry-fed ``BackpressureController``: a high signal defers, a
    fresh shed drops the request (``shed_requests``), and once the signal
    recedes a tick re-admits the deferred ones."""
    cfg, model = small_model
    m = MetricsRegistry()
    bp = BackpressureController(m)
    b = ContinuousBatcher(model, slots=2, cache_len=64, block=16,
                          backpressure=bp)
    prompts = _burst(cfg.vocab_size, seed=5, n=3)
    m.gauge("admission_signal").set(0.9)
    assert not b.submit(Request(rid=0, prompt=prompts[0], max_new=2))
    assert b.stats.deferred == 1 and len(b.deferred) == 1
    m.counter("filter_shed_ops").inc(64)
    assert not b.submit(Request(rid=1, prompt=prompts[1], max_new=2))
    assert b.stats.shed_requests == 1 and len(b.deferred) == 1
    m.gauge("admission_signal").set(0.1)
    stats = b.run_until_drained()
    assert stats.finished == 1 and stats.admitted == 1
    assert b.submit(Request(rid=2, prompt=prompts[2], max_new=2))
    assert b.run_until_drained().finished == 2
