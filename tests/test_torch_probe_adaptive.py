"""Kernel 7 (probe_adaptive, the adaptive filter's lookup) on
PROBE_ADAPTIVE_CASES: the port's plain version against the reference's XLA
grid emulation (and, on one small case, its Pallas interpreter), bit for
bit.  The cases force what ``csrc/probe_adaptive.cu`` makes hard: its stash
prefilter (full, empty, several staging passes, entries that share a key's
fingerprint or its 16-bit fold but not its buckets, a dense map at fp_bits
8), selector words read only for rows that match a family fingerprint
(slots holding fam[j] under a selector other than j, adapted rows), bucket
sizes 1, 2 and 8, n_buckets below the buffer, and key counts from 1 to
past 2^20.  ``tests/test_torch_cuda.py`` holds the
kernel against the plain version on the same cases on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.probe import probe_adaptive as ref_probe_adaptive
from repro_torch.kernels import cuda
from repro_torch.kernels.probe import probe_adaptive
from repro_torch.kernels.staging_cases import (PROBE_ADAPTIVE_CASES,
                                               probe_adaptive_inputs)

from torch_port_util import split, t32

pytestmark = pytest.mark.tier1


def _both(c, stash, keys, *, block, **ref_kw):
    hi, lo = split(keys)
    kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"], block=block)
    got = probe_adaptive(t32(c["table"]), t32(c["sels"]), t32(hi), t32(lo),
                         stash=None if stash is None else t32(stash), **kw)
    want = np.asarray(ref_probe_adaptive(
        jnp.asarray(c["table"]), jnp.asarray(c["sels"]), jnp.asarray(hi),
        jnp.asarray(lo), stash=None if stash is None else jnp.asarray(stash),
        **kw, **ref_kw))
    assert got.shape == (keys.size,) and got.dtype == torch.bool
    return got.numpy(), want


@pytest.mark.parametrize("with_stash", [False, True])
@pytest.mark.parametrize("label", PROBE_ADAPTIVE_CASES)
def test_probe_adaptive_cases_match_reference(label, with_stash):
    c = probe_adaptive_inputs(label)
    got, want = _both(c, c["stash"] if with_stash else None, c["keys"],
                      block=c["block"], emulate=True)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size or want.size == 1


def test_probe_adaptive_stash_answers_keys_the_buckets_miss():
    """On the full stash, some keys are answered by the stash alone (the
    prefilter's walk must find them), and a stash entry with a key's
    fingerprint in another bucket answers nothing."""
    c = probe_adaptive_inputs("stash-128-full")
    without, _ = _both(c, None, c["keys"], block=c["block"], emulate=True)
    with_stash, _ = _both(c, c["stash"], c["keys"], block=c["block"],
                          emulate=True)
    assert (with_stash & ~without).sum() > 0
    c = probe_adaptive_inputs("same-fp-other-bucket")
    without, _ = _both(c, None, c["keys"], block=c["block"], emulate=True)
    with_stash, _ = _both(c, c["stash"], c["keys"], block=c["block"],
                          emulate=True)
    assert (with_stash & ~without).sum() < (c["stash"][0] != 0).sum() // 4


def test_probe_adaptive_wrong_selector_case_matches_interpreter():
    """The wrong-selector case's first 256 keys: the port against the
    Pallas interpreter itself."""
    c = probe_adaptive_inputs("wrong-selector")
    got, want = _both(c, c["stash"], c["keys"][:256], block=128,
                      interpret=True)
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_take_the_plain_version():
    c = probe_adaptive_inputs("n-1000")
    hi, lo = split(c["keys"])
    cuda.reset_counts()
    probe_adaptive(t32(c["table"]), t32(c["sels"]), t32(hi), t32(lo),
                   fp_bits=16, n_buckets=c["n_buckets"], block=c["block"],
                   stash=t32(c["stash"]))
    assert cuda.PLAIN_CALLS["probe_adaptive"] == 1
    assert sum(cuda.LAUNCHES.values()) == 0
