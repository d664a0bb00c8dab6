"""The port's CUDA kernels against their plain versions, and the OCF and
the adaptive filter on the card against the same on the CPU.  Needs a GPU (marker ``cuda``); on a
machine without one every test here skips.  ``chip_smoke.py`` runs the
same checks at full size."""
import numpy as np
import pytest
import torch

from repro_torch.adaptive import AdaptiveConfig, AdaptiveMembership
from repro_torch.convert import adaptive_state_to_numpy
from repro_torch.core.ocf import OCF, OcfConfig
from repro_torch.kernels import cuda
from repro_torch.kernels.delete import (delete_bulk, delete_bulk_adaptive,
                                        delete_bulk_adaptive_plain,
                                        delete_bulk_plain)
from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                             fingerprint_hash_family,
                                             fingerprint_hash_family_plain,
                                             fingerprint_hash_plain)
from repro_torch.kernels.insert import (insert_bulk, insert_bulk_adaptive,
                                        insert_bulk_adaptive_plain,
                                        insert_bulk_plain)
from repro_torch.kernels.probe import (probe, probe_adaptive,
                                       probe_adaptive_plain, probe_plain)

from torch_port_util import (adaptive_planes, ocf_stream, port_snapshot,
                             assert_same_state, random_keys, split, t32)

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("block,rounds,slots", [(128, 32, 0), (128, 4, 16),
                                                (2048, 8, 0), (256, 0, 32)])
def test_kernels_match_plain(dev, block, rounds, slots):
    rng = np.random.RandomState(block + rounds)
    keys = random_keys(rng, 4096)
    hi, lo = (t32(x).to(dev) for x in split(keys))
    valid = torch.from_numpy(rng.rand(4096) < 0.95).to(dev)
    nb = 1000
    for a, b in zip(fingerprint_hash(hi, lo, fp_bits=16, n_buckets=nb),
                    fingerprint_hash_plain(hi, lo, fp_bits=16, n_buckets=nb)):
        assert torch.equal(a, b)
    tk = torch.zeros((1024, 4), dtype=torch.int32, device=dev)
    tp = tk.clone()
    sk = (torch.zeros((2, slots), dtype=torch.int32, device=dev)
          if slots else None)
    sp = None if sk is None else sk.clone()
    ok_k = insert_bulk(tk, hi, lo, fp_bits=16, n_buckets=nb, valid=valid,
                       evict_rounds=rounds, stash=sk, block=block)[-1]
    ok_p = insert_bulk_plain(tp, hi, lo, valid, fp_bits=16, n_buckets=nb,
                             evict_rounds=rounds, stash=sp, block=block)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp) and torch.equal(ok_k, ok_p)
    if slots:
        assert torch.equal(sk, sp)
    assert torch.equal(probe(tk, hi, lo, fp_bits=16, n_buckets=nb, stash=sk),
                       probe_plain(tp, hi, lo, fp_bits=16, n_buckets=nb,
                                   stash=sp))
    _t, d_k = delete_bulk(tk, hi, lo, fp_bits=16, n_buckets=nb, valid=valid,
                          block=block)
    d_p = delete_bulk_plain(tp, hi, lo, valid, fp_bits=16, n_buckets=nb,
                            block=block)
    assert torch.equal(tk, tp) and torch.equal(d_k, d_p)


def test_ocf_on_card_matches_cpu(dev):
    kw = dict(capacity=4096, mode="EOF", stash_slots=64, evict_rounds=16)
    on_card, on_cpu = (OCF(OcfConfig(device=d, **kw)) for d in ("cuda", "cpu"))
    cuda.reset_counts()
    for step, (op, keys) in enumerate(ocf_stream(seed=0, n_keys=24_000)):
        a = np.asarray(getattr(on_card, op)(keys))
        b = np.asarray(getattr(on_cpu, op)(keys))
        np.testing.assert_array_equal(a, b)
        assert_same_state(port_snapshot(on_cpu), port_snapshot(on_card),
                          f"op {step}")
    assert all(cuda.LAUNCHES[k] > 0 for k in ("fingerprint_hash", "probe",
                                              "insert_bulk", "delete_bulk"))


@pytest.mark.parametrize("block,rounds,slots", [(128, 32, 0), (128, 8, 16),
                                                (256, 0, 16)])
def test_adaptive_kernels_match_plain(dev, block, rounds, slots):
    rng = np.random.RandomState(block + rounds + slots)
    nb, fp_bits = 1000, 12
    *planes, members = adaptive_planes(rng, nb, 1024, 0.6, fp_bits=fp_bits)
    keys = random_keys(rng, 2048)
    hi, lo = (t32(x).to(dev) for x in split(keys))
    valid = torch.from_numpy(rng.rand(2048) < 0.95).to(dev)
    fam_k = fingerprint_hash_family(hi, lo, fp_bits=fp_bits, n_buckets=nb)
    fam_p = fingerprint_hash_family_plain(hi, lo, fp_bits=fp_bits,
                                          n_buckets=nb)
    for a, b in zip((*fam_k[0], *fam_k[1:]), (*fam_p[0], *fam_p[1:])):
        assert torch.equal(a, b)
    pk = [t32(p).to(dev) for p in planes]
    pp = [p.clone() for p in pk]
    sk = (torch.zeros((2, slots), dtype=torch.int32, device=dev)
          if slots else None)
    sp = None if sk is None else sk.clone()
    ok_k = insert_bulk_adaptive(*pk, hi, lo, fp_bits=fp_bits, n_buckets=nb,
                                valid=valid, evict_rounds=rounds, stash=sk,
                                block=block)[-1]
    ok_p = insert_bulk_adaptive_plain(*pp, hi, lo, valid, fp_bits=fp_bits,
                                      n_buckets=nb, evict_rounds=rounds,
                                      stash=sp, block=block)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(pk, pp))
    assert torch.equal(ok_k, ok_p) and not ok_k[valid].all()
    if slots:
        assert torch.equal(sk, sp)
    assert torch.equal(
        probe_adaptive(pk[0], pk[1], hi, lo, fp_bits=fp_bits, n_buckets=nb,
                       stash=sk),
        probe_adaptive_plain(pp[0], pp[1], hi, lo, fp_bits=fp_bits,
                             n_buckets=nb, stash=sp))
    d_k = delete_bulk_adaptive(*pk, hi, lo, fp_bits=fp_bits, n_buckets=nb,
                               valid=valid, block=block)[-1]
    d_p = delete_bulk_adaptive_plain(*pp, hi, lo, valid, fp_bits=fp_bits,
                                     n_buckets=nb, block=block)
    assert all(torch.equal(a, b) for a, b in zip(pk, pp))
    assert torch.equal(d_k, d_p)


def test_adaptive_membership_on_card_matches_cpu(dev):
    kw = dict(n_buckets=1024, stash_slots=32, fp_bits=10)
    on_card, on_cpu = (AdaptiveMembership(AdaptiveConfig(device=d, **kw))
                       for d in ("cuda", "cpu"))
    rng = np.random.RandomState(1)
    members, benign = random_keys(rng, 3800), random_keys(rng, 20_000)
    cuda.reset_counts()
    for step in range(6):
        if step < 4:
            op, keys = "insert", members[step * 950:(step + 1) * 950]
        elif step == 4:
            op, keys = "report", benign[on_cpu.lookup(benign)]
        else:
            op, keys = "delete", members[:1000]
        a, b = (getattr(m, op)(keys) for m in (on_card, on_cpu))
        np.testing.assert_array_equal(a, b)
        want = adaptive_state_to_numpy(on_cpu.filt.state)
        for key, value in adaptive_state_to_numpy(on_card.filt.state).items():
            np.testing.assert_array_equal(value, want[key], err_msg=key)
        assert torch.equal(on_card.filt.stash.cpu(), on_cpu.filt.stash)
    for name in ("fingerprint_hash_family", "insert_bulk_adaptive",
                 "delete_bulk_adaptive"):
        assert cuda.LAUNCHES[name] > 0
