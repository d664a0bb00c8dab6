"""The port's CUDA kernels against their plain versions, and the OCF on
the card against the OCF on the CPU.  Needs a GPU (marker ``cuda``); on a
machine without one every test here skips.  ``chip_smoke.py`` runs the
same checks at full size."""
import numpy as np
import pytest
import torch

from repro_torch.core.ocf import OCF, OcfConfig
from repro_torch.kernels import cuda
from repro_torch.kernels.delete import delete_bulk, delete_bulk_plain
from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                             fingerprint_hash_plain)
from repro_torch.kernels.insert import insert_bulk, insert_bulk_plain
from repro_torch.kernels.probe import probe, probe_plain

from torch_port_util import (ocf_stream, port_snapshot, assert_same_state,
                             random_keys, split, t32)

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
    assert all(cuda.LAUNCHES[k] > 0 for k in cuda.KERNELS)
