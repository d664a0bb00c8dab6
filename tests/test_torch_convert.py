"""repro_torch.convert: carrying filter state across from the reference,
and continuing a stream from a reference state mid-way."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.ocf import OCF as RefOCF
from repro.core.ocf import OcfConfig as RefConfig
from repro_torch.convert import (ocf_from_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core.ocf import OcfConfig

from torch_port_util import ocf_stream, run_ocf_parity

pytestmark = pytest.mark.tier1


def test_round_trip():
    rng = np.random.RandomState(0)
    table = rng.randint(0, 2 ** 32, size=(256, 4), dtype=np.uint64
                        ).astype(np.uint32)
    stash = rng.randint(0, 2 ** 32, size=(2, 16), dtype=np.uint64
                        ).astype(np.uint32)
    state, st = state_from_numpy(table, 123, 200, stash, device="cpu")
    assert state.table.dtype == st.dtype == torch.int32
    assert state.n_buckets == 200 and int(state.count) == 123
    back = state_to_numpy(state, st)
    np.testing.assert_array_equal(back["table"], table)
    np.testing.assert_array_equal(back["stash"], stash)
    assert back["count"] == 123 and back["n_buckets"] == 200
    assert back["table"].dtype == np.uint32
    none_state, none_stash = state_from_numpy(table, 0, 256, device="cpu")
    assert none_stash is None
    assert state_to_numpy(none_state)["stash"] is None


@pytest.mark.parametrize("mode,stash_slots", [("EOF", 64), ("PRE", 0)])
def test_continue_from_reference_mid_stream(mode, stash_slots):
    kw = dict(capacity=4096, mode=mode, stash_slots=stash_slots,
              evict_rounds=16)
    ref = RefOCF(RefConfig(backend="pallas", **kw))
    ops = ocf_stream(seed=2, n_keys=24_000)
    half = len(ops) // 2
    for op, keys in ops[:half]:
        getattr(ref, op)(keys)
    port = ocf_from_numpy(
        OcfConfig(device="cpu", **kw), table=np.asarray(ref.state.table),
        count=int(ref.state.count), n_buckets=int(ref.state.n_buckets),
        stash=None if ref.stash is None else np.asarray(ref.stash),
        keys=ref.keystore.materialize(),
        policy=dataclasses.asdict(ref.policy),
        stats=dataclasses.asdict(ref.stats),
        capacity_history=ref.capacity_history)
    assert dataclasses.asdict(port.policy) == dataclasses.asdict(ref.policy)
    run_ocf_parity(ref, port, ops[half:])


def test_ocf_from_numpy_checks():
    table = np.zeros((1024, 4), np.uint32)
    with pytest.raises(ValueError):
        ocf_from_numpy(OcfConfig(device="cpu", stash_slots=8), table=table,
                       count=0, n_buckets=1024, keys=np.zeros(0, np.uint64))
    with pytest.raises(ValueError):
        ocf_from_numpy(OcfConfig(device="cpu"), table=table, count=0,
                       n_buckets=1024, keys=np.zeros(0, np.uint64),
                       policy={"no_such_field": 1})
