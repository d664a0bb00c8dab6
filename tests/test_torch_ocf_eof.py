"""The slice as a whole, EOF mode: the port's OCF on the CPU against
the reference's OCF on its kernel backend (``backend="pallas"``, which
runs the kernels' XLA grid emulation off-TPU), on one seeded stream.
Tables, stash, n_buckets, count, capacity history, stats and every answer
must match after every operation."""
import numpy as np
import pytest

from repro.core.ocf import OCF as RefOCF
from repro.core.ocf import OcfConfig as RefConfig
from repro_torch.core.ocf import OCF, OcfConfig

from torch_port_util import ocf_stream, run_ocf_parity

pytestmark = pytest.mark.tier1

MODE = "EOF"


@pytest.mark.parametrize("stash_slots,evict_rounds", [(0, 16), (64, 16)])
def test_ocf_matches_reference(stash_slots, evict_rounds):
    kw = dict(capacity=4096, mode=MODE, stash_slots=stash_slots,
              evict_rounds=evict_rounds)
    ref = RefOCF(RefConfig(backend="pallas", **kw))
    port = OCF(OcfConfig(device="cpu", **kw))
    run_ocf_parity(ref, port, ocf_stream(seed=0))
    s = port.stats
    # the stream exercised what it is meant to
    assert s.grows >= 2 and s.shrinks >= 1 and s.failed_inserts > 0
    assert s.blind_deletes_blocked == 400
    assert (s.stash_spills > 0) == (stash_slots > 0)
    assert len(port) == ref.keystore.total


def test_ocf_default_budget_and_dedupe():
    kw = dict(capacity=4096, mode=MODE, dedupe_lookups=True)
    ref = RefOCF(RefConfig(backend="pallas", **kw))
    port = OCF(OcfConfig(device="cpu", **kw))
    ops = ocf_stream(seed=1, n_keys=24_000)
    ops.insert(3, ("lookup", np.concatenate([ops[0][1][:500]] * 3)))
    run_ocf_parity(ref, port, ops)
    assert port.stats.grows >= 2
