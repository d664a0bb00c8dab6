"""The adaptive slice end to end on the CPU: ``FilterOps``'s adaptive
methods, ``AdaptiveFilter`` and ``AdaptiveMembership`` against the
reference on seeded streams (all four planes, stash, count, answers,
adapted / promoted / deferred counts after every operation), the
admission controller copy, the reference's kick-storm behaviour (its
strict xfail mirrored), and the adaptive state's numpy round trip."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adaptive import (AdaptiveConfig as RefConfig,
                            AdaptiveMembership as RefMembership,
                            ReputationConfig as RefRepConfig)
from repro.adaptive.state import make_adaptive_state as ref_make_state
from repro.core.filter_ops import FilterOps as RefOps
from repro.core.policy import EofPolicy as RefEof
from repro.kernels import ops as ref_kops
from repro.streaming.admission import (AdmissionConfig as RefAdmConfig,
                                       AdmissionController as RefController)
from repro_torch.adaptive import (AdaptiveConfig, AdaptiveMembership,
                                  ReputationConfig, ReputationManager,
                                  make_adaptive_state)
from repro_torch.convert import (adaptive_state_from_numpy,
                                 adaptive_state_to_numpy)
from repro_torch.core.filter_ops import FilterOps
from repro_torch.core.policy import EofPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.insert import insert_bulk_adaptive
from repro_torch.kernels.stash import make_stash
from repro_torch.streaming.admission import (AdmissionConfig,
                                             AdmissionController)

from torch_port_util import adaptive_planes, random_keys, split, t32, u32

pytestmark = pytest.mark.tier1

PLANES = ("table", "sels", "khi", "klo")


def _ref_state_np(state):
    return {**{k: np.asarray(getattr(state, k)) for k in PLANES},
            "count": int(state.count), "n_buckets": int(state.n_buckets)}


def _assert_same_filter(ref_m, port_m, where):
    want = _ref_state_np(ref_m.filt.state)
    got = adaptive_state_to_numpy(port_m.filt.state)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value,
                                      err_msg=f"{where}: {key}")
    np.testing.assert_array_equal(u32(port_m.filt.stash),
                                  np.asarray(ref_m.filt.stash),
                                  err_msg=f"{where}: stash")
    for name in ("reports", "adapted"):
        assert getattr(port_m.filt, name) == getattr(ref_m.filt, name), \
            (where, name)
    assert port_m.reputation.promoted == ref_m.reputation.promoted, where
    assert port_m.deferred_reports == ref_m.deferred_reports, where
    assert port_m.filt.fills() == ref_m.filt.fills(), where


def _stream(seed, n_buckets):
    """Four insert bursts to ~0.94 load (kicks of adapted slots, spills),
    lookups, report rounds over the benign hits and a replay of the first
    round (promotions), deletes (members, duplicates, absent keys), a
    re-insert burst and a last lookup.  Batches of one kind share a shape,
    so the reference compiles each op once."""
    rng = np.random.RandomState(seed)
    burst = n_buckets * 4 * 94 // 400
    members = random_keys(rng, 5 * burst)
    benign = random_keys(rng, 2000)
    probe = np.concatenate([members[: 4 * burst], benign])
    ops_ = [("insert", members[i * burst:(i + 1) * burst]) for i in range(4)]
    ops_ += [("lookup", probe), ("report", None), ("lookup", probe),
             ("report", None), ("replay", None), ("lookup", probe)]
    ops_.append(("delete", np.concatenate([members[:burst // 2],
                                           members[:burst // 4],
                                           benign[:burst // 4]])))
    ops_ += [("insert", members[4 * burst:]), ("lookup", probe)]
    return ops_, benign


def test_membership_stream_matches_reference():
    kw = dict(n_buckets=256, stash_slots=16, fp_bits=10)
    rep = dict(promote_after=2)
    ref_m = RefMembership(RefConfig(**kw), RefRepConfig(**rep))
    port_m = AdaptiveMembership(AdaptiveConfig(**kw, device="cpu"),
                                ReputationConfig(**rep))
    stream, benign = _stream(0, kw["n_buckets"])
    hits, reported = None, []
    for step, (op, keys) in enumerate(stream):
        if op == "report":
            keys = benign[hits[-benign.size:]]
            reported.append(keys)
        elif op == "replay":
            op, keys = "report", reported[0]
        a = np.asarray(getattr(ref_m, op)(keys))
        b = getattr(port_m, op)(keys)
        np.testing.assert_array_equal(b, a, err_msg=f"{step} {op}")
        _assert_same_filter(ref_m, port_m, f"after op {step} ({op})")
        if op == "lookup":
            hits = b
    assert port_m.filt.adapted > 0 and port_m.reputation.promoted > 0
    assert port_m.filt.state.sels.any()
    assert int((port_m.filt.stash[0] != 0).sum()) > 0


def test_membership_admission_defers_cold_reports():
    """While tripped, cold reports stay on the host in both packages;
    reputed keys still adapt.  Mirrors the reference's own test."""
    kw = dict(n_buckets=64, bucket_size=4, fp_bits=12)
    adm = dict(high_water=0.85, low_water=0.60)
    ref_m = RefMembership(RefConfig(**kw), RefRepConfig(promote_after=3),
                          RefAdmConfig(**adm))
    port_m = AdaptiveMembership(AdaptiveConfig(**kw, device="cpu"),
                                ReputationConfig(promote_after=3),
                                AdmissionConfig(**adm))
    rng = np.random.RandomState(0)
    members = random_keys(rng, 128)
    probes = np.setdiff1d(random_keys(rng, 4096), members)
    for m in (ref_m, port_m):
        assert np.asarray(m.insert(members)).all()
    fps = probes[port_m.lookup(probes)]
    np.testing.assert_array_equal(np.asarray(ref_m.lookup(probes)),
                                  port_m.lookup(probes))
    assert fps.size >= 2
    warm, cold = fps[:1], fps[1:]
    pinned = type("F", (), {"fills": lambda s: (1.0, 1.0)})()
    for m in (ref_m, port_m):
        m.report(warm)
        m.admission.filt = pinned
        assert not m.admission.peek()
        m.report(np.concatenate([warm, cold]))
        m.admission.filt = m.filt
    assert port_m.deferred_reports == ref_m.deferred_reports == cold.size
    assert not port_m.filt.lookup(warm).any()
    assert port_m.reputation.seen(cold).all()
    for m in (ref_m, port_m):
        assert m.admission.peek()
        m.report(cold)
    _assert_same_filter(ref_m, port_m, "after the deferred reports")
    assert not port_m.filt.lookup(cold).any()
    assert port_m.lookup(members).all()


def test_reputation_promotes_repeat_offenders():
    mgr = ReputationManager(ReputationConfig(promote_after=2,
                                             side_table_max=4))
    keys = np.arange(1, 7, dtype=np.uint64)
    assert not mgr.seen(keys).any()
    assert not mgr.observe(keys).any()
    promoted = mgr.observe(keys)
    assert promoted[:4].all() and not promoted[4:].any()
    np.testing.assert_array_equal(mgr.denied(keys),
                                  np.array([1, 1, 1, 1, 0, 0], dtype=bool))
    assert mgr.counts[int(keys[4])] == 2


@dataclasses.dataclass
class _Stub:
    fill: float = 0.0
    stash_fill: float = 0.0

    def fills(self):
        return self.fill, self.stash_fill


def test_admission_controller_matches_reference():
    cfg = dict(high_water=0.85, low_water=0.60)
    ref_c = RefController(_Stub(), RefAdmConfig(**cfg))
    port_c = AdmissionController(_Stub(), AdmissionConfig(**cfg))
    ref_p, port_p = RefEof(), EofPolicy()
    for fill, stash_fill in ((0.1, 0.0), (0.5, 0.9), (0.9, 0.9), (0.7, 0.6),
                             (0.2, 0.1), (0.95, 1.0), (0.0, 0.0)):
        for c in (ref_c, port_c):
            c.filt.fill, c.filt.stash_fill = fill, stash_fill
        assert port_c.admit() == ref_c.admit()
        ref_d = ref_c.observe_eof(ref_p, items=900, capacity=1000, ops=3)
        port_d = port_c.observe_eof(port_p, items=900, capacity=1000, ops=3)
        assert (port_d is None) == (ref_d is None)
        if port_d is not None:
            assert dataclasses.asdict(port_d) == dataclasses.asdict(ref_d)
    for c in (ref_c, port_c):
        c.freeze()
        assert not c.peek()
        c.thaw()
    assert (port_c.admitted, port_c.deferred, port_c.peak_signal) == (
        ref_c.admitted, ref_c.deferred, ref_c.peak_signal)


def test_filter_ops_adaptive_without_stash_and_copies():
    """The no-stash branches of the FilterOps adaptive methods, with valid
    masks, on copies (donate=False) against the reference."""
    rng = np.random.RandomState(4)
    nb, fp_bits = 128, 12
    ref_ops, port_ops = RefOps(fp_bits=fp_bits), FilterOps(fp_bits=fp_bits)
    ref_st = ref_make_state(nb, 4, 256)
    port_st = make_adaptive_state(nb, 4, 256, device="cpu")
    keys = random_keys(rng, 500)
    hi, lo = split(keys)
    valid = rng.rand(500) < 0.9
    ref_st, rok = ref_ops.insert_adaptive(ref_st, jnp.asarray(hi),
                                          jnp.asarray(lo),
                                          valid=jnp.asarray(valid))
    before = [p.clone() for p in port_st[:4]]
    port_st2, pok = port_ops.insert_adaptive(port_st, t32(hi), t32(lo),
                                             valid=torch.from_numpy(valid))
    assert all(torch.equal(a, b) for a, b in zip(before, port_st[:4]))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))
    probes = np.concatenate([keys, random_keys(rng, 500)])
    p_hi, p_lo = split(probes)
    hits = port_ops.lookup_adaptive(port_st2, t32(p_hi), t32(p_lo)).numpy()
    np.testing.assert_array_equal(hits, np.asarray(ref_ops.lookup_adaptive(
        ref_st, jnp.asarray(p_hi), jnp.asarray(p_lo))))
    fp_keys = probes[500:][hits[500:]]
    f_hi, f_lo = split(fp_keys)
    ref_st, ra, rr = ref_ops.report_false_positive(ref_st, jnp.asarray(f_hi),
                                                   jnp.asarray(f_lo))
    port_st2, pa, pr = port_ops.report_false_positive(port_st2, t32(f_hi),
                                                      t32(f_lo))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rr))
    d_hi, d_lo = split(keys[:300])
    ref_st, rd = ref_ops.delete_adaptive(ref_st, jnp.asarray(d_hi),
                                         jnp.asarray(d_lo),
                                         valid=jnp.asarray(valid[:300]))
    port_st2, pd = port_ops.delete_adaptive(
        port_st2, t32(d_hi), t32(d_lo), valid=torch.from_numpy(valid[:300]))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    want = _ref_state_np(ref_st)
    got = adaptive_state_to_numpy(port_st2)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert pa.any() and got["sels"].any()


# ------------------------------------------------ kick-storm behaviour --
#
# The reference's tests/test_adaptive.py builds an adapted filter, drives
# it to ~0.9 load with a deep eviction budget, and documents (strict
# xfail) that kicks write selector 0, so some repaired false positives
# come back.  The port reproduces the same bits, so the same holds here.

FP_BITS = 12


def _lookup(planes, stash, hi, lo, nb):
    return ops.adaptive_lookup(planes[0], planes[1], hi, lo, fp_bits=FP_BITS,
                               n_buckets=nb, stash=stash).numpy()


def _adapted_state_with_repairs(rng, nb):
    keys = random_keys(rng, 128)
    hi, lo = (t32(x) for x in split(keys))
    planes = [torch.zeros((nb, 4), dtype=torch.int32),
              torch.zeros((nb, 1), dtype=torch.int32),
              torch.zeros((nb, 4), dtype=torch.int32),
              torch.zeros((nb, 4), dtype=torch.int32)]
    stash = make_stash(64, device="cpu")
    ok = insert_bulk_adaptive(*planes, hi, lo, fp_bits=FP_BITS, n_buckets=nb,
                              evict_rounds=8, stash=stash, block=64)[-1]
    assert ok.all()
    probes = np.setdiff1d(random_keys(rng, 4096), keys)
    phi, plo = (t32(x) for x in split(probes))
    hits = torch.from_numpy(_lookup(planes, stash, phi, plo, nb))
    _t, _s, adapted, _r = ops.adaptive_report(
        *planes, phi[hits], plo[hits], fp_bits=FP_BITS, n_buckets=nb,
        donate=True)
    assert adapted.any()
    rhi, rlo = phi[hits][adapted], plo[hits][adapted]
    assert not _lookup(planes, stash, rhi, rlo, nb).any()
    return planes, stash, (hi, lo), (rhi, rlo)


def _kick_storm(planes, stash, rng, nb, n_extra):
    ehi, elo = (t32(x) for x in split(random_keys(rng, n_extra)))
    ok = insert_bulk_adaptive(*planes, ehi, elo, fp_bits=FP_BITS,
                              n_buckets=nb, evict_rounds=32, stash=stash,
                              block=128)[-1]
    assert int(ok.sum()) > n_extra // 2
    return (ehi, elo), ok


def test_kick_storm_over_adapted_state_zero_false_negatives(rng):
    nb = 64
    planes, stash, (hi, lo), _ = _adapted_state_with_repairs(rng, nb)
    (ehi, elo), ok = _kick_storm(planes, stash, rng, nb, 104)
    mem = _lookup(planes, stash, torch.cat([hi, ehi[ok]]),
                  torch.cat([lo, elo[ok]]), nb)
    assert mem.all(), "kick storm produced a false negative"
    assert (planes[0] != 0).sum() / (nb * 4) >= 0.85


@pytest.mark.xfail(
    strict=True,
    reason="reproduces the reference: kicks write the victim with selector "
           "0 (movement loses a slot's adaptation), so storms resurrect "
           "some repaired false positives until they are re-reported")
def test_kick_storm_keeps_repaired_fps_suppressed(rng):
    nb = 64
    planes, stash, _, (rhi, rlo) = _adapted_state_with_repairs(rng, nb)
    _kick_storm(planes, stash, rng, nb, 104)
    assert not _lookup(planes, stash, rhi, rlo, nb).any(), \
        "a repaired FP re-appeared after the storm"


# ------------------------------------------------------------- convert --


def test_adaptive_state_round_trip_and_hand_over():
    """numpy planes in and out unchanged; a port filter continued from the
    reference's state equals the reference continued on the same keys."""
    rng = np.random.RandomState(6)
    table, sels, khi, klo, _members = adaptive_planes(rng, 200, 256, 0.7,
                                                      fp_bits=12)
    count = int((table != 0).sum())
    state = adaptive_state_from_numpy(table, sels, khi, klo, count, 200,
                                      device="cpu")
    back = adaptive_state_to_numpy(state)
    for key, value in zip(PLANES, (table, sels, khi, klo)):
        np.testing.assert_array_equal(back[key], value)
        assert back[key].dtype == np.uint32
    assert (back["count"], back["n_buckets"]) == (count, 200)
    with pytest.raises(ValueError):
        adaptive_state_from_numpy(table, sels[:10], khi, klo, count, 200,
                                  device="cpu")
    # hand-over: both continue with the same insert batch
    keys = random_keys(rng, 384)
    hi, lo = split(keys)
    ref_state = ref_make_state(200, 4, 256)._replace(
        table=jnp.asarray(table), sels=jnp.asarray(sels),
        khi=jnp.asarray(khi), klo=jnp.asarray(klo),
        count=jnp.asarray(count, jnp.int32))
    ref_state, r_stash, rok = RefOps(fp_bits=12).insert_adaptive(
        ref_state, jnp.asarray(hi), jnp.asarray(lo),
        stash=ref_kops.make_stash(16))
    state, p_stash, pok = FilterOps(fp_bits=12).insert_adaptive(
        state, t32(hi), t32(lo), stash=make_stash(16, device="cpu"))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))
    np.testing.assert_array_equal(u32(p_stash), np.asarray(r_stash))
    got, want = adaptive_state_to_numpy(state), _ref_state_np(ref_state)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
