"""The sharded filter's routed lookups and writes (``core/distributed.py``)
against the reference's on ``filter_mesh(2)`` and ``filter_mesh(4)``, bit
for bit: tables, stashes, hits, ok, deferred and overflow, for both routes,
both port backends (``"cuda"`` against ``"pallas"``, ``"torch"`` against
``"jnp"``), a capacity that defers, a stash-less state and an active count
below the buffer.  The reference runs in a subprocess per shard count
(as many CPU devices); the port on the CPU in process.  Also the
single-lane stream of ``tests/test_distributed_write.py`` against
per-shard ``PyStashFilter`` oracles, the control-plane shims, and the
false-positive cost of pair routing."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import hashing as jhash
from repro.streaming.oracle import PyStashFilter
from repro_torch.convert import (sharded_state_from_numpy,
                                 sharded_state_to_numpy)
from repro_torch.core import distributed as dist
from repro_torch.core import hashing
from repro_torch.distributed.elastic import filter_mesh
from repro_torch.distributed.sharding import shard_filter_state

from torch_port_util import (REF_JIT_LOOKUP, random_keys, reference_run,
                             split, t32, u32)

pytestmark = pytest.mark.tier1

# label -> (shards, n_buckets, buffer, stash slots, capacity factor)
CONFIGS = {"2-shards": (2, 256, 256, 16, 1.0),
           "4-shards": (4, 256, 256, 16, 1.0),
           "2-shards-roomy": (2, 256, 256, 16, 2.0),
           "4-shards-tight": (4, 256, 256, 16, 0.5),
           "2-shards-no-stash": (2, 256, 256, 0, 1.0),
           "4-shards-active-below-buffer": (4, 200, 256, 16, 1.0)}
BACKENDS = {"cuda": "pallas", "torch": "jnp"}
ROUTES = ("key", "pair")
N_KEYS = 1800

SCRIPT = REF_JIT_LOOKUP + """
import json
from repro.core import distributed as dist
from repro.distributed.elastic import filter_mesh
configs = json.loads(str(IN["configs"]))
hi, lo = jnp.asarray(IN["hi"]), jnp.asarray(IN["lo"])
for label, (S, nb, buf, slots, cf) in configs.items():
    mesh = filter_mesh(S)
    for backend in ("pallas", "jnp"):
        for route in ("key", "pair"):
            tag = f"{label}/{backend}/{route}"
            st = dist.make_sharded_state(S, nb, 4, stash_slots=slots,
                                         buffer_buckets=buf)
            kw = dict(fp_bits=16, backend=backend, route=route,
                      capacity_factor=cf)
            st, ok, dfr, ov = dist.distributed_insert(
                mesh, "data", st, hi, lo, max_disp=8, evict_rounds=8, **kw)
            put(tag + "/insert", st, ok=ok, deferred=dfr, overflow=ov)
            h, lov = lookup(mesh, st, hi, lo, **kw)
            OUT[tag + "/hits"], OUT[tag + "/lookup_overflow"] = h, lov
            acked = np.asarray(ok)
            dh, dl = hi[acked][:800], lo[acked][:800]
            dh, dl = dh[: dh.shape[0] // S * S], dl[: dl.shape[0] // S * S]
            st, dok, ddf, dov = dist.distributed_delete(
                mesh, "data", st, dh, dl, **kw)
            put(tag + "/delete", st, ok=dok, deferred=ddf, overflow=dov)
"""


@pytest.fixture(scope="module")
def ref():
    """The reference's outputs, one subprocess per shard count (~20 s
    each), run when a test first needs them."""
    runs = {}

    def get(shards):
        if shards not in runs:
            hi, lo = split(random_keys(np.random.RandomState(3), N_KEYS))
            configs = {k: v for k, v in CONFIGS.items() if v[0] == shards}
            runs[shards] = reference_run(SCRIPT, devices=shards, inputs=dict(
                hi=hi, lo=lo, configs=np.array(json.dumps(configs))))
        return runs[shards]
    return get


def _assert_step(ref, tag, state, **arrays):
    np.testing.assert_array_equal(ref[tag + "/tables"], u32(state.tables),
                                  err_msg=tag)
    if state.stashes is None:
        assert tag + "/stashes" not in ref
    else:
        np.testing.assert_array_equal(ref[tag + "/stashes"],
                                      u32(state.stashes), err_msg=tag)
    for key, got in arrays.items():
        np.testing.assert_array_equal(ref[f"{tag}/{key}"], got.numpy(),
                                      err_msg=f"{tag} {key}")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("label", list(CONFIGS))
def test_routed_ops_match_reference(ref, label, backend, route):
    S, nb, buf, slots, cf = CONFIGS[label]
    ref = ref(S)
    tag = f"{label}/{BACKENDS[backend]}/{route}"
    hi, lo = split(random_keys(np.random.RandomState(3), N_KEYS))
    mesh = filter_mesh(S, device="cpu")
    kw = dict(fp_bits=16, backend=backend, route=route, capacity_factor=cf)
    st = dist.make_sharded_state(S, nb, 4, stash_slots=slots,
                                 buffer_buckets=buf, device="cpu")
    st, ok, dfr, ov = dist.distributed_insert(mesh, "data", st, t32(hi),
                                              t32(lo), max_disp=8,
                                              evict_rounds=8, **kw)
    _assert_step(ref, tag + "/insert", st, ok=ok, deferred=dfr, overflow=ov)
    if cf < 1.5:
        assert dfr.any(), "the capacity must defer some lanes"
    assert not (ok & dfr).any()
    hits, lov = dist.distributed_lookup(mesh, "data", st, t32(hi), t32(lo),
                                        **kw)
    np.testing.assert_array_equal(ref[tag + "/hits"], hits.numpy())
    np.testing.assert_array_equal(ref[tag + "/lookup_overflow"], lov.numpy())
    assert hits[ok].all(), "an acknowledged key must be found"
    acked = ok.numpy()
    dh, dl = hi[acked][:800], lo[acked][:800]
    n = dh.size // S * S
    st, dok, ddf, dov = dist.distributed_delete(mesh, "data", st,
                                                t32(dh[:n]), t32(dl[:n]),
                                                **kw)
    _assert_step(ref, tag + "/delete", st, ok=dok, deferred=ddf,
                 overflow=dov)


def test_writes_leave_the_input_state_unless_donated():
    mesh = filter_mesh(2, device="cpu")
    st = dist.make_sharded_state(2, 64, 4, stash_slots=8, device="cpu")
    hi, lo = split(random_keys(np.random.RandomState(1), 200))
    new, ok, _d, _o = dist.distributed_insert(mesh, "data", st, t32(hi),
                                              t32(lo), fp_bits=16)
    assert not st.tables.any() and new.tables.any()
    donated, ok2, _d, _o = dist.distributed_insert(
        mesh, "data", st, t32(hi), t32(lo), fp_bits=16, donate=True)
    assert donated.tables is st.tables and torch.equal(st.tables, new.tables)
    assert torch.equal(ok, ok2)
    assert float(dist.sharded_occupancy(new)) == pytest.approx(
        int((new.tables != 0).sum() + (new.stashes[:, 0] != 0).sum())
        / new.tables.numel())


def test_state_on_another_device_is_refused():
    """A state whose tensors do not lie on the mesh's device never runs
    quietly on them."""
    mesh = dist.ShardMesh(2, "data", torch.device("cuda"))
    st = dist.make_sharded_state(2, 64, 4, device="cpu")
    hi = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="lie on"):
        dist.distributed_lookup(mesh, "data", st, hi, hi, fp_bits=16)
    with pytest.raises(ValueError, match="route"):
        dist.distributed_lookup(filter_mesh(2, device="cpu"), "data", st, hi,
                                hi, fp_bits=16, route="bucket")


def test_single_lane_stream_matches_stash_oracle():
    """One key per owner shard per step: every shard-local kernel call is a
    single lane, so routed insert and delete equal per-shard
    ``PyStashFilter`` oracles entry for entry (tables, stashes, acks),
    stash spills and stash deletes included (the stream of
    ``tests/test_distributed_write.py``)."""
    NB, BS, FP, ER, SS = 16, 4, 16, 8, 8
    mesh = filter_mesh(2, device="cpu")
    state = dist.make_sharded_state(2, NB, BS, stash_slots=SS, device="cpu")
    oracle = [PyStashFilter(n_buckets=NB, bucket_size=BS, fp_bits=FP,
                            evict_rounds=ER, stash_slots=SS)
              for _ in range(2)]
    rng = np.random.RandomState(7)
    raw = rng.randint(0, 2**63, size=4096, dtype=np.int64).astype(np.uint64)
    rhi, rlo = jhash.key_to_u32_pair_np(raw)
    owner = hashing.owner_shard_np(rhi, rlo, 2)
    by_owner = [raw[owner == s] for s in range(2)]
    pairs = [(int(by_owner[0][t]), int(by_owner[1][t])) for t in range(72)]
    acks = []
    for k0, k1 in pairs:
        hi, lo = split(np.array([k0, k1], dtype=np.uint64))
        state, ok, deferred, _ = dist.distributed_insert(
            mesh, "data", state, t32(hi), t32(lo), fp_bits=FP,
            backend="cuda", evict_rounds=ER)
        assert not deferred.any()
        want = [oracle[0].insert(k0), oracle[1].insert(k1)]
        assert ok.tolist() == want
        acks.append(want)
    for s in range(2):
        np.testing.assert_array_equal(u32(state.tables[s]), oracle[s].table)
        np.testing.assert_array_equal(u32(state.stashes[s]),
                                      oracle[s].stash_array())
    assert sum(o.spills for o in oracle) > 0, "the stream must spill"
    n_deletes = 0
    for t in range(0, 72, 2):
        if not all(acks[t]):
            continue
        k0, k1 = pairs[t]
        hi, lo = split(np.array([k0, k1], dtype=np.uint64))
        state, dok, _, _ = dist.distributed_delete(
            mesh, "data", state, t32(hi), t32(lo), fp_bits=FP,
            backend="cuda")
        assert dok.tolist() == [oracle[0].delete(k0), oracle[1].delete(k1)]
        n_deletes += 1
    assert n_deletes > 0
    for s in range(2):
        np.testing.assert_array_equal(u32(state.tables[s]), oracle[s].table)
        np.testing.assert_array_equal(u32(state.stashes[s]),
                                      oracle[s].stash_array())


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_replicated_lookup_and_host_shims_match_reference(backend):
    rng = np.random.RandomState(8)
    tables = np.zeros((3, 64, 4), np.uint32)
    keys = random_keys(rng, 500)
    hi, lo = split(keys)
    fp = jhash.fingerprint_np(hi, lo, 16)
    i1 = jhash.index_hash_np(hi, lo, 48)
    for k in range(0, 300):     # residents of shard k % 3, home buckets
        row = tables[k % 3, i1[k]]
        free = np.nonzero(row == 0)[0]
        if free.size:
            row[free[0]] = fp[k]
    ref_b = BACKENDS[backend]
    want = jdist.replicated_lookup(jnp.asarray(tables), jnp.asarray(hi),
                                   jnp.asarray(lo), fp_bits=16,
                                   backend=ref_b)
    got = dist.replicated_lookup(t32(tables), t32(hi), t32(lo), fp_bits=16,
                                 backend=backend)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    ref_st = jdist.ShardedFilterState(jnp.asarray(tables), n_buckets=48)
    port_st = sharded_state_from_numpy(tables, None, 48, device="cpu")
    r2, rok = jdist.local_shard_delete_host(ref_st, 1, jnp.asarray(hi),
                                            jnp.asarray(lo), fp_bits=16,
                                            backend=ref_b)
    p2, pok = dist.local_shard_delete_host(port_st, 1, t32(hi), t32(lo),
                                           fp_bits=16, backend=backend)
    np.testing.assert_array_equal(np.asarray(rok), pok.numpy())
    np.testing.assert_array_equal(np.asarray(r2.tables), u32(p2.tables))
    assert pok.any() and torch.equal(port_st.tables, t32(tables))
    swap = np.full((64, 4), 7, np.uint32)
    r3 = jdist.local_shard_insert_host(r2, 2, jnp.asarray(swap))
    p3 = dist.local_shard_insert_host(p2, 2, t32(swap))
    np.testing.assert_array_equal(np.asarray(r3.tables), u32(p3.tables))
    back = sharded_state_to_numpy(p3)
    assert back["n_buckets"] == 48 and back["stashes"] is None
    np.testing.assert_array_equal(back["tables"], np.asarray(r3.tables))


def test_shard_filter_state_moves_sharded_fields():
    mesh = filter_mesh(2, device="cpu")
    st = dist.make_sharded_state(2, 32, 4, stash_slots=4, device="cpu")
    placed = shard_filter_state(mesh, "data", st)
    assert isinstance(placed, dist.ShardedFilterState)
    assert placed.n_buckets == 32 and placed.tables.device.type == "cpu"
    assert mesh.shape == {"data": 2}


def test_pair_routing_spends_fingerprint_bits():
    """Routing by pair owner costs log2(shards) bits of fingerprint
    entropy: a bucket of shard s only holds fingerprints whose pair owner
    is s, and the absent keys routed to s carry such fingerprints too, so
    at one per-shard load the false-positive rate is about the shard count
    times key routing's (which matches the theoretical rate).  Seeded, 2^21
    absent keys."""
    rng = np.random.RandomState(1)
    hi, lo = split(random_keys(rng, 24576))
    ah, al = split(random_keys(rng, 1 << 21))
    theory = 8 * 0.75 / 2**16          # 2b * load / 2^f at load 0.75
    rates = {}
    for route in ("key", "pair"):
        mesh = filter_mesh(2, device="cpu")
        st = dist.make_sharded_state(2, 1 << 12, 4, device="cpu")
        kw = dict(fp_bits=16, route=route, capacity_factor=4.0)
        st, ok, _, _ = dist.distributed_insert(mesh, "data", st, t32(hi),
                                               t32(lo), **kw)
        assert ok.all()
        hits, _ = dist.distributed_lookup(mesh, "data", st, t32(ah),
                                          t32(al), **kw)
        rates[route] = float(hits.float().mean()) / theory
    assert 0.8 < rates["key"] < 1.2, rates
    assert 1.6 < rates["pair"] < 2.4, rates
