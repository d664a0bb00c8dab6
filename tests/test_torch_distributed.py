"""The sharded filter's routed lookups and writes (``core/distributed.py``)
against the reference's on ``filter_mesh(2)`` and ``filter_mesh(4)``, bit
for bit: tables, stashes, hits, ok, deferred and overflow, for both routes,
both port backends (``"cuda"`` against ``"pallas"``, ``"torch"`` against
``"jnp"``), a capacity that defers, a stash-less state and an active count
below the buffer.  The reference runs in a subprocess per shard count
(as many CPU devices); the port on the CPU in process.  Also the
single-lane stream of ``tests/test_distributed_write.py`` against
per-shard ``PyStashFilter`` oracles, the control-plane shims, and the
false-positive cost of pair routing.  The port runs in both layouts, every
shard in one part and one part a shard, against the same reference
outputs; the mesh rules (too few devices, a shard on another device than
the mesh's, a missing card) are held here too."""
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

from torch_port_util import (LAYOUTS, REF_JIT_LOOKUP, layout_mesh,
                             random_keys, reference_run, sharded_u32, split,
                             t32, u32)

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
    tables, stashes = sharded_u32(state)
    np.testing.assert_array_equal(ref[tag + "/tables"], tables, err_msg=tag)
    if stashes is None:
        assert tag + "/stashes" not in ref
    else:
        np.testing.assert_array_equal(ref[tag + "/stashes"], stashes,
                                      err_msg=tag)
    for key, got in arrays.items():
        np.testing.assert_array_equal(ref[f"{tag}/{key}"], got.numpy(),
                                      err_msg=f"{tag} {key}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("label", list(CONFIGS))
def test_routed_ops_match_reference(ref, label, backend, route, layout):
    S, nb, buf, slots, cf = CONFIGS[label]
    ref = ref(S)
    tag = f"{label}/{BACKENDS[backend]}/{route}"
    hi, lo = split(random_keys(np.random.RandomState(3), N_KEYS))
    mesh = layout_mesh(S, layout)
    kw = dict(fp_bits=16, backend=backend, route=route, capacity_factor=cf)
    st = dist.make_sharded_state(S, nb, 4, stash_slots=slots,
                                 buffer_buckets=buf, mesh=mesh)
    assert len(st.table_parts) == (1 if layout == "one part" else S)
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
    assert not st.table_parts[0].any() and new.table_parts[0].any()
    donated, ok2, _d, _o = dist.distributed_insert(
        mesh, "data", st, t32(hi), t32(lo), fp_bits=16, donate=True)
    assert donated.table_parts[0] is st.table_parts[0]
    assert torch.equal(st.table_parts[0], new.table_parts[0])
    assert torch.equal(ok, ok2)
    tables, stashes = new.stacked()
    assert float(dist.sharded_occupancy(new)) == pytest.approx(
        int((tables != 0).sum() + (stashes[:, 0] != 0).sum())
        / tables.numel())


def test_state_on_another_device_is_refused():
    """A state whose tensors do not lie on the mesh's device never runs
    quietly on them."""
    mesh = dist.ShardMesh(2, "data", ((torch.device("cuda", 0), 2),))
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
        np.testing.assert_array_equal(u32(state.table(s)), oracle[s].table)
        np.testing.assert_array_equal(u32(state.stash(s)),
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
        np.testing.assert_array_equal(u32(state.table(s)), oracle[s].table)
        np.testing.assert_array_equal(u32(state.stash(s)),
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
    port_st = sharded_state_from_numpy(tables, None, 48,
                                       devices=("cpu",) * 3)
    got = dist.replicated_lookup(port_st.table_parts, t32(hi), t32(lo),
                                 fp_bits=16, backend=backend)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    ref_st = jdist.ShardedFilterState(jnp.asarray(tables), n_buckets=48)
    port_st = sharded_state_from_numpy(tables, None, 48, device="cpu")
    r2, rok = jdist.local_shard_delete_host(ref_st, 1, jnp.asarray(hi),
                                            jnp.asarray(lo), fp_bits=16,
                                            backend=ref_b)
    p2, pok = dist.local_shard_delete_host(port_st, 1, t32(hi), t32(lo),
                                           fp_bits=16, backend=backend)
    np.testing.assert_array_equal(np.asarray(rok), pok.numpy())
    np.testing.assert_array_equal(np.asarray(r2.tables), sharded_u32(p2)[0])
    assert pok.any() and torch.equal(port_st.stacked()[0], t32(tables))
    swap = np.full((64, 4), 7, np.uint32)
    r3 = jdist.local_shard_insert_host(r2, 2, jnp.asarray(swap))
    p3 = dist.local_shard_insert_host(p2, 2, t32(swap))
    np.testing.assert_array_equal(np.asarray(r3.tables), sharded_u32(p3)[0])
    back = sharded_state_to_numpy(p3)
    assert back["n_buckets"] == 48 and back["stashes"] is None
    np.testing.assert_array_equal(back["tables"], np.asarray(r3.tables))


def test_shard_filter_state_moves_sharded_fields():
    mesh = filter_mesh(2, device="cpu")
    st = dist.make_sharded_state(2, 32, 4, stash_slots=4, device="cpu")
    placed = shard_filter_state(mesh, "data", st)
    assert isinstance(placed, dist.ShardedFilterState)
    assert placed.n_buckets == 32
    assert placed.devices == (torch.device("cpu"),) * 2
    assert placed is st and mesh.shape == {"data": 2}
    # laid out again one part a shard, every shard's rows kept
    st.table_parts[0][1, 3, 2] = 5
    apart = shard_filter_state(layout_mesh(2, "a part a shard"), "data", st)
    assert apart.parts == ((torch.device("cpu"), 1),) * 2
    assert int(apart.table(1)[3, 2]) == 5 and apart.stash(1).shape == (2, 4)
    assert torch.equal(apart.stacked()[0], st.stacked()[0])


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


def test_mesh_with_too_few_devices_raises():
    with pytest.raises(RuntimeError, match="cannot host 4"):
        filter_mesh(4, devices=["cpu"] * 3)
    mesh = filter_mesh(2, devices=["cpu"] * 3)     # the first two
    assert mesh.parts == ((torch.device("cpu"), 1),) * 2
    with pytest.raises(ValueError, match="do not hold"):
        dist.ShardMesh(3, "data", ((torch.device("cpu"), 2),))


def test_shard_on_another_device_than_the_mesh_is_refused():
    """``_on_mesh`` compares each shard's device with the mesh's for it,
    and the parts: shard 1 on ``meta`` against a CPU mesh is refused, and
    so is one part where the mesh has one a shard."""
    mesh = layout_mesh(2, "a part a shard")
    good = dist.make_sharded_state(2, 64, 4, stash_slots=4, mesh=mesh)
    dist._on_mesh(mesh, good)
    bad = good._replace(table_parts=(good.table_parts[0],
                                     good.table_parts[1].to("meta")))
    hi = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shard 1 lie on meta"):
        dist.distributed_lookup(mesh, "data", bad, hi, hi, fp_bits=16)
    one = dist.make_sharded_state(2, 64, 4, stash_slots=4, device="cpu")
    with pytest.raises(ValueError, match="parts"):
        dist.distributed_insert(mesh, "data", one, hi, hi, fp_bits=16)


def test_card_mesh_never_resolves_to_the_cpu():
    """``filter_mesh(2, devices=["cuda:0", "cuda:1"])`` raises where the
    two cards are not there (no fallback to the CPU) and lies on them
    where they are."""
    if torch.cuda.device_count() >= 2:
        mesh = filter_mesh(2, devices=["cuda:0", "cuda:1"])
        assert [(d.type, d.index) for d in mesh.devices] == \
            [("cuda", 0), ("cuda", 1)]
        return
    with pytest.raises(RuntimeError, match="card|CUDA"):
        filter_mesh(2, devices=["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="card|CUDA"):
        dist.make_sharded_state(2, 64, devices=["cuda:0", "cuda:1"])


@pytest.mark.parametrize("route", ROUTES)
def test_uneven_parts_match_one_part(route):
    """Parts of 2, 1 and 1 shards give one part's tables, stashes and
    answers: the exchange keeps the mesh's shard order."""
    cpu = torch.device("cpu")
    meshes = {"one": filter_mesh(4, device="cpu"),
              "uneven": dist.ShardMesh(4, "data",
                                       ((cpu, 2), (cpu, 1), (cpu, 1)))}
    hi, lo = split(random_keys(np.random.RandomState(5), 2400))
    outs = {}
    for name, mesh in meshes.items():
        st = dist.make_sharded_state(4, 128, 4, stash_slots=8, mesh=mesh)
        kw = dict(fp_bits=16, route=route, capacity_factor=1.0)
        st, ok, dfr, ov = dist.distributed_insert(mesh, "data", st, t32(hi),
                                                  t32(lo), **kw)
        hits, lov = dist.distributed_lookup(mesh, "data", st, t32(hi),
                                            t32(lo), **kw)
        st, dok, _d, _o = dist.distributed_delete(
            mesh, "data", st, t32(hi[:800]), t32(lo[:800]), **kw)
        outs[name] = [*sharded_u32(st), ok, dfr, ov, hits, lov, dok]
    assert dfr.any() and ok.any()
    for a, b in zip(outs["one"], outs["uneven"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("cap", [1, 3])
def test_received_lanes_are_contiguous(cap):
    """Each shard's received lanes are a kernel's input, so they must be
    contiguous, also where the capacity is one slot (a resubmitted wave of
    a few keys over many shards): the card's wrappers refuse strided
    lanes, the CPU's plain versions would not notice."""
    recv = torch.arange(1 * 8 * 3 * cap, dtype=torch.int32).reshape(
        1, 8, 3, cap)
    for field in dist._fields(recv):
        assert field.shape == (1, 8 * cap) and field[0].is_contiguous()
    np.testing.assert_array_equal(dist._fields(recv)[1][0].numpy(),
                                  recv[0, :, 1].reshape(-1).numpy())
