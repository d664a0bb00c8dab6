"""The port's CUDA kernels against their plain versions, and the OCF,
the adaptive filter, the streaming generation ring and the LM forward on
the card against the same on the CPU.  Needs a GPU (marker ``cuda``); on a
machine without one every test here skips.  ``chip_smoke.py`` runs the
same checks at full size."""
import numpy as np
import pytest
import torch

from repro_torch.adaptive import AdaptiveConfig, AdaptiveMembership
from repro_torch.convert import adaptive_state_to_numpy, generational_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.adaptive.state import make_adaptive_state
from repro_torch.core.filter import make_state
from repro_torch.core.filter_ops import FilterOps
from repro_torch.core.ocf import OCF, OcfConfig
from repro_torch.kernels import cuda
from repro_torch.kernels.delete import (delete_bulk, delete_bulk_adaptive,
                                        delete_bulk_adaptive_plain,
                                        delete_bulk_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                             fingerprint_hash_family,
                                             fingerprint_hash_family_plain,
                                             fingerprint_hash_plain)
from repro_torch.kernels.insert import (insert_bulk, insert_bulk_adaptive,
                                        insert_bulk_adaptive_plain,
                                        insert_bulk_adaptive_tm,
                                        insert_bulk_plain, insert_bulk_tm)
from repro_torch.kernels.probe import (probe, probe_adaptive,
                                       probe_adaptive_plain,
                                       probe_adaptive_tm, probe_multi,
                                       probe_multi_plain, probe_plain,
                                       probe_tm)
from repro_torch.kernels.staging_cases import (PROBE_ADAPTIVE_CASES,
                                               PROBE_CASES,
                                               PROBE_MULTI_CASES,
                                               probe_adaptive_inputs,
                                               probe_inputs,
                                               probe_multi_inputs)
from repro_torch.kernels.stash import make_stash
from repro_torch.kernels.telemetry import (KICK_BINS, insert_plane,
                                           probe_depth_counts)
from repro_torch.models import Transformer
from repro_torch.obs import MetricsRegistry
from repro_torch.serving import FilterOpBatcher, engine
from repro_torch.streaming import GenerationalFilter, GenerationConfig

from torch_port_util import (ADAPTIVE_STAGING_CASES, STAGING_CASES,
                             adaptive_planes, adaptive_staging_inputs,
                             ocf_stream, port_snapshot, assert_same_state,
                             random_keys, row_rel_err, split, staging_inputs,
                             t32)

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (block, eviction rounds, stash slots) on an empty 1024 x 4 table.
LEGACY_KERNEL_CASES = {"block-128": (128, 32, 0),
                       "block-128-stash": (128, 4, 16),
                       "block-2048": (2048, 8, 0),
                       "insert-once-stash": (256, 0, 32)}


def _kernel_case(label):
    if label in STAGING_CASES:
        return staging_inputs(label)
    block, rounds, slots = LEGACY_KERNEL_CASES[label]
    rng = np.random.RandomState(block + rounds)
    keys = random_keys(rng, 4096)
    valid = rng.rand(4096) < 0.95
    return dict(table=np.zeros((1024, 4), np.uint32),
                stash=np.zeros((2, slots), np.uint32) if slots else None,
                keys=keys, valid=valid, delete=keys, delete_valid=valid,
                n_buckets=1000, block=block, rounds=rounds)


@pytest.mark.parametrize("label", [*LEGACY_KERNEL_CASES, *STAGING_CASES])
def test_kernels_match_plain(dev, label):
    """The four OCF kernels against their plain versions, bit for bit:
    tables, stashes, ok masks and answers.  STAGING_CASES stress the
    insert and delete kernels' staged rows (tiny shared tables, several
    windows, blocks 1024 and 8192, bucket sizes 2 and 8, a nearly full
    stash, keys deleted once more than resident)."""
    c = _kernel_case(label)
    nb, block, rounds = c["n_buckets"], c["block"], c["rounds"]
    hi, lo = (t32(x).to(dev) for x in split(c["keys"]))
    valid = torch.from_numpy(c["valid"]).to(dev)
    for a, b in zip(fingerprint_hash(hi, lo, fp_bits=16, n_buckets=nb),
                    fingerprint_hash_plain(hi, lo, fp_bits=16, n_buckets=nb)):
        assert torch.equal(a, b)
    tk = t32(c["table"]).to(dev)
    tp = tk.clone()
    sk = None if c["stash"] is None else t32(c["stash"]).to(dev)
    sp = None if sk is None else sk.clone()
    cuda.reset_counts()
    ok_k = insert_bulk(tk, hi, lo, fp_bits=16, n_buckets=nb, valid=valid,
                       evict_rounds=rounds, stash=sk, block=block)[-1]
    assert cuda.LAUNCHES["insert_bulk"] == 1
    ok_p = insert_bulk_plain(tp, hi, lo, valid, fp_bits=16, n_buckets=nb,
                             evict_rounds=rounds, stash=sp, block=block)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp) and torch.equal(ok_k, ok_p)
    if sk is not None:
        assert torch.equal(sk, sp)
    assert torch.equal(probe(tk, hi, lo, fp_bits=16, n_buckets=nb, stash=sk),
                       probe_plain(tp, hi, lo, fp_bits=16, n_buckets=nb,
                                   stash=sp))
    hi, lo = (t32(x).to(dev) for x in split(c["delete"]))
    valid = torch.from_numpy(c["delete_valid"]).to(dev)
    _t, d_k = delete_bulk(tk, hi, lo, fp_bits=16, n_buckets=nb, valid=valid,
                          block=block)
    d_p = delete_bulk_plain(tp, hi, lo, valid, fp_bits=16, n_buckets=nb,
                            block=block)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp) and torch.equal(d_k, d_p)
    assert cuda.LAUNCHES["delete_bulk"] == 1


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


# (block, eviction rounds, stash slots) on a 1000-bucket state at load 0.6.
LEGACY_ADAPTIVE_CASES = {"block-128": (128, 32, 0),
                         "block-128-stash": (128, 8, 16),
                         "block-256-once-stash": (256, 0, 16)}


def _adaptive_case(label):
    if label in ADAPTIVE_STAGING_CASES:
        return dict(adaptive_staging_inputs(label), fp_bits=16)
    block, rounds, slots = LEGACY_ADAPTIVE_CASES[label]
    rng = np.random.RandomState(block + rounds + slots)
    *planes, _members = adaptive_planes(rng, 1000, 1024, 0.6, fp_bits=12)
    keys = random_keys(rng, 2048)
    valid = rng.rand(2048) < 0.95
    return dict(planes=planes,
                stash=np.zeros((2, slots), np.uint32) if slots else None,
                keys=keys, valid=valid, delete=keys, delete_valid=valid,
                n_buckets=1000, block=block, rounds=rounds, fp_bits=12)


def _adaptive_kernels_vs_plain(dev, c, split_keys=cuda.SPLIT_KEYS):
    """Family hash, insert, probe and delete of case ``c``, kernel against
    plain version on copies of the same planes -> the insert's launch
    count."""
    nb, block, fp_bits = c["n_buckets"], c["block"], c["fp_bits"]
    hi, lo = (t32(x).to(dev) for x in split(c["keys"]))
    valid = torch.from_numpy(c["valid"]).to(dev)
    fam_k = fingerprint_hash_family(hi, lo, fp_bits=fp_bits, n_buckets=nb)
    fam_p = fingerprint_hash_family_plain(hi, lo, fp_bits=fp_bits,
                                          n_buckets=nb)
    for a, b in zip((*fam_k[0], *fam_k[1:]), (*fam_p[0], *fam_p[1:])):
        assert torch.equal(a, b)
    pk = [t32(p).to(dev) for p in c["planes"]]
    pp = [p.clone() for p in pk]
    sk = None if c["stash"] is None else t32(c["stash"]).to(dev)
    sp = None if sk is None else sk.clone()
    cuda.reset_counts()
    ok_k = insert_bulk_adaptive(*pk, hi, lo, fp_bits=fp_bits, n_buckets=nb,
                                valid=valid, evict_rounds=c["rounds"],
                                stash=sk, block=block,
                                split_keys=split_keys)[-1]
    launches = cuda.LAUNCHES["insert_bulk_adaptive"]
    ok_p = insert_bulk_adaptive_plain(*pp, hi, lo, valid, fp_bits=fp_bits,
                                      n_buckets=nb, evict_rounds=c["rounds"],
                                      stash=sp, block=block)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(pk, pp))
    assert torch.equal(ok_k, ok_p) and not ok_k[valid].all()
    if sk is not None:
        assert torch.equal(sk, sp)
    assert torch.equal(
        probe_adaptive(pk[0], pk[1], hi, lo, fp_bits=fp_bits, n_buckets=nb,
                       stash=sk),
        probe_adaptive_plain(pp[0], pp[1], hi, lo, fp_bits=fp_bits,
                             n_buckets=nb, stash=sp))
    hi, lo = (t32(x).to(dev) for x in split(c["delete"]))
    valid = torch.from_numpy(c["delete_valid"]).to(dev)
    d_k = delete_bulk_adaptive(*pk, hi, lo, fp_bits=fp_bits, n_buckets=nb,
                               valid=valid, block=block,
                               split_keys=split_keys)[-1]
    d_p = delete_bulk_adaptive_plain(*pp, hi, lo, valid, fp_bits=fp_bits,
                                     n_buckets=nb, block=block)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(pk, pp))
    assert torch.equal(d_k, d_p)
    return launches


@pytest.mark.parametrize("label", [*LEGACY_ADAPTIVE_CASES,
                                   *ADAPTIVE_STAGING_CASES])
def test_adaptive_kernels_match_plain(dev, label):
    """The adaptive kernels against their plain versions, bit for bit: the
    family hash's fingerprints and buckets, all four planes, the stash, the
    ok masks and the probe's answers.
    ADAPTIVE_STAGING_CASES stress the insert and delete kernels' staged
    rows and selector words (tiny shared tables, several windows, blocks
    1024 and 8192, bucket sizes 2 and 8, adapted and scrambled slots that
    chains kick and roll back)."""
    assert _adaptive_kernels_vs_plain(dev, _adaptive_case(label)) == 1


def test_adaptive_calls_split_into_launches(dev):
    """A call longer than ``split_keys`` runs as launches in order at
    logical-block boundaries, with the one launch's result."""
    c = _adaptive_case("three-windows")
    spans = cuda.spans(len(c["keys"]), c["block"], 1000)
    assert len(spans) == 10 and spans[1] == (896, 1792)
    assert _adaptive_kernels_vs_plain(dev, c, split_keys=1000) == len(spans)


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


@pytest.mark.parametrize("k,slots,nb", [(1, 0, 1024), (2, 16, 1024),
                                        (3, 32, 900)])
def test_probe_multi_matches_plain(dev, k, slots, nb):
    rng = np.random.RandomState(k + slots)
    tables = torch.zeros((k, 1024, 4), dtype=torch.int32, device=dev)
    stashes = (torch.zeros((k, 2, slots), dtype=torch.int32, device=dev)
               if slots else None)
    landed = []
    for g in range(k):
        keys = random_keys(rng, 1024 * (g + 2))
        hi, lo = (t32(x).to(dev) for x in split(keys))
        out = insert_bulk(tables[g], hi, lo, fp_bits=16, n_buckets=nb,
                          evict_rounds=4, block=128,
                          stash=None if stashes is None else stashes[g])
        landed.append(keys[out[-1].cpu().numpy()])
    keys = np.concatenate([np.concatenate(landed)[:2048],
                           random_keys(rng, 2048)])
    hi, lo = (t32(x).to(dev) for x in split(keys))
    got = probe_multi(tables, hi, lo, fp_bits=16, n_buckets=nb,
                      stashes=stashes)
    want = probe_multi_plain(tables, hi, lo, fp_bits=16, n_buckets=nb,
                             stashes=stashes)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool(got[:2048].all())
    for gens in ([k - 1], list(range(k - 1, -1, -2)), []):
        got = probe_multi(tables, hi, lo, fp_bits=16, n_buckets=nb,
                          stashes=stashes, gens=gens)
        want = probe_multi_plain(tables, hi, lo, fp_bits=16, n_buckets=nb,
                                 stashes=stashes, gens=gens)
        torch.cuda.synchronize()
        assert torch.equal(got, want), gens


@pytest.mark.parametrize("label", PROBE_MULTI_CASES)
def test_probe_multi_cases_match_plain(dev, label):
    """PROBE_MULTI_CASES, with and without the stashes: the kernel's stash
    prefilter (full stashes, several staging passes, entries that share a
    key's fingerprint or its 16-bit fold but not its buckets, fp_bits 32
    and 8), its batched bucket loads (bucket sizes 2 and 8, pools of 5, 65
    and 130 slots with live slots in any order) and n not a multiple of
    the CTA, against the plain version bit for bit."""
    c = probe_multi_inputs(label)
    hi, lo = (t32(x).to(dev) for x in split(c["keys"]))
    tables = t32(c["tables"]).to(dev)
    sts = [None]
    if c["stashes"] is not None:
        sts.append(t32(c["stashes"]).to(dev))
    for st in sts:
        kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"], stashes=st,
                  gens=c["gens"])
        cuda.reset_counts()
        got = probe_multi(tables, hi, lo, block=c["block"], **kw)
        assert cuda.LAUNCHES["probe_multi"] >= 1
        want = probe_multi_plain(tables, hi, lo, **kw)
        torch.cuda.synchronize()
        assert got.shape == (c["keys"].size,)
        assert torch.equal(got, want), (label, st is None)


@pytest.mark.parametrize("label", PROBE_ADAPTIVE_CASES)
def test_probe_adaptive_cases_match_plain(dev, label):
    """PROBE_ADAPTIVE_CASES, with and without the stash: the kernel's stash
    prefilter (full, empty, three staging passes, entries that share a
    key's fingerprint or its 16-bit fold but not its buckets, fp_bits 32
    and 8), its selector words read only for rows that match a family
    fingerprint (slots holding fam[j] under a selector other than j,
    adapted rows), its alternate row loaded only where the home row
    missed, bucket sizes 1, 2 and 8, and n from 1 to past 2^20, against
    the plain version bit for bit; each call one launch."""
    c = probe_adaptive_inputs(label)
    hi, lo = (t32(x).to(dev) for x in split(c["keys"]))
    table, sels = t32(c["table"]).to(dev), t32(c["sels"]).to(dev)
    for st in (None, t32(c["stash"]).to(dev)):
        kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"], stash=st)
        cuda.reset_counts()
        got = probe_adaptive(table, sels, hi, lo, block=c["block"], **kw)
        assert cuda.LAUNCHES["probe_adaptive"] == 1
        want = probe_adaptive_plain(table, sels, hi, lo, **kw)
        torch.cuda.synchronize()
        assert got.shape == (c["keys"].size,)
        assert torch.equal(got, want), (label, st is None)


@pytest.mark.parametrize("k", [65, 130])
def test_probe_multi_over_64_generations(dev, k):
    """More pool slots than the kernel's 64-bit live mask: one launch per
    64 slots that hold a generation to probe, ORed, against the plain
    version, for every slot live and for subsets."""
    rng = np.random.RandomState(k)
    nb, buf = 900, 1024
    fill = rng.rand(k, buf, 4) < 0.3
    tables = torch.from_numpy(np.where(
        fill, rng.randint(1, 1 << 16, size=(k, buf, 4)), 0
    ).astype(np.int32)).to(dev)
    stashes = torch.zeros((k, 2, 8), dtype=torch.int32, device=dev)
    stashes[:, 0, :3] = torch.from_numpy(
        rng.randint(1, 1 << 16, size=(k, 3)).astype(np.int32)).to(dev)
    stashes[:, 1, :3] = torch.from_numpy(
        rng.randint(0, nb, size=(k, 3)).astype(np.int32)).to(dev)
    hi, lo = (t32(x).to(dev) for x in split(random_keys(rng, 4096)))
    for gens in (None, [0, 63, 64, k - 1], [k - 1], []):
        for st in (None, stashes):
            cuda.reset_counts()
            got = probe_multi(tables, hi, lo, fp_bits=16, n_buckets=nb,
                              stashes=st, gens=gens)
            want = probe_multi_plain(tables, hi, lo, fp_bits=16,
                                     n_buckets=nb, stashes=st, gens=gens)
            torch.cuda.synchronize()
            assert torch.equal(got, want), gens
            live = range(k) if gens is None else gens
            groups = {g // 64 for g in live} | {0}
            assert cuda.LAUNCHES["probe_multi"] == len(groups)


def test_ring_on_card_matches_cpu(dev):
    kw = dict(generations=3, capacity=2048, stash_slots=16, evict_rounds=4,
              ttl=4.0)
    on_card, on_cpu = (GenerationalFilter(GenerationConfig(device=d, **kw),
                                          now=0.0) for d in ("cuda", "cpu"))
    rng = np.random.RandomState(2)
    cuda.reset_counts()
    seen = []
    for t in range(8):
        keys = random_keys(rng, 600 + 500 * (t % 3))
        probe_keys = np.concatenate([keys] + seen[-2:])
        for ring_op, arg in (("lookup", probe_keys), ("insert", keys),
                             ("lookup_active", probe_keys)):
            a, b = (getattr(r, ring_op)(arg, now=float(t))
                    for r in (on_card, on_cpu))
            np.testing.assert_array_equal(a, b)
            want = generational_to_numpy(on_cpu)
            got = generational_to_numpy(on_card)
            assert got["stats"] == want["stats"]
            assert len(got["gens"]) == len(want["gens"])
            for gg, wg in zip(got["gens"], want["gens"]):
                assert_same_state(wg, gg, f"t={t} {ring_op}")
        seen.append(keys)
    assert on_cpu.stats.rotations >= 2 and on_cpu.stats.expirations >= 1
    assert cuda.LAUNCHES["probe_multi"] > 0 and cuda.LAUNCHES["insert_bulk"] > 0


@pytest.mark.parametrize("case", [
    # b, hq, hkv, sq, skv, d, causal, window, softcap
    (1, 4, 1, 512, 512, 256, True, 128, None),
    (1, 4, 1, 512, 512, 256, True, None, None),
    (1, 4, 1, 4096, 4096, 256, True, None, None),  # long rows, small values
    (1, 4, 1, 8192, 8192, 256, True, None, None),  # gemma3-1b, global layer
    (1, 4, 1, 8192, 8192, 256, True, 512, None),   # gemma3-1b, local layer
    (2, 2, 2, 128, 256, 128, True, None, 30.0),
    (1, 4, 4, 1, 384, 64, True, None, None),
    (1, 2, 1, 128, 128, 32, False, None, None),
    (1, 2, 1, 256, 128, 16, True, None, None),     # rows past the keys
    # the 128-row q tile and the 64-key kv tile cut short
    (1, 2, 2, 72, 72, 64, True, None, None),       # GQA group 1
    (1, 4, 2, 1, 72, 128, True, None, None),       # GQA group 2, Sq = 1
    (1, 4, 1, 96, 96, 256, True, None, None),      # GQA group 4
    (1, 2, 1, 64, 96, 128, False, None, None),
    (1, 2, 1, 256, 256, 64, True, 1, None),        # window 1
    (1, 4, 2, 512, 512, 128, True, 64, 20.0),      # window on a tile edge
    (1, 4, 2, 256, 256, 32, True, 48, None),       # 64-byte swizzle
    (2, 2, 1, 120, 120, 16, True, None, 10.0),     # 32-byte swizzle
    # lengths that are no multiple of the tiles: ragged last q and kv tiles
    (1, 4, 1, 200, 200, 256, True, None, None),    # gemma3-1b heads
    (1, 4, 1, 200, 200, 256, True, 64, None),
    (1, 2, 1, 300, 300, 64, True, None, 20.0),
    (1, 2, 2, 77, 200, 128, False, None, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(dev, case, dtype):
    """The kernel against its plain version on the card; tolerance: the
    reference sweep's 2e-6 (float32, with the longer sums of 512 or more
    keys at D = 256: 1e-5) and 2e-2 (bfloat16) elementwise, and row by row
    ||got - want|| / ||want|| within 1e-5 (float32) and 1e-2 (bfloat16):
    on long rows the outputs shrink to the size of the elementwise
    tolerance, and one dropped 64-key tile reads 0.03 or more there."""
    b, hq, hkv, sq, skv, d, causal, window, cap = case
    rng = np.random.RandomState(sq + d)
    q, k, v = (torch.from_numpy(rng.randn(*shape)).to(dev, dtype)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d)))
    cuda.reset_counts()
    got = flash_attention(q, k, v, causal=causal, window=window,
                          logit_softcap=cap)
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 logit_softcap=cap)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["flash_attention"] == 1
    tol = (2e-2 if dtype == torch.bfloat16
           else 1e-5 if d == 256 and skv >= 512 else 2e-6)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    row_tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert float(row_rel_err(got, want).max()) <= row_tol
    if skv < sq:
        assert float(got[:, :, :sq - skv].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_strided_views(dev, dtype):
    """q, k, v as the model hands them over, [B, S, H, D] tensors seen as
    [B, H, S, D], and k, v as slices of one packed [B, S, 2, Hkv, D]
    tensor: the kernel reads them through their strides and matches the
    plain version on contiguous copies, with the tolerances above:
    elementwise and row by row."""
    rng = np.random.RandomState(7)
    b, hq, hkv, s, d = 2, 4, 2, 256, 128
    q = torch.from_numpy(rng.randn(b, s, hq, d)).to(dev, dtype)
    kv = torch.from_numpy(rng.randn(b, s, 2, hkv, d)).to(dev, dtype)
    q, k, v = q.transpose(1, 2), kv[:, :, 0].transpose(1, 2), \
        kv[:, :, 1].transpose(1, 2)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    cuda.reset_counts()
    got = flash_attention(q, k, v, window=96)
    want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous(), window=96)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["flash_attention"] == 1
    assert got.is_contiguous()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-6
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    row_tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert float(row_rel_err(got, want).max()) <= row_tol
    with pytest.raises(ValueError, match="last dimension"):
        flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)


@pytest.mark.parametrize("seq", [64, 200])
def test_lm_on_card_matches_cpu(dev, seq):
    """gemma3-1b smoke weights built on the CPU and copied to the card:
    the flash forward's logits within 1e-4 in float32 (tf32 off), and the
    greedy tokens of prefill + 8 decode steps equal; 200 tokens is no
    multiple of the flash kernel's tiles."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"), dtype="float32")
    cpu = Transformer(cfg, seed=1, device="cpu")
    card = Transformer(cfg, seed=1, device="cpu").to(dev)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, seq)))
    cuda.reset_counts()
    a = card.apply(toks.to(dev)).logits
    assert cuda.LAUNCHES["flash_attention"] == cfg.n_layers
    assert not cuda.PLAIN_CALLS
    b = cpu.apply(toks).logits
    torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    outs = [engine.generate(m, t, 9).tokens.cpu()
            for m, t in ((card, toks.to(dev)), (cpu, toks))]
    assert torch.equal(*outs)


# ------------------------------------------------- telemetry twins ------


@pytest.mark.parametrize("label", [*LEGACY_KERNEL_CASES, *STAGING_CASES])
def test_insert_tm_matches_plain_with_stats(dev, label):
    """insert.cu's telemetry instantiation: table, stash and ok equal the
    flag-off kernel's and the plain version's, and its plane (kick
    histogram, spills, rollbacks) the plain version's stats."""
    c = _kernel_case(label)
    nb, block, rounds = c["n_buckets"], c["block"], c["rounds"]
    hi, lo = (t32(x).to(dev) for x in split(c["keys"]))
    valid = torch.from_numpy(c["valid"]).to(dev)
    tables = [t32(c["table"]).to(dev) for _ in range(3)]
    stashes = [None if c["stash"] is None else t32(c["stash"]).to(dev)
               for _ in range(3)]
    kw = dict(fp_bits=16, n_buckets=nb, evict_rounds=rounds, block=block)
    cuda.reset_counts()
    out = insert_bulk_tm(tables[0], hi, lo, valid=valid, stash=stashes[0],
                         **kw)
    assert cuda.LAUNCHES["insert_bulk_tm"] == 1
    ok_off = insert_bulk(tables[1], hi, lo, valid=valid, stash=stashes[1],
                         **kw)[-1]
    ok_p, stats = insert_bulk_plain(tables[2], hi, lo, valid,
                                    stash=stashes[2], want_stats=True, **kw)
    torch.cuda.synchronize()
    for t in tables[1:]:
        assert torch.equal(tables[0], t)
    if stashes[0] is not None:
        assert torch.equal(stashes[0], stashes[1])
        assert torch.equal(stashes[0], stashes[2])
    assert torch.equal(out[-2], ok_off) and torch.equal(out[-2], ok_p)
    assert torch.equal(out[-1], insert_plane(*stats, valid))
    assert int(out[-1][:KICK_BINS].sum()) == int(valid.sum())


@pytest.mark.parametrize("label", [*LEGACY_ADAPTIVE_CASES,
                                   *ADAPTIVE_STAGING_CASES])
@pytest.mark.parametrize("split_keys", [cuda.SPLIT_KEYS, 300])
def test_insert_adaptive_tm_matches_plain_with_stats(dev, label,
                                                     split_keys):
    """insert_adaptive.cu's telemetry instantiation, as above; a call split
    into launches adds them all to one plane."""
    c = _adaptive_case(label)
    if split_keys < c["block"]:
        pytest.skip("the split needs at least one logical block a launch")
    nb, block, fp_bits = c["n_buckets"], c["block"], c["fp_bits"]
    hi, lo = (t32(x).to(dev) for x in split(c["keys"]))
    valid = torch.from_numpy(c["valid"]).to(dev)
    planes = [[t32(p).to(dev) for p in c["planes"]] for _ in range(3)]
    stashes = [None if c["stash"] is None else t32(c["stash"]).to(dev)
               for _ in range(3)]
    kw = dict(fp_bits=fp_bits, n_buckets=nb, evict_rounds=c["rounds"],
              block=block)
    cuda.reset_counts()
    out = insert_bulk_adaptive_tm(*planes[0], hi, lo, valid=valid,
                                  stash=stashes[0], split_keys=split_keys,
                                  **kw)
    assert cuda.LAUNCHES["insert_bulk_adaptive_tm"] == len(
        cuda.spans(hi.numel(), block, split_keys))
    ok_off = insert_bulk_adaptive(*planes[1], hi, lo, valid=valid,
                                  stash=stashes[1], split_keys=split_keys,
                                  **kw)[-1]
    ok_p, stats = insert_bulk_adaptive_plain(*planes[2], hi, lo, valid,
                                             stash=stashes[2],
                                             want_stats=True, **kw)
    torch.cuda.synchronize()
    for ps in planes[1:]:
        assert all(torch.equal(a, b) for a, b in zip(planes[0], ps))
    if stashes[0] is not None:
        assert torch.equal(stashes[0], stashes[1])
        assert torch.equal(stashes[0], stashes[2])
    assert torch.equal(out[-2], ok_off) and torch.equal(out[-2], ok_p)
    assert torch.equal(out[-1], insert_plane(*stats, valid))


@pytest.mark.parametrize("label", PROBE_CASES)
def test_probe_tm_matches_plain_with_stats(dev, label):
    """probe.cu's telemetry instantiation: the flag-off kernel's answers
    for every lane, and the plain version's depth plane of the counted
    lanes (padding key 0 is planted and must not count)."""
    c = probe_inputs(label)
    table = t32(c["table"]).to(dev)
    hi, lo = (t32(x).to(dev) for x in split(c["keys"]))
    k = c["counted"]
    counted = torch.arange(hi.numel(), device=dev) < k
    for st in (None, None if c["stash"] is None
               else t32(c["stash"]).to(dev)):
        kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"], stash=st)
        hit, plane = probe_tm(table, hi, lo, n_valid=k, block=c["block"],
                              **kw)
        want, hs = probe_plain(table, hi, lo, want_stats=True, **kw)
        assert torch.equal(hit, want)
        assert torch.equal(hit, probe(table, hi, lo, block=c["block"], **kw))
        assert torch.equal(plane, probe_depth_counts(*hs, counted))


@pytest.mark.parametrize("label", PROBE_ADAPTIVE_CASES)
def test_probe_adaptive_tm_matches_plain_with_stats(dev, label):
    """probe_adaptive.cu's telemetry instantiation, as above (the last
    seven lanes uncounted)."""
    c = probe_adaptive_inputs(label, 0)
    table, sels = t32(c["table"]).to(dev), t32(c["sels"]).to(dev)
    hi, lo = (t32(x).to(dev) for x in split(c["keys"]))
    k = max(0, hi.numel() - 7)
    counted = torch.arange(hi.numel(), device=dev) < k
    for st in (None, t32(c["stash"]).to(dev)):
        kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"], stash=st)
        hit, plane = probe_adaptive_tm(table, sels, hi, lo, n_valid=k,
                                       block=c["block"], **kw)
        want, hs = probe_adaptive_plain(table, sels, hi, lo, want_stats=True,
                                        **kw)
        assert torch.equal(hit, want)
        assert torch.equal(hit, probe_adaptive(table, sels, hi, lo,
                                               block=c["block"], **kw))
        assert torch.equal(plane, probe_depth_counts(*hs, counted))


def _batcher_stream(adaptive, device, telemetry, seed=3):
    """A seeded wave stream through a ``FilterOpBatcher`` on ``device``
    -> (batcher, wave results, registry snapshot without latencies)."""
    ws, nb = 512, 256
    ops = FilterOps(fp_bits=8 if adaptive else 12, evict_rounds=4)
    state = (make_adaptive_state(nb, device=device) if adaptive
             else make_state(nb, device=device))
    m = MetricsRegistry()
    b = FilterOpBatcher(ops, state, stash=make_stash(8, device=device),
                        wave_slots=ws, double_buffer=True,
                        telemetry=telemetry, metrics=m)
    rng = np.random.RandomState(seed)
    members = random_keys(rng, 2 * ws)
    benign = random_keys(rng, ws)
    waves = [b.submit("insert", members[:ws]),
             b.submit("insert", members[ws:]),
             b.submit("lookup", np.concatenate([members[:300],
                                                benign[:200]]))]
    b.flush()
    taken = np.concatenate([members[:ws][waves[0].results],
                            members[ws:][waves[1].results]])
    if adaptive:
        waves.append(b.submit("report", benign))
    waves.append(b.submit("lookup", benign))
    waves.append(b.submit("delete", taken[:ws]))
    b.flush()
    snap = {k: v for k, v in m.snapshot().items() if "latency" not in k}
    return b, [w.results for w in waves], snap


@pytest.mark.parametrize("adaptive", [False, True])
def test_batcher_on_card_matches_cpu(dev, adaptive):
    """The batcher's two arms on one seeded stream, telemetry on: waves,
    states and counters on the card equal the CPU's, and the telemetry-off
    arm on the card gives the same waves and launches no tm symbol."""
    cuda.reset_counts()
    card, card_res, card_snap = _batcher_stream(adaptive, "cuda", True)
    assert any(cuda.LAUNCHES[k] for k in cuda.TM_KERNELS)
    cpu, cpu_res, cpu_snap = _batcher_stream(adaptive, "cpu", True)
    cuda.reset_counts()
    off, off_res, _ = _batcher_stream(adaptive, "cuda", False)
    assert not any(cuda.LAUNCHES[k] for k in cuda.TM_KERNELS)
    for a, b, c in zip(card_res, cpu_res, off_res):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert card_snap == cpu_snap
    for x in (cpu, off):
        assert torch.equal(card.state.table.cpu(), x.state.table.cpu())
        assert torch.equal(card.stash.cpu(), x.stash.cpu())
        assert int(card.state.count) == int(x.state.count)
    assert card_snap.get("filter_stash_spills", 0) > 0


@pytest.mark.parametrize("name", ["burst_train", "adversarial", "ttl_churn"])
def test_slo_scenario_on_card_matches_cpu(dev, name):
    """One short scenario of the SLO harness on the card and on the CPU:
    every wave's results, the final state and the report's fields that
    are no host time equal; the card's run launches kernels and takes no
    plain version."""
    from repro_torch.convert import generational_to_numpy
    from repro_torch.serving import slo
    from torch_port_util import (SLO_SMALL, SLO_WS, recording_harness,
                                 report_fields)
    runs = []
    for device in ("cuda", "cpu"):
        cuda.reset_counts()
        h = recording_harness(slo.SloHarness)
        rep = slo.run_scenario(name, seed=7, device=device, harness=h,
                               wave_slots=SLO_WS,
                               stream_kwargs=SLO_SMALL[name])
        if device == "cuda":
            assert sum(cuda.LAUNCHES.values()) > 0
            assert not cuda.PLAIN_CALLS
        runs.append((h, rep))
    (ch, crep), (ph, prep) = runs
    assert report_fields(crep) == report_fields(prep)
    assert len(ch.waves) == len(ph.waves)
    for a, b in zip(ch.waves, ph.waves):
        if hasattr(a, "results"):
            a, b = a.results, b.results
        np.testing.assert_array_equal(a, b)
    if name == "ttl_churn":
        ca, pa = generational_to_numpy(ch.target), generational_to_numpy(
            ph.target)
        assert ca["stats"] == pa["stats"]
        assert len(ca["gens"]) == len(pa["gens"])
        for x, y in zip(ca["gens"], pa["gens"]):
            for key in x:
                np.testing.assert_array_equal(x[key], y[key])
        return
    for plane in ("table", "sels", "khi", "klo"):
        if hasattr(ch.target.state, plane):
            assert torch.equal(getattr(ch.target.state, plane).cpu(),
                               getattr(ph.target.state, plane))
    assert torch.equal(ch.target.stash.cpu(), ph.target.stash)
    assert int(ch.target.state.count) == int(ph.target.state.count)
