"""A numpy model of the tile schedule of the bfloat16 backward kernels
(``csrc/flash_attention_bwd.cu``: ``flash_bwd_dkdv_wgmma_kernel`` and
``flash_bwd_dq_wgmma_kernel``), held against the mask of
``flash_attention_bwd_plain``.

For each CTA the model lists the (q tile, kv tile) pairs it visits, in the
order it sums them, and which it takes as full (no mask applied).  A dk/dv
key tile is a cluster of ``KPARTS`` CTAs: rank r walks items r, r +
KPARTS, ... of the tile's walk, and rank 0 adds the others' sums in rank
order.  The model restates the kernels' loop bounds, ``kParts`` and
``tile_full``: update it with them.  On every ``GRAD_CASES`` shape of ``test_torch_flash_grad.py``, on
ragged lengths, and on gemma3-1b's training shape (S 4096, global and
window 512):

* every live (query, key) pair of every q head is visited exactly once by
  each kernel, and no two visited tiles of a kernel overlap;
* a tile is taken as full exactly when it lies inside Sq and Skv and all
  its pairs are live (so the mask is skipped only where it keeps all);
* no visited tile is wholly dead;
* each output element is summed in a fixed order (ascending q head and q
  tile within each CTA of a dk/dv cluster, then the CTAs in rank order;
  ascending kv tile for dq), and under the causal mask the CTAs launch
  heaviest first.

The model's gradient, summed tile by tile in the schedule's order with the
mask applied only on tiles not taken as full, is held against
``flash_attention_bwd_plain`` (float64 against float32: 1e-5).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (_live,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)

pytestmark = pytest.mark.tier1

TILE = 64   # rows of every tile of the wgmma kernels: keys and q rows
KPARTS = 2  # CTAs of a dk/dv key tile (csrc's kParts)

# b, hq, hkv, sq, skv, d, causal, window, softcap: test_torch_flash_grad's
# GRAD_CASES, ragged lengths, Sq > Skv and Sq < Skv, a window of 1,
# non-causal windows, gemma3-1b's training shapes (S 4096).
CASES = {
    "causal": (2, 4, 2, 64, 64, 16, True, None, None),
    "window": (1, 8, 1, 96, 96, 32, True, 24, None),
    "softcap": (2, 2, 2, 48, 80, 64, True, None, 30.0),
    "gqa": (1, 8, 2, 40, 40, 16, True, None, None),
    "ragged": (1, 4, 1, 70, 70, 16, True, 33, 20.0),
    "noncausal": (1, 2, 1, 24, 50, 32, False, None, None),
    "dead_rows": (1, 2, 1, 80, 40, 16, True, None, None),
    "ragged_200_w64": (1, 4, 1, 200, 200, 16, True, 64, None),
    "ragged_300_cap": (1, 2, 1, 300, 300, 16, True, 100, 30.0),
    "sq_gt_skv": (1, 2, 1, 256, 128, 16, True, None, None),
    "sq_lt_skv": (1, 2, 1, 100, 250, 16, True, 70, None),
    "window_1": (1, 4, 1, 96, 96, 16, True, 1, None),
    "decode_row": (1, 4, 4, 1, 384, 16, True, None, None),
    "noncausal_window": (1, 2, 1, 130, 190, 16, False, 40, None),
    "gemma_global": (1, 4, 1, 4096, 4096, 256, True, None, None),
    "gemma_local": (1, 4, 1, 4096, 4096, 256, True, 512, None),
}
SMALL = [n for n, c in CASES.items() if c[3] * c[4] <= 300 * 300]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_full(sq, skv, causal, window, q0, k0) -> bool:
    """The kernels' ``tile_full``: every pair of q rows [q0, q0 + 64) x
    keys [k0, k0 + 64) live."""
    shift = skv - sq
    return (q0 + TILE <= sq and k0 + TILE <= skv
            and (not causal or k0 + TILE - 1 <= shift + q0)
            and (not window or k0 > shift + q0 + TILE - 1 - window))


def dkdv_schedule(hq, hkv, sq, skv, causal, window):
    """Clusters of the dk/dv kernel in launch order (one per key tile; the
    kv heads' clusters are alike): [(k0, [items of rank 0, items of rank
    1, ...])], each item (g, q0, full), in the order the CTA sums them."""
    group, shift = hq // hkv, skv - sq
    out = []
    for kt in range(_cdiv(skv, TILE)):
        k0 = kt * TILE
        kmax = min(k0 + TILE, skv) - 1
        i_lo = max(0, k0 - shift) if causal else 0
        i_hi = min(sq, kmax + window - shift) if window else sq
        t_lo = i_lo // TILE
        tiles = _cdiv(i_hi, TILE) - t_lo if i_hi > i_lo else 0
        ranks = [[] for _ in range(KPARTS)]
        for i in range(group * tiles):
            q0 = (t_lo + i % tiles) * TILE
            ranks[i % KPARTS].append(
                (i // tiles, q0, tile_full(sq, skv, causal, window, q0, k0)))
        out.append((k0, ranks))
    return out


def dq_schedule(sq, skv, causal, window):
    """CTAs of the dq kernel in launch order (one per 64-row q tile, the
    latest first; the heads' CTAs are alike): [(q0, [(k0, full), ...])]."""
    nqt = _cdiv(sq, TILE)
    out = []
    for y in range(nqt):
        q0 = (nqt - 1 - y) * TILE
        qpos0 = skv - sq + q0
        qlast = skv - sq + min(q0 + TILE, sq) - 1
        kv_hi = min(skv, qlast + 1) if causal else skv
        kv_lo = max(0, qpos0 - window + 1) if window else 0
        t_lo = kv_lo // TILE
        n = _cdiv(kv_hi, TILE) - t_lo if kv_hi > kv_lo else 0
        out.append((q0, [((t_lo + i) * TILE, tile_full(
            sq, skv, causal, window, q0, (t_lo + i) * TILE))
            for i in range(n)]))
    return out


def plain_mask(sq, skv, causal, window) -> np.ndarray:
    """[Sq, Skv] bool: the pairs ``flash_attention_bwd_plain`` keeps."""
    qpos = (skv - sq + torch.arange(sq))[:, None]
    return _live(qpos, 0, skv, causal, window).numpy()


def _tile(mask, q0, k0):
    return mask[q0:q0 + TILE, k0:k0 + TILE]


@pytest.mark.parametrize("name", list(CASES))
def test_dkdv_schedule_visits_every_live_pair_once(name):
    _b, hq, hkv, sq, skv, _d, causal, window, _c = CASES[name]
    mask = plain_mask(sq, skv, causal, window)
    sched = dkdv_schedule(hq, hkv, sq, skv, causal, window)
    group = hq // hkv
    seen = np.zeros((group, sq, skv), np.int32)
    for k0, ranks in sched:
        for items in ranks:
            for g, q0, full in items:
                seen[g, q0:q0 + TILE, k0:k0 + TILE] += 1
                tile = _tile(mask, q0, k0)
                assert tile.any(), (name, k0, g, q0)
                assert full == (q0 + TILE <= sq and k0 + TILE <= skv
                                and bool(tile.all())), (name, k0, q0)
            keys = [(g, q0) for g, q0, _ in items]
            assert keys == sorted(set(keys)), (name, k0)
        # the ranks share the walk within one item
        sizes = [len(items) for items in ranks]
        assert max(sizes) - min(sizes) <= 1, (name, k0, sizes)
    assert seen.max() <= 1
    assert (seen[:, mask] == 1).all()


@pytest.mark.parametrize("name", list(CASES))
def test_dq_schedule_visits_every_live_pair_once(name):
    _b, _hq, _hkv, sq, skv, _d, causal, window, _c = CASES[name]
    mask = plain_mask(sq, skv, causal, window)
    seen = np.zeros((sq, skv), np.int32)
    for q0, items in dq_schedule(sq, skv, causal, window):
        for k0, full in items:
            seen[q0:q0 + TILE, k0:k0 + TILE] += 1
            tile = _tile(mask, q0, k0)
            assert tile.any(), (name, q0, k0)
            assert full == (q0 + TILE <= sq and k0 + TILE <= skv
                            and bool(tile.all())), (name, q0, k0)
        keys = [k0 for k0, _ in items]
        assert keys == sorted(set(keys)), (name, q0)
    assert seen.max() <= 1
    assert (seen[mask] == 1).all()


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[6] and not c[7]])
def test_heaviest_ctas_launch_first(name):
    """Under the causal mask alone the low key tiles (dk/dv) and the late
    q tiles (dq) hold the most work, and they launch first."""
    _b, hq, hkv, sq, skv, _d, causal, window, _c = CASES[name]
    work = [len(ranks[0]) for _k0, ranks in
            dkdv_schedule(hq, hkv, sq, skv, causal, window)]
    assert work == sorted(work, reverse=True), (name, work)
    work = [len(items) for _q0, items in dq_schedule(sq, skv, causal,
                                                     window)]
    assert work == sorted(work, reverse=True), (name, work)


def test_gemma_schedule_counts():
    """gemma3-1b's training shapes: the work of the heaviest CTA and of
    all CTAs of a (batch, kv head), in 64 x 64 tiles (the header note's
    count: key tile 0 walks 4 x 64 q tiles, 128 in each CTA of its
    cluster)."""
    _b, hq, hkv, sq, skv, _d, causal, _w, _c = CASES["gemma_global"]
    sched = dkdv_schedule(hq, hkv, sq, skv, causal, None)
    assert len(sched) == 64
    assert [len(items) for items in sched[0][1]] == [4 * 64 // KPARTS] * 2
    assert sum(len(items) for _k, ranks in sched
               for items in ranks) == 4 * 64 * 65 // 2
    local = dkdv_schedule(hq, hkv, sq, skv, causal, 512)
    assert max(len(items) for _k, ranks in local
               for items in ranks) == 4 * 9 // KPARTS
    dq = dq_schedule(sq, skv, causal, 512)
    assert max(len(items) for _q, items in dq) == 9
    # tiles taken as masked: the diagonal of every q tile, and the
    # window's far edge of the 56 that reach back 512 keys
    assert sum(not f for _q, items in dq for _k, f in items) == 8 + 2 * 56


def _inputs(case, seed):
    b, hq, hkv, sq, skv, d, causal, window, cap = case
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*s)).float() for s in (
        (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d)))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    return q, k, v, o, lse, do, kw


def schedule_grads(q, k, v, o, lse, do, causal, window, cap):
    """dq, dk, dv in float64, summed tile by tile in the schedules' order,
    the mask applied only on tiles not taken as full."""
    q, k, v, o, lse, do = (t.double().numpy() for t in (q, k, v, o, lse, do))
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group, scale = hq // hkv, d ** -0.5
    mask = plain_mask(sq, skv, causal, window)
    delta = (o * do).sum(-1)

    def tile_terms(bi, h, q0, k0, full):
        qs, ks = slice(q0, q0 + TILE), slice(k0, k0 + TILE)
        kvh = h // group
        s = q[bi, h, qs] @ k[bi, kvh, ks].T * scale
        dcap = 1.0
        if cap:
            t = np.tanh(s / cap)
            s, dcap = cap * t, 1 - t * t
        with np.errstate(over="ignore"):   # dead rows: lse -1e30
            p = np.exp(s - lse[bi, h, qs, None])
        if not full:
            p = np.where(_tile(mask, q0, k0), p, 0.0)
        dp = do[bi, h, qs] @ v[bi, kvh, ks].T
        ds = p * (dp - delta[bi, h, qs, None]) * dcap * scale
        return qs, ks, p, ds
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for bi in range(b):
        for kvh in range(hkv):
            for k0, ranks in dkdv_schedule(hq, hkv, sq, skv, causal,
                                           window):
                ks = slice(k0, k0 + TILE)
                for items in ranks:       # rank 0's sums, then rank 1's
                    part_k = np.zeros_like(dk[bi, kvh, ks])
                    part_v = np.zeros_like(dv[bi, kvh, ks])
                    for g, q0, full in items:
                        h = kvh * group + g
                        qs, _ks, p, ds = tile_terms(bi, h, q0, k0, full)
                        part_v += p.T @ do[bi, h, qs]
                        part_k += ds.T @ q[bi, h, qs]
                    dk[bi, kvh, ks] += part_k
                    dv[bi, kvh, ks] += part_v
        for h in range(hq):
            for q0, items in dq_schedule(sq, skv, causal, window):
                for k0, full in items:
                    qs, ks, _p, ds = tile_terms(bi, h, q0, k0, full)
                    dq[bi, h, qs] += ds @ k[bi, h // group, ks]
    return dq, dk, dv


@pytest.mark.parametrize("name", SMALL)
def test_schedule_gradient_matches_plain_backward(name):
    case = CASES[name]
    _b, _hq, _hkv, _sq, _skv, _d, causal, window, cap = case
    q, k, v, o, lse, do, kw = _inputs(case, seed=len(name))
    got = schedule_grads(q, k, v, o, lse, do, causal, window, cap)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.double().numpy(), atol=1e-5,
                                   rtol=1e-5)
