"""Per-slot hash-selector plane: the shared math of the adaptive filter.

Counterpart of ``repro.kernels.selector``.  Every occupied slot carries a
2-bit **selector** choosing which member of a 4-hash fingerprint family it
stores:

    stored[b, s] == fingerprint_sel(resident_key, sel[b, s])

A confirmed false positive on query q at slot (b, s) is repaired by
bumping ``sel[b, s]`` and rewriting the slot from the resident's mirrored
key under its next family member.  The entry never moves: bucket geometry
always comes from the selector-0 fingerprint.

Layout (int32 tensors holding uint32 bit patterns, like the table):

  * ``sels`` — the packed selector plane ``[buffer_buckets, 1]``, slot s
    of a bucket in bits [2s, 2s+2), so bucket_size is at most 16;
  * ``khi`` / ``klo`` — mirror key planes ``[buffer_buckets, bucket_size]``,
    the resident's key halves, needed to rehash a slot on repair and to
    re-derive selector-0 geometry when an eviction chain kicks it.

``report_adapt`` is the reference's ``lax.scan``: reports are rare
control-plane events and keep exact sequential semantics.  Here the rows
the reported keys can touch are gathered once, adapted in lane order on
the host (only the lanes that can adapt a slot), and scattered back.  The kernels (``csrc/*_adaptive.cu``) read
the packed word directly (``ocf_common.cuh::sel_of``).
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing

SEL_MASK = 3          # 2 selector bits per slot
MAX_BUCKET_SIZE = 16  # 16 slots * 2 bits fill the packed word


def make_sel_plane(buffer_buckets: int, *, device="cuda") -> torch.Tensor:
    """Fresh all-zero packed selector plane: int32[buffer_buckets, 1]."""
    return torch.zeros((buffer_buckets, 1), dtype=torch.int32,
                       device=hashing.resolve_device(device))


def make_key_planes(buffer_buckets: int, bucket_size: int, *, device="cuda"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh mirror key planes (hi, lo): int32[buffer_buckets, bucket_size]."""
    if bucket_size > MAX_BUCKET_SIZE:
        raise ValueError("the packed selector plane holds at most 16 slots")
    dev = hashing.resolve_device(device)
    shape = (buffer_buckets, bucket_size)
    return (torch.zeros(shape, dtype=torch.int32, device=dev),
            torch.zeros(shape, dtype=torch.int32, device=dev))


def _shifts(bucket_size: int, device) -> torch.Tensor:
    return 2 * torch.arange(bucket_size, dtype=torch.int64, device=device)


def sel_unpack(packed: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """[..., 1] packed rows -> int64[..., bucket_size] selectors."""
    return (hashing.to_u32(packed) >> _shifts(bucket_size, packed.device)) \
        & SEL_MASK


def sel_pack(sel_tbl: torch.Tensor) -> torch.Tensor:
    """[..., bucket_size] selectors -> packed int32[..., 1] rows (the exact
    inverse of ``sel_unpack``: the bit ranges are disjoint)."""
    shifts = _shifts(sel_tbl.shape[-1], sel_tbl.device)
    word = ((sel_tbl.to(torch.int64) & SEL_MASK) << shifts).sum(
        dim=-1, keepdim=True)
    return hashing.to_i32(word)


def fp_family(hi: torch.Tensor, lo: torch.Tensor, fp_bits: int
              ) -> tuple[torch.Tensor, ...]:
    """All four family fingerprints of a key batch: 4 x int64[N].

    ``fam[0]`` is the static fingerprint; it fixes the bucket geometry and
    the stash identity.
    """
    return tuple(hashing.fingerprint_sel(hi, lo, s, fp_bits)
                 for s in range(hashing.SEL_VARIANTS))


def select_fp(fam, sels: torch.Tensor) -> torch.Tensor:
    """Per-slot expected fingerprint under slot selectors.

    fam: 4 x [N] (``fp_family``); sels: [N, bucket_size] -> int64[N,
    bucket_size] (a select chain, as in the reference).
    """
    exp = torch.where(sels == 1, fam[1][:, None], fam[0][:, None])
    exp = torch.where(sels == 2, fam[2][:, None], exp)
    return torch.where(sels == 3, fam[3][:, None], exp)


def _adapt_one_bucket(row, sels, rhi, rlo, fam, hi, lo, enable: bool, *,
                      fp_bits: int):
    """Repair every colliding slot of one bucket row for one reported key
    -> (row, sels, any adapted).

    ``row``/``rhi``/``rlo``: int64 u32 values [bucket_size]; ``sels``:
    int64 selectors [bucket_size]; ``fam``: int64 [4], the key's family;
    ``hi``/``lo``: the key's halves as ints.
    """
    exp = fam[sels]                   # fingerprint_sel(key, sels)
    occupied = row != 0
    same = (rhi == hi) & (rlo == lo) & occupied
    collide = occupied & (row == exp) & ~same & enable
    nsel = (sels + 1) & SEL_MASK
    nfp = hashing.fingerprint_sel(rhi, rlo, nsel, fp_bits)
    row = torch.where(collide, nfp, row)
    sels = torch.where(collide, nsel, sels)
    return row, sels, bool(collide.any())


def report_adapt(table: torch.Tensor, sels: torch.Tensor, khi: torch.Tensor,
                 klo: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                 valid: torch.Tensor, *, fp_bits: int, n_buckets: int,
                 family=None):
    """Apply confirmed-false-positive reports in lane order, updating
    ``table`` and ``sels`` IN PLACE -> (table, sels, adapted[N],
    resident[N]).

    A lane adapts every slot of its candidate pair whose stored fingerprint
    matches the query under that slot's selector and whose mirror key
    differs; ``resident`` flags reports whose key occupies a slot (true
    positives, never repaired).  The alternate pass is skipped where
    ``i2 == i1`` (the involution's fixed points), so a lane never bumps a
    selector twice.  ``family`` is the reported keys' ``((f0..f3), i1,
    i2)`` when the caller has hashed them (``kernels.ops.adaptive_report``
    uses the family kernel); otherwise it is computed here.
    """
    n = hi.shape[0]
    dev = table.device
    if n == 0:
        empty = torch.zeros((0,), dtype=torch.bool, device=dev)
        return table, sels, empty, empty.clone()
    if family is None:
        fam = fp_family(hi, lo, fp_bits)
        i1 = hashing.index_hash(hi, lo, n_buckets)
        family = (fam, i1, hashing.alt_index(i1, fam[0], n_buckets))
    fam, i1, i2 = family
    i1, i2 = hashing.to_u32(i1), hashing.to_u32(i2)
    bucket_size = table.shape[1]
    # Every row a report can touch, gathered once (sequential semantics
    # only matter among these rows), adapted on the host, scattered back.
    rows_at = torch.unique(torch.cat([i1, i2]))
    rows = hashing.to_u32(table[rows_at]).cpu()
    rsel = sel_unpack(sels[rows_at], bucket_size).cpu()
    rhi = hashing.to_u32(khi[rows_at]).cpu()
    rlo = hashing.to_u32(klo[rows_at]).cpu()
    fam_h = torch.stack([hashing.to_u32(f) for f in fam], dim=1).cpu()
    j1 = torch.searchsorted(rows_at, i1).cpu()
    j2 = torch.searchsorted(rows_at, i2).cpu()
    hi_c, lo_c = hashing.to_u32(hi).cpu(), hashing.to_u32(lo).cpu()
    # Adapting changes fingerprints and selectors, never which slots are
    # occupied or the mirror keys, so ``resident`` is read off the rows as
    # gathered, for all lanes at once.  A lane adapts nothing unless one of
    # its rows holds another key's slot under the lane's family
    # fingerprint (for the slot's selector) or an earlier lane adapted one
    # of its rows: only such valid lanes take the sequential path below.
    ok = valid.cpu()
    live = torch.zeros(n, dtype=torch.bool)
    resident = torch.zeros(n, dtype=torch.bool)
    for j in (j1, j2):
        r = rows[j]
        occupied = r != 0
        same = occupied & (rhi[j] == hi_c[:, None]) & (rlo[j] == lo_c[:, None])
        live |= (occupied & (r == fam_h.gather(1, rsel[j])) & ~same).any(1)
        resident |= same.any(1)
    resident &= ok
    hi_h, lo_h = hi_c.tolist(), lo_c.tolist()
    i1_h, i2_h, live_h = i1.tolist(), i2.tolist(), (live & ok).tolist()
    j1_h, j2_h, ok_h = j1.tolist(), j2.tolist(), ok.tolist()
    adapted = [False] * n
    dirty: set = set()
    for lane in range(n):
        if not ok_h[lane] or not (live_h[lane] or j1_h[lane] in dirty
                                  or j2_h[lane] in dirty):
            continue
        for j, enable in ((j1_h[lane], True),
                          (j2_h[lane], i2_h[lane] != i1_h[lane])):
            rows[j], rsel[j], a = _adapt_one_bucket(
                rows[j], rsel[j], rhi[j], rlo[j], fam_h[lane], hi_h[lane],
                lo_h[lane], enable, fp_bits=fp_bits)
            adapted[lane] |= a
            if a:
                dirty.add(j)
    table[rows_at] = hashing.to_i32(rows).to(dev)
    sels[rows_at] = sel_pack(rsel).to(dev)
    return (table, sels, torch.tensor(adapted, device=dev),
            resident.to(dev))
