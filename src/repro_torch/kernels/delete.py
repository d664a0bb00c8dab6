"""Fused hash + first-match-slot bulk delete (kernels 4 and 9).

Counterpart of ``repro.kernels.delete.delete_bulk`` and
``delete_bulk_adaptive`` (at the end of this module).  Per logical block,
in order, with the table carried from block to block: one clear round in
the home bucket for all lanes, then one in the alternate bucket for the
lanes that missed.  Lanes are ranked by (bucket, fingerprint) among
earlier active lanes, so the k-th duplicate clears the k-th matching slot.
All home attempts run before all alternate attempts — the reference's
order, reproduced as it is.

The CUDA kernel (``csrc/delete.cu``) is one CTA walking the logical blocks
in order, with a window's rows staged in shared memory; the plain version
below follows the same schedule.  Both update
``table`` IN PLACE.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.kernels import cuda
from repro_torch.kernels.rank import rank_among_earlier
from repro_torch.kernels.selector import (fp_family, sel_pack, sel_unpack,
                                          select_fp)

DEFAULT_BLOCK = 1024


def _clear_round(table, target, active, fp32):
    """One clear attempt for every active lane in ``target`` buckets
    -> cleared bool[N]."""
    rank = rank_among_earlier(target, active, fp=fp32)
    match = table[target] == fp32[:, None]                # [n, bucket_size]
    hits = active & (rank < match.sum(dim=1))
    match_pos = torch.cumsum(match.to(torch.int64), dim=1) - 1
    slot = (match & (match_pos == rank[:, None])).to(torch.int8).argmax(dim=1)
    table[target[hits], slot[hits]] = 0
    return hits


def _delete_block(table, hi, lo, valid, n_buckets, *, fp_bits: int):
    fp = hashing.fingerprint(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fp, n_buckets)
    fp32 = hashing.to_i32(fp)
    ok = _clear_round(table, i1, valid, fp32)
    return ok | _clear_round(table, i2, valid & ~ok, fp32)


def delete_bulk_plain(table: torch.Tensor, hi: torch.Tensor,
                      lo: torch.Tensor, valid: torch.Tensor, *, fp_bits: int,
                      n_buckets: int, block: int) -> torch.Tensor:
    """Plain PyTorch version: logical blocks in order, IN PLACE -> ok."""
    cuda.PLAIN_CALLS["delete_bulk"] += 1
    ok = [_delete_block(table, hi[s:s + block], lo[s:s + block],
                        valid[s:s + block], n_buckets, fp_bits=fp_bits)
          for s in range(0, hi.shape[0], block)]
    return torch.cat(ok)


def _delete_cuda(table, hi, lo, valid, *, fp_bits, n_buckets, block):
    cuda.check_cuda("delete_bulk", table=table, hi=hi, lo=lo, valid=valid)
    cuda.check_dtype("delete_bulk", torch.int32, table=table, hi=hi, lo=lo)
    cuda.check_dtype("delete_bulk", torch.bool, valid=valid)
    cuda.check_table("delete_bulk", table, n_buckets)
    n = hi.shape[0]
    ok = torch.empty((n,), dtype=torch.bool, device=table.device)
    spill = cuda.spill_buffer("delete_bulk", table.device, table.shape[1], n,
                              block)
    cuda.launch("delete_bulk", table.device, table.data_ptr(),
                table.shape[1], int(n_buckets), hi.data_ptr(), lo.data_ptr(),
                valid.data_ptr(), ok.data_ptr(), n, block, fp_bits,
                cuda.ptr(spill))
    return ok


def delete_bulk(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
                fp_bits: int, n_buckets: int | None = None,
                valid: torch.Tensor | None = None,
                block: int = DEFAULT_BLOCK):
    """Fused bulk delete, clearing ``table`` IN PLACE -> (table, ok[N]).

    N must be a multiple of ``min(block, N)``; ``valid=False`` lanes never
    touch the table.  Callers verify membership first (the OCF keystore
    does): clearing a fingerprint that was never inserted corrupts another
    key's slot.  CPU tensors take the plain version; CUDA tensors launch
    the kernel.
    """
    n = hi.shape[0]
    block = min(block, n) if n else block
    if n and n % block:
        raise ValueError(f"{n=} not a multiple of {block=}")
    if n_buckets is None:
        n_buckets = table.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=hi.device)
    if n == 0:
        return table, torch.zeros((0,), dtype=torch.bool, device=table.device)
    run = delete_bulk_plain if table.device.type == "cpu" else _delete_cuda
    return table, run(table, hi, lo, valid, fp_bits=fp_bits,
                      n_buckets=n_buckets, block=block)


# ------------------------------------------- selector-aware (adaptive) -----
#
# The same schedule over the four adaptive planes: a slot matches when it
# stores the lane's family fingerprint under the SLOT's selector, the
# duplicate rank stays keyed on (bucket, fp0) whatever the residents'
# selectors are, and a hit zeroes all four planes.  The kernel is
# ``csrc/delete_adaptive.cu``.


def _clear_round_adaptive(planes, target, active, fam, fp0_32):
    table, sel_tbl, khi_t, klo_t = planes
    rank = rank_among_earlier(target, active, fp=fp0_32)
    match = table[target] == hashing.to_i32(select_fp(fam, sel_tbl[target]))
    hits = active & (rank < match.sum(dim=1))
    match_pos = torch.cumsum(match.to(torch.int64), dim=1) - 1
    slot = (match & (match_pos == rank[:, None])).to(torch.int8).argmax(dim=1)
    t, s = target[hits], slot[hits]
    for plane in planes:
        plane[t, s] = 0
    return hits


def _delete_adaptive_block(planes, hi, lo, valid, n_buckets, *,
                           fp_bits: int):
    fam = fp_family(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    i2 = hashing.alt_index(i1, fam[0], n_buckets)
    fp0_32 = hashing.to_i32(fam[0])
    ok = _clear_round_adaptive(planes, i1, valid, fam, fp0_32)
    return ok | _clear_round_adaptive(planes, i2, valid & ~ok, fam, fp0_32)


def delete_bulk_adaptive_plain(table, sels, khi, klo, hi, lo, valid, *,
                               fp_bits: int, n_buckets: int, block: int
                               ) -> torch.Tensor:
    """Plain PyTorch version: logical blocks in order, all four planes
    cleared IN PLACE -> ok."""
    cuda.PLAIN_CALLS["delete_bulk_adaptive"] += 1
    sel_tbl = sel_unpack(sels, table.shape[1])
    planes = (table, sel_tbl, khi, klo)
    ok = [_delete_adaptive_block(planes, hi[s:s + block], lo[s:s + block],
                                 valid[s:s + block], n_buckets,
                                 fp_bits=fp_bits)
          for s in range(0, hi.shape[0], block)]
    sels.copy_(sel_pack(sel_tbl))
    return torch.cat(ok)


def _delete_adaptive_cuda(table, sels, khi, klo, hi, lo, valid, *, fp_bits,
                          n_buckets, block, split_keys=cuda.SPLIT_KEYS):
    name = "delete_bulk_adaptive"
    cuda.check_cuda(name, table=table, sels=sels, khi=khi, klo=klo, hi=hi,
                    lo=lo, valid=valid)
    cuda.check_dtype(name, torch.int32, table=table, sels=sels, khi=khi,
                     klo=klo, hi=hi, lo=lo)
    cuda.check_dtype(name, torch.bool, valid=valid)
    cuda.check_table(name, table, n_buckets, sels=sels, khi=khi, klo=klo)
    n = hi.shape[0]
    ok = torch.empty((n,), dtype=torch.bool, device=table.device)
    spill = cuda.spill_buffer(name, table.device, table.shape[1],
                              min(n, split_keys), block)
    for s, e in cuda.spans(n, block, split_keys):
        cuda.launch(name, table.device, table.data_ptr(), sels.data_ptr(),
                    khi.data_ptr(), klo.data_ptr(), table.shape[1],
                    int(n_buckets), hi[s:e].data_ptr(), lo[s:e].data_ptr(),
                    valid[s:e].data_ptr(), ok[s:e].data_ptr(), e - s, block,
                    fp_bits, cuda.ptr(spill))
    return ok


def delete_bulk_adaptive(table: torch.Tensor, sels: torch.Tensor,
                         khi: torch.Tensor, klo: torch.Tensor,
                         hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                         n_buckets: int | None = None,
                         valid: torch.Tensor | None = None,
                         block: int = DEFAULT_BLOCK,
                         split_keys: int = cuda.SPLIT_KEYS):
    """Selector-aware bulk delete, clearing all four planes IN PLACE
    -> (table, sels, khi, klo, ok[N]).

    Same contract as ``delete_bulk``; a slot matches under ITS selector, so
    an adapted resident stays deletable by its key.  Stash entries are
    the caller's (``kernels.stash.stash_delete_ref``).  CPU tensors take
    the plain version; CUDA tensors launch the kernel, as launches of at
    most ``split_keys`` keys at logical-block boundaries (the same result:
    the blocks run in order).
    """
    n = hi.shape[0]
    block = min(block, n) if n else block
    if n and n % block:
        raise ValueError(f"{n=} not a multiple of {block=}")
    if n_buckets is None:
        n_buckets = table.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=hi.device)
    planes = (table, sels, khi, klo)
    if n == 0:
        return (*planes, torch.zeros((0,), dtype=torch.bool,
                                     device=table.device))
    kw = dict(fp_bits=fp_bits, n_buckets=n_buckets, block=block)
    if table.device.type == "cpu":
        ok = delete_bulk_adaptive_plain(table, sels, khi, klo, hi, lo, valid,
                                        **kw)
    else:
        ok = _delete_adaptive_cuda(table, sels, khi, klo, hi, lo, valid,
                                   split_keys=split_keys, **kw)
    return (*planes, ok)
