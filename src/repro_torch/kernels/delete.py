"""Fused hash + first-match-slot bulk delete (kernel 4).

Counterpart of ``repro.kernels.delete.delete_bulk``.  Per logical block,
in order, with the table carried from block to block: one clear round in
the home bucket for all lanes, then one in the alternate bucket for the
lanes that missed.  Lanes are ranked by (bucket, fingerprint) among
earlier active lanes, so the k-th duplicate clears the k-th matching slot.
All home attempts run before all alternate attempts — the reference's
order, reproduced as it is.

The CUDA kernel (``csrc/delete.cu``) is one CTA walking the logical blocks
in order; the plain version below follows the same schedule.  Both update
``table`` IN PLACE.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.kernels import cuda
from repro_torch.kernels.rank import rank_among_earlier

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
    dev = table.device
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    lane_u32 = torch.empty((4, block), dtype=torch.int32, device=dev)
    lane_u8 = torch.empty((3, block), dtype=torch.uint8, device=dev)
    cuda.launch("delete_bulk", table.data_ptr(), table.shape[1],
                int(n_buckets), hi.data_ptr(), lo.data_ptr(),
                valid.data_ptr(), ok.data_ptr(), n, block, fp_bits,
                lane_u32.data_ptr(), lane_u8.data_ptr())
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
