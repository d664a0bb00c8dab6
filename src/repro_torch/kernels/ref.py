"""Plain tensor references: the filter's scan-backend refs and blockwise
attention.

Counterpart of ``repro.kernels.ref``.  The filter refs
(``fingerprint_ref``, ``probe_ref``, ``insert_once_ref``,
``insert_residue_ref``, ``delete_ref``) are the reference's raw-table refs
over ``core/filter.py``'s bulk ops, the code ``FilterOps(backend="torch")``
runs for inserts and deletes.

``blockwise_attention`` is the cached (prefill and decode) attention path.
Like the reference, it is plain tensor code and no kernel: the reference
reaches its Pallas flash kernel only for a cache-less forward
(``repro.kernels.ops.attention``), and so does the port
(``repro_torch.kernels.ops.attention``).
"""
from __future__ import annotations

import torch

from repro_torch.core import filter as tfilter
from repro_torch.core import hashing
from repro_torch.kernels.scan import DEFAULT_MAX_DISP

# ------------------------------------------------------------- filter refs --


def fingerprint_ref(hi: torch.Tensor, lo: torch.Tensor, *, fp_bits: int,
                    n_buckets: int):
    """(fp, i1, i2) of a key batch, int64 each."""
    fp = hashing.fingerprint(hi, lo, fp_bits)
    i1 = hashing.index_hash(hi, lo, n_buckets)
    return fp, i1, hashing.alt_index(i1, fp, n_buckets)


def probe_ref(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
              fp_bits: int, n_buckets=None) -> torch.Tensor:
    """Bulk membership on a raw table -> bool[N]."""
    return tfilter.bulk_lookup(tfilter.table_state(table, n_buckets), hi,
                               lo, fp_bits=fp_bits)


def insert_once_ref(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                    *, fp_bits: int, n_buckets=None, valid=None):
    """Optimistic single-round insert on a raw table -> (table, placed)."""
    st, placed = tfilter.parallel_insert_once(
        tfilter.table_state(table, n_buckets), hi, lo, fp_bits=fp_bits,
        valid=valid)
    return st.table, placed


def insert_residue_ref(table: torch.Tensor, hi: torch.Tensor,
                       lo: torch.Tensor, *, fp_bits: int, n_buckets=None,
                       valid=None, max_disp: int = DEFAULT_MAX_DISP):
    """Sequential eviction-chain insert on a raw table -> (table, placed)."""
    st, ok = tfilter.bulk_insert(tfilter.table_state(table, n_buckets), hi,
                                 lo, fp_bits=fp_bits, max_disp=max_disp,
                                 valid=valid)
    return st.table, ok


def delete_ref(table: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, *,
               fp_bits: int, n_buckets=None, valid=None):
    """Sequential delete on a raw table -> (table, deleted)."""
    st, ok = tfilter.bulk_delete(tfilter.table_state(table, n_buckets), hi,
                                 lo, fp_bits=fp_bits, valid=valid)
    return st.table, ok


# ------------------------------------------------------- flash attention --

NEG_INF = -1e30


def blockwise_attention(q, k, v, *, causal=True, window=None,
                        logit_softcap=None, scale=None, qpos_start=None,
                        valid_len=None, key_positions=None,
                        q_chunk: int = 512):
    """Memory-bounded attention: loop over q chunks, never materialize SxS.

    q: [B,Hq,Sq,Dk]; k: [B,Hkv,Skv,Dk]; v: [B,Hkv,Skv,Dv].  GQA via q-head
    h -> kv-head h // group.  ``qpos_start``: offset of q position 0
    (decode); default right-aligned (Skv - Sq).  ``valid_len``: number of
    valid cache entries; keys beyond it are masked.  ``key_positions``:
    absolute position of each key slot (the ring cache; negative = empty).
    Softmax in float32; the output has q's dtype.
    """
    b, hq, sq, dk = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    group = hq // hkv
    scale = scale if scale is not None else dk ** -0.5
    if qpos_start is None:
        qpos_start = skv - sq
    dev = q.device
    slot = torch.arange(skv, device=dev)
    kpos = slot if key_positions is None else torch.as_tensor(
        key_positions, device=dev)
    kvalid = kpos >= 0
    if valid_len is not None:
        kvalid = kvalid & (slot < valid_len)

    qg = q.reshape(b, hkv, group, sq, dk).float() * scale
    kf = k.float()
    vf = v.float()

    def one_chunk(qc, qpos):
        # qc: [b,hkv,group,C,dk]; qpos: [C]
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qc, kf)
        if logit_softcap is not None:
            logits = logit_softcap * torch.tanh(logits / logit_softcap)
        mask = kvalid[None, :]
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhgqk,bhkd->bhgqd", probs, vf)

    c = min(q_chunk, sq)
    qpos_all = qpos_start + torch.arange(sq, device=dev)
    if sq % c != 0 or sq == c:
        out = one_chunk(qg, qpos_all)
    else:
        out = torch.cat([one_chunk(qg[:, :, :, i:i + c], qpos_all[i:i + c])
                         for i in range(0, sq, c)], dim=3)
    return out.reshape(b, hq, sq, dv).to(q.dtype)
