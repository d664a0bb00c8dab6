"""Flash attention (online softmax) for the LM stack's cache-less forward
(kernel 10).

Counterpart of ``repro.kernels.flash_attention.flash_attention``.  The CUDA
kernels (``csrc/flash_attention.cu``) run one CTA per (batch x q head, q
tile) and loop over the kv tiles that its causal and window masks leave
live: bfloat16 inputs on the tensor cores (``wgmma`` fed by TMA, 128-row q
tiles, a producer warpgroup and two consumer warpgroups, scores and the
output accumulator in registers, p rounded to bfloat16 for P V), float32
inputs on the CUDA cores (64-row q tiles).  Both read q, k and v through
their strides (``byte_strides``), so transposed views need no copy; the
output is contiguous.  The plain version below is the
reference kernel's schedule in torch ops: the same online softmax over the
same ``bk``-key blocks (a fully masked block is an exact no-op there, so
all q rows go through each block at once).  Any Sq and Skv: the last q
and kv tiles may be ragged; the kernels mask keys at or past Skv (a
zero-filled key would score 0, not -inf) and store no row at or past Sq.

Both compute, for q [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D] (q head h
reads kv head h // (Hq / Hkv)): queries right-aligned to keys (query i
sits at position Skv - Sq + i), ``causal`` keeps keys at or before the
query, ``window`` keeps keys less than ``window`` positions back, the
optional soft-cap ``c * tanh(s / c)`` acts before the mask, the default
scale is D^-0.5, and a row with no live key gives 0.  Accumulation is in
float32; the output has q's dtype (float32 or bfloat16).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, bq: int, bk: int) -> tuple[int, int]:
    """The shape contract -> (bq_, bk_).  Unlike the reference kernel's,
    it takes any Sq and Skv (ragged last tiles)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be [B, Hq, Sq, D] and k, "
                         f"v [B, Hkv, Skv, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)} (Hq must be a multiple of Hkv)")
    skv = k.shape[2]
    bq_, bk_ = max(1, min(bq, sq)), max(1, min(bk, skv))
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    return bq_, bk_


def byte_strides(t: torch.Tensor, name: str = "x") -> tuple[int, int, int]:
    """The (batch, head, row) strides in bytes of a [B, H, S, D] operand,
    as the kernels take them: the last dimension contiguous, the data
    16-byte aligned, every other stride a positive multiple of 16 bytes.
    A dimension of size 1 is never stepped, so it gets the contiguous
    stride whatever its own.  ValueError on anything else: the wrapper
    copies nothing."""
    if t.dim() != 4:
        raise ValueError(f"flash_attention: {name} must be 4-D, got "
                         f"{tuple(t.shape)}")
    item = t.element_size()
    if t.shape[3] > 1 and t.stride(3) != 1:
        raise ValueError(f"flash_attention: {name}'s last dimension must "
                         f"be contiguous, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name}'s data must be 16-byte "
                         f"aligned")
    out, dense = [], t.shape[3] * item
    for dim in (2, 1, 0):
        size, stride = t.shape[dim], t.stride(dim) * item
        if size == 1:
            stride = dense
        elif stride <= 0 or stride % 16:
            raise ValueError(f"flash_attention: {name}'s strides "
                             f"{t.stride()} (elements of {item} bytes) "
                             f"must be positive multiples of 16 bytes")
        out.append(stride)
        dense *= size
    return out[2], out[1], out[0]


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          logit_softcap: float | None = None,
                          scale: float | None = None, bq: int = 128,
                          bk: int = 128) -> torch.Tensor:
    """Plain PyTorch version: the reference kernel's online softmax over
    ``bk``-key blocks, all q rows at once."""
    cuda.PLAIN_CALLS["flash_attention"] += 1
    _bq, bk_ = _check(q, k, v, bq, bk)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale_ = scale if scale is not None else d ** -0.5
    dev = q.device
    qf = q.reshape(b, hkv, group, sq, d).float() * scale_
    kf, vf = k.float(), v.float()
    qpos = (skv - sq + torch.arange(sq, device=dev))[:, None]
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32,
                      device=dev)
    m = torch.full((b, hkv, group, sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    for j0 in range(0, skv, bk_):
        width = min(bk_, skv - j0)                   # the last may be ragged
        kpos = (j0 + torch.arange(width, device=dev))[None, :]
        mask = torch.ones((sq, width), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        if not bool(mask.any()):
            continue                      # the kernel's block_live skip
        kb = kf[:, :, None, j0:j0 + bk_]
        vb = vf[:, :, None, j0:j0 + bk_]
        s = qf @ kb.transpose(-1, -2)                       # [.., sq, bk]
        if logit_softcap is not None:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        s = torch.where(mask, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.where(mask, torch.exp(s - m_cur[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vb
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    logit_softcap: float | None = None,
                    scale: float | None = None, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D].

    ``bq`` and ``bk`` are the reference's tiles; the plain version walks
    ``min(bk, Skv)``-key blocks, the last one ragged where it does not
    divide Skv (the reference kernel asserts there; its dispatcher sends
    such lengths elsewhere).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (D in 16, 32, 64, 128, 256; q, k, v as
    ``byte_strides`` takes them), which takes any Sq and Skv.
    """
    _check(q, k, v, bq, bk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_softcap=logit_softcap,
                                     scale=scale, bq=bq, bk=bk)
    return _flash_cuda(q, k, v, causal=causal, window=window,
                       logit_softcap=logit_softcap, scale=scale)


def _flash_cuda(q, k, v, *, causal, window, logit_softcap, scale):
    cuda.check_cuda("flash_attention", contiguous=False, q=q, k=k, v=v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"flash_attention: logit_softcap must be > 0, got "
                         f"{logit_softcap}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*byte_strides(q, "q"),
                                      *byte_strides(k, "k"),
                                      *byte_strides(v, "v"))
    cuda.launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b, hq, hkv, sq, skv, d, _DTYPES[q.dtype],
                int(causal), -1 if window is None else int(window),
                float(logit_softcap or 0.0),
                float(scale if scale is not None else d ** -0.5),
                ctypes.addressof(strides))
    return out
