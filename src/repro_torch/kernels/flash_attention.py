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

The gradient.  Where grad is enabled and q, k or v requires it,
``flash_attention`` goes through ``FlashAttentionFn``: its forward also
returns each row's float32 log-sum-exp (``lse`` [B, Hq, Sq], m + log l of
the scaled, capped scores; -1e30 for a row with no live key) and saves q,
k, v, the output and ``lse``; its backward is the exact gradient of the
function above (``flash_attention_bwd``): the CUDA kernels of
``csrc/flash_attention_bwd.cu`` on the card (a pre-pass D_i = rowsum(dO
o), a dk/dv kernel over kv tiles, a dq kernel over q tiles; ``LAUNCHES``
counts each under its own name), ``flash_attention_bwd_plain`` on the
CPU.  The reference's Pallas kernel has no VJP; its training step takes
the gradient of the same attention from XLA's autodiff off the TPU.  On a
CUDA tensor ``_flash_cuda`` refuses to run under grad rather than return
an output cut off from the graph.
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


def _on_host(t: torch.Tensor) -> bool:
    """True for a CPU tensor, or a ``meta`` one (the dry-run's abstract
    tensors, DTensors included): these take the plain version.  A CUDA
    tensor launches the kernel or raises."""
    return t.device.type in ("cpu", "meta")


def _block_live(sq: int, skv: int, j0: int, width: int, causal: bool,
                window) -> bool:
    """Whether any query of the right-aligned rows ``skv - sq .. skv - 1``
    sees a key of ``j0 .. j0 + width - 1`` (``_live``'s mask has a set
    element), from the positions alone: the live keys of all rows span
    ``(first row - window, last row]``."""
    if sq <= 0 or width <= 0:
        return False
    first, last = skv - sq, skv - 1
    if causal and j0 > last:
        return False
    return window is None or j0 + width - 1 > first - window


def _live(qpos, j0: int, width: int, causal: bool, window) -> torch.Tensor:
    """[Sq, width] bool: the keys j0 .. j0 + width that the masks leave
    live for queries at positions ``qpos`` [Sq, 1]."""
    kpos = (j0 + torch.arange(width, device=qpos.device))[None, :]
    mask = torch.ones((qpos.shape[0], width), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          logit_softcap: float | None = None,
                          scale: float | None = None, bq: int = 128,
                          bk: int = 128, return_lse: bool = False):
    """Plain PyTorch version: the reference kernel's online softmax over
    ``bk``-key blocks, all q rows at once.  ``return_lse``: also each row's
    float32 log-sum-exp [B, Hq, Sq] (m + log l; -1e30 for a row with no
    live key)."""
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
        if not _block_live(sq, skv, j0, width, causal, window):
            continue                      # the kernel's block_live skip
        mask = _live(qpos, j0, width, causal, window)
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
    out = out.reshape(b, hq, sq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      NEG_INF)
    return out, lse.reshape(b, hq, sq)


def bwd_delta_plain(o, do) -> torch.Tensor:
    """The backward's pre-pass in torch ops: D_i = rowsum(dO o), float32
    [B, Hq, Sq]."""
    cuda.PLAIN_CALLS["flash_attention_bwd_pre"] += 1
    return (do.float() * o.float()).sum(-1)


def bwd_delta(o, do) -> torch.Tensor:
    """D_i = rowsum(dO o) -> float32 [B, Hq, Sq]: ``bwd_delta_plain`` for
    CPU tensors, the pre-pass kernel for contiguous CUDA tensors of one
    dtype."""
    if _on_host(o):
        return bwd_delta_plain(o, do)
    cuda.check_cuda("flash_attention_bwd_pre", o=o, do=do)
    if do.dtype != o.dtype or o.dtype not in _DTYPES or do.shape != o.shape \
            or o.dim() != 4 or o.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_pre: o and do must be "
                         f"[B, H, S, D] of one dtype with D in {HEAD_DIMS}, "
                         f"got {o.dtype} {tuple(o.shape)} and {do.dtype} "
                         f"{tuple(do.shape)}")
    b, h, s, d = o.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=o.device)
    if delta.numel():
        cuda.launch("flash_attention_bwd_pre", o.device, o.data_ptr(),
                    do.data_ptr(), delta.data_ptr(), b * h * s, d,
                    _DTYPES[o.dtype])
    return delta


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int | None = None,
                              logit_softcap: float | None = None,
                              scale: float | None = None, bk: int = 64):
    """Plain PyTorch version of the backward kernels, on their kv-tile
    schedule: D_i = rowsum(dO o); then per ``bk``-key tile (all q rows at
    once) p = exp(x - lse) on live pairs, dP = dO v^T, dS = p (dP - D_i)
    (1 - tanh^2 of the capped score) scale; dv and dk of the tile summed
    over the group's q heads, dq accumulated over the tiles.  -> (dq, dk,
    dv) in q's dtype."""
    cuda.PLAIN_CALLS["flash_attention_bwd"] += 1
    _check(q, k, v, 128, bk)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale_ = scale if scale is not None else d ** -0.5
    dev = q.device
    qf = q.reshape(b, hkv, group, sq, d).float()
    dof = do.reshape(b, hkv, group, sq, d).float()
    kf, vf = k.float(), v.float()
    lse_ = lse.reshape(b, hkv, group, sq, 1).float()
    delta = bwd_delta_plain(o, do).reshape(b, hkv, group, sq, 1)
    qpos = (skv - sq + torch.arange(sq, device=dev))[:, None]
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for j0 in range(0, skv, bk):
        width = min(bk, skv - j0)
        if not _block_live(sq, skv, j0, width, causal, window):
            continue
        mask = _live(qpos, j0, width, causal, window)
        kb = kf[:, :, None, j0:j0 + width]
        vb = vf[:, :, None, j0:j0 + width]
        x = (qf @ kb.transpose(-1, -2)) * scale_
        dcap = 1.0
        if logit_softcap is not None:
            t = torch.tanh(x / logit_softcap)
            x = logit_softcap * t
            dcap = 1 - t * t
        p = torch.where(mask, torch.exp(x - lse_), 0.0)
        dp = dof @ vb.transpose(-1, -2)
        ds = p * (dp - delta) * dcap * scale_
        dv[:, :, j0:j0 + width] = (p.transpose(-1, -2) @ dof).sum(2)
        dk[:, :, j0:j0 + width] = (ds.transpose(-1, -2) @ qf).sum(2)
        dq += ds @ kb
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int | None = None,
                        logit_softcap: float | None = None,
                        scale: float | None = None):
    """The gradient of ``flash_attention`` -> (dq, dk, dv) in q's dtype,
    from the forward's output ``o`` and ``lse`` and the output's gradient
    ``do``.  CPU (and ``meta``) tensors take the plain version; CUDA
    tensors launch the three backward kernels (pre-pass, dk/dv, dq)."""
    if _on_host(q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window,
                                         logit_softcap=logit_softcap,
                                         scale=scale)
    _check(q, k, v, 128, 128)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do.to(q.dtype)))
    lse = lse.contiguous()
    cuda.check_cuda("flash_attention_bwd", q=q, k=k, v=v, o=o, lse=lse,
                    do=do)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 "
                         f"{(b, hq, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dtype = _DTYPES[q.dtype]
    delta = bwd_delta(o, do)
    mask = (int(causal), -1 if window is None else int(window),
            float(logit_softcap or 0.0),
            float(scale if scale is not None else d ** -0.5))
    shape = (b, hq, hkv, sq, skv, d, dtype)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    cuda.launch("flash_attention_bwd_dkdv", q.device, *common,
                dk.data_ptr(), dv.data_ptr(), *shape, *mask)
    cuda.launch("flash_attention_bwd_dq", q.device, *common, dq.data_ptr(),
                *shape, *mask)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward kernel (or the
    plain version on the CPU) with ``lse``, and ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap, scale, bq,
                bk):
        kw = dict(causal=causal, window=window, logit_softcap=logit_softcap,
                  scale=scale)
        if _on_host(q):
            out, lse = flash_attention_plain(q, k, v, bq=bq, bk=bk,
                                             return_lse=True, **kw)
        else:
            out, lse = _flash_cuda(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    logit_softcap: float | None = None,
                    scale: float | None = None, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D].

    ``bq`` and ``bk`` are the reference's tiles; the plain version walks
    ``min(bk, Skv)``-key blocks, the last one ragged where it does not
    divide Skv (the reference kernel asserts there; its dispatcher sends
    such lengths elsewhere).  CPU and ``meta`` tensors take the plain
    version; CUDA tensors launch the kernel (D in 16, 32, 64, 128, 256; q,
    k, v as ``byte_strides`` takes them), which takes any Sq and Skv.
    Under grad (grad enabled and q, k or v requiring it) the call goes
    through ``FlashAttentionFn``, and the output carries its gradient.
    """
    _check(q, k, v, bq, bk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, logit_softcap,
                                      scale, bq, bk)
    if _on_host(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_softcap=logit_softcap,
                                     scale=scale, bq=bq, bk=bk)
    return _flash_cuda(q, k, v, causal=causal, window=window,
                       logit_softcap=logit_softcap, scale=scale)


def _flash_cuda(q, k, v, *, causal, window, logit_softcap, scale,
                with_lse: bool = False):
    """The forward kernel -> the output (and ``lse`` with ``with_lse``).
    Refuses to run under grad: its output would carry no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the CUDA forward kernel was "
                           "called under grad outside FlashAttentionFn; "
                           "its output would carry no gradient")
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
    # the kernel writes every row's lse (-1e30 where no key is live)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    strides = (ctypes.c_longlong * 9)(*byte_strides(q, "q"),
                                      *byte_strides(k, "k"),
                                      *byte_strides(v, "v"))
    cuda.launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), cuda.ptr(lse), b, hq, hkv, sq,
                skv, d, _DTYPES[q.dtype], int(causal),
                -1 if window is None else int(window),
                float(logit_softcap or 0.0),
                float(scale if scale is not None else d ** -0.5),
                ctypes.addressof(strides))
    return (out, lse) if with_lse else out
