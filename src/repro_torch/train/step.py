"""Train-step factory: loss, backward and AdamW.

Counterpart of ``repro.train.step`` (``cross_entropy``, ``quantize_int8``,
``dequantize_int8``, ``_compress_pod_grads``, ``_compress_pod_grads_int8``,
``make_train_step``).  The loss is the token cross-entropy of the
differentiable forward (``Transformer.forward``) plus the MoE aux loss;
its gradient is ``torch.autograd.grad`` of that, through the flash
kernel's backward.  With ``microbatches > 1`` the batch is split along
its first axis, the gradients accumulate in float32 and are divided by
the count at the end, and loss and aux are averaged, as the reference's
scan does.  The cross-pod gradient compression acts only with a
``pod_axis``, as in the reference (on one card it is the same round trip
through bfloat16 or int8, without the all-reduce it precedes there).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import ParallelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamW


def cross_entropy(logits, targets, mask=None):
    """logits [B, S, V]; targets [B, S] int -> the mean negative
    log-likelihood over the tokens (over those where ``mask`` is set)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _compress_pod_grads(grads: dict, parallel: ParallelConfig) -> dict:
    """bfloat16 round trip of every gradient (the cross-pod all-reduce's
    bytes halved in the reference)."""
    return {k: g.to(torch.bfloat16).float() for k, g in grads.items()}


def quantize_int8(g):
    """Per-tensor symmetric int8 quantization -> (q, float32 scale);
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def _compress_pod_grads_int8(grads: dict, parallel: ParallelConfig) -> dict:
    """int8 round trip of every gradient (per-tensor scale)."""
    return {k: dequantize_int8(*quantize_int8(g)) for k, g in grads.items()}


def make_train_step(model: Transformer, tx: AdamW, parallel: ParallelConfig):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``params`` is ``dict(model.named_parameters())`` (made
    trainable here); the step updates them in place.  ``batch``: int
    ``tokens`` and ``targets`` [B, S], an optional ``mask`` [B, S], and
    ``prefix_embeds`` / ``memory`` where the config takes them.  The
    metrics are float32 scalars ``loss``, ``aux_loss`` and ``grad_norm``
    (the norm before clipping)."""
    cfg = model.cfg
    model.requires_grad_(True)

    def loss_fn(batch):
        kwargs = {}
        if cfg.prefix_embed_len:
            kwargs["prefix_embeds"] = batch["prefix_embeds"]
        if cfg.cross_attn_memory_len:
            kwargs["memory"] = batch["memory"]
        out = model(batch["tokens"], remat=parallel.remat, parallel=parallel,
                    **kwargs)
        loss = cross_entropy(out.logits, batch["targets"], batch.get("mask"))
        return loss + out.aux_loss, loss, out.aux_loss

    def grads_of(params, batch):
        names = list(params)
        tot, loss, aux = loss_fn(batch)
        grads = torch.autograd.grad(tot, [params[k] for k in names])
        return dict(zip(names, grads)), loss.detach(), aux.detach()

    def train_step(params: dict, opt_state, batch: dict):
        dev = model.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        mb = parallel.microbatches
        if mb > 1:
            b = batch["tokens"].shape[0]
            if b % mb:
                raise ValueError(f"batch {b} is no multiple of "
                                 f"{mb} microbatches")
            parts = {k: v.reshape(mb, b // mb, *v.shape[1:])
                     for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(mb):
                g, l_i, a_i = grads_of(params, {k: v[i]
                                                for k, v in parts.items()})
                for k, gk in g.items():
                    grads[k].add_(gk.float())
                del g
                loss, aux = loss + l_i, aux + a_i
            grads = {k: g.div_(mb) for k, g in grads.items()}
            loss, aux = loss / mb, aux / mb
        else:
            grads, loss, aux = grads_of(params, batch)

        if parallel.compress_grads and parallel.pod_axis:
            if parallel.compress_int8:
                grads = _compress_pod_grads_int8(grads, parallel)
            else:
                grads = _compress_pod_grads(grads, parallel)

        params, opt_state, gnorm = tx.update(grads, opt_state, params)
        metrics = {"loss": loss, "aux_loss": aux, "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step
