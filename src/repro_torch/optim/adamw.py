"""AdamW (decoupled weight decay) over a dict of named parameters.

Counterpart of ``repro.optim.adamw`` (``AdamWState``, ``AdamW``,
``cosine_schedule``).  The reference's pytree functions become functions
of ``{name: tensor}`` dicts (the port's ``Transformer.named_parameters()``;
``convert.adamw_state_to_numpy`` keys the state as the reference's
parameter tree).  Every quantity is computed as the reference computes it:
m and v are float32 whatever the parameter's dtype, ``step`` is an int32
tensor, the bias corrections are float32 powers (``1 - b1 ** step`` with
both in float32, not a Python double), the learning rate is a float32
tensor, and the update is cast back to the parameter's dtype.

The port updates in place, under ``no_grad``: ``update`` writes the new
parameters into the given tensors and the new moments into the given
state's m and v (the state passed in is consumed; the returned one holds
the same tensors and the next step).  At full width that keeps one copy of
the 16 GB of weights, moments and gradients of gemma3-1b.

The global norm sums each leaf's float32 sum of squares in sorted name
order; the reference sums in ``jax.tree.leaves`` order (its sorted keys,
with a block's periods stacked into one leaf).  Both are float32 sums in
another order, so the norms agree to float32 rounding (the tests hold
them to 1e-5 relative).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: dict                 # name -> float32 tensor
    v: dict


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: dict) -> AdamWState:
        """Zero float32 moments beside each parameter; step 0."""
        dev = next(iter(params.values())).device

        def z(p):   # a DTensor parameter gets a DTensor moment, laid out alike
            return torch.zeros_like(p, dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m={k: z(p) for k, p in params.items()},
                          v={k: z(p) for k, p in params.items()})

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        return (self.lr(step) if callable(self.lr)
                else _f32(self.lr, step.device))

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict):
        """-> (params, new state, the raw global gradient norm).  ``grads``
        and ``params`` share their keys; both are read, the parameters and
        the state's moments written in place."""
        dev = state.step.device
        if self.grad_clip:
            gn = torch.zeros((), dtype=torch.float32, device=dev)
            for name in sorted(grads):
                g = grads[name].float()
                gn = gn + (g * g).sum()
            gn = torch.sqrt(gn)
            scale = torch.minimum(_f32(1.0, dev),
                                  self.grad_clip / (gn + 1e-9))
        else:
            gn, scale = torch.zeros((), dtype=torch.float32, device=dev), None
        step = state.step + 1
        b1, b2 = _f32(self.b1, dev), _f32(self.b2, dev)
        c1, c2 = _f32(1 - self.b1, dev), _f32(1 - self.b2, dev)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = self._lr(step)
        wd, eps = _f32(self.weight_decay, dev), _f32(self.eps, dev)
        for name, p in params.items():
            g = grads[name].float()
            if scale is not None:
                g = g * scale
            m, v = state.m[name], state.v[name]
            m.copy_(b1 * m + c1 * g)
            v.copy_(b2 * v + c2 * g * g)
            p32 = p.float()
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + wd * p32
            p.copy_((p32 - lr * u).to(p.dtype))
        return params, AdamWState(step=step, m=state.m, v=state.v), gn


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine to
    ``floor_frac * peak_lr`` at ``total``: step (int tensor) -> float32
    learning rate, in the reference's float32 operations."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        dev = step.device
        s = step.float()
        warm = _f32(peak_lr, dev) * s / _f32(max(1, warmup), dev)
        t = torch.clamp((s - _f32(warmup, dev))
                        / _f32(max(1, total - warmup), dev), 0.0, 1.0)
        cos = _f32(peak_lr, dev) * (
            _f32(floor_frac, dev) + _f32((1 - floor_frac) * 0.5, dev)
            * (1 + torch.cos(_f32(math.pi, dev) * t)))
        return torch.where(s < warmup, warm, cos)
    return lr
