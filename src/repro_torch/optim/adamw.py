"""AdamW with cosine schedule and global-norm clipping.

Counterpart of the reference's ``optim/adamw.py``: functional over a parameter
dict (name -> tensor), not ``torch.optim``.  First/second moments are kept in
fp32; parameters may be bf16.  Clip scale ``min(1, clip / max(gnorm, 1e-12))``,
decoupled weight decay added inside ``delta``.  The reference's ZeRO-1 sharding
of the moments waits for the parallel layer.

Where the reference returns new arrays (and the launcher donates the old ones),
:func:`adamw_update` updates the parameters and moments IN PLACE and returns the
same tensors: the values are the same, and a 545 M-entry embedding then needs
two fp32 temporaries at a time instead of five.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then cosine decay to ``min_lr_frac`` of it;
    fp32, on ``step``'s device."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.peak_lr + \
        (1 - cfg.min_lr_frac) * cfg.peak_lr * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor


def init_opt_state(params: dict) -> OptState:
    z = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for name, p in params.items()}
    dev = next(iter(params.values())).device if params else None
    return OptState(m=z, v={name: torch.zeros_like(t) for name, t in z.items()},
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: OptState,
                 cfg: AdamWConfig) -> tuple[dict, OptState, dict]:
    """One AdamW step.  Returns (params, new_state, metrics); ``params`` and the
    moments are updated in place (see the module docstring)."""
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        delta = m / b1c
        delta.div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(p.float(), alpha=cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float().sub_(delta))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(state.m, state.v, step), metrics
