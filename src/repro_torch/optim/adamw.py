"""AdamW with cosine schedule and global-norm clipping.

Counterpart of the reference's ``optim/adamw.py``: functional over a parameter
dict (name -> tensor), not ``torch.optim``.  First/second moments are kept in
fp32; parameters may be bf16.  Clip scale ``min(1, clip / max(gnorm, 1e-12))``,
decoupled weight decay added inside ``delta``.

On a mesh the parameters, gradients and moments are DTensors, and the moments
may be sharded where the parameters are not (ZeRO-1: ``opt_rules`` shard the
"fsdp" dims over "data").  The update then runs in the moments' placements: each
gradient is redistributed onto its moments (a pending sum becomes a
reduce-scatter), and the step is redistributed onto the parameter's placements
(an all-gather) before it is applied, so that the new parameters keep the
parameters' placements and the moments theirs, as the reference's
``out_shardings`` force.

Where the reference returns new arrays (and the launcher donates the old ones),
:func:`adamw_update` updates the parameters and moments IN PLACE and returns the
same tensors: the values are the same, and a 545 M-entry embedding then needs
two fp32 temporaries at a time instead of five (:func:`plain_update`), or none
(the fused kernels).

On one card (plain CUDA tensors) the update is the fused multi-tensor kernels of
``kernels/adamw.py``: a sum of squares and an update pass over every leaf, with the
global norm and clip scale computed on the card between them, in place of ~20
PyTorch launches a leaf.  :func:`plain_update` is the same arithmetic in PyTorch
operations, for the CPU and for DTensors.  Both take the step count, learning rate
and bias corrections from :func:`step_scalars`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.kernels import adamw as fused_adamw
from repro_torch.obs import NULL_OBS, Obs


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


def step_scalars(cfg: AdamWConfig, step: torch.Tensor):
    """The step count after the step (``step`` + 1), its learning rate and the bias
    corrections ``1 - b1**t``, ``1 - b2**t``: 0-d tensors on ``step``'s device, the
    last three float32."""
    step = step + 1
    t = step.to(torch.float32)
    return step, cosine_lr(cfg, step), 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor


def init_opt_state(params: dict, shardings: dict | None = None) -> OptState:
    """Zeroed fp32 moments, one pair a parameter, and step 0.  ``shardings``
    (parameter name -> ``NamedSharding``) makes the moments DTensors under
    those placements (the parameters may be placed otherwise: ZeRO-1)."""
    def zeros(name, p):
        if shardings is None:
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        sh = shardings[name]
        return dtensor_zeros(p.shape, dtype=torch.float32, device_mesh=sh.mesh,
                             placements=list(sh.placements))
    dev = next(iter(params.values())).device if params else None
    return OptState(m={n: zeros(n, p) for n, p in params.items()},
                    v={n: zeros(n, p) for n, p in params.items()},
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in fp32 (a plain tensor, also
    for DTensors).  On a mesh each rank adds up its local shards' sums of
    squares, each divided by the number of ranks that hold the same shard (the
    product of its replicated mesh dims), so that the sum over every rank of the
    mesh is the whole: one reduction over the mesh (an all-reduce per mesh dim)
    for all the tensors, not one a tensor."""
    parts, pending = [], {}
    for x in tensors:
        if not isinstance(x, DTensor):
            parts.append(torch.sum(torch.square(x.float())))
            continue
        mesh = x.device_mesh
        if any(p.is_partial() for p in x.placements):
            x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in x.placements])
        copies = math.prod(mesh.size(d) for d, p in enumerate(x.placements)
                           if not p.is_shard())
        local = torch.sum(torch.square(x.to_local().float()))
        if copies > 1:
            local = local / copies
        pending[mesh] = pending[mesh] + local if mesh in pending else local
    for mesh, local in pending.items():
        whole = DTensor.from_local(local, mesh, [Partial()] * mesh.ndim)
        for d in range(mesh.ndim):          # a mesh dim at a time, as DTensor would
            whole = whole.redistribute(mesh, [Replicate()] * (d + 1)
                                       + [Partial()] * (mesh.ndim - d - 1))
        parts.append(whole.to_local())
    return torch.sqrt(sum(parts))


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` in ``ref``'s placements (a plain tensor as it is)."""
    if isinstance(t, DTensor) and tuple(t.placements) != tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def _fusable(params: dict, grads: dict, state: OptState) -> bool:
    """Whether the fused kernels take this step: every tensor a plain one on the
    card.  DTensors (a mesh, ZeRO-1, the dry run) and CPU tensors take
    :func:`plain_update`."""
    first = next(iter(params.values()), None)
    if first is None or any(isinstance(t, DTensor) for tree in (params, grads, state.m,
                                                                 state.v)
                            for t in tree.values()):
        return False
    return first.is_cuda


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: OptState, cfg: AdamWConfig,
                 obs: Obs = NULL_OBS) -> tuple[dict, OptState, dict]:
    """One AdamW step.  Returns (params, new_state, metrics); ``params`` and the
    moments are updated in place (see the module docstring).  Plain CUDA tensors
    take the fused kernels (``kernels/adamw.py``), anything else
    :func:`plain_update`; ``obs`` counts the leaves each took
    (``optim.adamw.fused_leaves``, ``optim.adamw.plain_leaves``)."""
    if _fusable(params, grads, state):
        obs.inc("optim.adamw.fused_leaves", len(params))
        names = list(params)
        step, lr, b1c, b2c = step_scalars(cfg, state.step)
        gnorm = fused_adamw.adamw_step(
            [params[n] for n in names], [grads[n] for n in names],
            [state.m[n] for n in names], [state.v[n] for n in names], lr, b1c, b2c, cfg)
    else:
        obs.inc("optim.adamw.plain_leaves", len(params))
        gnorm, lr, step = plain_update(params, grads, state, cfg)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(state.m, state.v, step), metrics


@torch.no_grad()
def plain_update(params: dict, grads: dict, state: OptState,
                 cfg: AdamWConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The update leaf by leaf in PyTorch operations, in place on ``params`` and
    ``state``'s moments; returns the global norm, the step's learning rate and the
    new step count.  What the fused kernels are held against."""
    grads = {name: _like(g, state.m[name]) for name, g in grads.items()}
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step, lr, b1c, b2c = step_scalars(cfg, state.step)
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        delta = m / b1c
        delta.div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(_like(p.float(), m), alpha=cfg.weight_decay).mul_(lr)
        delta = _like(delta, p)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float().sub_(delta))
    return gnorm, lr, step
