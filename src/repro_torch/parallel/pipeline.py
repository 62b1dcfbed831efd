"""Pipeline parallelism with uneven (planner-chosen) stages (the reference's
``parallel/pipeline.py``) over ``torch.distributed`` point-to-point ops.

The planner assigns *contiguous layer counts per stage* (possibly uneven -- its
heterogeneity mechanism, paper §4.1).  Every rank of a "pipe" mesh axis runs the
same program, so uneven stages are expressed by padding every stage to
``max_layers`` and masking the padding layers to identity:

  stage_params: tree with leading ``(n_stages, max_layers, ...)``; each rank
  applies only its own stage, ``stage_params[rank]``.  layer_mask:
  ``(n_stages, max_layers)`` bool.

Schedule: the reference's GPipe tick loop.  At tick ``t`` rank ``s`` computes
microbatch ``t - s``; its output goes to rank ``s + 1`` through
:class:`_ShiftNext`, an autograd function whose backward is the reverse shift,
the transpose JAX derives for ``lax.ppermute`` by itself.  Autograd runs on each
rank's own graph, so every rank's backward must reach its stages: as in the
reference, a rank's first stage reads ``where(rank == 0, x, received)`` and its
outputs are ``where(last rank and a valid tick, h, outputs)``, which ties every
tick into each rank's graph and gives warm-up and drain ticks' garbage a zero
cotangent.  Every rank then runs its shifts' backwards in the same reverse tick
order.  The last rank's collected outputs reach every rank through
:class:`_Deliver`.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

Pytree = Any


def pad_stages(per_layer_params: Pytree, sizes: list[int]
               ) -> tuple[Pytree, torch.Tensor]:
    """Regroup a per-layer stacked tree ``(L, ...)`` into padded stages.

    Returns ``(stage_params (S, Lmax, ...), layer_mask (S, Lmax))``."""
    S = len(sizes)
    Lmax = max(sizes)
    starts = [sum(sizes[:i]) for i in range(S)]

    def regroup(x):
        out = []
        for s in range(S):
            sl = x[starts[s]:starts[s] + sizes[s]]
            pad = x.new_zeros((Lmax - sizes[s], *x.shape[1:]))
            out.append(torch.cat([sl, pad], dim=0))
        return torch.stack(out)

    mask = torch.stack([torch.arange(Lmax) < s for s in sizes])
    return tree_map(regroup, per_layer_params), mask


def _exchange(send: torch.Tensor, to: int | None, frm: int | None, group) -> torch.Tensor:
    """Send ``send`` to global rank ``to`` and receive a tensor like it from
    ``frm`` (zeros where there is no peer), in one ``batch_isend_irecv``."""
    recv = torch.zeros_like(send)
    ops = []
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, recv, frm, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


class _ShiftNext(torch.autograd.Function):
    """``lax.ppermute`` over ``[(i, i + 1)]``: each rank sends ``h`` to the next
    stage and returns what the previous one sent (zeros on the first); the
    backward sends the cotangent back to the previous stage and returns the one
    the next stage sent (zeros on the last)."""

    @staticmethod
    def forward(ctx, h, nxt, prv, group):
        ctx.peers = (nxt, prv, group)
        return _exchange(h, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        nxt, prv, group = ctx.peers
        return _exchange(g, prv, nxt, group), None, None, None


class _Deliver(torch.autograd.Function):
    """The last stage's outputs on every rank (a broadcast from it).  The result
    is one value replicated on every rank, and each rank's loss on it is the
    same loss, so the backward hands the last stage its own cotangent and the
    others zeros: a summing transpose (an all-reduce) would count the loss once
    per rank, ``S`` times over."""

    @staticmethod
    def forward(ctx, outs, src, is_src, group):
        ctx.is_src = is_src
        buf = outs.clone() if is_src else torch.empty_like(outs)
        dist.broadcast(buf, src, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None, None


def pipeline_forward(layer_fn: Callable, stage_params: Pytree,
                     layer_mask: torch.Tensor, x_mb: torch.Tensor, *,
                     mesh, axis: str = "pipe") -> torch.Tensor:
    """Run microbatches through the pipeline.

    ``x_mb``: ``(M, mb, ...)`` microbatched inputs (the same on every pipe rank;
    only stage 0 reads them).  ``layer_fn(params_of_one_layer, h) -> h``.
    Returns ``(M, mb, ...)`` outputs on every rank (computed on the last).
    """
    group = mesh.get_group(axis)
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)
    M = x_mb.shape[0]
    nxt = dist.get_global_rank(group, sid + 1) if sid < S - 1 else None
    prv = dist.get_global_rank(group, sid - 1) if sid > 0 else None
    params = tree_map(lambda a: a[sid], stage_params)       # local (Lmax, ...)
    mask = layer_mask[sid].to(x_mb.device)
    Lmax = mask.shape[0]
    first = torch.tensor(sid == 0, device=x_mb.device)

    def stage_apply(h):
        for i in range(Lmax):
            out = layer_fn(tree_map(lambda a: a[i], params), h)
            h = torch.where(mask[i], out, h)
        return h

    state = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(M)]
    # tick t: rank s computes microbatch m = t - s (garbage flows through
    # warm-up and drain ticks but is never stored)
    for t in range(M + S - 1):
        h = torch.where(first, x_mb[min(t, M - 1)], state)
        h = stage_apply(h)
        out_idx = t - (S - 1)
        ok = torch.tensor(sid == S - 1 and 0 <= out_idx < M, device=h.device)
        ci = min(max(out_idx, 0), M - 1)
        # a where on every rank, as in the reference: each rank's outputs hang on
        # its own stages, so every rank's backward runs its stages and its shifts
        outs[ci] = torch.where(ok, h, outs[ci])
        if S > 1:
            state = _ShiftNext.apply(h, nxt, prv, group)
    out = torch.stack(outs)
    if S == 1:
        return out
    # deliver the collected outputs from the last rank to every rank
    return _Deliver.apply(out, dist.get_global_rank(group, S - 1), sid == S - 1, group)
