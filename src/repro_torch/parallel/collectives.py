"""Explicit collective schedules (paper §2.3 Fig. 3) and gradient compression
(the reference's ``parallel/collectives.py``) over ``torch.distributed``.

The paper's decomposition argument -- all-reduce = reduce-scatter + all-gather
removes the single-root bottleneck -- maps onto ``dist.reduce_scatter_tensor``
followed by ``dist.all_gather_into_tensor``.  The main train step gets the same
schedule implicitly through ZeRO-1 (the optimizer moments sharded over "data":
DTensor reduce-scatters the gradients onto them and all-gathers the parameters);
these explicit versions serve the Fig. 3 tool (``tools/fig3_allreduce_torch.py``)
and the gradient-compression path (int8 with error feedback, an extension beyond
the paper for the slow inter-node edge).

Each primitive takes the process group of one mesh axis
(``mesh.get_group(axis)`` on a ``launch.mesh`` ``DeviceMesh``), where the
reference names the axis inside ``shard_map``; :func:`sync_grads` takes the mesh
and the axis name, as the reference's does.  Gradients arrive as plain local
tensors, replicated across the axis: a DTensor is refused, never gathered
silently.  Every function returns new tensors and leaves its inputs as they are.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten, tree_unflatten

Pytree = Any
SCHEDULES = ("allreduce", "rs_ag", "int8")


def _plain(x: torch.Tensor) -> torch.Tensor:
    if isinstance(x, DTensor):
        raise TypeError("the collectives take plain local tensors; pass "
                        "x.to_local() (or x.full_tensor()) explicitly")
    return x


# -- one tensor over one group --------------------------------------------------


def allreduce_naive(x: torch.Tensor, group=None) -> torch.Tensor:
    """Single fused all-reduce, SUM (the baseline schedule)."""
    out = _plain(x).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def allreduce_decomposed(x: torch.Tensor, group=None) -> torch.Tensor:
    """reduce-scatter + all-gather over the leading dim (Fig. 3 right).

    Requires ``dim0 % group size == 0`` -- the caller pads (see
    :func:`sync_grads`)."""
    x = _plain(x).contiguous()
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} is not a multiple of the group's "
                         f"{n} ranks: pad it first")
    part = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(part, x, op=dist.ReduceOp.SUM, group=group)
    out = torch.empty_like(x)
    dist.all_gather_into_tensor(out, part, group=group)
    return out


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's formula: ``scale = max|x| / 127 + 1e-12``, ``q =
    clip(round(x / scale), -127, 127)`` as int8 (``torch.round`` rounds half to
    even, as ``jnp.round`` does)."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def allreduce_int8(x: torch.Tensor, group=None,
                   err: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8-compressed all-reduce with error feedback.

    Wire volume drops 4x in the planner's cost model; here the numerics are kept
    faithful as in the reference: quantize locally, sum the dequantized values
    (the wire still carries ``x.dtype``), and return the quantization residual
    as the new ``err`` to be added back next step."""
    x = _plain(x)
    g = x + _plain(err) if err is not None else x
    q, scale = _quantize_int8(g)
    deq = q.to(x.dtype) * scale
    new_err = g - deq
    return allreduce_naive(deq, group), new_err


# -- tree-level gradient sync --------------------------------------------------------


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def sync_grads(grads: Pytree, mesh, axis: str = "data", *,
               schedule: str = "rs_ag",
               err: Pytree | None = None) -> tuple[Pytree, Pytree | None]:
    """Mean-reduce ``grads`` (a tree of plain tensors, replicated across ``axis``
    of ``mesh``) with an explicit schedule.

    schedule: ``"allreduce" | "rs_ag" | "int8"``.  Returns ``(grads, new_err)``;
    ``new_err`` is ``None`` but for ``"int8"``, whose ``err`` is the error
    feedback state (a tree like ``grads``; zeros when ``None``)."""
    if schedule not in SCHEDULES:
        raise ValueError(schedule)
    group = mesh.get_group(axis)
    n = _axis_size(mesh, axis)
    leaves, spec = tree_flatten(grads)
    errs = tree_flatten(err)[0] if err is not None else [None] * len(leaves)
    synced, new_err = [], []
    for g, e in zip(leaves, errs):
        g = _plain(g)
        if schedule == "allreduce":
            synced.append(allreduce_naive(g, group) / n)
        elif schedule == "rs_ag":
            flat = g.reshape(-1)
            pad = (-flat.shape[0]) % n
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            out = allreduce_decomposed(flat, group) / n
            synced.append(out[:flat.shape[0] - pad].reshape(g.shape))
        else:
            s, ne = allreduce_int8(g, group, e)
            synced.append(s / n)
            new_err.append(ne)
    return (tree_unflatten(synced, spec),
            tree_unflatten(new_err, spec) if schedule == "int8" else None)
