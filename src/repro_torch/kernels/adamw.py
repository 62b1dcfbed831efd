"""Fused multi-tensor AdamW: the wrapper around ``csrc/adamw.cu``.

:func:`adamw_step` runs one AdamW step over lists of plain CUDA tensors (parameters,
gradients and float32 moments, updated in place) in a handful of launches: per
(parameter dtype, gradient dtype) group a sum of squares and an update, and one
launch between them that turns the sums into the global norm and the clip scale on
the card.  The learning rate and bias corrections come in as 0-d tensors on the card
(``optim.adamw.step_scalars``, the plain update's own).  Nothing waits for the card:
the leaves' addresses go to the kernels in their launch parameters, and the norm
comes back as a device scalar.

Its plain version is ``optim.adamw.plain_update``, which the CPU and every DTensor
(mesh, ZeRO-1, the dry run) take; ``optim.adamw.adamw_update`` chooses between them
by what the tensors are.  A CUDA tensor handed here launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build

#: as ``kSumsqBlocks`` and ``kMaxLeaves`` in ``csrc/adamw.cu`` (a test holds them to
#: it): the float64 partial sums a step writes, and the leaves a launch takes
SUMSQ_BLOCKS = 528
MAX_LEAVES = 80

#: kernels launched in this process: a step launches a sum of squares and an update
#: per table of at most MAX_LEAVES leaves of one (parameter, gradient) dtype pair,
#: and one clip launch (``ops.reset_launch_counts`` zeroes it)
launches = 0


def adamw_step(params: list, grads: list, ms: list, vs: list, lr: torch.Tensor,
               b1c: torch.Tensor, b2c: torch.Tensor, cfg) -> torch.Tensor:
    """One AdamW step of ``cfg`` (``optim.adamw.AdamWConfig``) with global-norm
    clipping, in place on ``params``, ``ms`` and ``vs``, at the learning rate ``lr``
    and the bias corrections ``b1c``, ``b2c`` (one float32 each on the card).
    Returns the gradients' global norm, a 0-d float32 tensor on the card."""
    global launches
    n = len(params)
    if not n or not len(grads) == len(ms) == len(vs) == n:
        raise ValueError(f"adamw: {n} parameters, {len(grads)} gradients, {len(ms)} and "
                         f"{len(vs)} moments")
    dev = params[0].get_device()
    if dev < 0:
        raise ValueError(f"adamw: the fused step takes CUDA tensors, got {params[0].device}")
    rows, keep = [], []     # keep: contiguous copies of strided gradients
    for i, (p, g, m, v) in enumerate(zip(params, grads, ms, vs)):
        if isinstance(p, DTensor) or isinstance(g, DTensor) or isinstance(m, DTensor) \
                or isinstance(v, DTensor):
            raise TypeError("adamw: the fused step takes plain tensors; DTensors take "
                            "optim.adamw.plain_update")
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"adamw: leaf {i}: p {tuple(p.shape)}, g {tuple(g.shape)}, m "
                             f"{tuple(m.shape)}, v {tuple(v.shape)} do not match")
        # get_device() is -1 on the CPU
        if not p.get_device() == g.get_device() == m.get_device() == v.get_device() == dev:
            raise ValueError(f"adamw: leaf {i}: p on {p.device}, g on {g.device}, m on "
                             f"{m.device}, v on {v.device}; all must be on cuda:{dev}")
        pcode, gcode = _build.DTYPE_CODES.get(p.dtype), _build.DTYPE_CODES.get(g.dtype)
        if pcode is None or gcode is None or m.dtype != torch.float32 \
                or v.dtype != torch.float32:
            raise TypeError(f"adamw: leaf {i}: unsupported dtypes p {p.dtype}, g {g.dtype},"
                            f" m {m.dtype}, v {v.dtype} (moments must be float32)")
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError(f"adamw: leaf {i}: p, m and v must be contiguous")
        if not g.is_contiguous():
            g = g.contiguous()
            keep.append(g)
        rows.append((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                     pcode, gcode))
    for name, x in (("lr", lr), ("b1c", b1c), ("b2c", b2c)):
        if x.dtype != torch.float32 or x.numel() != 1 or x.get_device() != dev:
            raise ValueError(f"adamw: the step's scalar {name} must be one float32 on "
                             f"cuda:{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    lib = _build.load()
    table = np.array(rows, dtype=np.int64)
    device = params[0].device
    partials = torch.empty(SUMSQ_BLOCKS, dtype=torch.float64, device=device)
    out = torch.empty(2, dtype=torch.float32, device=device)   # norm, clip scale
    call = _build.AdamwCall(
        leaves=table.ctypes.data, partials=partials.data_ptr(), out=out.data_ptr(),
        lr=lr.data_ptr(), b1c=b1c.data_ptr(), b2c=b2c.data_ptr(),
        stream=torch._C._cuda_getCurrentRawStream(dev), n_leaves=n,
        partials_len=SUMSQ_BLOCKS, b1=cfg.b1, one_minus_b1=1 - cfg.b1, b2=cfg.b2,
        one_minus_b2=1 - cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay,
        clip=cfg.clip_norm, device=dev)
    code = lib.repro_adamw_step(ctypes.addressof(call))
    launches += call.launched
    if code:
        _build.check(code, "adamw")
    return out[0]
