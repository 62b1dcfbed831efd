"""The initial parameters of a cell, made from the seed on the device.

Every normally drawn parameter is a slice of one ``torch.randn`` call of all their
entries together, in the parameter type, on a ``torch.Generator`` of the device,
scaled in place; the rest are ones or zeros.  The same seed on the same device gives
the same values, so the reference draws its copy again after the program's state is
gone instead of holding one through the window.  :func:`project` draws, on a stream of
its own, the fixed directions that both sides project the first gradient on.
"""

from __future__ import annotations

import math
from typing import Iterator

import torch

from harness.reference import DTYPES, ParamSpec


#: mixed into the seed for the stream of :func:`project`'s directions, apart from the
#: weights'
DIRECTIONS = 0x2545F4914F6CDD1D


def _seed(seed: int) -> int:
    """``--seed`` as a generator seed (any whole number; negatives folded in)."""
    return seed % (1 << 63)


def draw(specs: list[ParamSpec], seed: int, dtype: torch.dtype,
         device) -> Iterator[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for every parameter, in ``specs`` order.  The normal ones
    are views of one buffer, which lives as long as any of them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed))
    total = sum(math.prod(s.shape) for s in specs if s.init == "normal")
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    at = 0
    for s in specs:
        n = math.prod(s.shape)
        if s.init == "normal":
            yield s.name, flat[at:at + n].view(s.shape).mul_(s.scale)
            at += n
        elif s.init == "ones":
            yield s.name, torch.ones(s.shape, dtype=dtype, device=device)
        else:
            yield s.name, torch.zeros(s.shape, dtype=dtype, device=device)


@torch.no_grad()
def fill(params: dict[str, torch.Tensor], specs: list[ParamSpec], seed: int) -> None:
    """Write the seed's values into the program's own parameters (name -> tensor),
    which must be exactly the parameters ``specs`` lists, in its type."""
    want = {s.name: s.shape for s in specs}
    have = {n: tuple(p.shape) for n, p in params.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))
        raise ValueError(f"the program's parameters differ from the configuration's: {diff}")
    dtype = next(iter(params.values())).dtype
    device = next(iter(params.values())).device
    for name, value in draw(specs, seed, dtype, device):
        params[name].copy_(value)


def initial(cfg: dict, specs: list[ParamSpec], seed: int, device) -> dict[str, torch.Tensor]:
    """The seed's parameters in the configuration's parameter type (the
    reference's copy)."""
    return dict(draw(specs, seed, DTYPES[cfg["param_dtype"]], device))


@torch.no_grad()
def project(tensors: dict[str, torch.Tensor], seed: int) -> dict[str, float]:
    """``<r, t>`` for every tensor (name -> tensor, all on one device): ``r`` a fixed
    standard normal direction of the tensor's shape, in float32, drawn from the
    seed on a stream of its own, one tensor at a time in the order of the names.
    The same seed, names and shapes on the same device give the same directions,
    whatever order the dict holds them in."""
    device = next(iter(tensors.values())).device
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed) ^ DIRECTIONS)
    out = {}
    for name in sorted(tensors):
        t = tensors[name]
        r = torch.randn(t.numel(), generator=gen, dtype=torch.float32, device=device)
        out[name] = float(torch.dot(r, t.detach().reshape(-1).float()))
        del r                                   # one direction held at a time
    return out
