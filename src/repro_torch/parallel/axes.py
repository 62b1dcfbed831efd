"""Logical->physical axis mapping with divisibility fallback, over DTensor.

Counterpart of the reference's ``parallel/axes.py``.  Models annotate every
parameter and key activation with *logical* axis names ("batch", "heads",
"mlp", ...).  An :class:`AxisRules` table maps logical names onto physical mesh
axes ("pod", "data", "model").  The mapping is the hook through which a
:class:`repro_torch.core.plans.ParallelPlan` steers the sharding: the planner's
choices (TP on heads vs sequence, ZeRO-3 on the data axis, EP on the model axis)
are expressed as rule-table edits.  Where the reference hands the resulting
``PartitionSpec`` to GSPMD, the port turns it into DTensor placements over a
``DeviceMesh`` (:meth:`AxisRules.placements`), and DTensor's sharding
propagation emits the collectives.

Divisibility fallback: a logical dim whose size is not divisible by the mapped
mesh-axis extent is replicated for that dim (e.g. qwen2's 28 query heads on an
8-way model axis), exactly as the reference's ``spec`` decides.

:class:`NamedSharding` (a mesh and its placements) is the leaf of every sharding
tree; :func:`distribute` places a state tree under such a tree, and :func:`full`
gathers one back, so that the checkpoint layer needs nothing of the model's.

A mesh here is anything with named axes and their sizes: a torch
``DeviceMesh`` (``mesh_dim_names`` and ``shape``), or an object whose ``shape``
is a ``{axis: size}`` mapping (what the reference's ``spec`` reads of a JAX
``Mesh``), or such a mapping itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

# A logical->physical entry maps a logical axis name to one physical mesh axis
# or a tuple of them (major-to-minor).
Physical = tuple[str, ...]

DEFAULT_RULES: dict[str, Physical] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),                 # query sequence: unsharded by default
    "seq_shard": ("model",),   # context-parallel fallback for attention
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_mlp": ("data",),   # 2-D expert TP (see layers.moe_defs)
    "expert_in": (),
    "kv_seq": (),              # kv cache length (split-KV decode may shard)
    # parameters
    "fsdp": ("data",),         # ZeRO-3 dim when plan.zero3 (else remapped to ())
    "layers": (),
    "conv": (),
    "state": (),
}


class PartitionSpec(tuple):
    """One entry per tensor dim (trailing unsharded dims dropped): ``None``, a
    mesh axis name, or a tuple of them, major to minor -- the entries of JAX's
    ``PartitionSpec``, which also stores a one-axis tuple as the bare name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1
                                     else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh: Any) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, of an object whose ``shape`` is
    such a mapping, or of the mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and one DTensor placement per mesh dim: the counterpart of JAX's
    ``NamedSharding``, the leaf of the sharding trees in ``parallel.sharding``."""

    mesh: Any
    placements: tuple


def place(leaf: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """``leaf`` as a DTensor under ``sh``: a plain tensor is split from its full
    value (the same on every rank), a DTensor on ``sh``'s mesh redistributed,
    one on another mesh gathered and split anew."""
    if isinstance(leaf, DTensor):
        if leaf.device_mesh == sh.mesh:
            return leaf.redistribute(sh.mesh, sh.placements)
        leaf = leaf.full_tensor()
    return distribute_tensor(leaf.to(sh.mesh.device_type), sh.mesh,
                             list(sh.placements))


def distribute(tree: Any, shardings: Any) -> Any:
    """``tree``'s tensors placed (:func:`place`) under ``shardings``, a tree of
    the same structure whose leaves are :class:`NamedSharding` objects."""
    if isinstance(tree, torch.Tensor):
        return place(tree, shardings)
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(getattr(tree, f), getattr(shardings, f))
                            for f in tree._fields))
    return type(tree)(distribute(v, sh) for v, sh in zip(tree, shardings))


def full(tree: Any) -> Any:
    """``tree`` with every DTensor gathered to its full value (a plain tensor on
    each rank); other leaves as they are."""
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: full(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(full(getattr(tree, f)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(full(v) for v in tree)
    return tree


@dataclass(frozen=True)
class AxisRules:
    """Immutable rule table; planners derive edited copies."""

    rules: Mapping[str, Physical] = field(default_factory=lambda: dict(DEFAULT_RULES))

    def updated(self, **edits: Physical) -> "AxisRules":
        r = dict(self.rules)
        r.update(edits)
        return AxisRules(r)

    def physical(self, logical: str | None) -> Physical:
        if logical is None:
            return ()
        if logical not in self.rules:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.rules[logical]

    # -- spec building ---------------------------------------------------------

    def spec(self, logical_axes: Sequence[str | None],
             shape: Sequence[int] | None = None, mesh: Any = None) -> P:
        """PartitionSpec for a tensor annotated with logical axes.

        With ``shape``+``mesh``, drops mesh axes that do not divide the dim
        (divisibility fallback) and axes absent from the mesh (e.g. "pod" on
        the single-pod mesh).
        """
        sizes = mesh_shape(mesh) if mesh is not None else None
        entries: list[tuple[str, ...] | None] = []
        used: set[str] = set()
        for i, name in enumerate(logical_axes):
            phys = [a for a in self.physical(name) if a not in used]
            if sizes is not None:
                phys = [a for a in phys if a in sizes]
            if shape is not None and sizes is not None and phys:
                extent = math.prod(sizes[a] for a in phys)
                while phys and shape[i] % extent != 0:
                    phys.pop()           # drop minor-most until divisible
                    extent = math.prod(sizes[a] for a in phys) if phys else 1
            used.update(phys)
            entries.append(tuple(phys) if phys else None)
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    def placements(self, logical_axes: Sequence[str | None],
                   shape: Sequence[int], mesh: Any) -> tuple:
        """The spec as DTensor placements over ``mesh``: per mesh dim ``Shard(i)``
        for the tensor dim ``i`` it shards, else ``Replicate()``.  A tensor dim
        on two mesh axes (``"batch"`` -> ``("pod", "data")``) is ``Shard(i)`` on
        both, which DTensor splits in mesh-dim order: the mesh's axes must then
        be in the spec's major-to-minor order (they are for every built mesh)."""
        names = list(mesh_shape(mesh))
        out: list = [Replicate()] * len(names)
        for i, entry in enumerate(self.spec(logical_axes, shape, mesh)):
            if entry is None:
                continue
            dims = [names.index(a) for a in ((entry,) if isinstance(entry, str)
                                             else entry)]
            if dims != sorted(dims):
                raise ValueError(f"mesh axes {entry} of tensor dim {i} are not in "
                                 f"the mesh's order {tuple(names)}")
            for m in dims:
                out[m] = Shard(i)
        return tuple(out)

    def sharding(self, logical_axes: Sequence[str | None],
                 shape: Sequence[int], mesh: Any) -> NamedSharding:
        return NamedSharding(mesh, self.placements(logical_axes, shape, mesh))

    def shardable(self, logical: str, size: int, mesh: Any) -> bool:
        sizes = mesh_shape(mesh)
        phys = [a for a in self.physical(logical) if a in sizes]
        extent = math.prod(sizes[a] for a in phys) if phys else 1
        return extent > 1 and size % extent == 0


# ---------------------------------------------------------------------------
# Activation-constraint helper
# ---------------------------------------------------------------------------

# Set by `use_rules(mesh, rules)`; empty => `shard` is a no-op (one device).
_ACTIVE: list[tuple[Any, AxisRules]] = []


class use_rules:
    """Context manager activating sharding constraints inside model code."""

    def __init__(self, mesh: Any, rules: AxisRules | None = None):
        self.pair = (mesh, rules or AxisRules()) if mesh is not None else None

    def __enter__(self):
        if self.pair is not None:
            _ACTIVE.append(self.pair)  # type: ignore[arg-type]
        return self

    def __exit__(self, *exc):
        if self.pair is not None:
            _ACTIVE.pop()
        return False


def shard(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """Constrain an activation to its logical axes: a DTensor is redistributed
    to the active rules' placements (a ``Partial`` sum is reduced on the way);
    a no-op without an active mesh or for a plain tensor."""
    if not _ACTIVE or not isinstance(x, DTensor):
        return x
    mesh, rules = _ACTIVE[-1]
    want = rules.placements(logical_axes, x.shape, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def active_rules() -> tuple[Any, AxisRules] | None:
    return _ACTIVE[-1] if _ACTIVE else None
