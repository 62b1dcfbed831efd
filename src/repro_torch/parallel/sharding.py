"""Plan -> DTensor sharding bridge (the reference's ``parallel/sharding.py``).

Turns a :class:`repro_torch.core.plans.ParallelPlan` (or a per-arch default)
into the :class:`AxisRules` table and the concrete sharding trees the trainer
places its state with.  This is where the paper's planning decisions become
DTensor layouts:

  * TP on heads/mlp/vocab/experts        -> "model" axis rules
  * ZeRO-3 / FSDP parameter sharding     -> "fsdp" -> ("data",)
  * ZeRO-1 (decomposed grad sync, Fig.3) -> optimizer moments sharded over
    "data" even when parameters are replicated; the update then reduce-scatters
    the gradients onto the moments and all-gathers the new parameters
    (``optim.adamw``) instead of all-reducing.
  * GQA / head-count misalignment        -> divisibility fallback (replicate)
    plus split-KV decode (shard the cache length dim instead).

The trees have the reference's layouts: :func:`param_shardings` and
:func:`opt_state_shardings` follow ``LM.param_axes()`` (``pos{p}`` stacked),
:func:`cache_shardings` ``LM.cache_axes()``; each leaf is a
:class:`~repro_torch.parallel.axes.NamedSharding`.  :func:`module_shardings`
re-keys a parameter tree by the module's own parameter names (one per layer),
which is how the port's train state is keyed.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import is_stacked, target_names
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import OptState
from repro_torch.parallel.axes import AxisRules, NamedSharding, mesh_shape, place

Pytree = Any


@dataclass(frozen=True)
class ShardingProfile:
    """Arch x mesh-resolved sharding decisions (derived from a ParallelPlan)."""

    rules: AxisRules          # parameter + activation rules
    opt_rules: AxisRules      # optimizer-moment rules (ZeRO-1 default)
    zero3: bool
    notes: tuple[str, ...] = ()


def profile_for(cfg: ArchConfig, mesh: Any, *, zero3: bool = True,
                zero1: bool = True,
                shard_kv_seq: bool | None = None) -> ShardingProfile:
    """Resolve the sharding profile for an architecture on a mesh.

    ``zero3`` shards parameters' "fsdp" dims over the data axis; ``zero1``
    shards only optimizer moments.  ``shard_kv_seq`` forces split-KV decode; by
    default it turns on exactly when kv heads do not divide the model axis.
    """
    notes = []
    model_extent = mesh_shape(mesh).get("model", 1)
    rules = AxisRules()
    if not zero3:
        rules = rules.updated(fsdp=())
        notes.append("megatron-style: params TP-sharded only (no FSDP)")
    if shard_kv_seq is None:
        shard_kv_seq = cfg.n_kv_heads % model_extent != 0
    if shard_kv_seq:
        rules = rules.updated(kv_seq=("model",))
        notes.append(f"split-KV decode: kv_heads={cfg.n_kv_heads} not "
                     f"divisible by model={model_extent}; cache length "
                     "sharded over model axis")
    if cfg.n_heads % model_extent != 0:
        notes.append(f"q heads {cfg.n_heads} not divisible by model axis "
                     f"{model_extent}: attention projections replicated "
                     "(divisibility fallback); consider pad_heads")
    opt_rules = rules if zero3 else (
        rules.updated(fsdp=("data",)) if zero1 else rules)
    return ShardingProfile(rules=rules, opt_rules=opt_rules, zero3=zero3,
                           notes=tuple(notes))


def pad_heads(cfg: ArchConfig, mesh: Any) -> ArchConfig:
    """Pad query heads up to a model-axis multiple.

    Extra heads contribute nothing (their wo rows are trained from zero) but
    make the head dim shardable.  kv heads are left unpadded (GQA group size
    must stay integral)."""
    ext = mesh_shape(mesh).get("model", 1)
    if cfg.n_heads % ext == 0:
        return cfg
    new_h = math.ceil(cfg.n_heads / ext) * ext
    while new_h % cfg.n_kv_heads:
        new_h += ext
    return dataclasses.replace(cfg, n_heads=new_h, head_dim=cfg.hd)


# ---------------------------------------------------------------------------
# Concrete sharding trees
# ---------------------------------------------------------------------------


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _tree_shardings(axes_tree: Pytree, abstract_tree: Pytree, mesh: Any,
                    rules: AxisRules) -> Pytree:
    if _is_axes(axes_tree):
        return rules.sharding(axes_tree, abstract_tree.shape, mesh)
    if isinstance(axes_tree, dict):
        return {k: _tree_shardings(v, abstract_tree[k], mesh, rules)
                for k, v in axes_tree.items()}
    return type(axes_tree)(_tree_shardings(a, b, mesh, rules)
                           for a, b in zip(axes_tree, abstract_tree))


def param_shardings(model: LM, mesh: Any, rules: AxisRules) -> Pytree:
    return _tree_shardings(model.param_axes(), model.abstract_params(), mesh, rules)


def opt_state_shardings(model: LM, mesh: Any, opt_rules: AxisRules) -> OptState:
    m = _tree_shardings(model.param_axes(), model.abstract_params(), mesh, opt_rules)
    step = NamedSharding(mesh, (Replicate(),) * len(mesh_shape(mesh)))
    return OptState(m=m, v=m, step=step)


def cache_shardings(model: LM, mesh: Any, rules: AxisRules,
                    batch: int, max_len: int) -> Pytree:
    ab = model.init_cache(batch, max_len, device="meta")
    return _tree_shardings(model.cache_axes(), ab, mesh, rules)


def batch_shardings(mesh: Any, specs: dict, rules: AxisRules) -> dict:
    """Input batch: leading dim is batch for every entry; ``specs`` maps a name
    to anything with a ``shape``."""
    out = {}
    for k, v in specs.items():
        axes = ["batch"] + [None] * (len(v.shape) - 1)
        if k in ("audio_embed", "vision_embed"):
            axes = ["batch", "seq", "embed"]
        out[k] = rules.sharding(axes, v.shape, mesh)
    return out


def module_shardings(model: LM, tree: Pytree) -> dict[str, NamedSharding]:
    """A parameter-layout sharding tree (:func:`param_shardings`) keyed by the
    module's parameter names: a stacked leaf's sharding for each of its layers,
    with its leading ``"layers"`` dim (never sharded) taken off."""
    out = {}
    for path, names in target_names(model).items():
        node = tree
        for k in path.split("."):
            node = node[k]
        placements = node.placements
        if is_stacked(path):
            if Shard(0) in placements:
                raise ValueError(f"{path}: the stacked layer dim is sharded")
            placements = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                               for p in placements)
        out.update({n: NamedSharding(node.mesh, placements) for n in names})
    return out


@torch.no_grad()
def distribute_params(model: nn.Module, shardings: dict[str, NamedSharding]) -> None:
    """Replace each of ``model``'s parameters with a DTensor parameter under its
    sharding (keyed by parameter name, :func:`module_shardings`), in place."""
    for name, sh in shardings.items():
        mod_name, _, attr = name.rpartition(".")
        module = model.get_submodule(mod_name)
        old = getattr(module, attr)
        setattr(module, attr, nn.Parameter(place(old.detach(), sh),
                                           requires_grad=old.requires_grad))
