"""Parallel plans: the planner's output IR (paper §3.2.2) and baselines.

A :class:`ParallelPlan` captures everything the paper's output specification
requires at the model level: device assignment (pipeline stage -> device
group, layer -> stage), data-parallel batch shares (possibly uneven for
heterogeneous devices), the collective/link schedule choice (naive vs
decomposed all-reduce), and execution knobs (microbatches, remat, ZeRO-1).

``megatron_default_plan`` reproduces the paper's baseline: uniform layer
split, TP within a node, DP across nodes, even batch shares.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Sequence

from .cluster import ClusterTopology
from .opgraph import ModelDesc


@dataclass(frozen=True)
class StageAssignment:
    """One pipeline stage: which layers it owns and which devices run it."""

    layers: tuple[int, ...]            # global layer indices (contiguous)
    device_ids: tuple[int, ...]        # devices forming this stage's TP x DP block


@dataclass(frozen=True)
class ParallelPlan:
    """Hybrid-parallel execution plan (output spec, paper §3.2.2)."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1                         # expert parallel degree (MoE archs)
    sp: bool = True                     # sequence-parallel norm/dropout regions
    microbatches: int = 1
    stages: tuple[StageAssignment, ...] = ()
    # uneven data-parallel batch shares, one per DP rank (sums to 1).
    batch_shares: tuple[float, ...] = ()
    # collective schedule: "allreduce" (naive) or "rs_ag" (decomposed, Fig. 3)
    grad_sync: str = "rs_ag"
    zero1: bool = True                  # shard optimizer states over DP
    remat: str = "selective"            # none | selective | full
    grad_compression: str = "none"      # none | int8 | topk
    meta: dict = field(default_factory=dict)

    # -- derived ---------------------------------------------------------------

    @property
    def world(self) -> int:
        return self.dp * self.tp * self.pp

    def layers_of_stage(self, s: int) -> tuple[int, ...]:
        return self.stages[s].layers if self.stages else ()

    def structural_key(self) -> tuple:
        """Identity of everything the simulator reads; ``meta`` is excluded
        so plans differing only in provenance compare equal (score-cache
        keys, replan-switch detection)."""
        return (self.dp, self.tp, self.pp, self.ep, self.sp,
                self.microbatches, self.stages, self.batch_shares,
                self.grad_sync, self.zero1, self.remat,
                self.grad_compression)

    def validate(self, n_layers: int) -> None:
        if self.stages:
            got = [l for st in self.stages for l in st.layers]
            if sorted(got) != list(range(n_layers)):
                raise ValueError(
                    f"stage layers {got} do not cover 0..{n_layers - 1}")
        if self.batch_shares:
            if len(self.batch_shares) != self.dp:
                raise ValueError("batch_shares length must equal dp")
            if abs(sum(self.batch_shares) - 1.0) > 1e-6:
                raise ValueError("batch_shares must sum to 1")
        if self.microbatches < 1:
            raise ValueError("microbatches must be >= 1")

    # -- serialization (plans are checkpointed for elastic restart) -----------

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ParallelPlan":
        d = json.loads(s)
        d["stages"] = tuple(StageAssignment(tuple(st["layers"]),
                                            tuple(st["device_ids"]))
                            for st in d["stages"])
        d["batch_shares"] = tuple(d["batch_shares"])
        return ParallelPlan(**d)

    def describe(self) -> str:
        parts = [f"dp={self.dp} tp={self.tp} pp={self.pp}"]
        if self.ep > 1:
            parts.append(f"ep={self.ep}")
        parts.append(f"mb={self.microbatches} sync={self.grad_sync}")
        if self.stages and len({len(s.layers) for s in self.stages}) > 1:
            parts.append("layers=" + "/".join(str(len(s.layers))
                                              for s in self.stages))
        if self.batch_shares and len(set(self.batch_shares)) > 1:
            parts.append("shares=" + ",".join(f"{s:.2f}"
                                              for s in self.batch_shares))
        return " ".join(parts)


# ---------------------------------------------------------------------------
# Uniform helpers
# ---------------------------------------------------------------------------


def uniform_stages(n_layers: int, pp: int,
                   device_groups: Sequence[Sequence[int]]) -> tuple[StageAssignment, ...]:
    """Megatron-style uniform contiguous layer split."""
    base, rem = divmod(n_layers, pp)
    stages = []
    start = 0
    for s in range(pp):
        size = base + (1 if s < rem else 0)
        stages.append(StageAssignment(tuple(range(start, start + size)),
                                      tuple(device_groups[s])))
        start += size
    return tuple(stages)


def stages_from_sizes(sizes: Sequence[int],
                      device_groups: Sequence[Sequence[int]]) -> tuple[StageAssignment, ...]:
    """Build stage assignments from per-stage layer counts: stage ``s``
    holds the next ``sizes[s]`` consecutive layers on
    ``device_groups[s]``."""
    stages = []
    start = 0
    for s, size in enumerate(sizes):
        stages.append(StageAssignment(tuple(range(start, start + size)),
                                      tuple(device_groups[s])))
        start += size
    return tuple(stages)


def split_devices(topo: ClusterTopology, dp: int, tp: int, pp: int,
                  *, sort_by_speed: bool = False) -> list[list[int]]:
    """Group alive devices into pp stage groups of dp*tp devices each.

    With ``sort_by_speed`` the fastest devices land in the first stages —
    the natural layout for heterogeneous pipelines (paper §4.1 layer-level
    task assignment gives early/late stages different work)."""
    ids = topo.alive_ids()
    if sort_by_speed:
        ids = sorted(ids, key=lambda i: -topo.device(i).spec.peak_flops
                     * topo.device(i).perf_factor)
    need = dp * tp * pp
    if len(ids) < need:
        raise ValueError(f"cluster has {len(ids)} devices, plan needs {need}")
    ids = ids[:need]
    per_stage = dp * tp
    return [ids[s * per_stage:(s + 1) * per_stage] for s in range(pp)]


def megatron_default_plan(topo: ClusterTopology, model: ModelDesc, *,
                          gpus_per_node: int = 8,
                          microbatches: int | None = None) -> ParallelPlan:
    """The paper's baseline: Megatron default configuration.

    TP = min(gpus_per_node, heads divisor), PP grows until the model fits
    memory, DP takes the rest; uniform layers, even batch shares, naive
    all-reduce gradient sync, no heterogeneity awareness.
    """
    n = len(topo.alive_ids())
    tp = 1
    for cand in (8, 4, 2, 1):
        if cand <= gpus_per_node and cand <= n and model.n_heads % cand == 0 \
                and n % cand == 0:
            tp = cand
            break
    # memory-driven pp (uniform split): params*9 bytes (p+g+adam) per replica
    mem_per_dev = min(d.spec.mem_bytes for d in topo.alive_devices)
    state_bytes = model.total_params() * (2 + 2 + 8)
    pp = 1
    while pp < n // tp:
        if state_bytes / (tp * pp) * 1.35 < mem_per_dev * 0.9:
            break
        pp *= 2
    pp = max(1, min(pp, n // tp, model.n_layers))
    dp = max(1, n // (tp * pp))
    groups = split_devices(topo, dp, tp, pp)
    mb = microbatches if microbatches is not None else max(1, 4 * pp)
    return ParallelPlan(
        dp=dp, tp=tp, pp=pp,
        microbatches=mb,
        stages=uniform_stages(model.n_layers, pp, groups),
        batch_shares=tuple([1.0 / dp] * dp),
        grad_sync="allreduce", zero1=False,
        meta={"source": "megatron-default"})
