"""Hierarchical island search for fleet-scale planning.

Flat enumeration over ``(dp, tp, pp)`` factorizations of the *whole* device
count is what the cascade accelerates, and it tops out around 64
GPUs / 32 TPU chips: past that, every candidate simulation walks thousands
of DP ranks and the divisor lattice explodes.  Tangram-style decomposition
(PAPERS.md) is the lever for 1k-10k-device fleets:

  1. **Partition** the cluster into homogeneous islands
     (:meth:`~repro_torch.core.cluster.ClusterTopology.island_partition`): same
     device class, dense fast links inside; slow/sparse links become
     inter-island edges.  On a multi-pod TPU fleet each pod is one island.
  2. **Search** a sub-plan per island through the existing tiered cascade
     (:func:`repro_torch.core.planner.plan_hybrid` on the island's
     :meth:`~repro_torch.core.cluster.ClusterTopology.subtopology`), with
     **symmetry deduplication**: islands with equal canonical signatures
     (:meth:`~repro_torch.core.cluster.ClusterTopology.island_signature`) and
     equal batch shares are isomorphic for planning, so one representative
     is scored and its plan is remapped onto the twins.
  3. **Compose** across islands as inter-island data parallelism: each
     island trains its quantized share of the global batch under its own
     sub-plan, and islands exchange gradients over the slow fabric.  The
     composed step estimate is ``max_i(island step) + inter_sync``, where
     ``inter_sync`` is the admissible ring bound of
     :func:`inter_island_sync_bound` — the same coarse roofline/ring
     reasoning tier 2 of the cascade uses, applied at island granularity.

Small clusters (``<= flat_limit`` alive devices) and single-island
partitions **fall back to the flat cascade**, so every existing
``cascade == exhaustive`` identity gate keeps holding verbatim — the
hierarchical tier only engages where flat search is intractable.

The composed plan searches a *restricted* space (no parallel group may
span two islands), so on clusters where flat search completes the flat
argmin can be at or below the composed estimate; the fallback guarantees
the two never disagree where both run.  ``docs/search.md`` carries the
admissibility argument for the inter-island bound.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Mapping, Sequence

from ..obs import Obs, resolve_obs
from .cluster import ClusterTopology
from .opgraph import ModelDesc
from .planner import PlanResult, SearchStats, plan_hybrid
from .plans import ParallelPlan, StageAssignment
from .simulator import StepSim

# Alive-device count at or under which plan_hierarchical delegates to the
# flat cascade (the regime where flat search is tractable and exhaustively
# verified).  Its acceptance tests pin identity to flat argmin up to here.
DEFAULT_FLAT_LIMIT = 64


# ---------------------------------------------------------------------------
# Partition
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Island:
    """One homogeneous island: a maximal same-class, fast-link-connected
    device group (see :meth:`ClusterTopology.island_partition`)."""

    index: int                       # position in the partition (stable)
    device_ids: tuple[int, ...]      # sorted member ids
    signature: tuple                 # canonical id-free signature

    @property
    def n(self) -> int:
        return len(self.device_ids)


def partition_islands(topo: ClusterTopology, *,
                      fast_frac: float = 0.5) -> list[Island]:
    """Partition ``topo`` into :class:`Island` objects with signatures.

    Args:
        topo: the cluster (current state; apply events/snapshot first).
        fast_frac: intra-island link threshold, forwarded to
            :meth:`ClusterTopology.island_partition`.

    Returns:
        Islands ordered by smallest member id; indices are positions in
        this list.
    """
    groups = topo.island_partition(fast_frac=fast_frac)
    return [Island(i, ids, topo.island_signature(ids))
            for i, ids in enumerate(groups)]


# ---------------------------------------------------------------------------
# Composition pieces
# ---------------------------------------------------------------------------


def remap_plan(plan: ParallelPlan,
               mapping: Mapping[int, int]) -> ParallelPlan:
    """Rewrite a sub-plan's device ids through ``mapping`` (representative
    island member -> twin island member, sorted-order correspondence).

    Signature equality guarantees the twin holds the same device-class
    multiset and internal edge multiset, so the remapped plan is
    structurally valid on the twin; for exactly repeated hardware (pods,
    DGX nodes) the sorted-id correspondence is exact.  ``meta`` records the
    reuse for telemetry.
    """
    stages = tuple(
        StageAssignment(st.layers, tuple(mapping[d] for d in st.device_ids))
        for st in plan.stages)
    return replace(plan, stages=stages,
                   meta={**plan.meta, "island_remapped": True})


def inter_island_sync_bound(topo: ClusterTopology,
                            island_ids: Sequence[Sequence[int]],
                            model: ModelDesc) -> float:
    """Admissible lower bound on the per-step inter-island gradient sync.

    Composed islands form a data-parallel ring of ``K`` members: every
    member must send and receive ``2 (K-1)/K`` of the full gradient volume
    (the decomposed reduce-scatter + all-gather floor, same term as the
    cascade's tier-2 sync bound).  All of an island's traffic crosses its
    boundary cut, so the time is floored by the *tightest* island's
    aggregate cut bandwidth — summing every live direct link leaving the
    island is optimistic (perfect striping, zero latency, full overlap
    across pairs), which keeps the bound admissible.

    Args:
        topo: the cluster (current effective bandwidths).
        island_ids: one id-sequence per composed island.
        model: supplies the gradient volume (``total_params * dtype``).

    Returns:
        Seconds; ``0.0`` for a single island.

    Raises:
        RuntimeError: some island has zero live cut bandwidth — the cluster
            is partitioned and no composed plan can sync across it.
    """
    K = len(island_ids)
    if K <= 1:
        return 0.0
    member: dict[int, int] = {}
    for k, ids in enumerate(island_ids):
        for d in ids:
            member[d] = k
    cut = [0.0] * K
    for (a, b), link in topo.links.items():
        ka, kb = member.get(a), member.get(b)
        if ka is None or kb is None or ka == kb or not link.edges:
            continue
        bw = max(e.effective_bandwidth for e in link.edges)
        cut[ka] += bw
        cut[kb] += bw
    bottleneck = min(cut)
    if bottleneck <= 0:
        bad = cut.index(bottleneck)
        raise RuntimeError(
            "no feasible plan found: cluster is partitioned — island "
            f"{bad} (devices {list(island_ids[bad])[:4]}...) has no live "
            "inter-island link")
    grad_bytes = model.total_params() * model.dtype_bytes
    return 2.0 * (K - 1) / K * grad_bytes / bottleneck


def _island_weight(topo: ClusterTopology, isl: Island) -> float:
    """Aggregate attainable throughput of an island (relative batch-share
    weight): sum of members' effective matmul rates."""
    total = 0.0
    for i in isl.device_ids:
        d = topo.device(i)
        if d.alive:
            total += d.spec.peak_flops * d.spec.matmul_eff * d.perf_factor
    return total


def _quantize_shares(weights: Sequence[float],
                     global_batch: int) -> tuple[list[int], int]:
    """Split ``global_batch`` into integer per-island shares proportional
    to ``weights``, quantized to a power-of-two unit so sub-searches keep
    friendly microbatch divisibility.

    Largest-remainder apportionment in units; every island gets at least
    one unit.  Equal weights get equal shares whenever the unit count
    divides evenly — the property symmetry deduplication relies on (twin
    islands with equal shares search once).

    Returns:
        (shares summing exactly to ``global_batch``, the unit used).

    Raises:
        RuntimeError: ``global_batch`` is smaller than the island count.
    """
    K = len(weights)
    if global_batch < K:
        raise RuntimeError(
            f"no feasible plan found: global batch {global_batch} smaller "
            f"than island count {K}")
    unit = 1
    while unit * 2 <= max(1, global_batch // (8 * K)) \
            and global_batch % (unit * 2) == 0:
        unit *= 2
    units = global_batch // unit
    total_w = sum(weights)
    raw = [units * (w / total_w) if total_w > 0 else units / K
           for w in weights]
    base = [max(1, math.floor(r)) for r in raw]
    # the max(1, .) floors can overshoot when many islands round to the
    # minimum; steal back from the largest shares first
    over = sum(base) - units
    if over > 0:
        for i in sorted(range(K), key=lambda i: (-base[i], i)):
            take = min(over, base[i] - 1)
            base[i] -= take
            over -= take
            if over == 0:
                break
    rem = units - sum(base)
    by_frac = sorted(range(K),
                     key=lambda i: (-(raw[i] - math.floor(raw[i])), i))
    for j in range(rem):
        base[by_frac[j % K]] += 1
    return [b * unit for b in base], unit


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class IslandPlan:
    """One island's slot in a composed plan."""

    island: Island
    plan: ParallelPlan               # device ids are the island's global ids
    predicted: StepSim               # sub-plan step time at ``batch``
    batch: int                       # the island's global-batch share
    searched: bool                   # False: reused from an isomorphic twin


@dataclass(frozen=True)
class ComposedPlan:
    """Cross-island composition: per-island sub-plans + the admissible
    inter-island sync bound.  ``step_time`` is the composed estimate
    ``max_i(island step) + inter_sync_s`` — islands run their shares
    concurrently, then sync gradients over the slow fabric."""

    islands: tuple[IslandPlan, ...]
    inter_sync_s: float
    step_time: float


@dataclass
class HierarchicalResult:
    """Outcome of :func:`plan_hierarchical`.

    Exactly one of ``composed`` / ``flat`` is set, per ``path``:
    ``"flat"`` means the cluster was small (or single-island) and the flat
    cascade ran — byte-identical to calling ``plan_hybrid`` directly;
    ``"hierarchical"`` means island decomposition engaged.
    """

    path: str                        # "flat" | "hierarchical"
    wall_time: float
    stats: SearchStats               # aggregated over all sub-searches
    n_islands: int                   # partition size (before any drops)
    n_signatures: int                # distinct canonical signatures
    islands_deduped: int             # islands that reused a twin's sub-plan
    islands_dropped: int = 0         # islands with no feasible sub-plan
    composed: ComposedPlan | None = None
    flat: PlanResult | None = None

    @property
    def predicted_step(self) -> float:
        """The composed (or flat) predicted step time, seconds."""
        if self.composed is not None:
            return self.composed.step_time
        assert self.flat is not None
        return self.flat.predicted.step_time


def _merge_stats(dst: SearchStats, src: SearchStats | None) -> None:
    if src is None:
        return
    dst.explored += src.explored
    dst.pruned += src.pruned
    dst.infeasible += src.infeasible
    dst.rejected += src.rejected
    dst.cache_hits += src.cache_hits
    dst.cache_misses += src.cache_misses
    dst.pruned_feasibility += src.pruned_feasibility
    dst.pruned_bound += src.pruned_bound
    dst.pruned_coarse += src.pruned_coarse
    dst.simulated += src.simulated
    dst.budget_skipped += src.budget_skipped


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def plan_hierarchical(topo: ClusterTopology, model: ModelDesc, *,
                      global_batch: int, seq: int,
                      flat_limit: int = DEFAULT_FLAT_LIMIT,
                      fast_frac: float = 0.5,
                      gpus_per_node: int = 8,
                      max_candidates: int | None = None,
                      max_sims: int | None = None,
                      cache=None, executor=None,
                      top_k: int = 1,
                      lp_prune: bool = True,
                      obs: Obs | None = None) -> HierarchicalResult:
    """Plan a (possibly fleet-scale) cluster via hierarchical island search.

    Small clusters (``len(alive) <= flat_limit``) and single-island
    partitions delegate to :func:`repro_torch.core.planner.plan_hybrid` unchanged
    (``path == "flat"``), so the flat cascade's argmin identity is
    preserved exactly where it is verified.  Otherwise each island's
    sub-plan is searched independently (one search per distinct
    ``(signature, batch share)`` group — isomorphic islands are scored
    once) and composed with the admissible inter-island sync bound.

    Args:
        topo: the cluster, current state (snapshot first for a given time).
        model: the workload.
        global_batch: total batch; split across islands proportionally to
            their aggregate throughput, quantized by :func:`_quantize_shares`.
        seq: sequence length.
        flat_limit: alive-device count at or under which the flat cascade
            runs instead (``0`` forces hierarchical whenever K > 1).
        fast_frac: island partition threshold (see
            :meth:`ClusterTopology.island_partition`).
        gpus_per_node / max_candidates / cache / executor / top_k /
        lp_prune:
            forwarded to every ``plan_hybrid`` call (flat and per-island) —
            ``lp_prune`` toggles the tier-2.5 LP bound in each sub-search's
            cascade.
        max_sims: per-sub-search anytime simulation budget (forwarded to
            the cascade; see ``score_candidates``).  Essential at fleet
            scale — an island sub-search then stops after the budget's
            best-bound-first simulations.
        obs: a :class:`repro_torch.obs.Obs` bundle; records a
            ``plan.hierarchical`` span with one ``island.search`` child per
            distinct sub-search (no-op by default).

    Returns:
        A :class:`HierarchicalResult`; ``predicted_step`` is the composed
        (or flat) step-time estimate.

    Raises:
        RuntimeError: no feasible plan — every island's sub-search failed,
            the cluster is partitioned (some island unroutable / zero cut
            bandwidth), or the batch cannot cover the island count.
    """
    t0 = time.perf_counter()
    obs = resolve_obs(obs)
    alive = topo.alive_ids()
    islands = partition_islands(topo, fast_frac=fast_frac)
    n_signatures = len({isl.signature for isl in islands})

    if len(alive) <= flat_limit or len(islands) <= 1:
        res = plan_hybrid(topo, model, global_batch=global_batch, seq=seq,
                          gpus_per_node=gpus_per_node, with_baseline=False,
                          max_candidates=max_candidates, cache=cache,
                          executor=executor, top_k=top_k, max_sims=max_sims,
                          lp_prune=lp_prune, obs=obs)
        stats = res.search_stats or SearchStats()
        wall = time.perf_counter() - t0
        return HierarchicalResult(
            path="flat", wall_time=wall, stats=stats,
            n_islands=len(islands), n_signatures=n_signatures,
            islands_deduped=0, flat=res)

    # Inter-island routability (the existing routing machinery): if any
    # island cannot reach island 0 over live links, no composed plan can
    # sync gradients — same verdict flat search reaches via infinite
    # simulated transfers, surfaced before any sub-search runs.
    table = topo.routing()
    root = islands[0].device_ids[0]
    for isl in islands[1:]:
        if table.route(root, isl.device_ids[0]) is None:
            raise RuntimeError(
                "no feasible plan found: cluster is partitioned (island "
                f"{isl.index} is unreachable from island 0)")

    hier_span = obs.span("plan.hierarchical", n_islands=len(islands),
                         n_signatures=n_signatures, devices=len(alive))
    hier_span.__enter__()
    stats = SearchStats()
    active = list(islands)
    dropped = 0
    shares: list[int] = []
    groups: dict[tuple, list[Island]] = {}
    results: dict[tuple, PlanResult] = {}
    for _ in range(len(islands)):
        weights = [_island_weight(topo, isl) for isl in active]
        shares, _unit = _quantize_shares(weights, global_batch)
        groups = {}
        for isl, share in zip(active, shares):
            groups.setdefault((isl.signature, share), []).append(isl)
        results = {}
        infeasible: set[int] = set()
        for key, members in groups.items():
            rep = members[0]
            sub = topo.subtopology(rep.device_ids)
            with obs.span("island.search", signature=str(key[0]),
                          share=key[1], members=len(members)) as isl_span:
                try:
                    res = plan_hybrid(
                        sub, model, global_batch=key[1], seq=seq,
                        gpus_per_node=gpus_per_node, with_baseline=False,
                        max_candidates=max_candidates, allow_subset=False,
                        cache=cache, executor=executor, max_sims=max_sims,
                        lp_prune=lp_prune, obs=obs)
                except RuntimeError:
                    isl_span.set(feasible=False)
                    infeasible.update(m.index for m in members)
                    continue
                isl_span.set(feasible=True,
                             step_time=res.predicted.step_time)
            results[key] = res
            _merge_stats(stats, res.search_stats)
        if not infeasible:
            break
        # drop islands that cannot host the model at their share, recompute
        # shares over the survivors, and retry (at most K rounds)
        dropped += len(infeasible)
        active = [isl for isl in active if isl.index not in infeasible]
        if not active:
            raise RuntimeError(
                "no feasible plan found: no island can host the model")
    else:
        raise RuntimeError("no feasible plan found: island sub-searches "
                           "did not converge")

    plans: list[IslandPlan] = []
    for isl, share in zip(active, shares):
        key = (isl.signature, share)
        res = results[key]
        rep = groups[key][0]
        if isl.index == rep.index:
            plan, searched = res.plan, True
        else:
            mapping = dict(zip(rep.device_ids, isl.device_ids))
            plan, searched = remap_plan(res.plan, mapping), False
        plans.append(IslandPlan(island=isl, plan=plan,
                                predicted=res.predicted, batch=share,
                                searched=searched))
    inter = inter_island_sync_bound(
        topo, [isl.device_ids for isl in active], model)
    step = max(p.predicted.step_time for p in plans) + inter
    stats.wall_time = time.perf_counter() - t0
    hier_span.set(step_time=step, islands_dropped=dropped)
    hier_span.__exit__(None, None, None)
    return HierarchicalResult(
        path="hierarchical", wall_time=stats.wall_time, stats=stats,
        n_islands=len(islands), n_signatures=n_signatures,
        islands_deduped=len(active) - len(groups),
        islands_dropped=dropped,
        composed=ComposedPlan(islands=tuple(plans), inter_sync_s=inter,
                              step_time=step))
