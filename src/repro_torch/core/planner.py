"""Parallel branch-and-bound planner (paper §3.3, Algorithm 1) with
strategy pruning (§3.4).

Two faithful instantiations of Algorithm 1:

  * :func:`branch_and_bound_assign` — the general operator→device assignment
    search over an arbitrary :class:`OpGraph` (small graphs; used to verify
    optimality against exhaustive search in tests),
  * :func:`bnb_layer_split` — the LLM-scale instantiation at layer
    granularity (the paper's "first-level optimization"): contiguous layer →
    pipeline-stage assignment for heterogeneous stages.

Both follow Alg. 1 structure exactly: greedy initialization of the incumbent
(upper bound), a priority queue ordered by an admissible cost bound F(N),
feasible-child generation under the constraint system (Eq. 4-7), pruning of
children with F(N_child) >= best_UB, and parallel child evaluation.

:func:`plan_hybrid` is the end-to-end entry point: enumerate hybrid-parallel
strategy candidates (DP/TP/PP/EP/microbatching + collective decomposition),
then hand them to the tiered pruning cascade in :mod:`repro_torch.core.search`
(feasibility → analytic bound → coarse estimate → full simulation, with the
final tier optionally scored in worker processes — the paper accelerates its
search with parallel simulation, §3.4/§4).
"""

from __future__ import annotations

import functools
import heapq
import itertools
import math
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

from ..obs import Obs, resolve_obs
from .cluster import ClusterTopology, DeviceInstance
from .costmodel import graph_compute_lower_bound, op_time, transfer_time
from .opgraph import ModelDesc, OpGraph, layer_flops
from .plans import (ParallelPlan, StageAssignment, megatron_default_plan,
                    split_devices, stages_from_sizes, uniform_stages)
from .simulator import (StepSim, memory_feasible, simulate_schedule,
                        simulate_training_step)

# ---------------------------------------------------------------------------
# Generic Algorithm 1: operator -> device assignment
# ---------------------------------------------------------------------------


@dataclass
class SearchStats:
    """Search telemetry, shared by every planner entry point.

    ``explored``/``pruned``/``infeasible`` count enumeration/B&B work;
    the ``pruned_*``/``simulated``/``budget_skipped`` block is the tiered
    cascade's per-(point, refine)-candidate accounting (all sharing the
    :attr:`cascade_candidates` denominator); ``cache_hits``/``cache_misses``
    tell warm resolution apart from real simulator work.  Mutated in place
    by :func:`repro_torch.core.search.score_candidates`."""

    explored: int = 0
    pruned: int = 0
    infeasible: int = 0
    # candidates whose materialization/simulation raised (ValueError /
    # ZeroDivisionError) — previously swallowed silently; surfaced so the
    # paper-style search statistics show pruning efficacy.
    rejected: int = 0
    # strategy-cache telemetry (filled when plan_hybrid runs with a cache)
    cache_hits: int = 0
    cache_misses: int = 0
    wall_time: float = 0.0
    # -- tiered-cascade telemetry (repro_torch.core.search), counted per
    # (point, refine) candidate so the tiers share one denominator:
    # candidates cut by the structural/memory feasibility tier,
    pruned_feasibility: int = 0
    # ...by the analytic point_lower_bound tier,
    pruned_bound: int = 0
    # ...by the coarse pipeline/sync estimate tier,
    pruned_coarse: int = 0
    # ...by the LP-relaxation packing bound (repro_torch.core.mip, tier 2.5),
    pruned_lp: int = 0
    # ...and candidates that reached the final tier and were fully scored —
    # by a fresh simulation OR a session-cache hit (the cascade's pruning
    # denominator; ``cache_hits``/``cache_misses`` tell warm resolution
    # apart from real simulator work).
    simulated: int = 0
    # candidates skipped by the ``max_sims`` anytime budget — NOT soundly
    # pruned (one of them might have been the argmin); nonzero only when a
    # caller bounds the final tier (the hierarchical island searches do)
    budget_skipped: int = 0
    # wall seconds spent inside the LP tier (context build + simplex
    # solves + per-candidate bound assembly) — the cost the guard weighs
    # against projected simulation savings
    lp_wall_time: float = 0.0

    @property
    def cascade_candidates(self) -> int:
        """Candidates that entered the cascade (all tiers' denominator)."""
        return (self.pruned_feasibility + self.pruned_bound
                + self.pruned_coarse + self.pruned_lp + self.simulated
                + self.rejected + self.budget_skipped)

    @property
    def prune_rate(self) -> float:
        """Fraction of cascade candidates cut before full simulation."""
        total = self.cascade_candidates
        cut = (self.pruned_feasibility + self.pruned_bound
               + self.pruned_coarse + self.pruned_lp)
        return cut / total if total else 0.0


def greedy_assign(graph: OpGraph, topo: ClusterTopology) -> dict[str, int]:
    """HEFT-like greedy initialization (Alg. 1 line 4): place each op, in
    topological order, on the device minimizing its finish time."""
    order = graph.topo_order()
    assignment: dict[str, int] = {}
    dev_free = {d.device_id: 0.0 for d in topo.alive_devices}
    end: dict[str, float] = {}
    for v in order:
        best_dev, best_en = None, math.inf
        for d in topo.alive_devices:
            arrive = 0.0
            for u in graph.preds(v):
                du = assignment[u]
                x = 0.0 if du == d.device_id else transfer_time(
                    topo, du, d.device_id, graph.edges[(u, v)])
                arrive = max(arrive, end[u] + x)
            st = max(arrive, dev_free[d.device_id])
            en = st + op_time(graph.nodes[v], d)
            if en < best_en:
                best_dev, best_en = d.device_id, en
        assert best_dev is not None
        assignment[v] = best_dev
        end[v] = best_en
        dev_free[best_dev] = best_en
    return assignment


def _partial_bound(graph: OpGraph, topo: ClusterTopology,
                   assignment: Mapping[str, int], order: Sequence[str],
                   k: int) -> float:
    """Admissible F(N) = max of three individually-admissible lower bounds:

      * makespan of the assigned prefix simulated alone (adding the suffix
        can only delay prefix ops under the deterministic ready-order
        scheduler, never accelerate them),
      * remaining work over aggregate cluster throughput,
      * the suffix critical path on the fastest device.

    NOTE: summing prefix + suffix bounds is NOT admissible — independent
    suffix ops can overlap the prefix on idle devices (caught by the
    hypothesis optimality property test)."""
    prefix = {n: assignment[n] for n in order[:k]}
    if prefix:
        sub = OpGraph(
            nodes={n: graph.nodes[n] for n in prefix},
            edges={(u, v): s for (u, v), s in graph.edges.items()
                   if u in prefix and v in prefix})
        prefix_time = simulate_schedule(sub, prefix, topo).makespan
    else:
        prefix_time = 0.0
    rest = order[k:]
    if not rest:
        return prefix_time
    rest_flops = sum(graph.nodes[n].flops for n in rest)
    work_lb = graph_compute_lower_bound(rest_flops, topo.alive_devices)
    # critical path of the suffix on the fastest device
    fastest = max(topo.alive_devices,
                  key=lambda d: d.spec.peak_flops * d.perf_factor)
    cp = 0.0
    dist: dict[str, float] = {}
    for n in order:
        t = op_time(graph.nodes[n], fastest)
        dist[n] = max((dist[p] for p in graph.preds(n) if p in dist),
                      default=0.0) + (t if n in rest else 0.0)
        cp = max(cp, dist[n])
    return max(prefix_time, work_lb, cp)


def branch_and_bound_assign(
        graph: OpGraph, topo: ClusterTopology, *,
        max_nodes: int = 200_000, n_workers: int = 8,
        feasible_only: bool = True) -> tuple[dict[str, int], float, SearchStats]:
    """Algorithm 1 verbatim for operator→device assignment.

    Returns (assignment, makespan, stats).  Guaranteed optimal w.r.t. the
    simulator when the node budget is not exhausted (checked in tests against
    exhaustive enumeration).
    """
    t0 = time.perf_counter()
    order = graph.topo_order()
    devices = topo.alive_ids()
    stats = SearchStats()

    # line 4: greedy incumbent
    best_assignment = greedy_assign(graph, topo)
    best_ub = simulate_schedule(graph, best_assignment, topo).makespan

    # priority queue of (F(N), tiebreak, depth, partial assignment)
    counter = itertools.count()
    root = (0.0, next(counter), 0, ())
    pq: list[tuple[float, int, int, tuple[int, ...]]] = [root]

    pool = ThreadPoolExecutor(max_workers=n_workers)
    try:
        while pq and stats.explored < max_nodes:
            f, _, depth, partial = heapq.heappop(pq)
            if f >= best_ub - 1e-12:
                stats.pruned += 1
                continue
            stats.explored += 1
            if depth == len(order):
                # complete solution (Alg. 1 lines 9-10)
                assignment = dict(zip(order, partial))
                cost = simulate_schedule(graph, assignment, topo).makespan
                if cost < best_ub:
                    best_ub, best_assignment = cost, assignment
                continue
            # feasible children: next op on each device (lines 12-15)
            children = []
            for d in devices:
                cand = partial + (d,)
                assignment = dict(zip(order, cand))
                if feasible_only and not memory_feasible(
                        graph,
                        {**{n: assignment[n] for n in order[:depth + 1]}},
                        topo):
                    stats.infeasible += 1
                    continue
                children.append(cand)
            # estimate costs concurrently (paper: parallel simulation)
            bounds = list(pool.map(
                lambda c: _partial_bound(graph, topo,
                                         dict(zip(order, c)), order,
                                         len(c)), children))
            for cand, fb in zip(children, bounds):
                if fb < best_ub - 1e-12:
                    heapq.heappush(pq, (fb, next(counter), depth + 1, cand))
                else:
                    stats.pruned += 1
    finally:
        pool.shutdown(wait=False)
    stats.wall_time = time.perf_counter() - t0
    return best_assignment, best_ub, stats


def exhaustive_assign(graph: OpGraph, topo: ClusterTopology
                      ) -> tuple[dict[str, int], float]:
    """Brute force oracle for tests."""
    order = graph.topo_order()
    devices = topo.alive_ids()
    best, best_cost = None, math.inf
    for combo in itertools.product(devices, repeat=len(order)):
        assignment = dict(zip(order, combo))
        if not memory_feasible(graph, assignment, topo):
            continue
        c = simulate_schedule(graph, assignment, topo).makespan
        if c < best_cost:
            best, best_cost = assignment, c
    assert best is not None, "no feasible assignment"
    return best, best_cost


# ---------------------------------------------------------------------------
# Layer-level Algorithm 1: contiguous layer -> stage split
# ---------------------------------------------------------------------------


def _stage_rate(topo: ClusterTopology, group: Sequence[int], tp: int) -> float:
    """Effective flops rate of a stage: slowest member bounds synchronous TP."""
    devs = [topo.device(d) for d in group if topo.device(d).alive]
    slow = min(devs, key=lambda d: d.spec.peak_flops * d.perf_factor)
    return slow.spec.peak_flops * slow.spec.matmul_eff * slow.perf_factor * tp


def bnb_layer_split(model: ModelDesc, topo: ClusterTopology,
                    groups: Sequence[Sequence[int]], tp: int, *,
                    batch: int, seq: int, max_nodes: int = 50_000
                    ) -> tuple[list[int], SearchStats]:
    """Algorithm 1 at layer granularity: choose stage sizes (contiguous layer
    counts) minimizing the bottleneck stage time on heterogeneous stages.

    Node = (bound, next stage index, layers consumed, current max stage time).
    Greedy incumbent: proportional-to-capacity allocation.  Memory-infeasible
    children (stage params exceed stage memory, Eq. 6) are pruned.
    """
    t0 = time.perf_counter()
    S = len(groups)
    L = model.n_layers
    costs = [layer_flops(model, i, batch, seq) * 3.0 for i in range(L)]
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    rates = [_stage_rate(topo, g, tp) for g in groups]
    mems = [min(topo.device(d).spec.mem_bytes for d in g) * tp * 0.95
            for g in groups]
    state_mult = 12  # bytes per param: bf16 p+g + fp32 adam m,v
    stats = SearchStats()

    def stage_time(s: int, lo: int, hi: int) -> float:
        return (prefix[hi] - prefix[lo]) / rates[s]

    def stage_mem(lo: int, hi: int) -> float:
        return sum(model.layer_params(i) for i in range(lo, hi)) * state_mult

    def greedy_sizes() -> list[int]:
        total_rate = sum(rates)
        sizes, used = [], 0
        for s in range(S):
            if s == S - 1:
                sizes.append(L - used)
                break
            want = round(L * rates[s] / total_rate)
            want = max(1, min(want, L - used - (S - 1 - s)))
            sizes.append(want)
            used += want
        return sizes

    def eval_sizes(sizes: Sequence[int]) -> float:
        lo = 0
        worst = 0.0
        for s, sz in enumerate(sizes):
            worst = max(worst, stage_time(s, lo, lo + sz))
            lo += sz
        return worst

    incumbent = greedy_sizes()
    best_ub = eval_sizes(incumbent)

    counter = itertools.count()
    # node: (bound, tiebreak, stage idx, consumed layers, sizes, cur_max)
    pq: list[tuple[float, int, int, int, tuple[int, ...], float]] = [
        (0.0, next(counter), 0, 0, (), 0.0)]
    while pq and stats.explored < max_nodes:
        f, _, s, used, sizes, cur_max = heapq.heappop(pq)
        if f >= best_ub - 1e-12:
            stats.pruned += 1
            continue
        stats.explored += 1
        if s == S:
            if used == L and cur_max < best_ub:
                best_ub, incumbent = cur_max, list(sizes)
            continue
        remaining_stages = S - s - 1
        max_take = L - used - remaining_stages
        for take in range(1, max_take + 1):
            lo, hi = used, used + take
            if stage_mem(lo, hi) > mems[s]:
                stats.infeasible += 1
                break  # adding more layers only grows memory
            t_here = max(cur_max, stage_time(s, lo, hi))
            # admissible bound: remaining work over remaining capacity
            rem_work = prefix[L] - prefix[hi]
            rem_rate = sum(rates[s + 1:])
            lb = max(t_here,
                     (rem_work / rem_rate) if rem_rate > 0 else
                     (math.inf if rem_work > 0 else 0.0))
            if lb >= best_ub - 1e-12:
                stats.pruned += 1
                continue
            heapq.heappush(pq, (lb, next(counter), s + 1, hi,
                                sizes + (take,), t_here))
    stats.wall_time = time.perf_counter() - t0
    return incumbent, stats


# ---------------------------------------------------------------------------
# Heterogeneous batch shares (uneven DP)
# ---------------------------------------------------------------------------


def hetero_batch_shares(topo: ClusterTopology,
                        rank_devices: Sequence[Sequence[int]]) -> tuple[float, ...]:
    """Batch share per DP rank proportional to its slowest device's rate."""
    rates = []
    for group in rank_devices:
        devs = [topo.device(d) for d in group]
        slow = min(devs, key=lambda d: d.spec.peak_flops * d.perf_factor)
        rates.append(slow.spec.peak_flops * slow.perf_factor)
    total = sum(rates)
    if total <= 0:
        return tuple(1.0 / len(rates) for _ in rates)
    return tuple(r / total for r in rates)


# ---------------------------------------------------------------------------
# Strategy enumeration + pruning (paper §3.4)
# ---------------------------------------------------------------------------


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


@dataclass(frozen=True)
class StrategyPoint:
    """One point in the hybrid-parallel strategy lattice: the degrees of
    data/tensor/pipeline/expert parallelism, the microbatch count, and the
    gradient-sync schedule (``"rs_ag"`` decomposed vs ``"allreduce"``
    naive).  Materialization (device grouping, layer split, batch shares)
    happens later in :func:`materialize_plan` — a point is the cascade's
    unit of pruning, hashable and cheap to enumerate."""

    dp: int
    tp: int
    pp: int
    ep: int
    microbatches: int
    grad_sync: str


def enumerate_strategies(topo: ClusterTopology, model: ModelDesc, *,
                         global_batch: int, gpus_per_node: int = 8,
                         max_tp: int = 64) -> tuple[list[StrategyPoint], SearchStats]:
    """Enumerate hybrid-parallel candidates with strategy pruning.

    Pruning rules (cheap, before any simulation — §3.4 "apply constraints to
    eliminate infeasible choices"):
      * dp*tp*pp == alive devices; tp | n_heads & n_kv_heads alignment;
        pp <= n_layers; microbatches | per-rank batch
      * memory (Eq. 6): optimizer state per device must fit
      * MoE: ep | n_experts, ep <= tp (experts ride the model axis)
    """
    stats = SearchStats()
    n = len(topo.alive_ids())
    mem = min(d.spec.mem_bytes for d in topo.alive_devices)
    pts: list[StrategyPoint] = []
    state_bytes = model.total_params() * 12
    act_per_token = model.d_model * model.dtype_bytes * 12  # rough act factor
    for tp in _divisors(n):
        if tp > max_tp or model.n_heads % tp:
            continue
        for pp in _divisors(n // tp):
            if pp > model.n_layers:
                continue
            dp = n // (tp * pp)
            if global_batch % dp:
                stats.infeasible += 1
                continue
            # Eq. 6 pruning: params+opt state sharded over tp*pp (+zero1 dp)
            per_dev = state_bytes / (tp * pp)
            if per_dev > mem * 0.9:
                stats.pruned += 1
                continue
            eps = [1]
            if model.n_experts:
                eps = [e for e in _divisors(model.n_experts) if e <= tp]
            for ep in eps:
                for mb in (pp, 2 * pp, 4 * pp):
                    if (global_batch // dp) % mb:
                        continue
                    for sync in ("rs_ag", "allreduce"):
                        pts.append(StrategyPoint(dp, tp, pp, ep, mb, sync))
    stats.explored = len(pts)
    return pts, stats


# ---------------------------------------------------------------------------
# End-to-end planning
# ---------------------------------------------------------------------------


@dataclass
class PlanResult:
    """Everything :func:`plan_hybrid` returns: the argmin plan with its
    simulated step time, the optional Megatron baselines (literal default
    and tuned-uniform), per-tier :class:`SearchStats`, and the distinct
    ``top_k`` best plans for downstream candidate widening."""

    plan: ParallelPlan
    predicted: StepSim
    candidates_evaluated: int
    candidates_pruned: int
    wall_time: float
    candidates_rejected: int = 0
    baseline: ParallelPlan | None = None
    baseline_predicted: StepSim | None = None
    tuned_baseline: ParallelPlan | None = None
    tuned_baseline_predicted: StepSim | None = None
    search_stats: SearchStats | None = None
    # best distinct plans by predicted step time (length <= the ``top_k``
    # requested from plan_hybrid); feeds the cross-interval DP oracle's
    # widened per-interval candidate set
    top_plans: tuple[tuple[ParallelPlan, StepSim], ...] = ()

    @property
    def speedup_vs_baseline(self) -> float:
        """vs the literal Megatron default configuration (paper's baseline)."""
        if self.baseline_predicted is None:
            return 1.0
        return self.baseline_predicted.step_time / self.predicted.step_time

    @property
    def speedup_vs_tuned(self) -> float:
        """vs the best *uniform* (heterogeneity-blind) configuration — a
        stronger baseline isolating the gain from heterogeneity awareness."""
        if self.tuned_baseline_predicted is None:
            return 1.0
        return self.tuned_baseline_predicted.step_time / self.predicted.step_time


def megatron_tuned_plan(topo: ClusterTopology, model: ModelDesc, *,
                        global_batch: int, seq: int) -> tuple[ParallelPlan, StepSim]:
    """Best heterogeneity-*blind* plan: grid over (tp, pp, mb) with uniform
    layer split, even batch shares and naive all-reduce — what a careful
    practitioner gets from Megatron without the paper's technique."""
    n = len(topo.alive_ids())
    mem = min(d.spec.mem_bytes for d in topo.alive_devices)
    state_bytes = model.total_params() * 12
    best: tuple[float, ParallelPlan, StepSim] | None = None
    for tp in _divisors(n):
        if model.n_heads % tp or tp > 64:
            continue
        for pp in _divisors(n // tp):
            if pp > model.n_layers:
                continue
            dp = n // (tp * pp)
            if global_batch % dp:
                continue
            # same Eq. 6 feasibility the planner enforces — without it the
            # baseline "wins" with memory-infeasible configs
            if state_bytes / (tp * pp) > mem * 0.9:
                continue
            for mb in (pp, 2 * pp, 4 * pp):
                if (global_batch // dp) % mb:
                    continue
                groups = split_devices(topo, dp, tp, pp)
                plan = ParallelPlan(
                    dp=dp, tp=tp, pp=pp, microbatches=mb,
                    stages=uniform_stages(model.n_layers, pp, groups),
                    batch_shares=tuple([1.0 / dp] * dp),
                    grad_sync="allreduce", zero1=False,
                    meta={"source": "megatron-tuned-uniform"})
                try:
                    sim = simulate_training_step(
                        plan, model, topo, global_batch=global_batch, seq=seq)
                except (ValueError, ZeroDivisionError):
                    continue
                if best is None or sim.step_time < best[0]:
                    best = (sim.step_time, plan, sim)
    assert best is not None, "no feasible uniform plan"
    return best[1], best[2]


@functools.lru_cache(maxsize=128)
def _total_step_flops(model: ModelDesc, global_batch: int, seq: int) -> float:
    return 3.0 * sum(layer_flops(model, l, global_batch, seq)
                     for l in range(model.n_layers))


def point_lower_bound(point: StrategyPoint, topo: ClusterTopology,
                      model: ModelDesc, *, global_batch: int,
                      seq: int) -> float:
    """Optimistic step-time bound for a strategy point — no materialization,
    no simulation.  Used by the re-planning engine to cut candidates against
    an incumbent plan's score (Alg. 1 pruning reused across plans).

    compute-over-aggregate-throughput plus a gradient-sync floor.  Both
    terms undershoot the simulator by construction — the sync term charges
    one *average* stage's bytes at the cluster's best single-edge bandwidth,
    while the simulator pays the worst stage at the group's bottleneck — so
    a cut candidate can never have beaten the incumbent.  Keep it that way:
    tightening either term toward the simulator breaks the never-over-prune
    invariant the re-planning engine relies on.
    """
    rate = sum(d.spec.peak_flops * d.spec.matmul_eff * d.perf_factor
               for d in topo.alive_devices)
    if rate <= 0:
        return math.inf
    lb = _total_step_flops(model, global_batch, seq) / rate
    if point.dp > 1:
        stage_bytes = (model.total_params() * model.dtype_bytes
                       / (point.pp * point.tp))
        best_bw = max((e.effective_bandwidth
                       for link in topo.links.values() for e in link.edges),
                      default=0.0)
        if best_bw > 0:
            lb += (point.dp - 1) / point.dp * stage_bytes / best_bw
    return lb


def materialize_plan(point: StrategyPoint, topo: ClusterTopology,
                     model: ModelDesc, *, global_batch: int, seq: int,
                     refine_layers: bool = True) -> ParallelPlan:
    """Turn a strategy point into a concrete plan: device grouping, layer
    B&B for heterogeneous stages, uneven batch shares for heterogeneous DP."""
    hetero = topo.is_heterogeneous()
    groups = split_devices(topo, point.dp, point.tp, point.pp,
                           sort_by_speed=hetero)
    if point.pp > 1 and refine_layers and hetero:
        sizes, _ = bnb_layer_split(model, topo, groups, point.tp,
                                   batch=global_batch // point.dp, seq=seq)
        stages = stages_from_sizes(sizes, groups)
    else:
        stages = uniform_stages(model.n_layers, point.pp, groups)
    if hetero and point.dp > 1:
        rank_devs = [[g[r * point.tp] for g in groups] for r in range(point.dp)]
        shares = hetero_batch_shares(topo, rank_devs)
    else:
        shares = tuple([1.0 / point.dp] * point.dp)
    return ParallelPlan(
        dp=point.dp, tp=point.tp, pp=point.pp, ep=point.ep,
        microbatches=point.microbatches, stages=stages, batch_shares=shares,
        grad_sync=point.grad_sync, zero1=(point.grad_sync == "rs_ag"),
        meta={"source": "auto-planner"})


# Default search-space knobs.  Test fixtures (tests/conftest.py) shrink these
# so the tier-1 suite stays within its CI budget; explicit arguments win.
DEFAULT_MAX_CANDIDATES = 512


def plan_hybrid(topo: ClusterTopology, model: ModelDesc, *,
                global_batch: int, seq: int, gpus_per_node: int = 8,
                with_baseline: bool = True,
                max_candidates: int | None = None,
                allow_subset: bool = True,
                cache=None,
                incumbent_bound: float | None = None,
                points: Sequence[StrategyPoint] | None = None,
                executor=None, top_k: int = 1,
                prune: bool = True,
                lp_prune: bool = True,
                max_sims: int | None = None,
                obs: Obs | None = None) -> PlanResult:
    """End-to-end planning: resolve the candidate set (cache / enumeration /
    Oobleck-style degrade), then hand it to the tiered search pipeline in
    :mod:`repro_torch.core.search` — feasibility check, analytic bound, coarse
    estimate, full simulation — and return the argmin with per-tier search
    statistics.  This is a thin wrapper; the score loop lives in
    :func:`repro_torch.core.search.score_candidates`.

    Args:
        topo: the cluster, current state (apply events / snapshot first).
        model: the workload description.
        global_batch: total samples per optimizer step.
        seq: sequence length.
        gpus_per_node: node size assumed by enumeration heuristics and the
            Megatron baselines (part of the cache-context identity).
        with_baseline: also score the Megatron default + tuned-uniform
            baselines (fills ``baseline*`` / ``tuned_baseline*``).
        max_candidates: cap on the enumerated candidate list (default
            :data:`DEFAULT_MAX_CANDIDATES`).
        allow_subset: when no feasible (dp, tp, pp) factorization exists
            for the exact alive-device count (e.g. 7 survivors after a
            failure), retire the slowest devices until one does — the
            Oobleck-style degrade path.
        cache: a :class:`repro_torch.core.engine.StrategyCache` (duck-typed — any
            object with a ``context(topo, model, global_batch, seq)``
            method).  Enumeration output, materialized plans and simulator
            scores are then memoized per topology fingerprint, so
            re-planning after a dynamic event only pays for what changed.
        incumbent_bound: a known-achievable step time (the incumbent
            plan's score); candidates whose analytic lower bounds already
            meet it are cut before materialization/simulation.
        points: pre-seeded candidate list (the re-planning engine passes
            the incumbent's neighborhood); skips enumeration entirely.
        executor: a :class:`repro_torch.core.search.SearchExecutor` — the final
            simulation tier then runs in worker processes (the serial and
            parallel paths pick byte-identical plans).
        top_k: how many distinct best plans to report in
            :attr:`PlanResult.top_plans`; the cascade keeps pruning sound
            for the full top-``k`` set, not just the argmin.
        prune: ``False`` disables every pre-simulation tier and
            exhaustively simulates every candidate (the soundness
            reference for tests/benchmarks).
        lp_prune: ``False`` disables only the tier-2.5 LP-relaxation bound
            (:mod:`repro_torch.core.mip`).  The tier is admissible, so toggling
            it never changes the chosen plan — only how many candidates
            reach the simulator.
        max_sims: anytime budget on fully scored candidates (best-bound
            first; see ``score_candidates``).  NOT sound — the argmin
            identity is waived when it binds.  Used by the hierarchical
            island tier to bound fleet-scale sub-searches.
        obs: a :class:`repro_torch.obs.Obs` telemetry bundle; the search records
            ``plan.hybrid``/``plan.enumerate``/``search.*`` spans and
            counters into it.  Defaults to the ``REPRO_TRACE``-driven
            process default (a shared no-op when the env var is unset).

    Returns:
        A :class:`PlanResult` holding the argmin plan, its simulated
        :class:`~repro_torch.core.simulator.StepSim`, baselines and search stats.

    Raises:
        RuntimeError: no candidate survived scoring ("no feasible plan
            found") — undersized/partitioned cluster, or a batch that no
            factorization divides.
    """
    from . import search as search_mod  # deferred: search imports planner
    t0 = time.perf_counter()
    obs = resolve_obs(obs)
    plan_span = obs.span("plan.hybrid", devices=len(topo.alive_ids()),
                         global_batch=global_batch)
    plan_span.__enter__()
    if max_candidates is None:
        max_candidates = DEFAULT_MAX_CANDIDATES
    ctx = cache.context(topo, model, global_batch=global_batch, seq=seq,
                        gpus_per_node=gpus_per_node) \
        if cache is not None else None
    enum_stats = SearchStats()
    if points is None:
        with obs.span("plan.enumerate") as enum_span:
            cached_pts = ctx.get_points() if ctx is not None else None
            if cached_pts is not None:
                points = cached_pts
                enum_stats.explored = len(points)
            else:
                points, enum_stats = enumerate_strategies(
                    topo, model, global_batch=global_batch,
                    gpus_per_node=gpus_per_node)
                if not points and allow_subset:
                    ids = sorted(topo.alive_ids(),
                                 key=lambda i: -topo.device(i).spec.peak_flops
                                 * topo.device(i).perf_factor)
                    for n_use in range(len(ids) - 1, 0, -1):
                        sub = topo.snapshot(0.0)
                        for d in ids[n_use:]:
                            sub.devices[d].alive = False
                        points, enum_stats = enumerate_strategies(
                            sub, model, global_batch=global_batch,
                            gpus_per_node=gpus_per_node)
                        if points:
                            topo = sub
                            # degraded topology is a different fingerprint
                            ctx = cache.context(topo, model,
                                                global_batch=global_batch,
                                                seq=seq,
                                                gpus_per_node=gpus_per_node) \
                                if cache is not None else None
                            break
                if ctx is not None:
                    ctx.put_points(points)
            enum_span.set(explored=enum_stats.explored,
                          cached=cached_pts is not None)
    else:
        points = list(points)
        enum_stats.explored = len(points)
    points = list(points)[:max_candidates]

    stats = SearchStats(explored=enum_stats.explored,
                        pruned=enum_stats.pruned,
                        infeasible=enum_stats.infeasible)
    scored = search_mod.score_candidates(
        topo, model, global_batch=global_batch, seq=seq, points=points,
        ctx=ctx, incumbent_bound=incumbent_bound, keep_top_k=max(1, top_k),
        executor=executor, prune=prune, lp_prune=lp_prune, stats=stats,
        max_sims=max_sims, obs=obs)
    if not scored:
        plan_span.__exit__(None, None, None)
        raise RuntimeError("no feasible plan found")
    best = scored[0]
    top_plans: list[tuple[ParallelPlan, StepSim]] = []
    seen_keys: set = set()
    for out in scored:
        key = out.plan.structural_key()
        if key in seen_keys:
            continue
        seen_keys.add(key)
        top_plans.append((out.plan, out.sim))
        if len(top_plans) >= max(1, top_k):
            break

    baseline = baseline_sim = tuned = tuned_sim = None
    if with_baseline:
        with obs.span("plan.baselines"):
            baseline = megatron_default_plan(topo, model,
                                             gpus_per_node=gpus_per_node)
            baseline_sim = simulate_training_step(
                baseline, model, topo, global_batch=global_batch, seq=seq)
            tuned, tuned_sim = megatron_tuned_plan(
                topo, model, global_batch=global_batch, seq=seq)

    if ctx is not None:
        stats.cache_hits, stats.cache_misses = ctx.counters()
    stats.wall_time = time.perf_counter() - t0
    plan_span.set(simulated=stats.simulated, pruned=stats.pruned,
                  step_time=best.sim.step_time)
    plan_span.__exit__(None, None, None)
    return PlanResult(
        plan=best.plan, predicted=best.sim,
        candidates_evaluated=stats.simulated,
        candidates_pruned=stats.pruned + stats.infeasible,
        candidates_rejected=stats.rejected,
        wall_time=stats.wall_time,
        baseline=baseline, baseline_predicted=baseline_sim,
        tuned_baseline=tuned, tuned_baseline_predicted=tuned_sim,
        search_stats=stats, top_plans=tuple(top_plans))
