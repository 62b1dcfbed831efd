"""Incremental re-planning engine with a persistent strategy cache.

The paper's adaptability claim (§2.2) only holds if re-planning is cheap
enough to run *during* training when the network shifts.  The seed planner
re-enumerated and re-simulated every candidate from scratch on every
topology event; this module makes re-planning incremental:

  * :class:`TopologyFingerprint` — canonical, quantized hash of the alive
    device set (spec + perf-factor bucket) and the effective edge bandwidths
    (log-scale buckets), so "the same topology modulo noise" maps to the
    same cache key while a real change maps to a new one.
  * :class:`StrategyCache` — LRU-bounded memo of ``enumerate_strategies``
    output, per-:class:`StrategyPoint` materialized plans, and simulator
    scores, keyed by fingerprint context.  Hit/miss telemetry folds into
    :class:`SearchStats`.
  * :class:`ReplanEngine` — the ``replan(topo, event)`` entry point.  It
    classifies the topology delta and picks the cheapest sound path:

    ========== ============== ==================================================
    event      device set     re-plan path
    ========== ============== ==================================================
    bandwidth  unchanged      re-score cached materialized plans (simulation
                              only — no enumeration, no layer B&B); only the
                              top-K candidates ranked by a bandwidth-adjusted
                              estimate of their previous score are simulated
                              (batched through ``simulate_many`` on the
                              shared ``SearchExecutor`` when one is
                              attached).
    slowdown   unchanged      ReCycle-style local rebalance of the incumbent
                              (layer split + batch shares) *plus* the top-K
                              re-score above; best of both wins.
    fail/join  changed        seed a bounded search from the incumbent plan's
                              strategy neighborhood (dp/tp/pp within a factor
                              of 2); fall back to full enumeration — with the
                              neighborhood winner's score as the pruning
                              bound — only when the neighborhood is infeasible.
    ========== ============== ==================================================

The engine's cold path *is* :func:`repro_torch.core.planner.plan_hybrid` (with the
cache threaded through), so warm results stay comparable to a from-scratch
plan; `benchmarks/bench_replan.py` measures the latency gap and
`tests/test_engine.py` checks warm/cold step-time equivalence.
"""

from __future__ import annotations

import hashlib
import math
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Sequence

from ..obs import Obs, resolve_obs
from .cluster import ClusterTopology, NetworkEvent
from .opgraph import ModelDesc
from .planner import SearchStats, StrategyPoint, _divisors, plan_hybrid
from .plans import ParallelPlan
from .reconfig import ReconfigCostModel
from .simulator import StepSim, simulate_many, simulate_training_step

# ---------------------------------------------------------------------------
# Topology fingerprinting
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TopologyFingerprint:
    """Canonical quantized view of a topology snapshot.

    ``devices``: sorted (device_id, spec name, perf-factor bucket) triples of
    the alive set.  ``edges``: sorted (a, b, tag, bandwidth bucket) tuples of
    the edges between alive devices.  Bandwidth buckets are log2-scale, so a
    few-percent wobble keeps the key stable while a real shift (2x drop, link
    swap) moves to a new bucket and therefore a new key.
    """

    devices: tuple[tuple[int, str, int], ...]
    edges: tuple[tuple[int, int, str, int], ...]

    @property
    def key(self) -> str:
        return hashlib.sha1(repr((self.devices, self.edges))
                            .encode()).hexdigest()[:16]

    @property
    def device_key(self) -> tuple[tuple[int, str], ...]:
        """Identity of the alive device set, ignoring perf factors — used to
        classify a delta as device-set-changing (fail/join) or not."""
        return tuple((i, name) for i, name, _ in self.devices)


def fingerprint_topology(topo: ClusterTopology, *, bw_quant: float = 0.25,
                         perf_quant: float = 0.05) -> TopologyFingerprint:
    """Fingerprint the *current* state of ``topo`` (apply events/snapshot
    first if you need a particular time).

    ``bw_quant``: bucket width in log2(bytes/s) — 0.25 means edges within
    ~±9% of a bucket center hash identically.  ``perf_quant``: linear bucket
    width for device perf factors.
    """
    devices = tuple(sorted(
        (d.device_id, d.spec.name, int(round(d.perf_factor / perf_quant)))
        for d in topo.alive_devices))
    alive = {d.device_id for d in topo.alive_devices}
    edges = []
    for (a, b), link in sorted(topo.links.items()):
        if a not in alive or b not in alive:
            continue
        for e in link.edges:
            bw = e.effective_bandwidth
            bucket = int(round(math.log2(bw) / bw_quant)) if bw > 0 else -1
            edges.append((a, b, e.tag, bucket))
    return TopologyFingerprint(devices, tuple(sorted(edges)))


# ---------------------------------------------------------------------------
# Strategy cache
# ---------------------------------------------------------------------------


@dataclass
class CacheStats:
    """Session-wide :class:`StrategyCache` telemetry: lookup hits/misses
    across every context plus LRU evictions."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class _CacheEntry:
    """Everything memoized for one (fingerprint, model, batch, seq) context."""

    __slots__ = ("points", "plans", "scores")

    def __init__(self) -> None:
        self.points: list[StrategyPoint] | None = None
        # (StrategyPoint, refine_layers) -> materialized ParallelPlan
        self.plans: dict[tuple[StrategyPoint, bool], ParallelPlan] = {}
        # structural plan key -> StepSim
        self.scores: dict[tuple, StepSim] = {}


def _plan_key(plan: ParallelPlan) -> tuple:
    """Structural identity of a plan — everything the simulator reads."""
    return plan.structural_key()


class _CacheContext:
    """Handle bound to one cache entry; the duck-typed interface
    :func:`plan_hybrid` consumes.  Thread-safe (the planner scores
    candidates from a thread pool)."""

    def __init__(self, cache: "StrategyCache", entry: _CacheEntry):
        self._cache = cache
        self._entry = entry
        self._hits = 0
        self._misses = 0
        self._lock = threading.Lock()

    def _count(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self._hits += 1
            else:
                self._misses += 1
        self._cache._count(hit)

    def counters(self) -> tuple[int, int]:
        with self._lock:
            return self._hits, self._misses

    # -- points ----------------------------------------------------------------

    def get_points(self) -> list[StrategyPoint] | None:
        pts = self._entry.points
        self._count(pts is not None)
        return list(pts) if pts is not None else None

    def put_points(self, points: list[StrategyPoint]) -> None:
        self._entry.points = list(points)

    # -- materialized plans ----------------------------------------------------

    def get_plan(self, point: StrategyPoint, refine: bool) -> ParallelPlan | None:
        plan = self._entry.plans.get((point, refine))
        self._count(plan is not None)
        return plan

    def put_plan(self, point: StrategyPoint, refine: bool,
                 plan: ParallelPlan) -> None:
        with self._lock:
            self._entry.plans[(point, refine)] = plan

    # -- simulator scores ------------------------------------------------------

    def get_score(self, plan: ParallelPlan) -> StepSim | None:
        sim = self._entry.scores.get(_plan_key(plan))
        self._count(sim is not None)
        return sim

    def put_score(self, plan: ParallelPlan, sim: StepSim) -> None:
        with self._lock:
            self._entry.scores[_plan_key(plan)] = sim

    # -- bulk view (warm re-scoring) -------------------------------------------

    def materialized(self) -> list[tuple[tuple[StrategyPoint, bool],
                                         ParallelPlan, StepSim | None]]:
        """All materialized plans with their scores (if simulated)."""
        with self._lock:
            return [(key, plan, self._entry.scores.get(_plan_key(plan)))
                    for key, plan in self._entry.plans.items()]


class StrategyCache:
    """LRU cache of planning work, keyed by topology fingerprint context.

    One *entry* holds the strategy points, materialized plans and simulator
    scores for one (fingerprint, model, global_batch, seq).  ``max_entries``
    bounds memory; least-recently-used contexts are evicted.
    """

    def __init__(self, max_entries: int = 64, *, bw_quant: float = 0.25,
                 perf_quant: float = 0.05, obs: "Obs | None" = None):
        self.max_entries = max_entries
        self.bw_quant = bw_quant
        self.perf_quant = perf_quant
        self.obs = resolve_obs(obs)
        self.stats = CacheStats()
        self._entries: OrderedDict[tuple, _CacheEntry] = OrderedDict()
        self._lock = threading.Lock()

    def _count(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.stats.hits += 1
            else:
                self.stats.misses += 1
        self.obs.inc("cache.hit" if hit else "cache.miss")

    def fingerprint(self, topo: ClusterTopology) -> TopologyFingerprint:
        return fingerprint_topology(topo, bw_quant=self.bw_quant,
                                    perf_quant=self.perf_quant)

    def context(self, topo: ClusterTopology, model: ModelDesc, *,
                global_batch: int, seq: int,
                gpus_per_node: int = 8) -> _CacheContext:
        fp = self.fingerprint(topo)
        # gpus_per_node shapes enumerate_strategies output, so it is part
        # of the context identity
        key = (fp.key, model, global_batch, seq, gpus_per_node)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = _CacheEntry()
                self._entries[key] = entry
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
                    self.stats.evictions += 1
                    self.obs.inc("cache.eviction")
            else:
                self._entries.move_to_end(key)
        return _CacheContext(self, entry)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# ---------------------------------------------------------------------------
# Re-planning engine
# ---------------------------------------------------------------------------


@dataclass
class ReplanResult:
    """Outcome of one (cold or warm) planning call."""

    plan: ParallelPlan
    predicted: StepSim
    path: str                     # cold-plan | bandwidth-rescore |
    #                               straggler-rebalance |
    #                               straggler-neighborhood | neighborhood |
    #                               full-replan
    wall_time: float
    stats: SearchStats
    cold: bool
    # switch-cost hysteresis: modeled cost (s) of moving off the incumbent,
    # and whether the engine kept the incumbent because the projected
    # savings over the remaining horizon did not cover that cost
    switch_cost: float = 0.0
    kept: bool = False
    # best distinct plans from a full (cold) search, best-first — fills the
    # cross-interval DP oracle's widened per-interval candidate set when the
    # engine was built with ``plan_top_k > 1``
    top_plans: tuple[tuple[ParallelPlan, StepSim], ...] = ()


def _comm_scale_estimate(sim: StepSim, plan: ParallelPlan,
                         ratio: float) -> float:
    """Heuristic re-estimate of a plan's step time after every edge bandwidth
    scales by ``ratio``.  Only used to *rank* cached candidates before the
    top-K get truly re-simulated, so it needs the right shape, not accuracy:
    the additive dp-sync term scales exactly, the in-pipeline collective
    totals are normalized and clamped so comm-heavy plans move more than
    compute-heavy ones."""
    if ratio <= 0:
        ratio = 1.0
    inpipe = (sim.tp_comm_time + sim.pp_comm_time) / max(plan.dp, 1)
    comm = min(sim.dp_sync_time + inpipe, 0.95 * sim.step_time)
    return (sim.step_time - comm) + comm / ratio


class ReplanEngine:
    """Incremental re-planner for one (model, global_batch, seq) workload.

    Call :meth:`plan` once to establish the incumbent (cold, full search),
    then :meth:`replan` on every :class:`NetworkEvent`.  All paths share the
    :class:`StrategyCache`, so repeated events on similar topologies keep
    getting cheaper.
    """

    def __init__(self, model: ModelDesc, *, global_batch: int, seq: int,
                 cache: StrategyCache | None = None,
                 max_candidates: int | None = None, rescore_top_k: int = 12,
                 rescore_min_sims: int = 4, rescore_stop_margin: float = 1.35,
                 gpus_per_node: int = 8,
                 reconfig: ReconfigCostModel | None = None,
                 switch_horizon_s: float | None = None,
                 straggler_escalate_gap: float = 1.15,
                 executor=None, plan_top_k: int = 1,
                 lp_prune: bool = True,
                 obs: Obs | None = None):
        self.model = model
        self.global_batch = global_batch
        self.seq = seq
        # tier-2.5 LP bound toggle, forwarded to every plan_hybrid this
        # engine issues (admissible — never changes the chosen plan)
        self.lp_prune = lp_prune
        # telemetry bundle: every replan records a ``replan.<path>`` span,
        # a ``replan.path.<path>`` counter and a ``replan.latency_s``
        # observation into it (no-op unless tracing is on)
        self.obs = resolve_obs(obs)
        self.cache = cache if cache is not None \
            else StrategyCache(obs=self.obs)
        # a repro_torch.core.search.SearchExecutor: full searches then score their
        # final simulation tier in worker processes (plan identity with the
        # serial path is guaranteed by the pipeline's canonical tie-break)
        self.executor = executor
        # how many distinct best plans a cold search reports in
        # ReplanResult.top_plans (the DP oracle's widened candidate set)
        self.plan_top_k = plan_top_k
        self.max_candidates = max_candidates
        self.rescore_top_k = rescore_top_k
        self.rescore_min_sims = rescore_min_sims
        self.rescore_stop_margin = rescore_stop_margin
        self.gpus_per_node = gpus_per_node
        # switch-cost model: every keep/switch decision prices the move off
        # the incumbent through this (no hard-coded reconfig constants).
        # ``switch_horizon_s`` is the remaining-horizon budget the projected
        # savings must amortize the switch over; None means an unbounded
        # horizon (any strictly-better plan is worth its switch cost).
        self.reconfig = reconfig if reconfig is not None \
            else ReconfigCostModel(model)
        self.switch_horizon_s = switch_horizon_s
        # straggler path: escalate to the dp/tp/pp neighborhood search when
        # the local rebalance stays above this factor of the engine's last
        # (pre-event) predicted step time
        self.straggler_escalate_gap = straggler_escalate_gap
        self.incumbent: tuple[ParallelPlan, StepSim] | None = None
        self._device_key: tuple | None = None
        # last applied bandwidth factor per event selector, so consecutive
        # S1 events rank by the *relative* change
        self._bw_factor: dict[str | None, float] = {}
        # (point-key, plan, last StepSim) portfolio for the current device set
        self._portfolio: list[tuple[tuple[StrategyPoint, bool],
                                    ParallelPlan, StepSim | None]] = []
        self.history: list[ReplanResult] = []

    # -- shared helpers --------------------------------------------------------

    def _simulate(self, plan: ParallelPlan, topo: ClusterTopology,
                  ctx: _CacheContext | None = None) -> StepSim | None:
        if ctx is not None:
            sim = ctx.get_score(plan)
            if sim is not None:
                return sim
        try:
            sim = simulate_training_step(plan, self.model, topo,
                                         global_batch=self.global_batch,
                                         seq=self.seq)
        except (ValueError, ZeroDivisionError):
            return None
        if not math.isfinite(sim.step_time):
            # unroutable transfer (partitioned cluster): the plan is
            # infeasible, same verdict simulate_many returns
            return None
        if ctx is not None:
            ctx.put_score(plan, sim)
        return sim

    def _keep_or_switch(self, plan: ParallelPlan, sim: StepSim,
                        topo: ClusterTopology, ctx: _CacheContext | None
                        ) -> tuple[ParallelPlan, StepSim, float, bool]:
        """Switch-cost hysteresis: price moving off the incumbent through
        the :class:`ReconfigCostModel` and keep the incumbent when the
        projected step-time savings over the remaining horizon do not cover
        the modeled switch cost.  Returns (plan, sim, switch_cost, kept)."""
        prev = self.incumbent
        if prev is None or self.reconfig is None:
            return plan, sim, 0.0, False
        prev_plan, _ = prev
        if plan.structural_key() == prev_plan.structural_key():
            return plan, sim, 0.0, False
        # never keep an incumbent naming dead devices: the simulator silently
        # drops dead TP-group members, so its score would be optimistic while
        # the plan is actually unrunnable.  The switch is forced, but still
        # price it (reshard from survivors + store fallback) for telemetry.
        alive = set(topo.alive_ids())
        if prev_plan.world > len(alive) or (prev_plan.stages and not
                                            {d for st in prev_plan.stages
                                             for d in st.device_ids} <= alive):
            return plan, sim, self.reconfig.cost(prev_plan, plan,
                                                 topo).total_s, False
        prev_sim = self._simulate(prev_plan, topo, ctx)
        cost = self.reconfig.cost(prev_plan, plan, topo).total_s
        if prev_sim is None or not math.isfinite(prev_sim.step_time) \
                or prev_sim.step_time <= 0:
            # incumbent no longer simulatable: the switch is forced, but
            # the telemetry still carries what it costs
            return plan, sim, cost, False
        if self.switch_horizon_s is None:
            # unbounded horizon: any strictly-better plan amortizes any
            # finite cost eventually; equal-or-worse keeps the incumbent
            switch = sim.step_time < prev_sim.step_time
        else:
            # running old for H costs H/old steps; switching yields
            # (H - c)/new -> switch iff H * (1 - new/old) > c
            saved = self.switch_horizon_s \
                * (1.0 - sim.step_time / prev_sim.step_time)
            switch = saved > cost
        if switch:
            return plan, sim, cost, False
        return prev_plan, prev_sim, cost, True

    def _finish(self, plan: ParallelPlan, sim: StepSim, path: str,
                t0: float, stats: SearchStats, *, cold: bool,
                topo: ClusterTopology, ctx: _CacheContext | None,
                refresh_portfolio: bool = False,
                top_plans: tuple = ()) -> ReplanResult:
        switch_cost, kept = 0.0, False
        if not cold:
            plan, sim, switch_cost, kept = \
                self._keep_or_switch(plan, sim, topo, ctx)
        self.incumbent = (plan, sim)
        self._device_key = self.cache.fingerprint(topo).device_key
        if refresh_portfolio and ctx is not None:
            # Rebuild the warm-start portfolio from the plans this full
            # search materialized for its own context.  Strategy points that
            # keep a stale prior score still rank in future re-scores.
            # Canonical ordering matters: the context's plan memo is filled
            # in thread-completion order, and downstream tie-breaks (stable
            # rank sort, strict-< best selection) follow portfolio order —
            # identical replays must pick identical plans.
            stale = {key: s for key, _, s in self._portfolio if s is not None}
            self._portfolio = [
                (key, p, s if s is not None else stale.get(key))
                for key, p, s in sorted(
                    ctx.materialized(),
                    key=lambda item: (item[0][0].dp, item[0][0].tp,
                                      item[0][0].pp, item[0][0].ep,
                                      item[0][0].microbatches,
                                      item[0][0].grad_sync, item[0][1]))]
        wall = time.perf_counter() - t0
        res = ReplanResult(plan=plan, predicted=sim, path=path,
                           wall_time=wall, stats=stats,
                           cold=cold, switch_cost=switch_cost, kept=kept,
                           top_plans=tuple(top_plans))
        self.history.append(res)
        # single telemetry funnel: every planning call (cold or warm) exits
        # through here, so the registry sees each path exactly once
        self.obs.inc(f"replan.path.{path}")
        self.obs.observe("replan.latency_s", wall)
        if self.obs.enabled:
            # the path is only known at the end, so the span is backdated
            # to t0 (same perf_counter clock) to cover the whole call
            handle = self.obs.span(f"replan.{path}", cold=cold, kept=kept,
                                   step_time=sim.step_time)
            handle.span.t0 = t0
            handle.__exit__(None, None, None)
        return res

    def seed_incumbent(self, topo: ClusterTopology, plan: ParallelPlan,
                       sim: StepSim) -> None:
        """Adopt an externally-provided incumbent as if :meth:`plan` had
        produced it — warm :meth:`replan` paths dispatch against it without
        a cold search.  The cross-job planner service uses this to hand an
        engine a shared-cache plan remapped onto its device slice
        (:meth:`repro_torch.service.SharedStrategyCache.lookup`); the portfolio
        starts empty, so the first bandwidth re-score falls back to
        re-simulating the incumbent alone and rebuilds from there."""
        self.incumbent = (plan, sim)
        self._device_key = self.cache.fingerprint(topo).device_key
        self._bw_factor = {}
        ctx = self.cache.context(topo, self.model,
                                 global_batch=self.global_batch, seq=self.seq,
                                 gpus_per_node=self.gpus_per_node)
        ctx.put_score(plan, sim)

    def score_plan(self, plan: ParallelPlan,
                   topo: ClusterTopology) -> StepSim | None:
        """Cache-backed simulation of an explicit plan.  Returns None when
        the plan is infeasible on ``topo``.  Prefer :meth:`score_plans` for
        a batch — the topology fingerprint is computed once per call."""
        return self.score_plans([plan], topo)[0]

    def score_plans(self, plans: Sequence[ParallelPlan],
                    topo: ClusterTopology) -> list[StepSim | None]:
        """Simulate explicit plans against one topology through the score
        cache (one fingerprint/context for the whole batch; cache misses go
        through the batched :func:`repro_torch.core.simulator.simulate_many`, so
        the topology snapshot is materialized once).  Benchmarks that sweep
        fixed configurations across dynamic network conditions (fig6c) use
        this; scores repeat for free when the same condition is scored
        again."""
        ctx = self.cache.context(topo, self.model,
                                 global_batch=self.global_batch, seq=self.seq,
                                 gpus_per_node=self.gpus_per_node)
        out: list[StepSim | None] = [ctx.get_score(p) for p in plans]
        missing = [i for i, s in enumerate(out) if s is None]
        if missing:
            fresh = simulate_many([plans[i] for i in missing], self.model,
                                  topo, global_batch=self.global_batch,
                                  seq=self.seq, obs=self.obs)
            for i, sim in zip(missing, fresh):
                if sim is not None:
                    ctx.put_score(plans[i], sim)
                out[i] = sim
        return out

    # -- cold path -------------------------------------------------------------

    def plan(self, topo: ClusterTopology) -> ReplanResult:
        """Full search (enumerate + materialize + simulate), cache-backed.
        Establishes the incumbent plan and the warm-start portfolio."""
        t0 = time.perf_counter()
        ctx = self.cache.context(topo, self.model,
                                 global_batch=self.global_batch, seq=self.seq,
                                 gpus_per_node=self.gpus_per_node)
        res = plan_hybrid(topo, self.model, global_batch=self.global_batch,
                          seq=self.seq, gpus_per_node=self.gpus_per_node,
                          with_baseline=False,
                          max_candidates=self.max_candidates,
                          cache=self.cache, executor=self.executor,
                          top_k=self.plan_top_k, lp_prune=self.lp_prune,
                          obs=self.obs)
        stats = res.search_stats or SearchStats()
        return self._finish(res.plan, res.predicted, "cold-plan", t0, stats,
                            cold=True, topo=topo, ctx=ctx,
                            refresh_portfolio=True,
                            top_plans=res.top_plans)

    # -- warm paths ------------------------------------------------------------

    def replan(self, topo: ClusterTopology,
               event: NetworkEvent | None = None) -> ReplanResult:
        """Re-plan after ``event`` on the (already updated) topology.

        Classifies the actual delta — device set changed vs parameters-only —
        rather than trusting ``event.kind`` alone, and dispatches per the
        decision table in the module docstring.

        Args:
            topo: the cluster with the event ALREADY applied (the caller
                applies events; the engine only reads the current state).
            event: the triggering :class:`NetworkEvent`, used as a routing
                hint (slowdown -> straggler path, bandwidth -> re-score
                ratio); ``None`` falls back to fingerprint classification.

        Returns:
            A :class:`ReplanResult`; ``path`` names the chosen warm/cold
            path, ``kept`` whether switch-cost hysteresis retained the
            incumbent.  The incumbent and history are updated in place.
        """
        if self.incumbent is None or self._device_key is None:
            return self.plan(topo)
        fp = self.cache.fingerprint(topo)
        if fp.device_key != self._device_key:
            return self._replan_device_set(topo)
        if event is not None and event.kind == "slowdown":
            return self._replan_straggler(topo)
        ratio = 1.0
        if event is not None and event.kind == "bandwidth":
            if event.mode == "scale":
                # compositional event: the factor IS the relative change
                ratio = event.factor
                prev = self._bw_factor.get(event.selector, 1.0)
                self._bw_factor[event.selector] = prev * event.factor
            else:
                prev = self._bw_factor.get(event.selector, 1.0)
                ratio = event.factor / prev if prev > 0 else event.factor
                self._bw_factor[event.selector] = event.factor
        return self._replan_bandwidth(topo, ratio)

    def _rescore_portfolio(self, topo: ClusterTopology, ctx: _CacheContext,
                           ratio: float, stats: SearchStats
                           ) -> tuple[float, ParallelPlan, StepSim] | None:
        """Simulate the top-K cached plans (ranked by a bandwidth-adjusted
        estimate of their previous score) on the new topology."""
        inc_plan, _ = self.incumbent  # type: ignore[misc]
        ranked = sorted(
            (p for p in self._portfolio if p[2] is not None),
            key=lambda p: _comm_scale_estimate(p[2], p[1], ratio))
        chosen = ranked[:self.rescore_top_k]
        min_sims = min(self.rescore_min_sims,
                       max(1, len(ranked) // 3))
        # With a shared SearchExecutor, the whole top-K batch (plus the
        # incumbent) is pre-scored in worker processes through the batched
        # simulate_many path.  The serial walk below then *consumes* the
        # pre-computed scores, so the executor path picks the exact plans
        # and portfolio state the serial walk would — only wall time
        # changes.  (ROADMAP open item 3: the warm path used to simulate
        # its top-K serially even when the harness held an executor.)
        pre: dict[int, StepSim | None] = {}
        if self.executor is not None and len(chosen) > 1:
            # ship only the score-cache misses, deduplicated by structural
            # key (the incumbent is usually the best-ranked entry): on
            # cache-hot fingerprints the serial walk simulates ~nothing,
            # and the executor path must not do strictly more work than it
            walk = [(i, p) for i, (_, p, _) in enumerate(chosen)]
            walk.append((len(chosen), inc_plan))
            indices_by_key: dict[tuple, list[int]] = {}
            batch: list[ParallelPlan] = []
            for i, p in walk:
                if ctx is not None and ctx.get_score(p) is not None:
                    continue            # the walk reads it from ctx
                key = p.structural_key()
                if key not in indices_by_key:
                    indices_by_key[key] = []
                    batch.append(p)
                indices_by_key[key].append(i)
            if len(batch) > 1:
                sims = self.executor.simulate_plans(
                    topo, self.model, batch,
                    global_batch=self.global_batch, seq=self.seq)
                for p, sim in zip(batch, sims):
                    for i in indices_by_key[p.structural_key()]:
                        pre[i] = sim

        def scored(idx: int, plan: ParallelPlan) -> StepSim | None:
            if idx not in pre:
                return self._simulate(plan, topo, ctx)
            sim = ctx.get_score(plan) if ctx is not None else None
            if sim is None:
                sim = pre[idx]
                if sim is not None and ctx is not None:
                    ctx.put_score(plan, sim)
            return sim

        fresh: dict[tuple[StrategyPoint, bool], StepSim] = {}
        best: tuple[float, ParallelPlan, StepSim] | None = None
        for i, (key, plan, old) in enumerate(chosen):
            # estimate-gated early stop: the ranking estimate consistently
            # *over*shoots the true step time, so once the next candidate's
            # estimate clears the best simulated time by the stop margin the
            # remaining tail cannot plausibly win
            if (best is not None and stats.explored >= min_sims
                    and _comm_scale_estimate(old, plan, ratio)
                    >= best[0] * self.rescore_stop_margin):
                stats.pruned += len(chosen) - i
                break
            sim = scored(i, plan)
            if sim is None:
                stats.rejected += 1
                continue
            stats.explored += 1
            fresh[key] = sim
            if best is None or sim.step_time < best[0]:
                best = (sim.step_time, plan, sim)
        # the incumbent always gets re-scored, even if ranked out
        inc_sim = scored(len(chosen), inc_plan)
        if inc_sim is not None and (best is None
                                    or inc_sim.step_time < best[0]):
            best = (inc_sim.step_time, inc_plan, inc_sim)
        # fold fresh scores back into the engine-private portfolio (the
        # context's plan memo stays untouched: its materializations belong
        # to full searches on *this* fingerprint, not recycled ones)
        if fresh:
            self._portfolio = [(k, p, fresh.get(k, s))
                               for k, p, s in self._portfolio]
        return best

    def _replan_bandwidth(self, topo: ClusterTopology,
                          ratio: float) -> ReplanResult:
        """S1: same devices, different links — simulation only (no
        enumeration, no layer B&B)."""
        t0 = time.perf_counter()
        stats = SearchStats()
        ctx = self.cache.context(topo, self.model,
                                 global_batch=self.global_batch, seq=self.seq,
                                 gpus_per_node=self.gpus_per_node)
        best = self._rescore_portfolio(topo, ctx, ratio, stats)
        if best is None:                       # cache somehow useless: cold
            return self.plan(topo)
        stats.cache_hits, stats.cache_misses = ctx.counters()
        stats.wall_time = time.perf_counter() - t0
        return self._finish(best[1], best[2], "bandwidth-rescore", t0, stats,
                            cold=False, topo=topo, ctx=ctx)

    def _replan_straggler(self, topo: ClusterTopology) -> ReplanResult:
        """S2: same devices, changed perf factor — local rebalance of the
        incumbent (keep dp/tp/pp; re-split layers and batch shares) raced
        against the top-K portfolio re-score."""
        from .dynamic import reassign_for_straggler
        t0 = time.perf_counter()
        stats = SearchStats()
        ctx = self.cache.context(topo, self.model,
                                 global_batch=self.global_batch, seq=self.seq,
                                 gpus_per_node=self.gpus_per_node)
        inc_plan, _ = self.incumbent  # type: ignore[misc]
        best = self._rescore_portfolio(topo, ctx, 1.0, stats)
        try:
            rebalanced = reassign_for_straggler(
                inc_plan, self.model, topo, batch=self.global_batch,
                seq=self.seq)
            sim = self._simulate(rebalanced, topo, ctx)
        except (ValueError, ZeroDivisionError):
            sim = None
        if sim is not None:
            stats.explored += 1
            if best is None or sim.step_time < best[0]:
                best = (sim.step_time, rebalanced, sim)
        if best is None:
            return self.plan(topo)
        # Escalation: the local rebalance keeps dp/tp/pp frozen, which on
        # strong slowdowns leaves a documented ~11% gap to the oracle.  When
        # the best local result stays above ``straggler_escalate_gap`` x the
        # engine's last (pre-event) prediction, revisit dp/tp/pp through the
        # bounded neighborhood search and race the winner.
        baseline = self.history[-1].predicted.step_time if self.history \
            else math.inf
        path = "straggler-rebalance"
        if math.isfinite(baseline) \
                and best[0] > self.straggler_escalate_gap * baseline:
            neigh = self._neighborhood(len(topo.alive_ids()))
            if neigh:
                try:
                    res = plan_hybrid(
                        topo, self.model, global_batch=self.global_batch,
                        seq=self.seq, gpus_per_node=self.gpus_per_node,
                        with_baseline=False,
                        max_candidates=self.max_candidates, cache=self.cache,
                        points=neigh, allow_subset=False,
                        incumbent_bound=best[0], executor=self.executor,
                        lp_prune=self.lp_prune, obs=self.obs)
                    ns = res.search_stats or SearchStats()
                    stats.explored += ns.explored
                    stats.pruned += ns.pruned
                    stats.rejected += ns.rejected
                    if res.predicted.step_time < best[0]:
                        best = (res.predicted.step_time, res.plan,
                                res.predicted)
                        path = "straggler-neighborhood"
                except RuntimeError:
                    pass
        stats.cache_hits, stats.cache_misses = ctx.counters()
        stats.wall_time = time.perf_counter() - t0
        return self._finish(best[1], best[2], path, t0,
                            stats, cold=False, topo=topo, ctx=ctx,
                            refresh_portfolio=(path ==
                                               "straggler-neighborhood"))

    def _neighborhood(self, n: int) -> list[StrategyPoint]:
        """Strategy points within a factor-2 dp/tp/pp neighborhood of the
        incumbent, valid for an ``n``-device cluster."""
        inc_plan, _ = self.incumbent  # type: ignore[misc]
        m = self.model
        tps = {inc_plan.tp, inc_plan.tp * 2, max(1, inc_plan.tp // 2)}
        pps = {inc_plan.pp, inc_plan.pp + 1, max(1, inc_plan.pp - 1),
               inc_plan.pp * 2, max(1, inc_plan.pp // 2)}
        syncs = {inc_plan.grad_sync, "rs_ag", "allreduce"}
        pts: list[StrategyPoint] = []
        for tp in sorted(tps):
            if n % tp or m.n_heads % tp:
                continue
            for pp in sorted(pps):
                if (n // tp) % pp or pp > m.n_layers:
                    continue
                dp = n // (tp * pp)
                if self.global_batch % dp:
                    continue
                eps = [1]
                if m.n_experts:
                    eps = [e for e in _divisors(m.n_experts) if e <= tp]
                    if inc_plan.ep in eps:
                        eps = [inc_plan.ep]
                for ep in eps:
                    for mb in (pp, 2 * pp, 4 * pp):
                        if (self.global_batch // dp) % mb:
                            continue
                        for sync in sorted(syncs):
                            pts.append(StrategyPoint(dp, tp, pp, ep, mb,
                                                     sync))
        return pts

    def _replan_device_set(self, topo: ClusterTopology) -> ReplanResult:
        """S3: the alive set changed — cached plans reference a dead layout.
        Seed from the incumbent's strategy neighborhood; only when that is
        infeasible, run the full search with the best known score as the
        pruning bound."""
        t0 = time.perf_counter()
        ctx = self.cache.context(topo, self.model,
                                 global_batch=self.global_batch, seq=self.seq,
                                 gpus_per_node=self.gpus_per_node)
        n = len(topo.alive_ids())
        neigh = self._neighborhood(n)
        if neigh:
            try:
                res = plan_hybrid(
                    topo, self.model, global_batch=self.global_batch,
                    seq=self.seq, gpus_per_node=self.gpus_per_node,
                    with_baseline=False,
                    max_candidates=self.max_candidates, cache=self.cache,
                    points=neigh, allow_subset=False,
                    executor=self.executor, lp_prune=self.lp_prune,
                    obs=self.obs)
                stats = res.search_stats or SearchStats()
                return self._finish(res.plan, res.predicted, "neighborhood",
                                    t0, stats, cold=False, topo=topo,
                                    ctx=ctx, refresh_portfolio=True)
            except RuntimeError:
                pass
        # fall back to the full search; a surviving incumbent score bounds
        # the candidates (point_lower_bound cut inside plan_hybrid).  The
        # incumbent only participates if every device it names is still
        # alive — the simulator silently drops dead members from TP groups,
        # so scoring a stale plan would look optimistic while the plan is
        # actually unrunnable.
        alive = set(topo.alive_ids())
        inc_sim = None
        if self.incumbent is not None:
            inc_plan = self.incumbent[0]
            inc_alive = {d for st in inc_plan.stages for d in st.device_ids}
            if inc_plan.world <= len(alive) and inc_alive <= alive:
                inc_sim = self._simulate(inc_plan, topo, ctx)
        bound = inc_sim.step_time if inc_sim is not None else None
        res = plan_hybrid(topo, self.model, global_batch=self.global_batch,
                          seq=self.seq, gpus_per_node=self.gpus_per_node,
                          with_baseline=False,
                          max_candidates=self.max_candidates,
                          cache=self.cache, incumbent_bound=bound,
                          executor=self.executor, lp_prune=self.lp_prune,
                          obs=self.obs)
        stats = res.search_stats or SearchStats()
        best_plan, best_sim = res.plan, res.predicted
        if inc_sim is not None and inc_sim.step_time < best_sim.step_time:
            best_plan, best_sim = self.incumbent[0], inc_sim
        return self._finish(best_plan, best_sim, "full-replan", t0, stats,
                            cold=False, topo=topo, ctx=ctx,
                            refresh_portfolio=True)

    # -- telemetry -------------------------------------------------------------

    def describe(self) -> str:
        """One-paragraph status: plan counts, cache hit rate, and the last
        few :class:`ReplanResult` rows (path, latency, step time, work)."""
        cs = self.cache.stats
        lines = [f"ReplanEngine: {len(self.history)} plans "
                 f"({sum(1 for r in self.history if not r.cold)} warm), "
                 f"cache {cs.hits} hits / {cs.misses} misses "
                 f"({cs.hit_rate:.0%}), {cs.evictions} evictions"]
        for r in self.history[-8:]:
            lines.append(
                f"  {r.path:20s} {r.wall_time * 1e3:8.1f} ms  "
                f"step {r.predicted.step_time * 1e3:8.2f} ms  "
                f"explored {r.stats.explored:4d} pruned {r.stats.pruned:4d} "
                f"rejected {r.stats.rejected:3d}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Hierarchical re-planning (island-routed)
# ---------------------------------------------------------------------------


@dataclass
class HierarchicalReplanResult:
    """Outcome of one hierarchical plan/replan.

    ``islands_replanned`` lists the island indices whose per-island engine
    actually ran (empty when only the inter-island composition was
    refreshed, e.g. a DCI-only bandwidth event); ``island_results`` maps
    those indices to the inner :class:`ReplanResult`.  ``flat_result`` is
    set instead when the cluster was small enough for the flat engine."""

    path: str
    step_time: float
    inter_sync_s: float
    wall_time: float
    islands_replanned: tuple[int, ...] = ()
    island_results: dict = None  # type: ignore[assignment]
    flat_result: ReplanResult | None = None

    def __post_init__(self) -> None:
        if self.island_results is None:
            self.island_results = {}


class HierarchicalReplanEngine:
    """Island-routed incremental re-planner for fleet-scale clusters.

    Wraps :func:`repro_torch.core.islands.plan_hierarchical` the way
    :class:`ReplanEngine` wraps ``plan_hybrid``: :meth:`plan` establishes
    the composed incumbent, :meth:`replan` routes each
    :class:`NetworkEvent` to the narrowest sound scope —

    ========== ================================================================
    event      re-plan scope
    ========== ================================================================
    slowdown   only the island containing the device (its per-island
               :class:`ReplanEngine` runs its warm straggler path on the
               island's subtopology), then recompose.
    bandwidth  only islands holding an *intra-island* edge matching the
               event selector; a selector touching exclusively inter-island
               fabric (e.g. ``"dci"``) replans nothing and just recomputes
               the inter-island sync bound on the updated topology.
    fail/join  full repartition + hierarchical re-plan (island membership
               may shift); sub-searches stay warm through the shared
               :class:`StrategyCache`.
    ========== ================================================================

    Small clusters / single-island partitions delegate to one inner flat
    :class:`ReplanEngine`, preserving its decision table unchanged.
    Batch shares are rebalanced only on full (re-)plans: a degraded island
    keeps its share between full plans, and the composed estimate reflects
    the hit through the max over island step times.
    """

    def __init__(self, model: ModelDesc, *, global_batch: int, seq: int,
                 cache: StrategyCache | None = None, executor=None,
                 flat_limit: int | None = None, fast_frac: float = 0.5,
                 gpus_per_node: int = 8,
                 max_candidates: int | None = None,
                 max_sims: int | None = None,
                 lp_prune: bool = True,
                 obs: Obs | None = None):
        from .islands import DEFAULT_FLAT_LIMIT
        self.model = model
        self.lp_prune = lp_prune
        self.global_batch = global_batch
        self.seq = seq
        self.obs = resolve_obs(obs)
        self.cache = cache if cache is not None \
            else StrategyCache(obs=self.obs)
        self.executor = executor
        self.flat_limit = DEFAULT_FLAT_LIMIT if flat_limit is None \
            else flat_limit
        self.fast_frac = fast_frac
        self.gpus_per_node = gpus_per_node
        self.max_candidates = max_candidates
        self.max_sims = max_sims
        # per-island warm engines, keyed by the island's device-id tuple;
        # created lazily on the first event routed to that island
        self._engines: dict[tuple[int, ...], ReplanEngine] = {}
        # island device-id tuple -> current IslandPlan (composition state)
        self._plans: dict[tuple[int, ...], object] = {}
        self._flat: ReplanEngine | None = None
        self.history: list[HierarchicalReplanResult] = []

    # -- cold path -------------------------------------------------------------

    def _flat_engine(self) -> ReplanEngine:
        if self._flat is None:
            self._flat = ReplanEngine(
                self.model, global_batch=self.global_batch, seq=self.seq,
                cache=self.cache, executor=self.executor,
                max_candidates=self.max_candidates,
                gpus_per_node=self.gpus_per_node, lp_prune=self.lp_prune,
                obs=self.obs)
        return self._flat

    def _wrap_flat(self, inner: ReplanResult) -> HierarchicalReplanResult:
        res = HierarchicalReplanResult(
            path="flat:" + inner.path, step_time=inner.predicted.step_time,
            inter_sync_s=0.0, wall_time=inner.wall_time,
            flat_result=inner)
        self.history.append(res)
        return res

    def plan(self, topo: ClusterTopology) -> HierarchicalReplanResult:
        """Full hierarchical (or flat-fallback) plan; establishes the
        composed incumbent and the island -> sub-plan state.

        Returns a :class:`HierarchicalReplanResult`; raises
        ``RuntimeError`` when no feasible plan exists (partitioned or
        undersized cluster)."""
        from .islands import partition_islands, plan_hierarchical
        t0 = time.perf_counter()
        islands = partition_islands(topo, fast_frac=self.fast_frac)
        if len(topo.alive_ids()) <= self.flat_limit or len(islands) <= 1:
            self._plans, self._engines = {}, {}
            return self._wrap_flat(self._flat_engine().plan(topo))
        hres = plan_hierarchical(
            topo, self.model, global_batch=self.global_batch, seq=self.seq,
            flat_limit=self.flat_limit, fast_frac=self.fast_frac,
            gpus_per_node=self.gpus_per_node,
            max_candidates=self.max_candidates, max_sims=self.max_sims,
            cache=self.cache, executor=self.executor,
            lp_prune=self.lp_prune, obs=self.obs)
        assert hres.composed is not None
        self._plans = {ip.island.device_ids: ip
                       for ip in hres.composed.islands}
        self._engines = {}
        res = HierarchicalReplanResult(
            path="hierarchical:cold",
            step_time=hres.composed.step_time,
            inter_sync_s=hres.composed.inter_sync_s,
            wall_time=time.perf_counter() - t0,
            islands_replanned=tuple(ip.island.index
                                    for ip in hres.composed.islands))
        self.history.append(res)
        return res

    # -- warm path -------------------------------------------------------------

    def _engine_for(self, topo: ClusterTopology, ip) -> ReplanEngine:
        """The island's warm engine, lazily seeded with the island's
        current sub-plan as incumbent (portfolio starts empty: warm paths
        always re-score the incumbent, so the seed suffices)."""
        key = ip.island.device_ids
        eng = self._engines.get(key)
        if eng is None:
            eng = ReplanEngine(
                self.model, global_batch=ip.batch, seq=self.seq,
                cache=self.cache, executor=self.executor,
                max_candidates=self.max_candidates,
                gpus_per_node=self.gpus_per_node, lp_prune=self.lp_prune,
                obs=self.obs)
            eng.incumbent = (ip.plan, ip.predicted)
            eng._device_key = self.cache.fingerprint(
                topo.subtopology(key)).device_key
            self._engines[key] = eng
        return eng

    def _intra_island_tags(self, topo: ClusterTopology
                           ) -> dict[tuple[int, ...], set[str]]:
        """Edge tags appearing on links internal to each composed island
        (one pass over the link table)."""
        member: dict[int, tuple[int, ...]] = {}
        for key in self._plans:
            for d in key:
                member[d] = key
        tags: dict[tuple[int, ...], set[str]] = {k: set()
                                                 for k in self._plans}
        for (a, b), link in topo.links.items():
            ka, kb = member.get(a), member.get(b)
            if ka is not None and ka is kb:
                tags[ka].update(e.tag for e in link.edges)
        return tags

    def _compose(self, topo: ClusterTopology) -> tuple[float, float]:
        from .islands import inter_island_sync_bound
        ids = [ip.island.device_ids for ip in self._plans.values()]
        inter = inter_island_sync_bound(topo, ids, self.model) \
            if len(ids) > 1 else 0.0
        step = max(ip.predicted.step_time
                   for ip in self._plans.values()) + inter
        return step, inter

    def replan(self, topo: ClusterTopology,
               event: NetworkEvent | None = None
               ) -> HierarchicalReplanResult:
        """Re-plan after ``event`` on the (already updated) topology,
        touching only the affected island(s) — see the class docstring's
        routing table.

        Args:
            topo: the cluster with the event ALREADY applied.
            event: the triggering event; ``None`` (or a device-set change)
                repartitions via :meth:`plan`.

        Returns:
            A :class:`HierarchicalReplanResult` with the refreshed composed
            step estimate; per-island inner results in ``island_results``.
        """
        if not self._plans:
            if self._flat is not None and self._flat.incumbent is not None:
                return self._wrap_flat(self._flat.replan(topo, event))
            return self.plan(topo)
        if event is None or event.kind in ("fail", "join"):
            return self.plan(topo)
        t0 = time.perf_counter()
        from .islands import IslandPlan
        if event.kind == "slowdown":
            targets = [ip for ip in self._plans.values()
                       if event.device_id in ip.island.device_ids]
            if not targets:
                return self.plan(topo)   # unknown device: repartition
        else:  # bandwidth
            tags = self._intra_island_tags(topo)
            targets = [ip for ip in self._plans.values()
                       if event.selector is None
                       or event.selector in tags[ip.island.device_ids]]
        results: dict[int, ReplanResult] = {}
        for ip in targets:
            eng = self._engine_for(topo, ip)
            inner = eng.replan(topo.subtopology(ip.island.device_ids),
                               event)
            results[ip.island.index] = inner
            self._plans[ip.island.device_ids] = IslandPlan(
                island=ip.island, plan=inner.plan,
                predicted=inner.predicted, batch=ip.batch, searched=True)
        step, inter = self._compose(topo)
        paths = sorted({r.path for r in results.values()}) or ["recompose"]
        res = HierarchicalReplanResult(
            path="hierarchical:" + "+".join(paths),
            step_time=step, inter_sync_s=inter,
            wall_time=time.perf_counter() - t0,
            islands_replanned=tuple(sorted(results)),
            island_results=results)
        self.history.append(res)
        return res
