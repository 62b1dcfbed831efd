"""Tiered strategy-search pipeline (paper §3.4 pruning + §4 parallel sim).

The paper's search acceleration rests on two legs: *strategy pruning* that
discards infeasible/hopeless configurations before they reach the expensive
simulator, and *parallel execution within the simulator* for the candidates
that survive.  This module is both legs:

Tier 0  ``point_feasible``      structural/memory feasibility (Eq. 6,
                                divisibility, EP alignment) — pure arithmetic.
Tier 1  ``point_lower_bound``   analytic optimistic step time (compute over
                                aggregate throughput + dp-sync floor).
Tier 2  ``coarse_lower_bound``  tighter closed-form estimate adding the
                                pipeline-chain / bottleneck-stage and TP
                                collective floors — still admissible.
Tier 2.5 ``lp`` (repro_torch.core.mip) class-capacity packing LP: fractional
                                layer->TP-group assignment with per-class
                                slot capacities, fabric-priced collective
                                floors and microbatch occupancy rows —
                                still admissible, much tighter on
                                heterogeneous fleets (memoized per tp and
                                skipped by a cost guard when the projected
                                solver wall exceeds projected sim savings).
Tier 3  materialize + simulate  the full pipeline (layer B&B, batch shares,
                                1F1B step simulation).

Tiers prune against a **monotonically tightening incumbent bound**: the
k-th best *simulated* step time seen so far (``keep_top_k``), plus any
externally supplied ``incumbent_bound``.  Every tier-1/2 bound undershoots
the simulator by construction, and dynamic pruning is strict (``>``), so the
cascade can never discard the true argmin (or any member of the true
top-k) — the hypothesis property test in ``tests/test_search.py`` checks
this against exhaustive scoring.

:class:`SearchExecutor` runs tier 3 in **worker processes** (spawn-safe,
chunked, picklable ``(point, refine)`` work items).  Workers share one
cross-process incumbent bound (a ``multiprocessing.Value``) so pruning keeps
tightening while chunks are in flight, amortize per-process topology/model
setup via a token-keyed context cache + :func:`repro_torch.core.simulator
.simulate_many`, and return per-worker cache deltas that the parent merges
back into the session :class:`repro_torch.core.engine.StrategyCache`.  Because
pruned candidates provably cannot beat (or tie) any simulated one, and final
selection is the deterministic ``(step_time, canonical index)`` argmin,
serial and process-parallel searches pick **byte-identical plans** no matter
the completion order.
"""

from __future__ import annotations

import hashlib
import math
import os
import pickle
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from dataclasses import dataclass
from multiprocessing import get_context
from typing import Sequence

from ..obs import Obs, resolve_obs
from .cluster import ClusterTopology
from .costmodel import collective_floor
from .fabric import default_fabric, set_default_fabric
from .opgraph import ModelDesc
from .planner import (SearchStats, StrategyPoint, materialize_plan,
                      point_lower_bound)
from .plans import ParallelPlan
from .simulator import StepSim, simulate_many

# Cascade-tier slugs: SearchStats field suffix == repro_torch.obs counter suffix,
# so _note_pruned is the single tally point for both
# (the per-tier counters and the ``pruned`` total used to be bumped in five
# separate places and could silently drift from ``cascade_candidates``).
_TIERS = ("feasibility", "bound", "coarse", "lp")


def _note_pruned(stats: SearchStats, obs: Obs, tier: str, n: int) -> None:
    """Record ``n`` candidates cut by cascade tier ``tier`` — bumps the
    per-tier :class:`SearchStats` field, the shared ``pruned`` total, and
    the ``search.pruned.<tier>`` registry counter together."""
    if n <= 0:
        return
    setattr(stats, f"pruned_{tier}", getattr(stats, f"pruned_{tier}") + n)
    stats.pruned += n
    obs.inc(f"search.pruned.{tier}", n)

# ---------------------------------------------------------------------------
# Tier 0: structural / memory feasibility
# ---------------------------------------------------------------------------


def point_feasible(point: StrategyPoint, topo: ClusterTopology,
                   model: ModelDesc, *, global_batch: int) -> bool:
    """The same constraint system ``enumerate_strategies`` emits under
    (§3.4 / Eq. 6), re-checked cheaply so pre-seeded candidate lists (the
    re-planning engine's neighborhood) go through identical pruning.  Any
    point emitted by enumeration passes by construction."""
    n = len(topo.alive_ids())
    if point.dp * point.tp * point.pp != n:
        return False
    if point.tp < 1 or model.n_heads % point.tp:
        return False
    if point.pp > model.n_layers:
        return False
    if global_batch % point.dp:
        return False
    if (global_batch // point.dp) % point.microbatches:
        return False
    mem = min(d.spec.mem_bytes for d in topo.alive_devices)
    if model.total_params() * 12 / (point.tp * point.pp) > mem * 0.9:
        return False
    if model.n_experts and (model.n_experts % point.ep
                            or point.ep > point.tp):
        return False
    return True


# ---------------------------------------------------------------------------
# Tier 2: coarse admissible estimate
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _BoundCtx:
    """Cluster/model aggregates shared by every candidate's tier-2 bound."""

    # distinct alive (DeviceSpec, perf_factor) classes — per-layer floors
    # take the min across classes, so a heterogeneous fleet collapses to a
    # handful of roofline evaluations instead of one per device
    classes: tuple[tuple, ...]
    # fastest bottleneck any ring over g devices can achieve, indexed by
    # g - 1; combines three sound caps (see _bound_context)
    ring_bw_by_size: tuple[float, ...]
    layer_flops1: tuple[float, ...]    # per-layer flops at batch=1
    layer_params: tuple[float, ...]    # per-layer parameter counts
    layer_is_attn: tuple[bool, ...]    # unfused-attention traffic applies
    act_per_sample: float              # seq * d_model * dtype bytes
    dtype_bytes: float
    n_heads: int
    seq: int


def _bound_context(topo: ClusterTopology, model: ModelDesc, *,
                   seq: int) -> _BoundCtx:
    from .opgraph import layer_flops
    classes = tuple({(d.spec, d.perf_factor) for d in topo.alive_devices})
    alive = set(d.device_id for d in topo.alive_devices)
    pair_best: dict[tuple[int, int], float] = {}
    incident: dict[int, float] = {d: 0.0 for d in alive}
    for (a, b), link in topo.links.items():
        if a in alive and b in alive and link.edges:
            bw = max(e.effective_bandwidth for e in link.edges)
            if bw <= 0:
                # a fully dead link routes like a missing one
                # (costmodel._has_live_edge) — keep the pair graph in sync
                # so `complete` below means "every pair priced direct"
                continue
            pair_best[(a, b)] = bw
            incident[a] = max(incident[a], bw)
            incident[b] = max(incident[b], bw)
    # Fastest bottleneck a ring over g devices can possibly achieve.  Three
    # independently sound caps, combined by min:
    #   (a) a ring over g >= 3 devices crosses g distinct pairs -> g-th
    #       largest pair bw (a 2-ring reuses its single pair both ways, so
    #       only the best pair caps it),
    #   (b) every member's two ring hops are capped by its best incident
    #       link -> g-th best-connected device,
    #   (c) a ring with bottleneck B connects its g members through edges
    #       of bw >= B -> highest B whose >=B-subgraph has a connected
    #       component of >= g devices (union-find over descending bw).
    # (c) is what catches multi-node rings: a tp=32 group over 4 NVLink
    # islands must cross the inter-node fabric no matter how it is laid
    # out.
    #
    # On a sparse link graph (TPU torus) a ring pair without a direct link
    # is priced by the fabric's ring_capacity (repro_torch.core.fabric): the
    # pair streams cut-through chunks at its route's bottleneck rate,
    # divided by how many ring pairs share each directed physical link.
    # That price never exceeds ANY hop's own bandwidth (load >= 1), which
    # is the invariant both surviving caps rest on: (b) stays sound (a
    # routed pair's first hop is incident to the member, so its price <=
    # the member's best incident link) and (c) stays sound (a pair priced
    # >= B has every hop's bandwidth >= B, so its whole route lies in the
    # >=B subgraph and the g members share a component there).  The old
    # store-and-forward resistance-sum argument (price <= 1/sum(1/bw))
    # was *stronger* than needed and no longer holds under pipelining;
    # only the per-hop form above is load-bearing.  Cap (a) does NOT
    # survive routing — g routed pairs may share one fast physical edge
    # (e.g. a line graph's wrap-around pair reuses every link) — so it
    # applies on complete graphs only.  The caps are then scaled by the
    # fabric's linearized rate (FabricModel.linear_bw): the simulator
    # prices every hop at beta * bw, so a calibrated beta < 1 tightens the
    # ring caps by the same factor, while linear_bw's clamp at 1 keeps a
    # non-physical beta > 1 (which would price sims *below* the raw caps)
    # from breaking admissibility — tools/calibrate_fabric.py clamps
    # beta <= 1 anyway, and the never-over-prune property test guards the
    # rest.
    pair_bws = sorted(pair_best.values(), reverse=True)
    dev_bws = sorted(incident.values(), reverse=True)
    n = len(alive)
    complete = len(pair_best) == n * (n - 1) // 2
    comp_bw = [0.0] * (n + 1)
    parent = {d: d for d in alive}
    size = {d: 1 for d in alive}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    reached = 1
    for (a, b), bw in sorted(pair_best.items(), key=lambda kv: -kv[1]):
        ra, rb = find(a), find(b)
        if ra != rb:
            if size[ra] < size[rb]:
                ra, rb = rb, ra
            parent[rb] = ra
            size[ra] += size[rb]
            while reached < size[ra]:
                reached += 1
                comp_bw[reached] = bw
    ring_by_size = []
    for g in range(1, n + 1):
        if not pair_bws:
            ring_by_size.append(0.0)
        elif g == 1:
            ring_by_size.append(pair_bws[0])
        else:
            # comp_bw[g] == 0 means no component holds g devices: every
            # g-ring crosses a partition and simulates to inf, so any cap
            # is sound — 0.0 simply disables the term (still admissible)
            caps = [dev_bws[min(g, len(dev_bws)) - 1], comp_bw[g]]
            if complete:
                pairs_crossed = g if g >= 3 else 1
                caps.append(pair_bws[min(pairs_crossed, len(pair_bws)) - 1])
            ring_by_size.append(min(caps))
    fab = default_fabric()
    ring_by_size = [fab.linear_bw(bw) for bw in ring_by_size]
    L = model.n_layers
    return _BoundCtx(
        classes=classes,
        ring_bw_by_size=tuple(ring_by_size),
        layer_flops1=tuple(layer_flops(model, l, 1, seq) for l in range(L)),
        layer_params=tuple(float(model.layer_params(l)) for l in range(L)),
        layer_is_attn=tuple(model.layer_kind(l) == "attn" for l in range(L)),
        act_per_sample=seq * model.d_model * model.dtype_bytes,
        dtype_bytes=model.dtype_bytes, n_heads=model.n_heads, seq=seq)


def _ring_bw(bctx: _BoundCtx, group_size: int) -> float:
    """Fastest bottleneck any ring over ``group_size`` devices can achieve
    (precomputed in :func:`_bound_context`); 0.0 disables the term."""
    if not bctx.ring_bw_by_size:
        return 0.0
    return bctx.ring_bw_by_size[
        min(group_size, len(bctx.ring_bw_by_size)) - 1]


def _sync_floor(point: StrategyPoint, bctx: _BoundCtx) -> float:
    """Gradient-sync ring floor shared by the coarse and LP tiers: the
    point's sync collective (decomposed rs+ag, or the naive root-funnel
    reduce+broadcast pair) on the *mean* per-stage parameter shard at the
    fastest dp-ring bandwidth.  The simulator adds dp_sync — the max over
    stages, for both sync modes >= the decomposed ring time — after the
    pipeline flush, so this undershoots it for every materialization."""
    dp = point.dp
    if dp <= 1:
        return 0.0
    bw = _ring_bw(bctx, dp)
    if bw <= 0:
        return 0.0
    shard = sum(bctx.layer_params) * bctx.dtype_bytes / (point.pp * point.tp)
    kind = "rs_ag" if point.grad_sync == "rs_ag" else "reduce_broadcast"
    return collective_floor(kind, shard, dp, bw)


def _coarse_bound(point: StrategyPoint, bctx: _BoundCtx, *,
                  global_batch: int) -> float:
    """Admissible pipeline floor for one strategy point, tighter than the
    aggregate-throughput bound on comm-heavy / memory-bound / deep-pipeline
    candidates.

    Derivation (each step undershoots the 1F1B simulator):

      * some DP rank carries a batch share >= 1/dp, so its per-microbatch
        batch is >= global_batch / (dp * M);
      * that rank's microbatch-0 chain crosses every stage forward then
        backward: sum_s (fwd_s + bwd_s) = 3x per-layer compute + 2x the TP
        collective total (2 all-reduces per layer in fwd, 2 in bwd);
      * per-layer compute is floored by the *minimum over device classes*
        of that class's own roofline (fusion-aware traffic included) — the
        actual stage device is one of the classes, so its time can only be
        higher;
      * collectives are floored by the ring bandwidth term at the g-th
        largest pair bandwidth (:func:`_ring_bw`) — any real tp/dp ring's
        bottleneck edge is at most that;
      * the bottleneck stage serializes all M microbatches and by
        pigeonhole holds >= 1/pp of the total work, so the chain also
        scales by max(1, M / pp);
      * the 1F1B drain lemma adds a fill/drain floor the busy-time factor
        misses on deep pipelines (M <= pp): for ANY stage s, microbatch 0
        must cross every earlier stage before s's first forward, round-trip
        the later stages before s's first backward, s then serializes its M
        backwards, and the last microbatch's backward still drains through
        the earlier stages — so makespan >= chain + (M-1) * bwd_s.  With
        bwd_s >= (fwd_s + bwd_s) / 2 for every stage the simulator prices
        (bwd = 2x fwd compute + the same collectives; remat only raises
        it), the bottleneck stage (>= chain / pp by pigeonhole) gives
        makespan >= chain * (1 + (M-1) / (2 pp)) — the pipeline factor is
        the max of both legs;
      * the gradient-sync floor (2x ring factor on the mean per-stage
        parameter shard) adds on top — the simulator adds dp_sync (the max
        over stages, for both sync modes >= the decomposed ring time) after
        the pipeline flush.

    Ignored-but-positive simulator terms (p2p transfers, remat recompute,
    MoE all-to-all, collective latency) keep it admissible.  Do not tighten
    any term toward the simulator without re-running the never-over-prune
    property test in ``tests/test_search.py``.
    """
    dp, tp, pp, M = point.dp, point.tp, point.pp, point.microbatches
    mb = global_batch / (dp * M)
    act = mb * bctx.act_per_sample
    chain = 0.0
    for l, fl1 in enumerate(bctx.layer_flops1):
        fl = fl1 * mb / tp
        base_traffic = (4.0 * act + bctx.layer_params[l] * bctx.dtype_bytes) \
            / tp
        attn_traffic = (4.0 * mb * bctx.n_heads * bctx.seq * bctx.seq
                        * bctx.dtype_bytes / tp) if bctx.layer_is_attn[l] \
            else 0.0
        t = math.inf
        for spec, perf in bctx.classes:
            traffic = base_traffic
            if attn_traffic and not spec.supports_fusion:
                traffic += attn_traffic
            t = min(t, spec.roofline_time(fl, traffic, perf_factor=perf))
        chain += 3.0 * t
    if tp > 1:
        bw = _ring_bw(bctx, tp)
        if bw > 0:
            chain += 4.0 * len(bctx.layer_flops1) \
                * collective_floor("all_reduce", act, tp, bw)
    pipe = chain * max(1.0, M / pp, 1.0 + (M - 1.0) / (2.0 * pp))
    return pipe + _sync_floor(point, bctx)


def coarse_lower_bound(point: StrategyPoint, topo: ClusterTopology,
                       model: ModelDesc, *, global_batch: int,
                       seq: int) -> float:
    """Tier-2 estimate: max of the tier-1 analytic bound and the pipeline
    floor — by construction >= :func:`point_lower_bound` and still <= the
    simulated step time of every materialization of ``point``."""
    lb1 = point_lower_bound(point, topo, model, global_batch=global_batch,
                            seq=seq)
    bctx = _bound_context(topo, model, seq=seq)
    return max(lb1, _coarse_bound(point, bctx, global_batch=global_batch))


# ---------------------------------------------------------------------------
# Tier 3: materialization + simulation (shared by parent and workers)
# ---------------------------------------------------------------------------


def materialize_variant(point: StrategyPoint, refine: bool,
                        topo: ClusterTopology, model: ModelDesc, *,
                        global_batch: int, seq: int) -> ParallelPlan:
    """One concrete plan per (point, refine) work item.  ``refine=True`` is
    the heterogeneity-refined materialization (layer B&B + uneven shares);
    ``refine=False`` forces the plain uniform layout — on near-identical
    devices the forced uneven split can lose to uniform, so the search
    space includes both (operator splitting is a *choice*, §2.3)."""
    plan = materialize_plan(point, topo, model, global_batch=global_batch,
                            seq=seq, refine_layers=refine)
    if not refine:
        plan = ParallelPlan(
            dp=plan.dp, tp=plan.tp, pp=plan.pp, ep=plan.ep,
            microbatches=plan.microbatches, stages=plan.stages,
            batch_shares=tuple([1.0 / plan.dp] * plan.dp),
            grad_sync=plan.grad_sync, zero1=plan.zero1, meta=plan.meta)
    return plan


@dataclass(frozen=True)
class CandidateOutcome:
    """One fully simulated (point, refine) candidate."""

    index: int               # canonical position in the expanded candidate
    #                          list — the deterministic tie-break
    point: StrategyPoint
    refine: bool
    plan: ParallelPlan
    sim: StepSim


def _score_variant(point: StrategyPoint, refine: bool,
                   topo: ClusterTopology, model: ModelDesc, *,
                   global_batch: int, seq: int, ctx=None,
                   memo: dict | None = None, obs=None,
                   plans: dict | None = None
                   ) -> tuple[ParallelPlan, StepSim] | None:
    """Cache-aware materialize + simulate; None on rejection (the candidate
    raised ValueError/ZeroDivisionError somewhere in the pipeline).  ``obs``
    reaches :func:`repro_torch.core.simulator.simulate_many` so traced serial
    searches record per-candidate ``sim.batch`` spans (worker chunks leave
    it unset — shared-bound timing makes their sim counts nondeterministic,
    and the chunk span already covers the time).  ``plans`` is a read-only
    materialization snapshot (worker processes receive the parent
    :class:`repro_torch.core.engine.StrategyCache`'s already-built plans in the
    context blob) consulted after ``ctx`` — a snapshot hit skips the
    materialization pipeline but never the simulation."""
    plan = ctx.get_plan(point, refine) if ctx is not None else None
    if plan is None and plans is not None:
        plan = plans.get((point, refine))
    if plan is None:
        try:
            plan = materialize_variant(point, refine, topo, model,
                                       global_batch=global_batch, seq=seq)
        except (ValueError, ZeroDivisionError):
            return None
        if ctx is not None:
            ctx.put_plan(point, refine, plan)
    sim = ctx.get_score(plan) if ctx is not None else None
    if sim is None:
        key = plan.structural_key()
        sim = memo.get(key) if memo is not None else None
        if sim is None:
            sim = simulate_many([plan], model, topo,
                                global_batch=global_batch, seq=seq,
                                obs=obs)[0]
            if sim is None:
                return None
            if memo is not None:
                memo[key] = sim
        if ctx is not None:
            ctx.put_score(plan, sim)
    return plan, sim


# ---------------------------------------------------------------------------
# Worker side (module-level for spawn picklability)
# ---------------------------------------------------------------------------

_SHARED_BOUND = None       # multiprocessing.Value('d') injected at pool init
_CTX_TOKEN: str | None = None
_CTX_STATE: tuple | None = None
_CTX_MEMO: dict = {}
_CTX_SNAPSHOT: dict = {}   # read-only (point, refine) -> ParallelPlan


def _pool_init(shared_bound) -> None:
    global _SHARED_BOUND
    _SHARED_BOUND = shared_bound
    # Workers must not inherit the parent's REPRO_TRACE default: each would
    # atexit-dump its own (uncollected) trace over the parent's file.
    # Worker telemetry is shipped explicitly (_score_chunk traced=True).
    os.environ.pop("REPRO_TRACE", None)


def _pool_warm(_: int) -> int:
    """No-op used to absorb worker start-up (interpreter + repro import)."""
    return 0


def _load_search_ctx(token: str, blob: bytes) -> tuple:
    """(topo, model, global_batch, seq), unpickled once per worker per
    search — chunks of the same search reuse it (amortized setup).  The
    parent's default :class:`repro_torch.core.fabric.FabricModel` rides along and
    is installed as this worker's default, so serial and process-parallel
    searches price identically even under a non-default calibration; so
    does a read-only :class:`repro_torch.core.engine.StrategyCache`
    materialization snapshot, sparing workers plan rebuilds the parent
    already paid for.  The token hashes the whole blob — fabric AND
    snapshot version included — so a stale context (recalibrated fabric,
    cache grown since the last search) forces a reload instead of serving
    old state."""
    global _CTX_TOKEN, _CTX_STATE, _CTX_MEMO, _CTX_SNAPSHOT
    if token != _CTX_TOKEN:
        *state, fabric, snapshot = pickle.loads(blob)
        set_default_fabric(fabric)
        _CTX_STATE = tuple(state)
        _CTX_SNAPSHOT = snapshot
        _CTX_TOKEN = token
        _CTX_MEMO = {}
    return _CTX_STATE  # type: ignore[return-value]


def _sim_chunk(token: str, blob: bytes,
               items: "list[tuple[int, ParallelPlan]]"
               ) -> "list[tuple[int, StepSim | None]]":
    """Score one chunk of explicit (index, plan) items via the batched
    :func:`repro_torch.core.simulator.simulate_many` (one topology snapshot per
    chunk).  Serves :meth:`SearchExecutor.simulate_plans` — the warm
    bandwidth-rescore path's top-K portfolio re-simulation."""
    topo, model, global_batch, seq = _load_search_ctx(token, blob)
    sims = simulate_many([p for _, p in items], model, topo,
                         global_batch=global_batch, seq=seq)
    return [(i, sim) for (i, _), sim in zip(items, sims)]


def _score_chunk(token: str, blob: bytes,
                 tasks: list[tuple[float, int, StrategyPoint, bool]],
                 threshold: float, tighten: bool, chunk_index: int = 0,
                 traced: bool = False
                 ) -> tuple[list[tuple[int, StrategyPoint, bool,
                                       ParallelPlan, StepSim]], int, int,
                            "tuple[list[dict], dict] | None"]:
    """Score one chunk of (bound, index, point, refine) work items.

    Returns (outcomes, n_rejected, n_pruned, obs_delta).  The pruning
    threshold is the static ``threshold`` tightened by the cross-process
    shared bound (only read when ``tighten`` — i.e. ``keep_top_k == 1``,
    where a single shared scalar is the correct k-th best).

    With ``traced`` the chunk records into a worker-local
    :class:`repro_torch.obs.Obs` and ships the delta (span dicts + metrics
    snapshot) back for the parent to re-parent under its tier-3 span —
    tracing never touches scoring, so serial == parallel plan identity is
    unaffected."""
    topo, model, global_batch, seq = _load_search_ctx(token, blob)
    wobs = Obs(enabled=True) if traced else None
    handle = wobs.span("search.worker.chunk", chunk=chunk_index,
                       n_tasks=len(tasks)) if wobs is not None else None
    out: list[tuple[int, StrategyPoint, bool, ParallelPlan, StepSim]] = []
    rejected = pruned = 0
    for bound, index, point, refine in tasks:
        thr = threshold
        if tighten and _SHARED_BOUND is not None:
            thr = min(thr, _SHARED_BOUND.value)
        if bound > thr:
            pruned += 1
            continue
        res = _score_variant(point, refine, topo, model,
                             global_batch=global_batch, seq=seq,
                             memo=_CTX_MEMO, plans=_CTX_SNAPSHOT)
        if res is None:
            rejected += 1
            continue
        plan, sim = res
        out.append((index, point, refine, plan, sim))
        if tighten and _SHARED_BOUND is not None \
                and sim.step_time < _SHARED_BOUND.value:
            with _SHARED_BOUND.get_lock():
                if sim.step_time < _SHARED_BOUND.value:
                    _SHARED_BOUND.value = sim.step_time
    delta = None
    if wobs is not None:
        handle.set(simulated=len(out), rejected=rejected, pruned=pruned)
        handle.__exit__(None, None, None)
        wobs.inc("search.worker.chunks")
        delta = wobs.export_delta()
    return out, rejected, pruned, delta


# ---------------------------------------------------------------------------
# SearchExecutor: long-lived spawn pool for the final tier
# ---------------------------------------------------------------------------


class SearchExecutor:
    """Process pool that scores the cascade's final tier.

    Spawn-safe (workers import only dependency-free ``repro_torch.core``), reusable
    across many searches (the scenario harness keeps one executor alive for
    a whole trace replay instead of re-spawning per interval), and
    deterministic: whatever the completion order, the parent's
    ``(step_time, index)`` argmin matches the serial cascade's.

    ``n_procs`` defaults to the machine's core count; ``chunk_size`` to an
    even split into ~4 chunks per worker (small enough that the tightening
    bound keeps helping, large enough to amortize dispatch).
    """

    def __init__(self, n_procs: int | None = None,
                 chunk_size: int | None = None):
        self.n_procs = max(1, n_procs if n_procs is not None
                           else (os.cpu_count() or 1))
        self.chunk_size = chunk_size
        self._mp = get_context("spawn")
        self._pool: ProcessPoolExecutor | None = None
        self._bound = None

    # -- lifecycle -------------------------------------------------------------

    def _ensure(self) -> ProcessPoolExecutor:
        if self._pool is None:
            self._bound = self._mp.Value("d", math.inf)
            self._pool = ProcessPoolExecutor(
                max_workers=self.n_procs, mp_context=self._mp,
                initializer=_pool_init, initargs=(self._bound,))
        return self._pool

    def warm(self) -> None:
        """Start the workers now so pool spin-up does not pollute timed
        regions (benchmarks call this before measuring)."""
        pool = self._ensure()
        list(pool.map(_pool_warm, range(self.n_procs)))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
            self._bound = None

    def __enter__(self) -> "SearchExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- scoring ---------------------------------------------------------------

    def run(self, topo: ClusterTopology, model: ModelDesc, *,
            global_batch: int, seq: int,
            tasks: Sequence[tuple[float, int, StrategyPoint, bool]],
            threshold: float, tighten: bool, obs: Obs | None = None,
            snapshot: "dict[tuple[StrategyPoint, bool], ParallelPlan] "
                      "| None" = None
            ) -> tuple[list[tuple[int, StrategyPoint, bool,
                                  ParallelPlan, StepSim]], int, int]:
        """Score ``tasks`` across the pool; returns (outcomes, rejected,
        pruned) merged over all chunks.  With an enabled ``obs``, worker
        chunk spans are shipped back and re-parented under the caller's
        current span (one Perfetto lane per worker process).  ``snapshot``
        ships the parent session cache's already-materialized plans to the
        workers read-only (it is part of the hashed context blob, so a
        grown cache invalidates stale worker contexts)."""
        obs = resolve_obs(obs)
        pool = self._ensure()
        blob = pickle.dumps((topo, model, global_batch, seq,
                             default_fabric(), snapshot or {}),
                            protocol=pickle.HIGHEST_PROTOCOL)
        token = hashlib.sha1(blob).hexdigest()
        assert self._bound is not None
        with self._bound.get_lock():
            self._bound.value = threshold
        n_chunks = max(1, min(
            len(tasks),
            self.n_procs * 4 if self.chunk_size is None
            else -(-len(tasks) // self.chunk_size)))
        # stride assignment: tasks arrive bound-sorted, so striding spreads
        # the most promising candidates across workers — every worker lands
        # a good incumbent early and the shared bound tightens fast
        chunks = [list(tasks[i::n_chunks]) for i in range(n_chunks)]
        parent_id = obs.current_span_id()
        futures = [pool.submit(_score_chunk, token, blob, chunk,
                               threshold, tighten, ci, obs.enabled)
                   for ci, chunk in enumerate(chunks) if chunk]
        outcomes: list = []
        rejected = pruned = 0
        for fut in as_completed(futures):
            out, rej, pr, delta = fut.result()
            outcomes.extend(out)
            rejected += rej
            pruned += pr
            if delta is not None:
                obs.adopt(delta[0], parent_id, delta[1])
        return outcomes, rejected, pruned

    def simulate_plans(self, topo: ClusterTopology, model: ModelDesc,
                       plans: Sequence[ParallelPlan], *,
                       global_batch: int, seq: int
                       ) -> list[StepSim | None]:
        """Score explicit plans across the pool (input order preserved).

        Each worker chunk goes through :func:`repro_torch.core.simulator
        .simulate_many`, so the topology snapshot is materialized once per
        chunk and infeasible / unroutable plans come back as ``None`` —
        identical semantics to scoring each plan alone in the parent.  The
        re-planning engine's warm bandwidth-rescore ships its top-K
        portfolio through this instead of simulating serially."""
        if not plans:
            return []
        pool = self._ensure()
        blob = pickle.dumps((topo, model, global_batch, seq,
                             default_fabric(), {}),
                            protocol=pickle.HIGHEST_PROTOCOL)
        token = hashlib.sha1(blob).hexdigest()
        n_chunks = max(1, min(len(plans), self.n_procs))
        chunks = [[(i, plans[i]) for i in range(c, len(plans), n_chunks)]
                  for c in range(n_chunks)]
        futures = [pool.submit(_sim_chunk, token, blob, chunk)
                   for chunk in chunks if chunk]
        out: list[StepSim | None] = [None] * len(plans)
        for fut in as_completed(futures):
            for i, sim in fut.result():
                out[i] = sim
        return out


# ---------------------------------------------------------------------------
# The cascade
# ---------------------------------------------------------------------------

# LP-tier cost-guard constants.  A candidate's simulation walks every DP
# rank over its stages' layers plus the M x pp 1F1B grid, so its wall is
# estimated at _LP_SIM_SECONDS_PER_UNIT * (dp*L + dp*pp*M) — order of
# magnitude is all the guard needs.  The guard blocks a fresh LP solve only
# when the projected solver wall (distinct unsolved tp values x measured
# solve EMA) exceeds _LP_GUARD_SAVINGS_FRACTION of the projected remaining
# sim wall; per-tp memoization keeps real searches at a handful of solves,
# so the guard binds only on degenerate tiny candidate sets where even a
# 100% prune rate could not repay the solver.
_LP_SIM_SECONDS_PER_UNIT = 1e-4
_LP_GUARD_SAVINGS_FRACTION = 0.1


def _lp_est_sim_seconds(point: StrategyPoint, n_layers: int) -> float:
    return _LP_SIM_SECONDS_PER_UNIT * (
        point.dp * n_layers
        + point.dp * point.pp * point.microbatches)


def _lp_guard_blocks(lp_ctx,
                     remaining: "Sequence[tuple[float, int, StrategyPoint, "
                                "bool]]") -> bool:
    """True when the LP tier's projected cost exceeds its projected
    savings for the rest of this cascade (see constants above)."""
    n_layers = lp_ctx.model.n_layers
    unsolved = {p.tp for _, _, p, _ in remaining if lp_ctx.would_solve(p.tp)}
    projected_lp = len(unsolved) * lp_ctx.solve_wall_estimate()
    projected_sim = sum(_lp_est_sim_seconds(p, n_layers)
                       for _, _, p, _ in remaining)
    return projected_lp > _LP_GUARD_SAVINGS_FRACTION * projected_sim


def score_candidates(topo: ClusterTopology, model: ModelDesc, *,
                     global_batch: int, seq: int,
                     points: Sequence[StrategyPoint], ctx=None,
                     incumbent_bound: float | None = None,
                     keep_top_k: int = 1,
                     executor: SearchExecutor | None = None,
                     prune: bool = True,
                     lp_prune: bool = True,
                     stats: SearchStats | None = None,
                     max_sims: int | None = None,
                     obs: Obs | None = None
                     ) -> list[CandidateOutcome]:
    """Run the staged pruning cascade over ``points`` and return every fully
    simulated candidate, sorted by ``(step_time, canonical index)`` — the
    head is the argmin, the first ``keep_top_k`` distinct plans are the
    sound top-k.  ``stats`` (mutated in place) accumulates the per-tier
    pruned counts.

    ``max_sims`` is an *anytime* budget: at most that many candidates are
    fully scored (best-bound-first — the most promising candidates by the
    tier-2 estimate go first), and the unscored tail is counted in
    ``stats.budget_skipped``.  Unlike the pruning tiers the budget is NOT
    sound: a skipped candidate might have been the argmin, so the
    serial == parallel and cascade == exhaustive identities are waived when
    it binds.  The hierarchical island tier (:mod:`repro_torch.core.islands`)
    uses it to keep fleet-scale sub-searches bounded.

    ``lp_prune`` toggles the tier-2.5 LP-relaxation bound
    (:mod:`repro_torch.core.mip`): admissible like tiers 1-2, so the argmin /
    top-k portfolio is byte-identical with it on or off — only how many
    candidates reach the simulator changes.  Set
    ``REPRO_SEARCH_DEBUG=1`` to assert the tier monotonicity
    ``point <= coarse <= lp <= simulated`` on every simulated candidate."""
    if stats is None:
        stats = SearchStats()
    obs = resolve_obs(obs)
    # drift invariant: everything this call adds to
    # ``stats.pruned`` must land in exactly one per-tier counter — checked
    # on exit against the deltas, so a new tally site that bypasses
    # ``_note_pruned`` fails loudly instead of skewing cascade_candidates
    pruned_at_entry = stats.pruned
    tiers_at_entry = (stats.pruned_feasibility + stats.pruned_bound
                      + stats.pruned_coarse + stats.pruned_lp)
    debug = os.environ.get("REPRO_SEARCH_DEBUG", "") not in ("", "0")
    variants = (True, False) if topo.is_heterogeneous() else (False,)
    nv = len(variants)
    cascade = obs.span("search.cascade", n_points=len(points),
                       n_devices=len(topo.alive_ids()), prune=prune)
    cascade.__enter__()

    # canonical expansion: indices cover the FULL candidate list (pruned
    # included) so tie-breaking matches exhaustive scoring exactly
    bctx = _bound_context(topo, model, seq=seq) if prune else None
    point_bounds: dict[StrategyPoint, tuple[float, float]] = {}
    tasks: list[tuple[float, int, StrategyPoint, bool]] = []
    with obs.span("search.tiers012"):
        for pi, point in enumerate(points):
            base = pi * nv
            if prune:
                if not point_feasible(point, topo, model,
                                      global_batch=global_batch):
                    _note_pruned(stats, obs, "feasibility", nv)
                    continue
                lb1 = point_lower_bound(point, topo, model,
                                        global_batch=global_batch, seq=seq)
                if incumbent_bound is not None and lb1 >= incumbent_bound:
                    _note_pruned(stats, obs, "bound", nv)
                    continue
                lb2 = max(lb1,
                          _coarse_bound(point, bctx,  # type: ignore[arg-type]
                                        global_batch=global_batch))
                if incumbent_bound is not None and lb2 >= incumbent_bound:
                    _note_pruned(stats, obs, "coarse", nv)
                    continue
            else:
                lb1 = lb2 = 0.0
            point_bounds[point] = (lb1, lb2)
            for vi, refine in enumerate(variants):
                tasks.append((lb2, base + vi, point, refine))

    # Tier 2.5: LP-relaxation bound (repro_torch.core.mip).  Same admissibility
    # contract as tiers 1-2 so it prunes against the same bounds — the
    # packing LP is memoized per tp (a handful of solves per search), and
    # the cost guard skips fresh solves outright when the projected solver
    # wall for the remaining unsolved tp values exceeds a conservative
    # fraction of the projected simulation wall still on the table (the
    # tier can then not pay for itself — degenerate tiny searches).
    lb3_by_variant: dict[tuple[StrategyPoint, bool], float] = {}
    if prune and lp_prune and tasks:
        from .mip import lp_bound_context
        t_lp = time.perf_counter()
        with obs.span("search.tier_lp", n_tasks=len(tasks)) as lp_span:
            lp_ctx = lp_bound_context(topo, model, global_batch=global_batch,
                                      seq=seq, bctx=bctx)
            kept: list[tuple[float, int, StrategyPoint, bool]] = []
            guard_skipped = 0
            for ti, (lb2, index, point, refine) in enumerate(tasks):
                lb3 = lb3_by_variant.get((point, refine))
                if lb3 is None:
                    if lp_ctx.would_solve(point.tp) \
                            and _lp_guard_blocks(lp_ctx, tasks[ti:]):
                        lb3 = lb2           # fall back to the coarse bound
                        guard_skipped += 1
                    else:
                        lb3 = lp_ctx.variant_bound(point, refine, lb2)
                    lb3_by_variant[(point, refine)] = lb3
                if incumbent_bound is not None and lb3 >= incumbent_bound:
                    _note_pruned(stats, obs, "lp", 1)
                    continue
                kept.append((lb3, index, point, refine))
            tasks = kept
            lp_span.set(solves=lp_ctx.lp_solves,
                        guard_skipped=guard_skipped)
        stats.lp_wall_time += time.perf_counter() - t_lp
    # best-first simulation order tightens the incumbent fastest; the index
    # tie-break keeps equal-bound ordering canonical
    tasks.sort(key=lambda t: (t[0], t[1]))

    outcomes: list[CandidateOutcome] = []
    sim_times: list[float] = []

    def threshold() -> float:
        if not prune or len(sim_times) < keep_top_k:
            return math.inf
        return sorted(sim_times)[keep_top_k - 1]

    def note(index: int, point: StrategyPoint, refine: bool,
             plan: ParallelPlan, sim: StepSim) -> None:
        if debug and prune:
            # tier monotonicity: point <= coarse holds by the max() in the
            # tier loop and coarse <= lp by the max() in point_bound — the
            # load-bearing leg is lp <= simulated (admissibility)
            lb1d, lb2d = point_bounds.get(point, (0.0, 0.0))
            lb3d = lb3_by_variant.get((point, refine), lb2d)
            ok = (lb1d <= lb2d * (1 + 1e-9) + 1e-12
                  and lb2d <= lb3d * (1 + 1e-9) + 1e-12
                  and lb3d <= sim.step_time * (1 + 1e-9) + 1e-12)
            if not ok:
                raise AssertionError(
                    f"cascade tier monotonicity violated for {point} "
                    f"refine={refine}: point={lb1d} coarse={lb2d} "
                    f"lp={lb3d} simulated={sim.step_time}")
        outcomes.append(CandidateOutcome(index=index, point=point,
                                         refine=refine, plan=plan, sim=sim))
        sim_times.append(sim.step_time)
        stats.simulated += 1

    tier3 = obs.span("search.tier3", n_tasks=len(tasks),
                     parallel=executor is not None and len(tasks) > 1)
    tier3.__enter__()
    # Worker pre-pass (performance only): ship the likely-live work to the
    # pool so the sims are hot when the canonical walk below needs them.
    # The walk is the sole authority on outcomes, session-cache content,
    # and stats — worker results are consumed as a sim cache, gaps (tasks a
    # racing shared bound pruned that the walk's threshold admits) are
    # scored in the parent, and worker sims the walk prunes are discarded.
    # That keeps serial and process-parallel searches plan-for-plan AND
    # portfolio-for-portfolio identical whatever the chunk completion
    # order; the shared bound only decides how much worker time is spent.
    available: dict[int, tuple[ParallelPlan, StepSim]] = {}
    if executor is not None and len(tasks) > 1:
        # resolve session-cache hits in the parent first: they are free and
        # pre-tighten the static bound the workers start from.  Plans the
        # cache materialized but never scored ride to the workers as a
        # read-only snapshot so they skip the rebuild.
        hit_times: list[float] = []
        pending: list[tuple[float, int, StrategyPoint, bool]] = []
        snapshot: dict[tuple[StrategyPoint, bool], ParallelPlan] = {}
        for bound, index, point, refine in tasks:
            plan = ctx.get_plan(point, refine) if ctx is not None else None
            sim = ctx.get_score(plan) \
                if (plan is not None and ctx is not None) else None
            if plan is not None and sim is not None:
                hit_times.append(sim.step_time)
            else:
                if plan is not None:
                    snapshot[(point, refine)] = plan
                pending.append((bound, index, point, refine))
        thr0 = math.inf
        if prune and len(hit_times) >= keep_top_k:
            thr0 = sorted(hit_times)[keep_top_k - 1]
        live = [t for t in pending if not (prune and t[0] > thr0)]
        if max_sims is not None:
            # dispatch cap only — the walk does the budget accounting
            live = live[:max(0, max_sims - len(hit_times))]
        if live:
            out, _rejected, _pruned = executor.run(
                topo, model, global_batch=global_batch, seq=seq,
                tasks=live, threshold=thr0, tighten=(keep_top_k == 1),
                obs=obs, snapshot=snapshot)
            for index, point, refine, plan, sim in out:
                available[index] = (plan, sim)
    memo: dict = {}
    for bound, index, point, refine in tasks:
        if max_sims is not None and len(sim_times) >= max_sims:
            stats.budget_skipped += 1
            obs.inc("search.budget_skipped")
            continue
        thr = threshold()
        if prune and bound > thr:
            # attribute the cut to the cheapest tier whose bound did it —
            # with the LP tier off, bound == the coarse bound and the lp
            # branch is unreachable, so pruned_bound / pruned_coarse tally
            # exactly as they did before the tier existed
            lb1, lb2 = point_bounds[point]
            if lb1 > thr:
                _note_pruned(stats, obs, "bound", 1)
            elif lb2 > thr:
                _note_pruned(stats, obs, "coarse", 1)
            else:
                _note_pruned(stats, obs, "lp", 1)
            continue
        got = available.get(index)
        if got is not None:
            plan, sim = got
            # merge the worker's result into the session cache
            if ctx is not None:
                ctx.put_plan(point, refine, plan)
                ctx.put_score(plan, sim)
            note(index, point, refine, plan, sim)
            continue
        res = _score_variant(point, refine, topo, model,
                             global_batch=global_batch, seq=seq,
                             ctx=ctx, memo=memo if ctx is None else None,
                             obs=obs)
        if res is None:
            stats.rejected += 1
            continue
        note(index, point, refine, res[0], res[1])
    tier3.set(simulated=stats.simulated)
    tier3.__exit__(None, None, None)

    obs.inc("search.simulated", stats.simulated)
    obs.inc("search.rejected", stats.rejected)
    tier_delta = (stats.pruned_feasibility + stats.pruned_bound
                  + stats.pruned_coarse + stats.pruned_lp) - tiers_at_entry
    if stats.pruned - pruned_at_entry != tier_delta:
        raise RuntimeError(
            f"cascade prune-counter drift: pruned "
            f"delta {stats.pruned - pruned_at_entry} != per-tier delta "
            f"{tier_delta} — some tally site bypassed _note_pruned")
    cascade.set(simulated=stats.simulated, pruned=stats.pruned)
    cascade.__exit__(None, None, None)
    outcomes.sort(key=lambda o: (o.sim.step_time, o.index))
    return outcomes
