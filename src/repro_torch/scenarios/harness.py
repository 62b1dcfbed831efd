"""Scenario replay harness: trace -> (static | adapted | oracle) metrics.

Replays a :class:`Trace` against the analytic simulator through the
:class:`ReplanEngine` (via :class:`DynamicOrchestrator`) and reports
per-scenario adaptation metrics:

  * ``static``  — the cold t=0 plan, never re-planned (what a planner with
    no dynamic awareness delivers; after a failure it may be infeasible,
    contributing zero throughput for that interval),
  * ``adapted`` — every event flows through ``DynamicOrchestrator.adapt``;
    measured re-plan latency plus the *physically modeled* reconfiguration
    cost (checkpoint/reshard traffic priced on the post-event topology via
    :class:`repro_torch.core.ReconfigCostModel`) is charged against the throughput
    budget on every plan switch.  The engine's keep/switch hysteresis sees
    the remaining horizon, so it only switches when the modeled savings
    amortize the modeled cost,
  * ``oracle``  — the clairvoyant *greedy* baseline: a fresh full search on
    every interval's topology, now charged the same modeled switch cost when
    its per-interval winners differ,
  * ``oracle_dp`` — the true clairvoyant bound: a cross-interval dynamic
    program (:func:`repro_torch.core.plan_sequence_dp`) over the candidate plans
    (per-interval winners + the adapted policy's plans), switch costs
    included.  Never worse than the greedy oracle.

Step-time timelines are derived per inter-event interval; throughput is the
time-weighted number of optimizer steps completed inside the horizon.

:meth:`ScenarioHarness.run_many` evaluates several scenarios at once, either
sequentially or **process-parallel**; :meth:`ScenarioHarness.run_sweep` runs
multi-seed sweeps and aggregates mean / 95% CI per scenario family.
"""

from __future__ import annotations

import itertools
import math
import multiprocessing
import os
import statistics
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, replace
from typing import Sequence

from repro_torch.core import (ClusterTopology, DynamicOrchestrator, ModelDesc,
                        NetworkEvent, ParallelPlan, ReconfigCostModel,
                        ReplanEngine, StrategyCache, plan_sequence_dp,
                        simulate_training_step)
from repro_torch.obs import NULL_OBS, Obs, resolve_obs

from . import catalog
from .trace import Trace


# ---------------------------------------------------------------------------
# Configuration / results
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HarnessConfig:
    """Everything a (possibly remote) scenario replay needs — picklable, so
    :meth:`ScenarioHarness.run_many` can ship it to worker processes."""

    model: ModelDesc
    global_batch: int
    seq: int
    max_candidates: int | None = None
    # switch-cost model: checkpoint/reshard traffic priced on the post-event
    # topology (cf. the Oobleck/ReCycle reconfiguration-cost discussion,
    # paper §2.2.2).  None builds the default model from ``model``.
    # (the legacy replan_threshold knob is gone: with a finite
    # switch-horizon the engine's cost-model hysteresis decides keep/switch)
    reconfig: ReconfigCostModel | None = None
    oracle: bool = True
    # DP-oracle candidate widening: each interval contributes its top-K
    # distinct plans (not just the winner) to plan_sequence_dp's candidate
    # set — the cascade makes the extra per-interval scoring affordable
    dp_top_k: int = 4
    # score the search's final simulation tier in this many worker
    # processes; ONE SearchExecutor is created per replay and reused across
    # every interval (None = serial in-process scoring).  Leave None when
    # the replay itself runs under run_many(parallel=True) — nesting pools
    # oversubscribes the host.
    search_procs: int | None = None
    # telemetry bundle (repro_torch.obs.Obs): the replay records scenario.*
    # spans plus the engine/orchestrator replan counters and latency
    # histograms into it.  None falls back to the REPRO_TRACE-driven
    # process default (a no-op unless the env var is set).  Note that
    # run_many(parallel=True) replays in spawn workers — each worker
    # records into its own pickled copy, which is not shipped back; pass
    # an explicit obs only for in-process replays.
    obs: Obs | None = None


@dataclass(frozen=True)
class PolicyResult:
    """One replan policy's outcome over a scenario."""

    name: str
    avg_step: float                         # time-weighted mean step time, s
    steps: float                            # optimizer steps completed
    timeline: tuple[tuple[float, float], ...]  # (interval start, step time)


@dataclass(frozen=True)
class ScenarioReport:
    """One (scenario, seed) replay: static / adapted / oracle policy
    results plus replan accounting (see :meth:`to_row`)."""

    scenario: str
    seed: int
    n_devices: int
    n_events: int
    horizon: float
    static: PolicyResult
    adapted: PolicyResult
    oracle: PolicyResult | None              # greedy clairvoyant (costed)
    oracle_dp: PolicyResult | None           # DP clairvoyant bound (costed)
    adaptations: int                         # events processed
    replans: int                             # actual plan switches
    actions: tuple[tuple[str, int], ...]     # replan-path histogram
    switch_cost_s: float                     # modeled switch cost charged
    replan_latency_mean_ms: float
    replan_latency_max_ms: float
    wall_s: float

    @property
    def adapted_over_static(self) -> float:
        return _ratio(self.adapted.avg_step, self.static.avg_step)

    @property
    def adapted_over_oracle(self) -> float:
        if self.oracle is None:
            return float("nan")
        return _ratio(self.adapted.avg_step, self.oracle.avg_step)

    @property
    def adapted_over_oracle_dp(self) -> float:
        if self.oracle_dp is None:
            return float("nan")
        return _ratio(self.adapted.avg_step, self.oracle_dp.avg_step)

    @property
    def greedy_over_dp(self) -> float:
        """Greedy-oracle avg step over DP-oracle avg step (>= 1: the DP
        schedule is the tighter clairvoyant bound)."""
        if self.oracle is None or self.oracle_dp is None:
            return float("nan")
        return _ratio(self.oracle.avg_step, self.oracle_dp.avg_step)

    def to_row(self) -> dict:
        row = {
            "scenario": self.scenario, "seed": self.seed,
            "devices": self.n_devices, "events": self.n_events,
            "static_step_s": _round(self.static.avg_step),
            "adapted_step_s": _round(self.adapted.avg_step),
            "oracle_step_s": _round(self.oracle.avg_step)
            if self.oracle else None,
            "oracle_dp_step_s": _round(self.oracle_dp.avg_step)
            if self.oracle_dp else None,
            "adapted_over_static": _round(self.adapted_over_static),
            "adapted_over_oracle": _round(self.adapted_over_oracle),
            "adapted_over_oracle_dp": _round(self.adapted_over_oracle_dp),
            "greedy_over_dp": _round(self.greedy_over_dp),
            "replans": self.replans,
            "switch_cost_s": _round(self.switch_cost_s),
            "actions": "|".join(f"{k}:{v}" for k, v in self.actions),
            "replan_ms_mean": round(self.replan_latency_mean_ms, 1),
            "replan_ms_max": round(self.replan_latency_max_ms, 1),
            "wall_s": round(self.wall_s, 2),
        }
        return row


def _round(x: float, nd: int = 4) -> float:
    return round(x, nd) if math.isfinite(x) else x


def _ratio(a: float, b: float) -> float:
    if not math.isfinite(a) or not math.isfinite(b) or b <= 0:
        if math.isinf(b) and math.isfinite(a):
            return 0.0                      # baseline infeasible, policy fine
        return float("nan") if not (math.isinf(a) and math.isfinite(b)) \
            else math.inf
    return a / b


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


def _step_time(plan: ParallelPlan, cfg: HarnessConfig,
               topo: ClusterTopology, t: float) -> float:
    try:
        return simulate_training_step(
            plan, cfg.model, topo, global_batch=cfg.global_batch,
            seq=cfg.seq, at_time=t).step_time
    except (ValueError, ZeroDivisionError):
        return math.inf


def _aggregate(name: str, segs: Sequence[tuple[float, float, float]],
               horizon: float) -> PolicyResult:
    """segs: (interval start, step time, overhead charged at interval
    start).  Throughput = sum of d_i/s_i over the overhead-trimmed
    intervals; overhead exceeding its interval carries into the next one
    (a reconfiguration does not get cheaper because the next event came
    quickly).  avg step = horizon / steps."""
    steps = 0.0
    carry = 0.0
    starts = [t for t, _, _ in segs]
    for (t0, s, oh), t1 in zip(segs, starts[1:] + [horizon]):
        oh += carry
        d = t1 - t0
        carry = max(0.0, oh - d)
        usable = max(0.0, d - oh)
        if math.isfinite(s) and s > 0:
            steps += usable / s
    avg = horizon / steps if steps > 0 else math.inf
    return PolicyResult(name=name, avg_step=avg, steps=round(steps, 3),
                        timeline=tuple((t, _round(s)) for t, s, _ in segs))


def _oracle_policies(cfg: HarnessConfig, topo: ClusterTopology,
                     boundaries: list[float], horizon: float,
                     reconfig: ReconfigCostModel,
                     extra_plans: Sequence[ParallelPlan],
                     executor=None) -> tuple[PolicyResult, PolicyResult]:
    """(greedy oracle, DP oracle) — both clairvoyant, both charged the
    modeled switch cost.

    Greedy re-plans from scratch per interval and pays whenever consecutive
    winners differ.  The DP oracle chooses the best plan *sequence* over the
    candidate set — each interval's top-``cfg.dp_top_k`` distinct plans
    (the search cascade makes the runner-ups free to report) plus
    ``extra_plans`` — via :func:`plan_sequence_dp`; when the carry-over of a
    switch cost across an interval boundary makes the DP's carry-free
    objective mis-rank, the greedy sequence (a member of the DP's search
    space) is taken instead — so the DP oracle is never worse than the
    greedy one.
    """
    # oracle searches are baseline machinery, not the policy under test:
    # they get NULL_OBS so the replay's replan.*/cache.* metrics reflect
    # only the adapted engine
    engine = ReplanEngine(cfg.model, global_batch=cfg.global_batch,
                          seq=cfg.seq, cache=StrategyCache(obs=NULL_OBS),
                          max_candidates=cfg.max_candidates,
                          reconfig=reconfig, executor=executor,
                          plan_top_k=max(1, cfg.dp_top_k), obs=NULL_OBS)
    snaps = [topo.snapshot(t) for t in boundaries]
    winners: list[ParallelPlan | None] = []
    runners_up: list[ParallelPlan] = []
    for snap in snaps:
        try:
            res = engine.plan(snap)
            winners.append(res.plan)
            runners_up.extend(p for p, _ in res.top_plans)
        except RuntimeError:
            winners.append(None)

    # candidate set: per-interval top-K plans + the adapted policy's plans
    cands: list[ParallelPlan] = []
    cand_idx: dict = {}
    for p in [*winners, *runners_up, *extra_plans]:
        if p is not None and p.structural_key() not in cand_idx:
            cand_idx[p.structural_key()] = len(cands)
            cands.append(p)
    if not cands:                      # every interval infeasible
        segs = [(t, math.inf, 0.0) for t in boundaries]
        return (_aggregate("oracle", segs, horizon),
                _aggregate("oracle_dp", segs, horizon))

    # step-time grid through the engine's score cache: one batched
    # score_plans per boundary; same-fingerprint boundaries hit the cache
    st = []
    for snap in snaps:
        sims = engine.score_plans(cands, snap)
        st.append([s.step_time if s is not None else math.inf
                   for s in sims])

    def seq_segs(idxs: Sequence[int | None]
                 ) -> list[tuple[float, float, float]]:
        segs = []
        prev: int | None = None
        for i, (t, c) in enumerate(zip(boundaries, idxs)):
            if c is None:
                segs.append((t, math.inf, 0.0))
                continue
            oh = switch_cost(i, prev, c) if i and prev is not None \
                and prev != c else 0.0
            segs.append((t, st[i][c], oh))
            prev = c
        return segs

    durations = [t1 - t0 for t0, t1 in
                 zip(boundaries, boundaries[1:] + [horizon])]
    cost_memo: dict[tuple[int, int, int], float] = {}

    def switch_cost(i: int, q: int, c: int) -> float:
        key = (i, q, c)
        if key not in cost_memo:
            cost_memo[key] = reconfig.cost(cands[q], cands[c],
                                           snaps[i]).total_s
        return cost_memo[key]

    winner_idxs = [cand_idx[p.structural_key()] if p is not None else None
                   for p in winners]
    greedy = _aggregate("oracle", seq_segs(winner_idxs), horizon)
    _, choices = plan_sequence_dp(durations, st, switch_cost)
    dp = _aggregate("oracle_dp", seq_segs(choices), horizon)
    # the DP objective is carry-free while _aggregate carries overhead
    # across short intervals; when that mis-ranks, the greedy sequence (a
    # member of the DP search space) is the DP result — compare on the
    # *unrounded* avg_step so the invariant dp <= greedy holds exactly
    if not (dp.avg_step <= greedy.avg_step):
        dp = replace(greedy, name="oracle_dp")
    return greedy, dp


def run_scenario(cfg: HarnessConfig, scenario: str | Trace, seed: int = 0,
                 topo: ClusterTopology | None = None) -> ScenarioReport:
    """Replay one scenario end-to-end; see the module docstring for the
    four policies.  ``scenario`` is a catalog name (the topology comes from
    the spec) or an explicit :class:`Trace` (then ``topo`` is required)."""
    wall0 = time.perf_counter()
    if isinstance(scenario, Trace):
        if topo is None:
            raise ValueError("an explicit Trace needs an explicit topology")
        trace = scenario
    else:
        built_topo, trace = catalog.build(scenario, seed)
        if topo is None:
            topo = built_topo
    # replay on a private copy: attaching the trace must not clobber a
    # caller-provided topology's own event timeline
    topo = topo.copy()
    topo.events = trace.to_events()
    horizon = trace.horizon
    # t == horizon included: the interval it opens has zero width (no
    # throughput effect) but the event still flows through the orchestrator,
    # matching the Trainer's to_step_events behaviour — and from_events()
    # defaults the horizon to the *last* event's time, which must not vanish
    boundaries = [0.0] + [t for t in trace.event_times() if 0.0 < t <= horizon]

    reconfig = cfg.reconfig if cfg.reconfig is not None \
        else ReconfigCostModel(cfg.model)
    # one process pool for the whole replay: every interval's search (the
    # adapted engine's re-plans AND the oracles' per-boundary full searches)
    # reuses it instead of re-spawning workers per event
    executor = None
    if cfg.search_procs and cfg.search_procs > 1:
        from repro_torch.core import SearchExecutor
        executor = SearchExecutor(n_procs=cfg.search_procs)
    try:
        return _run_scenario_inner(cfg, trace, topo, seed, boundaries,
                                   horizon, reconfig, executor, wall0)
    finally:
        if executor is not None:
            executor.close()


_ACTION_PREFIX = "replan.action."


def _action_delta(obs: Obs, before: dict) -> dict[str, int]:
    """Per-action counts this replay added to the registry: the delta of
    the ``replan.action.*`` counters against the entry snapshot (a shared
    registry may carry counts from earlier replays)."""
    after = obs.metrics.counters_with_prefix(_ACTION_PREFIX)
    return {k[len(_ACTION_PREFIX):]: after[k] - before.get(k, 0)
            for k in after if after[k] - before.get(k, 0) > 0}


def _run_scenario_inner(cfg: HarnessConfig, trace: Trace,
                        topo: ClusterTopology, seed: int,
                        boundaries: list[float], horizon: float,
                        reconfig: ReconfigCostModel, executor,
                        wall0: float) -> ScenarioReport:
    obs = resolve_obs(cfg.obs)
    actions0 = obs.metrics.counters_with_prefix(_ACTION_PREFIX) \
        if obs.enabled else {}
    replay_span = obs.span("scenario.replay", scenario=trace.name, seed=seed,
                           n_events=len(trace))
    replay_span.__enter__()
    engine = ReplanEngine(cfg.model, global_batch=cfg.global_batch,
                          seq=cfg.seq, cache=StrategyCache(obs=obs),
                          max_candidates=cfg.max_candidates,
                          reconfig=reconfig,
                          switch_horizon_s=horizon, executor=executor,
                          obs=obs)
    orch = DynamicOrchestrator(model=cfg.model, global_batch=cfg.global_batch,
                               seq=cfg.seq, engine=engine, obs=obs)
    cold = engine.plan(topo.snapshot(0.0))
    plan0 = cold.plan

    # -- static: the t=0 plan, never revisited ------------------------------
    with obs.span("scenario.static"):
        static_segs = [(t, _step_time(plan0, cfg, topo, t), 0.0)
                       for t in boundaries]

    # -- adapted: every event through the orchestrator ----------------------
    plan = plan0
    adapted_segs: list[tuple[float, float, float]] = \
        [(0.0, _step_time(plan0, cfg, topo, 0.0), 0.0)]
    adapted_plans: list[ParallelPlan] = [plan0]
    latencies: list[float] = []
    replans = 0
    switch_cost_total = 0.0
    grouped = [(t, list(evs)) for t, evs in
               itertools.groupby(trace.events, key=lambda e: e.time)
               if 0.0 < t <= horizon]
    for t, evs in grouped:
        interval = obs.span("scenario.interval", t=t, n_events=len(evs))
        interval.__enter__()
        overhead = 0.0
        # the hysteresis amortizes switch cost over what is actually left
        engine.switch_horizon_s = max(horizon - t, 0.0)
        for ev in evs:
            t0 = time.perf_counter()
            new_plan = orch.adapt(plan, topo, ev)
            lat = time.perf_counter() - t0
            latencies.append(lat)
            if new_plan.structural_key() != plan.structural_key():
                replans += 1
                # the engine priced this exact switch inside its hysteresis
                # (same incumbent, same snapshot); a structural switch costs
                # at least the base term, so 0.0 means the engine's cold
                # fallback skipped pricing — compute it here then
                cost = orch.history[-1].switch_cost if orch.history else 0.0
                if cost <= 0.0:
                    cost = reconfig.cost(plan, new_plan,
                                         topo.snapshot(t)).total_s
                switch_cost_total += cost
                overhead += lat + cost
                adapted_plans.append(new_plan)
            else:
                overhead += lat
            plan = new_plan
        adapted_segs.append((t, _step_time(plan, cfg, topo, t), overhead))
        interval.set(switched=plan is not plan0)
        interval.__exit__(None, None, None)

    # -- oracles: clairvoyant greedy + cross-interval DP bound --------------
    oracle_res = oracle_dp_res = None
    if cfg.oracle:
        with obs.span("scenario.oracle"):
            oracle_res, oracle_dp_res = _oracle_policies(
                cfg, topo, boundaries, horizon, reconfig, adapted_plans,
                executor=executor)

    # replan-path histogram: the metrics registry is the source of truth
    # (every action funnels through DynamicOrchestrator._record); the
    # history fallback serves untraced replays only
    if obs.enabled:
        actions = _action_delta(obs, actions0)
    else:
        actions = {}
        for rec in orch.history:
            actions[rec.action] = actions.get(rec.action, 0) + 1
    replay_span.set(replans=replans, adaptations=len(orch.history))
    replay_span.__exit__(None, None, None)
    return ScenarioReport(
        scenario=trace.name, seed=trace.seed if trace.seed is not None
        else seed,
        n_devices=len(topo.devices), n_events=len(trace),
        horizon=horizon,
        static=_aggregate("static", static_segs, horizon),
        adapted=_aggregate("adapted", adapted_segs, horizon),
        oracle=oracle_res, oracle_dp=oracle_dp_res,
        adaptations=len(orch.history), replans=replans,
        actions=tuple(sorted(actions.items())),
        switch_cost_s=switch_cost_total,
        replan_latency_mean_ms=1e3 * (sum(latencies) / len(latencies))
        if latencies else 0.0,
        replan_latency_max_ms=1e3 * max(latencies, default=0.0),
        wall_s=time.perf_counter() - wall0)


def _worker(payload: tuple[HarnessConfig, str, int]) -> ScenarioReport:
    cfg, name, seed = payload
    return run_scenario(cfg, name, seed)


def run_payloads(payloads: Sequence[tuple[HarnessConfig, str, int]], *,
                 parallel: bool = False,
                 max_workers: int | None = None) -> list[ScenarioReport]:
    """Replay explicit (config, scenario, seed) payloads, sequentially or
    process-parallel (results keep input order).  Payloads may mix harness
    configurations — e.g. the bandwidth-crossover families replay at a
    comm-heavy scale while the rest use the default one."""
    if not parallel or len(payloads) <= 1:
        return [_worker(p) for p in payloads]
    workers = max_workers or min(len(payloads), os.cpu_count() or 1)
    # spawn, not fork: the caller may be multi-threaded (planner thread
    # pools, JAX) and fork()ing a threaded parent risks deadlocked
    # children; workers only import dependency-free repro_torch.core, so a
    # fresh interpreter starts in well under a second
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        return list(ex.map(_worker, payloads))


# ---------------------------------------------------------------------------
# Multi-seed aggregation
# ---------------------------------------------------------------------------


# two-sided 95% Student-t quantiles by degrees of freedom; the normal 1.96
# would understate the interval ~6.5x at the n=2 sweeps the bench runs
_T95 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 15: 2.131, 20: 2.086,
        30: 2.042}


def _t95(df: int) -> float:
    if df <= 0:
        return float("nan")
    usable = [d for d in _T95 if d <= df]
    return _T95[max(usable)] if usable else 1.96


def _mean_ci(xs: Sequence[float]) -> tuple[float, float]:
    """(mean, Student-t 95% CI half-width) over the finite values; NaNs
    if none."""
    vals = [x for x in xs if math.isfinite(x)]
    if not vals:
        return float("nan"), float("nan")
    mean = sum(vals) / len(vals)
    if len(vals) < 2:
        return mean, 0.0
    return mean, _t95(len(vals) - 1) * statistics.stdev(vals) \
        / math.sqrt(len(vals))


@dataclass(frozen=True)
class FamilySummary:
    """Mean / 95% CI across the seeds of one scenario family."""

    scenario: str
    n: int
    seeds: tuple[int, ...]
    adapted_over_static: tuple[float, float]       # (mean, ci95)
    adapted_over_oracle_dp: tuple[float, float]
    greedy_over_dp: tuple[float, float]
    replans_mean: float
    switch_cost_s_mean: float

    def to_row(self) -> dict:
        aos, aod, god = (self.adapted_over_static,
                         self.adapted_over_oracle_dp, self.greedy_over_dp)
        return {
            "scenario": self.scenario,
            "seeds": "|".join(str(s) for s in self.seeds),
            "n": self.n,
            "adapted_over_static_mean": _round(aos[0]),
            "adapted_over_static_ci95": _round(aos[1]),
            "adapted_over_oracle_dp_mean": _round(aod[0]),
            "adapted_over_oracle_dp_ci95": _round(aod[1]),
            "greedy_over_dp_mean": _round(god[0]),
            "replans_mean": _round(self.replans_mean, 2),
            "switch_cost_s_mean": _round(self.switch_cost_s_mean, 2),
        }


def summarize_reports(reports: Sequence[ScenarioReport]
                      ) -> list[FamilySummary]:
    """Aggregate per-(family, seed) reports into per-family mean/CI rows,
    in first-appearance order."""
    by_family: dict[str, list[ScenarioReport]] = {}
    for r in reports:
        by_family.setdefault(r.scenario, []).append(r)
    out = []
    for name, reps in by_family.items():
        out.append(FamilySummary(
            scenario=name, n=len(reps),
            seeds=tuple(r.seed for r in reps),
            adapted_over_static=_mean_ci(
                [r.adapted_over_static for r in reps]),
            adapted_over_oracle_dp=_mean_ci(
                [r.adapted_over_oracle_dp for r in reps]),
            greedy_over_dp=_mean_ci([r.greedy_over_dp for r in reps]),
            replans_mean=sum(r.replans for r in reps) / len(reps),
            switch_cost_s_mean=sum(r.switch_cost_s for r in reps)
            / len(reps)))
    return out


# ---------------------------------------------------------------------------
# Multi-scenario evaluation
# ---------------------------------------------------------------------------


class ScenarioHarness:
    """Replays catalog scenarios and evaluates adaptation quality.

    >>> h = ScenarioHarness(model, global_batch=64, seq=2048)
    >>> rep = h.run("cloud_spot", seed=1)
    >>> reps = h.run_many([("cloud_spot", 0), ("diurnal_wan", 0)],
    ...                   parallel=True)
    >>> reps, fams = h.run_sweep(["cloud_spot"], seeds=(0, 1, 2))
    """

    def __init__(self, model: ModelDesc, *, global_batch: int, seq: int,
                 max_candidates: int | None = None,
                 reconfig: ReconfigCostModel | None = None,
                 oracle: bool = True, obs: Obs | None = None):
        self.cfg = HarnessConfig(
            model=model, global_batch=global_batch, seq=seq,
            max_candidates=max_candidates,
            reconfig=reconfig, oracle=oracle, obs=obs)

    def run(self, scenario: str | Trace, seed: int = 0,
            topo: ClusterTopology | None = None) -> ScenarioReport:
        return run_scenario(self.cfg, scenario, seed, topo=topo)

    def run_many(self, items: Sequence[tuple[str, int] | str], *,
                 parallel: bool = False,
                 max_workers: int | None = None) -> list[ScenarioReport]:
        """Replay several catalog scenarios; ``items`` are names or
        (name, seed) pairs.  With ``parallel=True`` scenarios run in worker
        processes (results keep input order)."""
        norm: list[tuple[str, int]] = [
            it if isinstance(it, tuple) else (it, 0) for it in items]
        payloads = [(self.cfg, name, seed) for name, seed in norm]
        return run_payloads(payloads, parallel=parallel,
                            max_workers=max_workers)

    def run_sweep(self, families: Sequence[str] | None = None, *,
                  seeds: Sequence[int] = (0, 1, 2),
                  parallel: bool = False, max_workers: int | None = None
                  ) -> tuple[list[ScenarioReport], list[FamilySummary]]:
        """Multi-seed sweep: replay every (family, seed) pair and aggregate
        mean / 95% CI per family."""
        names = list(families) if families is not None \
            else catalog.list_scenarios()
        items = [(n, s) for n in names for s in seeds]
        reports = self.run_many(items, parallel=parallel,
                                max_workers=max_workers)
        return reports, summarize_reports(reports)
