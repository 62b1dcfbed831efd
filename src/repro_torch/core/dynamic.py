"""Dynamic-network adaptation (paper §2.2): re-planning on temporal events.

Three mechanisms, matching the paper's scenarios S1-S3 (Fig. 1):

  * S1 bandwidth variation  — :func:`replan_on_event` re-runs the planner on
    the topology snapshot; the new plan may pick a different TP size or
    collective decomposition (the paper's Fig. 6c finding).
  * S2 stragglers           — :func:`reassign_for_straggler` performs a
    ReCycle-style local re-balance: shrink the slow device's layer share /
    batch share without a full re-plan.
  * S3 failures/joins       — :class:`PlanTemplates` precomputes Oobleck-style
    plans for descending device counts so failover is a table lookup, not a
    search.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..obs import Obs, resolve_obs
from .cluster import ClusterTopology, NetworkEvent
from .opgraph import ModelDesc
from .planner import (PlanResult, bnb_layer_split, hetero_batch_shares,
                      plan_hybrid)
from .plans import ParallelPlan, StageAssignment, stages_from_sizes
from .simulator import simulate_training_step


# ---------------------------------------------------------------------------
# Oobleck-style templates (S3)
# ---------------------------------------------------------------------------


@dataclass
class PlanTemplates:
    """Pre-computed plans keyed by alive-device count.

    ``precompute`` plans for n, n-f1, n-f2, ... devices ahead of time (the
    paper cites Oobleck's pipeline templates); ``plan_for`` returns the best
    template not exceeding the current device count, so recovery needs no
    search in the critical path.
    """

    model: ModelDesc
    global_batch: int
    seq: int
    templates: dict[int, ParallelPlan] = field(default_factory=dict)

    @staticmethod
    def precompute(topo: ClusterTopology, model: ModelDesc, *,
                   global_batch: int, seq: int,
                   failure_budget: int = 2,
                   step: int | None = None) -> "PlanTemplates":
        """Plan for len(devices) - k for k in 0..failure_budget (k*step devs
        removed per template, default one node of 1)."""
        tpl = PlanTemplates(model, global_batch, seq)
        ids = topo.alive_ids()
        step = step or 1
        for k in range(failure_budget + 1):
            n = len(ids) - k * step
            if n < 1:
                break
            snap = topo.snapshot(0.0)
            # remove the k*step slowest devices — the most likely casualties
            # are interchangeable; any subset of size n yields the same shape
            for d in ids[n:]:
                snap.devices[d].alive = False
            try:
                res = plan_hybrid(snap, model, global_batch=global_batch,
                                  seq=seq, with_baseline=False)
                tpl.templates[n] = res.plan
            except RuntimeError:
                continue
        return tpl

    def plan_for(self, n_alive: int) -> ParallelPlan:
        usable = [k for k in self.templates if k <= n_alive]
        if not usable:
            raise KeyError(f"no template for {n_alive} devices")
        return self.templates[max(usable)]


# ---------------------------------------------------------------------------
# Straggler mitigation (S2)
# ---------------------------------------------------------------------------


def reassign_for_straggler(plan: ParallelPlan, model: ModelDesc,
                           topo: ClusterTopology, *,
                           batch: int, seq: int) -> ParallelPlan:
    """Local re-balance after a slowdown event: recompute layer split and
    batch shares against current perf factors, keeping dp/tp/pp fixed
    (ReCycle-style — no topology change, no checkpoint reload)."""
    groups = [list(st.device_ids) for st in plan.stages]
    if not groups:
        # plans built without explicit stages (templates, manual configs)
        # get the default device grouping before re-balancing
        from .plans import split_devices
        groups = split_devices(topo, plan.dp, plan.tp, plan.pp)
    if plan.pp > 1:
        sizes, _ = bnb_layer_split(model, topo, groups, plan.tp,
                                   batch=batch, seq=seq)
        stages = stages_from_sizes(sizes, groups)
    else:
        stages = plan.stages
    if plan.dp > 1:
        rank_devs = [[g[r * plan.tp] for g in groups]
                     for r in range(plan.dp)]
        shares = hetero_batch_shares(topo, rank_devs)
    else:
        shares = plan.batch_shares
    return ParallelPlan(
        dp=plan.dp, tp=plan.tp, pp=plan.pp, ep=plan.ep, sp=plan.sp,
        microbatches=plan.microbatches, stages=stages, batch_shares=shares,
        grad_sync=plan.grad_sync, zero1=plan.zero1, remat=plan.remat,
        grad_compression=plan.grad_compression,
        meta={**plan.meta, "source": "straggler-reassign"})


# ---------------------------------------------------------------------------
# Event-driven orchestration (S1 + S2 + S3)
# ---------------------------------------------------------------------------


@dataclass
class AdaptationRecord:
    """One adaptation taken by the orchestrator: the triggering event, the
    action chosen (keep / switch variant), and the step-time before/after
    plus the modeled plan-switch charge."""

    time: float
    event: NetworkEvent
    action: str
    old_step_time: float
    new_step_time: float
    # modeled reconfiguration charge for this adaptation's plan switch
    # (ReconfigCostModel via the engine; 0.0 when the plan was kept or the
    # engine-less legacy path was taken)
    switch_cost: float = 0.0


@dataclass
class DynamicOrchestrator:
    """Drives plan adaptation over a temporal topology.

    With an incremental :class:`repro_torch.core.engine.ReplanEngine` attached
    (the default path wired by the trainer), every event goes through
    ``engine.replan`` — warm cache re-scoring for bandwidth shifts, local
    rebalance for stragglers, neighborhood-seeded search for device-set
    changes.  Without one, the legacy seed behaviour applies: S2 slowdowns
    get the cheap local reassignment; S3 failures consult the precomputed
    templates; S1 bandwidth changes trigger a full re-plan only if the
    current plan degrades by more than ``replan_threshold``."""

    model: ModelDesc
    global_batch: int
    seq: int
    templates: PlanTemplates | None = None
    engine: "object | None" = None       # ReplanEngine (duck-typed; avoids
    #                                      a core.engine import cycle)
    replan_threshold: float = 1.10
    history: list[AdaptationRecord] = field(default_factory=list)
    obs: Obs | None = None

    def _record(self, rec: AdaptationRecord) -> None:
        """Single funnel for adaptation telemetry: every action taken lands
        in ``history`` AND bumps the ``replan.action.<action>`` counter, so
        the registry and the hand-inspectable history cannot drift."""
        self.history.append(rec)
        resolve_obs(self.obs).inc(f"replan.action.{rec.action}")

    def adapt(self, plan: ParallelPlan, topo: ClusterTopology,
              event: NetworkEvent) -> ParallelPlan:
        snap = topo.snapshot(event.time)
        import math

        class _Inf:
            step_time = math.inf

        try:
            old = simulate_training_step(plan, self.model, topo,
                                         global_batch=self.global_batch,
                                         seq=self.seq, at_time=event.time)
        except (ValueError, ZeroDivisionError):
            old = _Inf()      # old plan infeasible on new topology (dead
            #                   stage after S3) -> any re-plan wins
        if self.engine is not None:
            if not isinstance(old, _Inf) \
                    and self.engine._device_key is not None:
                # the caller's *running* plan becomes the incumbent so warm
                # paths rebalance it (the engine's cached portfolio from its
                # cold plan stays valid for the same device set).  An engine
                # that never cold-planned has no pre-event baseline to
                # classify the delta against — leave incumbent unset and let
                # replan() take its cold path.
                self.engine.incumbent = (plan, old)
            res = self.engine.replan(snap, event)
            new_plan, action = res.plan, res.path
            new_step = res.predicted.step_time     # scored on this snapshot
            if getattr(res, "kept", False):
                # the engine's switch-cost hysteresis priced the move off
                # the incumbent (ReconfigCostModel) and kept it
                action = "keep"
            elif action == "bandwidth-rescore" \
                    and getattr(self.engine, "switch_horizon_s", None) \
                    is None \
                    and old.step_time / max(res.predicted.step_time, 1e-12) \
                    < self.replan_threshold:
                # legacy threshold hysteresis: only applies when no
                # remaining-horizon budget makes the cost model decisive
                new_plan, action, new_step = plan, "keep", old.step_time
            self._record(AdaptationRecord(
                time=event.time, event=event, action=action,
                old_step_time=old.step_time, new_step_time=new_step,
                switch_cost=0.0 if action == "keep"
                else getattr(res, "switch_cost", 0.0)))
            return new_plan
        if event.kind == "fail":
            n_alive = len(snap.alive_ids())
            if self.templates is not None:
                try:
                    new_plan = self.templates.plan_for(n_alive)
                    action = "template-failover"
                except KeyError:
                    new_plan = plan_hybrid(snap, self.model,
                                           global_batch=self.global_batch,
                                           seq=self.seq,
                                           with_baseline=False).plan
                    action = "full-replan"
            else:
                new_plan = plan_hybrid(snap, self.model,
                                       global_batch=self.global_batch,
                                       seq=self.seq,
                                       with_baseline=False).plan
                action = "full-replan"
        elif event.kind == "slowdown":
            new_plan = reassign_for_straggler(
                plan, self.model, snap,
                batch=self.global_batch, seq=self.seq)
            action = "straggler-reassign"
        else:  # bandwidth / join
            res = plan_hybrid(snap, self.model,
                              global_batch=self.global_batch, seq=self.seq,
                              with_baseline=False)
            candidate = res.plan
            cand_sim = res.predicted
            if old.step_time / max(cand_sim.step_time, 1e-12) \
                    >= self.replan_threshold:
                new_plan, action = candidate, "bandwidth-replan"
            else:
                new_plan, action = plan, "keep"
        new = simulate_training_step(new_plan, self.model, topo,
                                     global_batch=self.global_batch,
                                     seq=self.seq, at_time=event.time)
        self._record(AdaptationRecord(
            time=event.time, event=event, action=action,
            old_step_time=old.step_time, new_step_time=new.step_time))
        return new_plan
