"""Discrete-event simulator for heterogeneous, dynamic clusters.

This is our stand-in for SimAI (paper §4): a deterministic performance model
that predicts task execution times under the paper's constraint system:

  Eq. 4  data dependencies   — an op starts after its preds and their transfers,
  Eq. 5  communication       — a transfer starts after its producer finishes,
  Eq. 6  memory              — per-device residency must fit (checked statically),
  Eq. 7  bandwidth           — transfers on one physical edge-class serialize
                               (exclusive use at rate B_alpha).  Pairs without
                               a live direct link relay hop-by-hop along the
                               cached widest route (repro_torch.core.routing); every
                               relay hop claims its physical edge, so relayed
                               traffic contends with direct traffic.

Two levels are provided:

  * :func:`simulate_schedule` — faithful event-driven simulation of an
    arbitrary op DAG with an explicit device assignment, including dynamic
    bandwidth events re-rating in-flight transfers (temporal graph, §2.2).
    This is what the branch-and-bound planner evaluates.
  * :func:`simulate_training_step` / :func:`simulate_epoch` — model-level
    hybrid-parallel (DP/TP/PP/EP) step simulation with 1F1B pipelining,
    uneven heterogeneous batch shares and layer assignments, naive vs
    decomposed gradient sync.  This is the resolution the paper evaluates at
    (its §5 notes SimAI limits it to Megatron-style model-level assignment).
"""

from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

from .cluster import ClusterTopology, DeviceInstance, Edge, NetworkEvent
from .costmodel import _has_live_edge, collective_time, op_time, transfer_time
from .fabric import default_fabric
from .opgraph import CommOp, ModelDesc, OpGraph, layer_flops
from .plans import ParallelPlan

# ---------------------------------------------------------------------------
# Level 1: faithful DAG simulation
# ---------------------------------------------------------------------------


@dataclass
class SimResult:
    """Outcome of one discrete-event schedule simulation: end-to-end
    makespan, per-op start/end times, per-device busy time and aggregate
    communication volume/time."""

    makespan: float
    op_start: dict[str, float]
    op_end: dict[str, float]
    device_busy: dict[int, float]
    comm_bytes: float
    comm_time: float

    def utilization(self, topo: ClusterTopology) -> dict[int, float]:
        if self.makespan <= 0:
            return {d: 0.0 for d in self.device_busy}
        return {d: b / self.makespan for d, b in self.device_busy.items()}


class _EdgeClass:
    """Serialization domain: one physical edge (plus its conflict partners)."""

    __slots__ = ("edge", "free_at")

    def __init__(self, edge: Edge):
        self.edge = edge
        self.free_at = 0.0


def _edge_classes(topo: ClusterTopology) -> dict[tuple[int, int, str], _EdgeClass]:
    out: dict[tuple[int, int, str], _EdgeClass] = {}
    for (a, b), link in topo.links.items():
        for e in link.edges:
            out[(a, b, e.tag)] = _EdgeClass(e)
    return out


def check_memory(graph: OpGraph, assignment: Mapping[str, int],
                 topo: ClusterTopology) -> dict[int, float]:
    """Eq. 6: per-device residency.  Returns bytes per device; raises nothing —
    the planner compares against capacity for pruning."""
    usage: dict[int, float] = {}
    for name, dev in assignment.items():
        op = graph.nodes[name]
        usage[dev] = usage.get(dev, 0.0) + op.params_bytes + op.mem_required
    for (u, v), size in graph.edges.items():
        du, dv = assignment.get(u), assignment.get(v)
        if du is not None and dv is not None and du != dv:
            usage[dv] = usage.get(dv, 0.0) + size
    return usage


def memory_feasible(graph: OpGraph, assignment: Mapping[str, int],
                    topo: ClusterTopology, *, headroom: float = 0.95) -> bool:
    """True when every device's working set under ``assignment`` fits in
    ``headroom`` of its memory (see :func:`check_memory`)."""
    for dev, used in check_memory(graph, assignment, topo).items():
        if used > topo.device(dev).spec.mem_bytes * headroom:
            return False
    return True


def simulate_schedule(graph: OpGraph, assignment: Mapping[str, int],
                      topo: ClusterTopology, *,
                      priority: Sequence[str] | None = None,
                      apply_events: bool = True,
                      start_time: float = 0.0,
                      obs=None) -> SimResult:
    """Event-driven simulation of ``graph`` under ``assignment``.

    Ops on one device run serially in ready order (ties broken by the given
    priority / topological order).  Each cross-device dependency becomes a
    transfer that must win exclusive use of one physical edge; conflicting
    edge tags (paper Fig. 5b) share a serialization domain.  Dynamic
    bandwidth events re-rate in-flight transfers at their event time.

    Relayed transfers pipeline cut-through chunks through the default
    :class:`repro_torch.core.fabric.FabricModel` (every hop still claims its
    physical edge, so relay traffic serializes against direct traffic);
    ``obs`` records ``fabric.relays`` / ``fabric.relay_hops`` /
    ``fabric.chunks`` counters (no-op by default).
    """
    from ..obs import resolve_obs
    obs = resolve_obs(obs)
    fabric = default_fabric()
    topo = topo.snapshot(start_time) if apply_events else topo
    order = priority or graph.topo_order()
    rank = {n: i for i, n in enumerate(order)}
    classes = _edge_classes(topo)
    # hoisted: the sim's topology is immutable for the whole run, so one
    # table serves every relayed transfer (construction is O(links); the
    # per-source widest-path trees stay lazy inside it)
    route_table = topo.routing()
    # conflict partners share the max free_at: map tag -> sibling tags
    dev_free = {d: 0.0 for d in topo.devices}
    op_start: dict[str, float] = {}
    op_end: dict[str, float] = {}
    xfer_end: dict[tuple[str, str], float] = {}
    busy: dict[int, float] = {d: 0.0 for d in topo.devices}
    comm_bytes = 0.0
    comm_time = 0.0

    pending_events = [e for e in topo.events if e.time > start_time] \
        if apply_events else []

    remaining = set(graph.nodes)
    n_preds = {v: len(graph.preds(v)) for v in graph.nodes}
    done_preds = {v: 0 for v in graph.nodes}

    def hop_earliest(link, key: tuple[int, int], e: Edge, cls: _EdgeClass,
                     not_before: float) -> float:
        """Earliest start on one physical edge: queueing behind the edge's
        own traffic plus its conflict partners (they serialize together)."""
        conflict_free = max(
            [classes[(key[0], key[1], o.tag)].free_at
             for o in link.edges
             if o.tag in e.conflicts_with or e.tag in o.conflicts_with],
            default=0.0)
        return max(not_before, cls.free_at, conflict_free)

    def hop_ready(a: int, b: int, size: float,
                  not_before: float) -> tuple[float, float, _EdgeClass]:
        """(start, end, edge_class) for the best physical edge on the
        direct link ``a``-``b``, queueing included."""
        link = topo.link(a, b)
        key = (min(a, b), max(a, b))
        best = None
        for e in link.edges:
            cls = classes[(key[0], key[1], e.tag)]
            st = hop_earliest(link, key, e, cls, not_before)
            en = st + fabric.edge_time(e, size)
            if best is None or en < best[1]:
                best = (st, en, cls)
        return best  # type: ignore[return-value]

    def edge_ready_time(a: int, b: int, size: float, not_before: float
                        ) -> tuple[float, float, list[tuple[_EdgeClass, float]]]:
        """(start, end, claims) for one logical transfer.

        Direct pairs pick the best physical edge on their link.  Pairs
        without a live direct link relay cut-through chunks hop-by-hop
        along the cached widest route (:mod:`repro_torch.core.routing`) via the
        fabric's relay recursion — hop ``h`` finishes once it has
        serialized all chunks *and* the last chunk has arrived from hop
        ``h-1``, so on an uncontended fabric the final hop's end equals
        :meth:`repro_torch.core.fabric.FabricModel.route_time`'s closed form.
        Every hop still claims its physical edge's serialization domain,
        so relay traffic contends with direct traffic on the same links
        (paper Fig. 5b generalized).  ``claims`` are (edge_class,
        busy_until) pairs the caller commits once the transfer is
        scheduled.  Unroutable pairs (partitioned cluster) finish at
        ``inf``."""
        if a == b:
            return not_before, not_before, []
        if _has_live_edge(topo, a, b):
            st, en, cls = hop_ready(a, b, size, not_before)
            return st, en, [(cls, en)]
        route = route_table.route(a, b)
        if route is None:
            return not_before, math.inf, []
        first_chunk_at = not_before
        prev_end: float | None = None
        st0 = not_before
        claims: list[tuple[_EdgeClass, float]] = []
        for hi, (u, v) in enumerate(zip(route.path, route.path[1:])):
            link = topo.link(u, v)
            key = (min(u, v), max(u, v))
            best = None
            for e in link.edges:
                cls = classes[(key[0], key[1], e.tag)]
                st = hop_earliest(link, key, e, cls, first_chunk_at)
                en, nxt = fabric.relay_step(
                    size, e.effective_bandwidth, e.latency,
                    st, first_chunk_at, prev_end)
                if best is None or en < best[0]:
                    best = (en, st, nxt, cls)
            en, st, nxt, cls = best  # type: ignore[misc]
            if hi == 0:
                st0 = st
            claims.append((cls, en))
            prev_end = en
            first_chunk_at = nxt
        obs.inc("fabric.relays")
        obs.inc("fabric.relay_hops", len(claims))
        obs.inc("fabric.chunks", fabric.chunks(size))
        return st0, prev_end, claims  # type: ignore[return-value]

    # Kahn-style scheduling loop: repeatedly place the ready op whose device
    # is available earliest; deterministic by (ready-rank) priority.
    ready = [v for v in order if n_preds[v] == 0]
    while remaining:
        if not ready:
            raise RuntimeError("deadlock: no ready ops but graph not done")
        # choose the ready op with the smallest priority rank
        v = min(ready, key=lambda n: rank[n])
        ready.remove(v)
        dev = assignment[v]
        # data-arrival time: all incoming transfers must complete (Eq. 4)
        arrive = 0.0
        for u in graph.preds(v):
            du = assignment[u]
            size = graph.edges[(u, v)]
            if du == dev:
                arrive = max(arrive, op_end[u])
            else:
                st, en, claims = edge_ready_time(du, dev, size,
                                                 not_before=op_end[u])  # Eq. 5
                for cls, busy_until in claims:
                    cls.free_at = busy_until
                xfer_end[(u, v)] = en
                comm_bytes += size
                comm_time += en - st
                arrive = max(arrive, en)
        st = max(arrive, dev_free[dev], start_time)
        dur = op_time(graph.nodes[v], topo.device(dev))
        # dynamic bandwidth events don't change compute; device slowdown
        # events between start_time and st are visible via snapshot+replay:
        for ev in pending_events:
            if ev.kind == "slowdown" and ev.device_id == dev and ev.time <= st:
                dur = op_time(graph.nodes[v], DeviceInstance(
                    dev, topo.device(dev).spec, perf_factor=ev.factor))
        en = st + dur
        op_start[v], op_end[v] = st, en
        dev_free[dev] = en
        busy[dev] += dur
        remaining.discard(v)
        for s in graph.succs(v):
            done_preds[s] += 1
            if done_preds[s] == n_preds[s]:
                ready.append(s)

    makespan = max(op_end.values(), default=0.0) - start_time
    return SimResult(makespan=makespan, op_start=op_start, op_end=op_end,
                     device_busy=busy, comm_bytes=comm_bytes,
                     comm_time=comm_time)


# ---------------------------------------------------------------------------
# Level 2: hybrid-parallel training-step simulation
# ---------------------------------------------------------------------------


@dataclass
class StepSim:
    """Predicted timing of one optimizer step under a ParallelPlan."""

    step_time: float
    compute_time: float
    tp_comm_time: float
    pp_comm_time: float
    dp_sync_time: float
    bubble_time: float
    breakdown: dict = field(default_factory=dict)


def _stage_device(topo: ClusterTopology, stage_devices: Sequence[int]) -> DeviceInstance:
    """Slowest alive device in the stage group bounds the stage (synchronous TP)."""
    devs = [topo.device(d) for d in stage_devices if topo.device(d).alive]
    if not devs:
        raise ValueError("stage has no alive devices")
    return min(devs, key=lambda d: d.spec.peak_flops * d.perf_factor)


def _tp_group_time(topo: ClusterTopology, stage_devices: Sequence[int],
                   tp: int, size: float) -> float:
    """One activation all-reduce over the first TP subgroup of the stage."""
    if tp <= 1:
        return 0.0
    group = tuple(stage_devices[:tp])
    return collective_time(
        topo, CommOp("tp_ar", "all_reduce", size, group))


def simulate_training_step(plan: ParallelPlan, model: ModelDesc,
                           topo: ClusterTopology, *,
                           global_batch: int, seq: int,
                           at_time: float = 0.0) -> StepSim:
    """Deterministic step-time prediction for a hybrid-parallel plan.

    Per DP rank r (batch share w_r), per pipeline stage s, per microbatch:
      fwd_s = sum_{l in stage s} roofline(layer flops / tp on slowest stage dev)
              + per-layer TP collectives (+ EP all-to-all for MoE layers)
      bwd_s ~= 2 * fwd compute + same collectives
    The 1F1B schedule is simulated exactly over (stages x microbatches); the
    step ends after the slowest DP rank finishes its pipeline flush plus
    (non-overlapped) gradient synchronization.
    """
    plan.validate(model.n_layers)
    snap = topo.snapshot(at_time)
    dp, tp, pp, M = plan.dp, plan.tp, plan.pp, plan.microbatches
    shares = plan.batch_shares or tuple([1.0 / dp] * dp)
    stages = plan.stages
    if not stages:
        from .plans import split_devices, uniform_stages
        stages = uniform_stages(model.n_layers, pp, split_devices(snap, dp, tp, pp))
    db = model.dtype_bytes

    rank_makespans: list[float] = []
    total_compute = total_tp = total_pp = 0.0
    bubble = 0.0

    for r in range(dp):
        mb_batch = max(global_batch * shares[r] / M, 1e-9)
        act_bytes = mb_batch * seq * model.d_model * db
        fwd: list[float] = []
        bwd: list[float] = []
        p2p: list[float] = []
        for s, st in enumerate(stages):
            # the TP subgroup serving DP rank r inside this stage
            group = st.device_ids[r * tp:(r + 1) * tp] if len(st.device_ids) >= dp * tp \
                else st.device_ids
            dev = _stage_device(snap, group)
            f = 0.0
            tp_c = 0.0
            for l in st.layers:
                fl = layer_flops(model, l, 1, seq) * mb_batch  # scale by batch
                params = model.layer_params(l) * db
                traffic = (4 * act_bytes + params) / tp
                if not dev.spec.supports_fusion and model.layer_kind(l) == "attn":
                    # no fused attention on this device (paper §2.3 / Fig. 2):
                    # the S x S score matrix round-trips HBM in fwd and bwd.
                    traffic += 4 * mb_batch * model.n_heads * seq * seq * db / tp
                f += dev.spec.roofline_time(fl / tp, traffic,
                                            perf_factor=dev.perf_factor)
                if tp > 1:
                    # 2 activation all-reduces fwd (attn out + mlp out); with
                    # sequence parallelism these become AG+RS of equal volume.
                    n_coll = 2
                    tp_c += n_coll * _tp_group_time(snap, group, tp, act_bytes)
                if model.n_experts and plan.ep > 1 and model.layer_kind(l) == "attn":
                    a2a = collective_time(snap, CommOp(
                        "a2a", "all_to_all",
                        act_bytes * model.top_k, tuple(group)))
                    tp_c += 2 * a2a
            fwd.append(f + tp_c)
            bwd.append(2.0 * f + tp_c)
            total_compute += M * 3.0 * f
            total_tp += M * 2 * tp_c
            if s + 1 < len(stages):
                nxt = stages[s + 1].device_ids
                nxt_dev = nxt[r * tp] if len(nxt) >= dp * tp else nxt[0]
                cur_dev = group[0]
                p2p.append(transfer_time(snap, cur_dev, nxt_dev, act_bytes))
            # remat: full recompute adds ~1 fwd to bwd
            if plan.remat == "full":
                bwd[-1] += f
            elif plan.remat == "selective":
                bwd[-1] += 0.3 * f

        makespan = _simulate_1f1b(fwd, bwd, p2p, M)
        ideal = sum(M * (fwd[s] + bwd[s]) for s in range(len(stages))) / max(len(stages), 1)
        bubble = max(bubble, makespan - ideal)
        total_pp += 2 * M * sum(p2p)
        rank_makespans.append(makespan)

    pipe_time = max(rank_makespans)

    # Gradient sync across DP ranks, per stage (worst stage counts).
    dp_sync = 0.0
    if dp > 1:
        for st in stages:
            params_bytes = sum(model.layer_params(l) for l in st.layers) * db / tp
            # participants: one device per DP rank in this stage
            members = tuple(st.device_ids[r * tp] for r in range(dp)) \
                if len(st.device_ids) >= dp * tp else tuple(st.device_ids)
            if plan.grad_compression == "int8":
                params_bytes *= 0.5
            elif plan.grad_compression == "topk":
                params_bytes *= 0.15
            t = allreduce_like(snap, params_bytes, members,
                               decomposed=(plan.grad_sync == "rs_ag"))
            dp_sync = max(dp_sync, t)

    step = pipe_time + dp_sync
    return StepSim(step_time=step, compute_time=total_compute,
                   tp_comm_time=total_tp, pp_comm_time=total_pp,
                   dp_sync_time=dp_sync, bubble_time=bubble,
                   breakdown={"pipe_time": pipe_time,
                              "rank_makespans": rank_makespans})


def simulate_many(plans: Sequence[ParallelPlan], model: ModelDesc,
                  topo: ClusterTopology, *, global_batch: int, seq: int,
                  at_time: float = 0.0,
                  obs=None) -> list["StepSim | None"]:
    """Batch step simulation: score many plans against one topology state.

    The topology snapshot is materialized once for the whole batch (one
    event replay + deep copy instead of one per plan), which is what lets
    search worker processes amortize per-process setup across their chunk.
    Per-plan infeasibility (ValueError / ZeroDivisionError) yields ``None``
    instead of aborting the batch — identical semantics to scoring each
    plan alone, so batched and per-plan scoring are interchangeable.  A
    non-finite step time is infeasibility too: with routed transfer pricing
    an unroutable collective or p2p hop (partitioned cluster) simulates to
    ``inf``, and planning must reject such plans, not rank them.

    ``obs`` is a :class:`repro_torch.obs.Obs` bundle; the batch records one
    ``sim.batch`` span and a ``sim.plans`` counter (no-op by default).
    """
    from ..obs import resolve_obs
    obs = resolve_obs(obs)
    snap = topo.snapshot(at_time)
    out: list[StepSim | None] = []
    with obs.span("sim.batch", n_plans=len(plans)) as sp:
        for plan in plans:
            try:
                sim = simulate_training_step(
                    plan, model, snap, global_batch=global_batch, seq=seq)
            except (ValueError, ZeroDivisionError):
                sim = None
            if sim is not None and not math.isfinite(sim.step_time):
                sim = None
            out.append(sim)
        sp.set(feasible=sum(1 for s in out if s is not None))
    obs.inc("sim.plans", len(plans))
    return out


def allreduce_like(topo: ClusterTopology, size: float, ranks: Sequence[int],
                   *, decomposed: bool) -> float:
    """Gradient-sync collective time over ``ranks`` (ring allreduce, or
    the decomposed reduce-scatter + all-gather when ``decomposed``);
    thin forwarding wrapper over :func:`repro_torch.core.costmodel.allreduce_time`."""
    from .costmodel import allreduce_time
    return allreduce_time(topo, size, ranks, decomposed=decomposed)


def _simulate_1f1b(fwd: Sequence[float], bwd: Sequence[float],
                   p2p: Sequence[float], M: int) -> float:
    """Exact event simulation of the 1F1B schedule for one DP rank.

    Stage s runs its microbatch queue; forward of mb m on stage s needs
    forward of m on s-1 (plus p2p); backward of m on stage s needs backward
    of m on s+1 (plus p2p).  Steady-state 1F1B interleaving is enforced by
    the standard warmup rule (stage s admits pp-s forwards before its first
    backward)."""
    S = len(fwd)
    if S == 1:
        return M * (fwd[0] + bwd[0])
    f_done = [[0.0] * M for _ in range(S)]
    b_done = [[0.0] * M for _ in range(S)]
    # Each stage executes its 1F1B queue (warmup = min(S-s, M) forwards, then
    # alternate B/F, then drain).  Cross-stage dependencies resolve by
    # relaxation to a fixed point (bounded by pipeline depth).
    for _ in range(2 * (S + M) + 4):
        changed = False
        for s in range(S):
            order = _1f1b_order(S, s, M)
            t = 0.0
            for kind, m in order:
                if kind == "F":
                    dep = f_done[s - 1][m] + p2p[s - 1] if s > 0 else 0.0
                    st = max(t, dep)
                    en = st + fwd[s]
                    if f_done[s][m] != en:
                        f_done[s][m] = en
                        changed = True
                else:
                    dep = b_done[s + 1][m] + p2p[s] if s < S - 1 else f_done[s][m]
                    st = max(t, dep)
                    en = st + bwd[s]
                    if b_done[s][m] != en:
                        b_done[s][m] = en
                        changed = True
                t = f_done[s][m] if kind == "F" else b_done[s][m]
        if not changed:
            break
    return max(b_done[0])


def _1f1b_order(S: int, s: int, M: int) -> list[tuple[str, int]]:
    order: list[tuple[str, int]] = []
    warm = min(S - s, M)
    for m in range(warm):
        order.append(("F", m))
    nb, nf = 0, warm
    while nb < M:
        order.append(("B", nb))
        nb += 1
        if nf < M:
            order.append(("F", nf))
            nf += 1
    return order


# ---------------------------------------------------------------------------
# Epoch-level simulation with dynamic events (paper Fig. 6 setting)
# ---------------------------------------------------------------------------


@dataclass
class EpochSim:
    """Epoch-level simulation outcome: total wall time over ``steps``
    optimizer steps, the per-step times, and the re-plan count plus total
    modeled reconfiguration charge."""

    total_time: float
    steps: int
    step_times: list[float]
    replans: int = 0
    reconfig_s: float = 0.0      # total modeled plan-switch cost charged


def simulate_epoch(plan: ParallelPlan, model: ModelDesc, topo: ClusterTopology,
                   *, global_batch: int, seq: int, steps: int,
                   replan_fn: Callable[[ClusterTopology, float],
                                       ParallelPlan] | None = None,
                   reconfig: "object | None" = None,
                   reroute_in_flight: bool = True,
                   obs=None) -> EpochSim:
    """Simulate ``steps`` optimizer steps over the temporal topology.

    With ``reroute_in_flight`` (the default), a bandwidth/link event that
    lands *inside* a step no longer waits for the step boundary: the step
    is split at the event time, and the remaining fraction of its work is
    re-priced on the post-event topology snapshot — in-flight relayed
    transfers see the post-event routing table instead of holding the
    stale route (a degraded relay slows the step remainder immediately; a
    recovered link speeds it up).  ``reroute_in_flight=False`` restores
    the old boundary-only semantics.  ``obs`` records
    ``sim.reroute.events`` (events applied mid-step) and
    ``sim.reroute.steps`` (steps split at least once).

    If ``replan_fn`` is given, topology changes trigger re-planning at the
    next step boundary.  A re-plan that actually *switches* plans is charged
    the physically-modeled checkpoint/reshard cost (checkpoint bytes,
    reshard traffic, post-event bandwidths) through ``reconfig`` — a
    :class:`repro_torch.core.reconfig.ReconfigCostModel`, built from ``model``
    when not supplied.  Re-plans that keep the incumbent cost nothing."""
    from ..obs import resolve_obs
    from .reconfig import ReconfigCostModel
    obs = resolve_obs(obs)
    if reconfig is None:
        reconfig = ReconfigCostModel(model)
    t = 0.0
    times: list[float] = []
    replans = 0
    reconfig_s = 0.0
    current = plan
    pending = sorted(topo.events, key=lambda e: e.time)
    ei = 0
    fired = False      # events seen since the last re-plan opportunity
    for _ in range(steps):
        # apply any events that fired at / before the step boundary
        while ei < len(pending) and pending[ei].time <= t:
            fired = True
            ei += 1
        if fired and replan_fn is not None:
            snap = topo.snapshot(t)
            new = replan_fn(snap, t)
            if new.structural_key() != current.structural_key():
                charge = reconfig.cost(current, new, snap).total_s
                t += charge
                reconfig_s += charge
            current = new
            replans += 1
            fired = False
        sim = simulate_training_step(current, model, topo,
                                     global_batch=global_batch, seq=seq,
                                     at_time=t)
        step_t = sim.step_time
        cur, frac = t, 1.0
        split = False
        if reroute_in_flight:
            while (ei < len(pending) and math.isfinite(step_t) and step_t > 0
                   and pending[ei].time < cur + frac * step_t):
                tau = pending[ei].time
                # progress made on the pre-event pricing, then re-price the
                # remaining work fraction on the post-event snapshot
                frac -= (tau - cur) / step_t
                cur = tau
                while ei < len(pending) and pending[ei].time <= tau:
                    ei += 1
                    fired = True
                    split = True
                    obs.inc("sim.reroute.events")
                step_t = simulate_training_step(
                    current, model, topo, global_batch=global_batch,
                    seq=seq, at_time=tau).step_time
        if split:
            obs.inc("sim.reroute.steps")
        step_time = (cur + frac * step_t) - t
        times.append(step_time)
        t += step_time
    return EpochSim(total_time=t, steps=steps, step_times=times,
                    replans=replans, reconfig_s=reconfig_s)
