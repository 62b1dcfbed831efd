"""Physically-modeled reconfiguration cost (checkpoint/reshard traffic).

Switching between two :class:`~repro_torch.core.plans.ParallelPlan`\\ s mid-run is
not free: the runtime checkpoints the train state, tears the mesh down,
re-materializes the new plan's layout and reshards every parameter/optimizer
shard onto it (``repro_torch.checkpoint.store.restore`` with the new sharding tree
— Oobleck's template switch).  The harness and simulator used to charge two
disagreeing made-up constants for this (2 s vs 5 s); this module prices the
switch from first principles:

  * :meth:`ReconfigCostModel.checkpoint_bytes` — the full sharded train-state
    footprint (params at the training dtype + Adam moments) that the
    checkpoint store's flattened reshard tree carries,
  * :meth:`ReconfigCostModel.reshard_traffic` — which bytes actually cross
    the fabric: per (device, layer) shard *signatures* (tp size, tp rank,
    owned layers) are compared between the old and new layouts; a device
    whose signature for a layer is unchanged keeps its shard in place, every
    other destination pulls its shard from the nearest alive old owner —
    or from the host checkpoint store when no alive peer holds it (post-S3
    failover),
  * :meth:`ReconfigCostModel.cost` — prices that traffic over the
    *post-event* topology's links (per-device serialization: a device's
    total send+receive time bounds the reshard; disjoint pairs overlap),
    plus host-store I/O and a fixed teardown/rebuild term.

The model carries a calibration hook (:meth:`calibrate_io` /
:meth:`calibrate`) fed by the runtime :class:`repro_torch.runtime.trainer.Trainer`'s
measured checkpoint-restore path, so simulated switch charges track what the
real restore actually costs on the deployment.

:func:`plan_sequence_dp` is the cross-interval clairvoyant bound built on
top: given per-interval step times for a candidate plan set and a switch-cost
function, it chooses the plan *sequence* maximizing completed optimizer
steps — the true oracle once switches are no longer free (the per-interval
greedy oracle over-switches and over-pays).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

from .cluster import ClusterTopology
from .costmodel import transfer_time
from .opgraph import ModelDesc
from .plans import ParallelPlan, split_devices, uniform_stages

# ---------------------------------------------------------------------------
# Cost breakdown
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ReconfigCost:
    """One plan switch, decomposed.  ``total_s`` is what callers charge."""

    total_s: float
    checkpoint_bytes: float      # full train-state footprint of the new plan
    reshard_bytes: float         # bytes moved device-to-device over the fabric
    store_bytes: float           # bytes with no alive peer source (host store)
    transfer_s: float            # fabric reshard time on the given topology
    io_s: float                  # host checkpoint-store read time
    base_s: float                # fixed teardown / re-jit / rebuild term
    bottleneck_bw: float         # slowest link the reshard actually used


_ZERO = ReconfigCost(total_s=0.0, checkpoint_bytes=0.0, reshard_bytes=0.0,
                     store_bytes=0.0, transfer_s=0.0, io_s=0.0, base_s=0.0,
                     bottleneck_bw=math.inf)


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------


def _plan_stages(plan: ParallelPlan, model: ModelDesc,
                 topo: ClusterTopology):
    """The plan's stages, synthesizing the default layout for plans built
    without explicit stages (templates, hand-written configs) — the same
    fallback the simulator applies."""
    if plan.stages:
        return plan.stages
    return uniform_stages(model.n_layers, plan.pp,
                          split_devices(topo, plan.dp, plan.tp, plan.pp))


class ReconfigCostModel:
    """Prices a plan switch from the model/plan sharding and the topology.

    ``opt_bytes_per_param`` covers the Adam moment pair (2x fp32); the
    optimizer shard is additionally split over DP under ZeRO-1.  ``io_bw``
    is the host checkpoint-store bandwidth used for bytes with no alive
    peer source — replace it with a measured value via :meth:`calibrate_io`.
    ``calibration`` is a global scale trimmed by :meth:`calibrate` against an
    end-to-end measured switch.
    """

    def __init__(self, model: ModelDesc, *,
                 opt_bytes_per_param: float = 8.0,
                 base_overhead_s: float = 0.25,
                 io_bw: float = 4e9,
                 calibration: float = 1.0,
                 fabric_scale: float = 1.0,
                 store_scale: float = 1.0):
        self.model = model
        self.opt_bytes_per_param = opt_bytes_per_param
        self.base_overhead_s = base_overhead_s
        self.io_bw = io_bw
        self.calibration = calibration
        # per-term scales fit by :meth:`calibrate_terms` from a few measured
        # switches: fabric covers teardown + peer-to-peer reshard, store the
        # host checkpoint-store I/O — a single global scale cannot fit both
        # when the deployment's fabric and disk drift differently.
        self.fabric_scale = fabric_scale
        self.store_scale = store_scale

    # -- checkpoint footprint --------------------------------------------------

    def bytes_per_param(self) -> float:
        return self.model.dtype_bytes + self.opt_bytes_per_param

    def checkpoint_bytes(self, plan: ParallelPlan | None = None) -> float:
        """Total train-state bytes the store's flattened tree carries.  The
        sharded layout spreads, but does not shrink, this footprint (ZeRO-1
        shards the moments across DP; every byte still exists once)."""
        del plan  # the global footprint is plan-independent
        return float(self.model.total_params()) * self.bytes_per_param()

    # -- layouts ---------------------------------------------------------------

    def _unit_bytes(self, unit: int | str) -> tuple[float, float]:
        """(param bytes, optimizer bytes) of one reshard unit — a layer, or
        the tied embedding/head matrix (``"embed"``, owned by stage 0)."""
        m = self.model
        if unit == "embed":
            params = float(m.vocab * m.d_model)
        else:
            params = float(m.layer_params(unit))
        return params * m.dtype_bytes, params * self.opt_bytes_per_param

    def _layout(self, plan: ParallelPlan, topo: ClusterTopology
                ) -> dict[int, dict[int | str, tuple]]:
        """device -> unit -> (param frac, opt frac, param sig, opt sig).

        The param signature ``(tp_size, tp_rank)`` identifies *which* slice
        of the unit the device holds — independent of which other layers
        share the stage, so a layer-rebalance only moves the layers that
        actually changed hands.  The optimizer signature additionally pins
        the ZeRO-1 partition ``(dp_size, dp_rank)``: a device that keeps its
        TP slice but lands in a different DP group holds the wrong moment
        slice and must refetch it."""
        stages = _plan_stages(plan, self.model, topo)
        dp, tp = plan.dp, plan.tp
        out: dict[int, dict[int | str, tuple]] = {}
        for si, st in enumerate(stages):
            G = st.device_ids
            if len(G) >= dp * tp:
                groups = [G[r * tp:(r + 1) * tp] for r in range(dp)]
            else:                      # degenerate stage: one shared group
                groups = [G]
            units: list[int | str] = list(st.layers)
            if si == 0:
                units.append("embed")
            for dp_rank, sub in enumerate(groups):
                width = max(1, len(sub))
                for rank, dev in enumerate(sub):
                    slot = out.setdefault(dev, {})
                    pf = 1.0 / width
                    psig = (width, rank)
                    if plan.zero1 and dp > 1:
                        of = pf / dp
                        osig = (width, rank, dp, dp_rank)
                    else:
                        of = pf
                        osig = psig
                    for u in units:
                        slot[u] = (pf, of, psig, osig)
        return out

    # -- reshard traffic -------------------------------------------------------

    @staticmethod
    def _sig_interval(sig: tuple) -> tuple[float, float]:
        """A shard signature as the [lo, hi) slice of its unit it covers.

        Param signatures ``(tp_width, tp_rank)`` slice the unit into
        ``tp_width`` contiguous equal pieces; ZeRO-1 optimizer signatures
        ``(tp_width, tp_rank, dp, dp_rank)`` subdivide that TP slice across
        the DP group.  Expressing signatures as intervals is what lets a
        nested tp reshape (width 2 -> 4, rank chosen inside the old half)
        claim its overlap instead of pricing a whole-shard pull."""
        if len(sig) == 2:
            w, r = sig
            return r / w, (r + 1) / w
        w, r, dp, dpr = sig
        width = 1.0 / (w * dp)
        lo = r / w + dpr * width
        return lo, lo + width

    @classmethod
    def _missing_fraction(cls, new_sig: tuple, old_sig: tuple) -> float:
        """Fraction of the unit the destination must fetch: its new slice
        minus the overlap with the slice it already holds."""
        nlo, nhi = cls._sig_interval(new_sig)
        olo, ohi = cls._sig_interval(old_sig)
        overlap = max(0.0, min(nhi, ohi) - max(nlo, olo))
        return (nhi - nlo) - overlap

    def reshard_traffic(self, old: ParallelPlan, new: ParallelPlan,
                        topo: ClusterTopology
                        ) -> tuple[dict[tuple[int, int], float], float]:
        """(pair -> bytes moved peer-to-peer, bytes served by the host store).

        Destinations are the new layout's owners; sources are *alive* old
        owners of the same unit (nearest by transfer time, deterministic
        tie-break by device id).  Identical shard signatures move nothing —
        two structurally identical plans therefore cost zero — and a
        destination whose old slice *partially overlaps* its new one (a
        nested tp reshape) pulls only the missing slice remainder.

        A stage-less old plan whose default layout no longer fits the
        (post-failure) topology has no peer sources at all: everything the
        new layout needs comes from the host checkpoint store.  A new plan
        whose layout cannot be synthesized is priced as a full store
        restore."""
        if old.structural_key() == new.structural_key():
            return {}, 0.0
        try:
            old_map = self._layout(old, topo)
        except ValueError:
            old_map = {}
        try:
            new_map = self._layout(new, topo)
        except ValueError:
            return {}, self.checkpoint_bytes(new)
        alive = set(topo.alive_ids())
        # fetched once: the nearest-owner loop prices O(units x sources)
        # pairs, too hot for routing()'s per-call signature re-check
        table = topo.routing()
        # unit -> alive old owners (for source selection)
        owners: dict[int | str, list[int]] = {}
        for dev, units in old_map.items():
            if dev in alive:
                for u in units:
                    owners.setdefault(u, []).append(dev)
        pair_bytes: dict[tuple[int, int], float] = {}
        store_bytes = 0.0
        for dev in sorted(new_map):
            held = old_map.get(dev, {})
            for u, (pf, of, psig, osig) in sorted(new_map[dev].items(),
                                                  key=str):
                pb, ob = self._unit_bytes(u)
                old_entry = held.get(u)
                need = 0.0
                if old_entry is None:
                    need = pf * pb + of * ob
                else:
                    # slice-overlap credit: only the part of the new shard
                    # the device does not already hold crosses the fabric
                    if old_entry[2] != psig:
                        need += self._missing_fraction(psig,
                                                       old_entry[2]) * pb
                    if old_entry[3] != osig:
                        need += self._missing_fraction(osig,
                                                       old_entry[3]) * ob
                if need <= 0.0:
                    continue
                srcs = [s for s in owners.get(u, ()) if s != dev]
                # nearest alive owner by (routed) transfer time; owners the
                # fabric cannot reach (partitioned post-event topology) are
                # no sources at all — those bytes come from the host store
                timed = sorted((transfer_time(topo, s, dev, need,
                                              routing=table), s)
                               for s in srcs)
                if not timed or not math.isfinite(timed[0][0]):
                    store_bytes += need
                    continue
                src = timed[0][1]
                pair_bytes[(src, dev)] = pair_bytes.get((src, dev), 0.0) + need
        return pair_bytes, store_bytes

    # -- pricing ---------------------------------------------------------------

    @staticmethod
    def _path_time(topo: ClusterTopology, a: int, b: int, size: float,
                   *, routing=None) -> tuple[float, float]:
        """(seconds, bandwidth) for one transfer — thin delegate to the
        default fabric's :meth:`repro_torch.core.fabric.FabricModel.path_time`.
        Pairs without a live direct link are priced on their widest
        multi-hop route with chunked cut-through pipelining; unreachable
        pairs return ``(inf, 0.0)`` and callers fall back to the host
        store."""
        from .fabric import default_fabric
        return default_fabric().path_time(topo, a, b, size, routing=routing)

    @staticmethod
    def _pair_links(topo: ClusterTopology, a: int, b: int,
                    table) -> list[tuple[tuple[int, int], float]]:
        """The physical ``(min, max)`` link keys (with per-hop bandwidth) a
        reshard pair actually rides: the live direct link when one exists,
        otherwise every hop of the widest route — the same per-edge
        serialization domains :func:`repro_torch.core.simulator.simulate_schedule`
        claims for relayed transfers.  Unreachable pairs ride nothing (they
        are store-served)."""
        direct = table.hop_price(a, b)
        if direct is not None:
            return [((min(a, b), max(a, b)), direct[0])]
        route = table.route(a, b)
        if route is None:
            return []
        out = []
        for u, v in zip(route.path, route.path[1:]):
            hop = table.hop_price(u, v)
            if hop is not None:
                out.append(((min(u, v), max(u, v)), hop[0]))
        return out

    def edge_traffic(self, old: ParallelPlan, new: ParallelPlan,
                     topo: ClusterTopology) -> dict[tuple[int, int], float]:
        """Route-expanded reshard traffic of the switch: physical link key
        ``(min, max)`` -> bytes this switch pushes over that link (a relayed
        pair charges every hop).  This is what one job's reshard looks like
        *to another job sharing the fabric* — the load board concurrent
        switches are priced against (see :meth:`cost`'s ``edge_load``)."""
        pair_bytes, _ = self.reshard_traffic(old, new, topo)
        if not pair_bytes:
            return {}
        table = topo.routing()
        load: dict[tuple[int, int], float] = {}
        for (src, dst), nbytes in sorted(pair_bytes.items()):
            for key, _bw in self._pair_links(topo, src, dst, table):
                load[key] = load.get(key, 0.0) + nbytes
        return load

    def cost(self, old: ParallelPlan, new: ParallelPlan,
             topo: ClusterTopology, *,
             edge_load: dict[tuple[int, int], float] | None = None
             ) -> ReconfigCost:
        """Price switching ``old -> new`` on (post-event) ``topo``.

        ``edge_load`` maps physical link keys ``(min, max)`` to *other*
        jobs' in-flight bytes on that link (their :meth:`edge_traffic`).
        Each reshard pair then queues behind the foreign bytes on its most
        contended hop — ``extra / (beta * hop_bw)`` added to the solo fabric
        price, exactly the simulator's serialize-behind-the-edge semantics.
        Without it the model prices every switch as if the job owned the
        fabric, silently optimistic whenever two jobs reshard at once."""
        if old.structural_key() == new.structural_key():
            return _ZERO
        pair_bytes, store_bytes = self.reshard_traffic(old, new, topo)
        per_dev: dict[int, float] = {}
        bottleneck = math.inf
        table = topo.routing() if pair_bytes else None
        beta = 1.0
        if edge_load and pair_bytes:
            from .fabric import default_fabric
            beta = max(default_fabric().beta, 1e-12)
        for (src, dst), nbytes in sorted(pair_bytes.items()):
            t, bw = self._path_time(topo, src, dst, nbytes, routing=table)
            if edge_load:
                queue = 0.0
                for key, hop_bw in self._pair_links(topo, src, dst, table):
                    extra = edge_load.get(key, 0.0)
                    if extra > 0 and hop_bw > 0:
                        queue = max(queue, extra / (beta * hop_bw))
                t += queue
            per_dev[src] = per_dev.get(src, 0.0) + t
            per_dev[dst] = per_dev.get(dst, 0.0) + t
            bottleneck = min(bottleneck, bw)
        transfer_s = max(per_dev.values(), default=0.0)
        io_s = store_bytes / self.io_bw if self.io_bw > 0 else 0.0
        total = self.calibration * (
            self.fabric_scale * (self.base_overhead_s + transfer_s)
            + self.store_scale * io_s)
        return ReconfigCost(
            total_s=total,
            checkpoint_bytes=self.checkpoint_bytes(new),
            reshard_bytes=sum(pair_bytes.values()),
            store_bytes=store_bytes, transfer_s=transfer_s, io_s=io_s,
            base_s=self.base_overhead_s, bottleneck_bw=bottleneck)

    def switch_seconds(self, old: ParallelPlan, new: ParallelPlan,
                       topo: ClusterTopology) -> float:
        return self.cost(old, new, topo).total_s

    def concurrent_costs(self, switches: Sequence[
            tuple[ParallelPlan, ParallelPlan, ClusterTopology]]
            ) -> list[ReconfigCost]:
        """Price several switches happening *at once* on a shared fabric.

        Each switch is charged its own :meth:`cost` with ``edge_load`` set
        to the sum of every *other* switch's :meth:`edge_traffic` — the
        symmetric fixed-point of "everyone queues behind everyone else's
        bytes".  Switches whose reshards ride disjoint links price exactly
        their solo cost; switches colliding on a link each pay the queueing
        term.  Deterministic in the input order (the pricing itself is
        order-independent).  ``topo`` may differ per switch (per-job device
        slices) — link keys are global device-id pairs, so traffic charged
        by one slice is visible to any other slice sharing the link."""
        traffics = [self.edge_traffic(old, new, topo)
                    for old, new, topo in switches]
        out: list[ReconfigCost] = []
        for i, (old, new, topo) in enumerate(switches):
            load: dict[tuple[int, int], float] = {}
            for j, tr in enumerate(traffics):
                if j == i:
                    continue
                for key, v in tr.items():
                    load[key] = load.get(key, 0.0) + v
            out.append(self.cost(old, new, topo, edge_load=load))
        return out

    # -- calibration hooks -----------------------------------------------------

    def calibrate_io(self, measured_s: float, nbytes: float) -> float:
        """Fold a measured checkpoint-restore (``nbytes`` restored in
        ``measured_s`` seconds) into the host-store bandwidth.  Returns the
        new ``io_bw``.  The runtime trainer calls this after every elastic
        restore, so simulated post-failover charges track the deployment."""
        if measured_s > 0 and nbytes > 0:
            self.io_bw = nbytes / measured_s
        return self.io_bw

    def calibrate(self, measured_total_s: float, old: ParallelPlan,
                  new: ParallelPlan, topo: ClusterTopology) -> float:
        """Scale the whole model so its prediction for an observed switch
        matches the end-to-end measurement.  Returns the new scale.  Prefer
        :meth:`calibrate_terms` when several measured switches are
        available — a single global scale cannot fit fabric-dominated and
        store-dominated switches at once."""
        predicted = self.cost(old, new, topo).total_s
        if predicted > 0 and measured_total_s > 0:
            self.calibration *= measured_total_s / predicted
        return self.calibration

    def calibrate_terms(self, measurements: Sequence[
            tuple[float, ParallelPlan, ParallelPlan, ClusterTopology]]
            ) -> tuple[float, float]:
        """Fit the fabric and host-store scales separately from measured
        switches (``(measured_s, old, new, topo)`` tuples) by least squares
        on ``measured = a * (base + transfer) + b * io``.

        With switches that exercise both the fabric and the store, the 2x2
        normal equations solve both scales; when every measurement is
        fabric-only (or store-only) the other scale is left untouched
        instead of extrapolating from zero signal.  Scales are clamped
        positive.  Returns ``(fabric_scale, store_scale)``.
        """
        rows: list[tuple[float, float, float]] = []
        for measured, old, new, topo in measurements:
            if measured <= 0:
                continue
            c = self.cost(old, new, topo)
            # un-scaled per-term predictions (ReconfigCost components carry
            # the raw physical terms; only total_s is scaled)
            rows.append((c.base_s + c.transfer_s, c.io_s,
                         measured / max(self.calibration, 1e-12)))
        if not rows:
            return self.fabric_scale, self.store_scale
        sff = sum(f * f for f, _, _ in rows)
        sss = sum(s * s for _, s, _ in rows)
        sfs = sum(f * s for f, s, _ in rows)
        sfm = sum(f * m for f, _, m in rows)
        ssm = sum(s * m for _, s, m in rows)
        det = sff * sss - sfs * sfs
        if det > 1e-18 * max(sff, 1.0) * max(sss, 1.0):
            fabric = (sfm * sss - ssm * sfs) / det
            store = (ssm * sff - sfm * sfs) / det
            self.fabric_scale = max(fabric, 1e-6)
            self.store_scale = max(store, 1e-6)
        elif sff > 0 and sss == 0:          # no store signal: fit fabric only
            self.fabric_scale = max(sfm / sff, 1e-6)
        elif sss > 0 and sff == 0:          # no fabric signal: fit store only
            self.store_scale = max(ssm / sss, 1e-6)
        elif sff > 0:
            # collinear terms: fall back to scaling the dominant fabric term
            self.fabric_scale = max(sfm / sff, 1e-6)
        return self.fabric_scale, self.store_scale


# ---------------------------------------------------------------------------
# Cross-interval DP oracle
# ---------------------------------------------------------------------------


def plan_sequence_dp(durations: Sequence[float],
                     step_times: Sequence[Sequence[float]],
                     switch_cost: Callable[[int, int, int], float]
                     ) -> tuple[float, list[int]]:
    """Clairvoyant plan schedule over consecutive intervals, switch costs
    included — the true oracle bound the per-interval greedy replay is not.

    ``durations[i]`` is interval *i*'s length in seconds; ``step_times[i][c]``
    the simulated step time of candidate plan *c* during interval *i*
    (``inf`` = infeasible); ``switch_cost(i, prev, cur)`` the seconds charged
    at interval *i*'s start for arriving on plan ``cur`` from ``prev``
    (called only when ``prev != cur``).  The initial plan is free — the
    clairvoyant picks its starting layout before training begins.

    Returns ``(steps, choices)`` maximizing total completed optimizer steps
    ``sum_i max(0, d_i - oh_i) / s_i``.  O(intervals * candidates^2).
    """
    B = len(durations)
    if B == 0 or not step_times or not step_times[0]:
        return 0.0, []
    C = len(step_times[0])

    def gain(d: float, oh: float, s: float) -> float:
        if not math.isfinite(s) or s <= 0:
            return 0.0
        return max(0.0, d - oh) / s

    best = [[-math.inf] * C for _ in range(B)]
    back = [[0] * C for _ in range(B)]
    for c in range(C):
        best[0][c] = gain(durations[0], 0.0, step_times[0][c])
    for i in range(1, B):
        for c in range(C):
            for q in range(C):
                if best[i - 1][q] == -math.inf:
                    continue
                oh = 0.0 if q == c else switch_cost(i, q, c)
                val = best[i - 1][q] + gain(durations[i], oh,
                                            step_times[i][c])
                if val > best[i][c]:
                    best[i][c] = val
                    back[i][c] = q
    end = max(range(C), key=lambda c: best[B - 1][c])
    choices = [end]
    for i in range(B - 1, 0, -1):
        choices.append(back[i][choices[-1]])
    choices.reverse()
    return best[B - 1][end], choices
