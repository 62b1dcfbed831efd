"""Unified fabric transfer model.

Transfer pricing used to be quadruplicated — :func:`repro_torch.core.costmodel.
transfer_time`, the simulator's ``hop_ready``/``edge_ready_time`` relay,
:meth:`repro_torch.core.reconfig.ReconfigCostModel._path_time` and
:meth:`repro_torch.core.routing.Route.transfer_time` each re-implemented the
"latency + size / bandwidth, store-and-forward over the widest route"
formula — so any fidelity fix had to land four times or drift.  This module
owns the single implementation; every former call site delegates here.

Pricing model
-------------

A :class:`FabricModel` prices one logical transfer of ``size`` bytes as a
stream of ``K = ceil(size / chunk_bytes)`` cut-through chunks of
``c = size / K`` bytes:

* **direct link** (single hop, bandwidth ``bw``, latency ``l``)::

      T = alpha * l + size / (beta * bw)

  identical to :meth:`repro_torch.core.cluster.Edge.transfer_time` at the default
  calibration ``alpha = beta = 1``;

* **relayed route** (hops ``h`` with latencies ``l_h``, bandwidths ``bw_h``,
  bottleneck ``bneck = min bw_h``, resistance ``R = sum 1/bw_h``), chunks
  pipeline through the relays instead of store-and-forward::

      T = alpha * sum(l_h) + c * R / beta + (K - 1) * c / (beta * bneck)
        =  latency        +  pipeline fill +  size drained at bottleneck rate

  For ``K -> inf`` this approaches ``latency + size / bneck``; for ``K = 1``
  (or a single hop) it degenerates to the store-and-forward sum
  ``latency + size * R``.  Three invariants hold for every route (the
  hypothesis suite in ``tests/test_fabric.py`` locks them in):

  1. pipelined <= store-and-forward (``latency + size * R``),
  2. == the direct-link price on single-hop routes,
  3. >= the slowest single hop's own price ``alpha*l_h + size/(beta*bw_h)``.

  Invariant 3 is what the coarse search tier's per-hop/connectivity caps
  rest on (see ``docs/search.md``): a routed pair's end-to-end bandwidth
  never exceeds its bottleneck hop's bandwidth.

* **ring collectives** (:meth:`FabricModel.ring_capacity`): a collective
  *streams* continuously, so a relayed ring pair sustains its route's
  bottleneck rate — but every physical link it relays over is shared with
  the other ring pairs routed across that link.  The sustained per-pair
  rate is therefore ``min over hops of beta * bw_link / load(link)`` where
  ``load`` counts how many of the ring's pair-routes traverse the link.
  This replaces the old resistance-sum pricing (``1 / R``), which modeled
  relays as store-and-forward; it is never above any hop's bandwidth, so
  the coarse tier's caps stay admissible (``docs/search.md``).

With ``pipelining=False`` the model reproduces the pre-fabric
store-and-forward pricing exactly (at ``alpha = beta = 1``) — benchmarks
use :func:`use_fabric` to measure the pipelined-vs-store-and-forward delta.

Calibration
-----------

``alpha`` scales every latency term and ``beta`` scales every bandwidth
term; ``tools/calibrate_fabric.py`` fits them from measured JAX transfer /
collective microbenchmark sweeps (least squares on ``t = alpha*l +
size/(beta*bw)``) and gates the simulated-vs-measured step error.

The process-wide default instance (:func:`default_fabric`) is what the
cost model, simulator and reconfig pricing consult; ``SearchExecutor``
ships it to worker processes so serial and process-parallel searches price
identically even under a non-default calibration.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Iterator, Sequence

if TYPE_CHECKING:                                     # pragma: no cover
    from .cluster import ClusterTopology, Edge
    from .routing import Route, RoutingTable


def _has_live_direct(topo: "ClusterTopology", a: int, b: int) -> bool:
    """True iff the pair has a direct link with positive effective
    bandwidth (a fully degraded link routes like a missing one)."""
    link = topo.link(a, b)
    return link is not None and any(e.effective_bandwidth > 0
                                    for e in link.edges)


@dataclass(frozen=True)
class FabricModel:
    """The one routed-transfer pricing implementation (see module doc).

    Frozen/picklable on purpose: search worker processes receive the
    parent's instance verbatim, and :func:`use_fabric` swaps whole
    instances rather than mutating shared state.
    """

    chunk_bytes: float = float(1 << 20)   # cut-through chunk size (1 MiB)
    alpha: float = 1.0                    # latency calibration scale
    beta: float = 1.0                     # bandwidth efficiency scale
    pipelining: bool = True               # False -> store-and-forward

    # -- primitives ------------------------------------------------------------

    def chunks(self, size: float) -> int:
        """Number of cut-through chunks a transfer is split into."""
        if not self.pipelining or size <= 0 or self.chunk_bytes <= 0:
            return 1
        return max(1, math.ceil(size / self.chunk_bytes))

    def hop_time(self, size: float, bw: float, latency: float) -> float:
        """One physical hop: ``alpha * latency + size / (beta * bw)``."""
        if bw <= 0:
            return math.inf
        return self.alpha * latency + size / (self.beta * bw)

    def linear_bw(self, bw: float) -> float:
        """Linearized pricing hook for the admissible search bounds (the
        coarse and LP tiers): the highest sustained rate this fabric can
        deliver over a link of nominal bandwidth ``bw`` — the latency-free,
        chunking-free limit of :meth:`hop_time`.  Clamped at the nominal
        rate so a (non-physical) ``beta > 1`` calibration cannot lift a
        lower bound above the raw-bandwidth caps the admissibility
        arguments are stated for; under the calibrated ``beta <= 1`` this
        *tightens* the bounds to match the scaled simulator."""
        return bw * min(1.0, self.beta)

    def edge_time(self, edge: "Edge", size: float) -> float:
        """Price ``size`` bytes on one physical edge (calibrated)."""
        return self.hop_time(size, edge.effective_bandwidth, edge.latency)

    # -- routed transfers ------------------------------------------------------

    def route_time(self, route: "Route", size: float) -> float:
        """End-to-end time of one transfer along ``route`` (closed form).

        Equals the simulator's per-hop relay recursion on an uncontended
        fabric (``tests/test_fabric.py`` asserts the identity), so every
        pricing path that consults the fabric returns the same number.
        """
        if route.hops <= 0:
            return 0.0
        if route.bottleneck_bw <= 0 or not math.isfinite(route.resistance):
            return math.inf
        if not self.pipelining:
            return self.alpha * route.latency + size * route.resistance / self.beta
        k = self.chunks(size)
        c = size / k
        return (self.alpha * route.latency
                + c * route.resistance / self.beta
                + (k - 1) * c / (self.beta * route.bottleneck_bw))

    def store_and_forward_time(self, route: "Route", size: float) -> float:
        """The un-pipelined reference price (sum of per-hop times)."""
        if route.hops <= 0:
            return 0.0
        return self.alpha * route.latency + size * route.resistance / self.beta

    def pair_bandwidth(self, route: "Route") -> float:
        """Sustained end-to-end bandwidth of a routed pair: the bottleneck
        hop rate under pipelining, the store-and-forward ``1/resistance``
        otherwise (both ``beta``-scaled)."""
        if route.hops <= 0:
            return math.inf
        if self.pipelining:
            return self.beta * route.bottleneck_bw
        if route.resistance <= 0:
            return math.inf
        return self.beta / route.resistance

    # -- the four ported call sites --------------------------------------------

    def transfer_time(self, topo: "ClusterTopology", a: int, b: int,
                      size: float, *, edge: "Edge | None" = None,
                      routing: "RoutingTable | None" = None) -> float:
        """T_comm(size, l_alpha): one logical transfer ``a -> b``.

        Dispatch: explicit ``edge`` > live direct link (best edge) > widest
        multi-hop route (pipelined) > unreachable (``inf``).  Hot loops
        pricing many pairs should fetch ``topo.routing()`` once and pass it
        as ``routing``."""
        if a == b:
            return 0.0
        if edge is not None:
            return self.edge_time(edge, size)
        if _has_live_direct(topo, a, b):
            return self.edge_time(topo.link(a, b).best_edge(size), size)
        table = routing if routing is not None else topo.routing()
        route = table.route(a, b)
        if route is None:
            return math.inf
        return self.route_time(route, size)

    def path_time(self, topo: "ClusterTopology", a: int, b: int, size: float,
                  *, routing: "RoutingTable | None" = None
                  ) -> tuple[float, float]:
        """(seconds, sustained bandwidth) for one transfer — the reconfig
        reshard pricing entry point.  Unreachable pairs return
        ``(inf, 0.0)``; callers fall back to the host checkpoint store."""
        if _has_live_direct(topo, a, b):
            link = topo.link(a, b)
            return (self.edge_time(link.best_edge(size), size),
                    self.beta * max(e.effective_bandwidth
                                    for e in link.edges))
        table = routing if routing is not None else topo.routing()
        route = table.route(a, b)
        if route is None:
            return math.inf, 0.0
        return self.route_time(route, size), self.pair_bandwidth(route)

    def ring_capacity(self, topo: "ClusterTopology", ranks: Sequence[int],
                      *, routing: "RoutingTable | None" = None
                      ) -> tuple[float, float]:
        """(bandwidth, latency) of the slowest pair on the participant ring.

        Every consecutive pair contributes its physical hop path (the
        direct link, or the widest route).  Under pipelining the sustained
        per-pair rate is ``min over hops of beta * bw / load`` with
        ``load`` = number of the ring's pair-paths crossing that physical
        link *in the same direction* (links are full duplex, matching the
        analytic collective model's convention — a 2-rank ring exchanges
        both ways at full link rate) — relayed pairs stream at bottleneck
        rate but share directed link capacity with the pairs they relay
        through.  Without pipelining, routed pairs price at the
        store-and-forward ``beta / resistance`` (the pre-fabric model).
        A ring crossing a partition (no route) returns bandwidth 0 — the
        collective is unpriceable and the candidate infeasible."""
        if len(ranks) < 2:
            return math.inf, 0.0
        n = len(ranks)
        table = None
        # pair -> list of (link_key, bw) hops, plus the pair's latency
        paths: list[tuple[list[tuple[tuple[int, int], float]], float]] = []
        probe = float(1 << 20)
        for i in range(n):
            a, b = ranks[i], ranks[(i + 1) % n]
            if a == b:
                continue
            if _has_live_direct(topo, a, b):
                e = topo.link(a, b).best_edge(probe)
                paths.append(([((a, b), e.effective_bandwidth)], e.latency))
                continue
            if table is None:
                table = (routing if routing is not None else topo.routing())
            route = table.route(a, b)
            if route is None:
                return 0.0, 0.0
            hops: list[tuple[tuple[int, int], float]] = []
            for u, v in zip(route.path, route.path[1:]):
                hop = table.hop_price(u, v)
                hops.append(((u, v), hop[0] if hop is not None else 0.0))
            paths.append((hops, route.latency))
        if not paths:
            return math.inf, 0.0
        lat = self.alpha * max(p[1] for p in paths)
        if self.pipelining:
            load: dict[tuple[int, int], int] = {}
            for hops, _ in paths:
                for key, _bw in hops:
                    load[key] = load.get(key, 0) + 1
            bw = math.inf
            for hops, _ in paths:
                for key, hop_bw in hops:
                    bw = min(bw, self.beta * hop_bw / load[key])
            return bw, lat
        bw = math.inf
        for hops, _ in paths:
            if len(hops) == 1:
                bw = min(bw, self.beta * hops[0][1])
                continue
            res = sum(1.0 / hop_bw if hop_bw > 0 else math.inf
                      for _, hop_bw in hops)
            bw = min(bw, self.beta / res if res > 0 else math.inf)
        return bw, lat

    # -- simulator relay recursion ---------------------------------------------

    def relay_step(self, size: float, bw: float, latency: float,
                   hop_start: float, first_chunk_at: float,
                   prev_end: float | None) -> tuple[float, float]:
        """One hop of the cut-through relay recursion used by
        ``simulate_schedule``: returns ``(hop_end, next_first_chunk_at)``.

        ``hop_start`` is when this hop's edge actually starts forwarding
        (contention included); ``first_chunk_at`` is when the first chunk
        arrived at this hop's sender; ``prev_end`` is when the previous hop
        delivered its *last* chunk (``None`` on the first hop).  The hop
        finishes once it has serialized all chunks (``hop_start +
        hop_time(size)``) and once the last chunk has arrived and crossed
        (``prev_end + alpha*l + c/(beta*bw)``).  On an uncontended fabric
        the last hop's end equals :meth:`route_time`'s closed form —
        ``tests/test_fabric.py`` asserts the identity."""
        if bw <= 0:
            return math.inf, math.inf
        c = size / self.chunks(size)
        chunk_cross = self.alpha * latency + c / (self.beta * bw)
        end = hop_start + self.hop_time(size, bw, latency)
        if prev_end is not None:
            end = max(end, prev_end + chunk_cross)
        return end, hop_start + chunk_cross


# ---------------------------------------------------------------------------
# Process-wide default + scoped override
# ---------------------------------------------------------------------------

_default = FabricModel()


def default_fabric() -> FabricModel:
    """The fabric every pricing path consults unless handed one."""
    return _default


def set_default_fabric(fabric: FabricModel) -> FabricModel:
    """Install ``fabric`` as the process default; returns the previous one
    (e.g. applying a calibration from ``tools/calibrate_fabric.py``)."""
    global _default
    prev = _default
    _default = fabric
    return prev


@contextmanager
def use_fabric(fabric: FabricModel) -> Iterator[FabricModel]:
    """Scoped default-fabric override::

        with use_fabric(FabricModel(pipelining=False)):
            snf = simulate_training_step(...)   # store-and-forward pricing
    """
    prev = set_default_fabric(fabric)
    try:
        yield fabric
    finally:
        set_default_fabric(prev)


def calibrated(alpha: float, beta: float, *,
               base: FabricModel | None = None) -> FabricModel:
    """A copy of ``base`` (default: the current default fabric) with fitted
    calibration terms — what ``tools/calibrate_fabric.py`` installs."""
    return replace(base if base is not None else default_fabric(),
                   alpha=alpha, beta=beta)
