"""Multi-hop routing over the live link graph.

The simulator used to price any device pair without a direct link with an
optimistic flat bottleneck estimate — which is exactly why the tiered
search's coarse ring caps had to be disabled on sparse link graphs (TPU
torus), and why cross-region / degraded-fabric scenarios were not believable.
This module gives :class:`~repro_torch.core.cluster.ClusterTopology` a cached
**widest-path** routing table:

  * routes maximize the bottleneck bandwidth over the live link graph
    (alive devices, edges with positive effective bandwidth), with
    deterministic tie-breaks (fewer hops, then canonical device order), so
    serial and process-parallel searches price identically;
  * a :class:`Route` carries the physical path plus three pricing
    aggregates: ``bottleneck_bw`` (min hop bandwidth — what the coarse
    bound's connectivity caps reason about), ``latency`` (sum of hop
    latencies) and ``resistance`` (sum of inverse hop bandwidths).  Those
    three are exactly what :class:`repro_torch.core.fabric.FabricModel` needs to
    price the route — chunked cut-through pipelining by default
    (``latency + fill + size/bottleneck``), the store-and-forward sum
    ``latency + size * resistance`` as the un-pipelined reference.  Either
    way a routed price is never below any single hop's own
    serialization-aware time;
  * tables are built lazily per source (Dijkstra-style widest path,
    O(E log V) per source) and cached per topology state — the topology's
    existing snapshot version/signature mechanism invalidates them, so
    dynamic events (link death, degradation, device fail/join) re-route
    mid-trace.

Consumers: :class:`repro_torch.core.fabric.FabricModel` — the single transfer
pricing implementation behind :func:`repro_torch.core.costmodel.transfer_time`
(routed p2p), :func:`repro_torch.core.costmodel._bottleneck_bw` (routed ring
collectives), :meth:`repro_torch.core.reconfig.ReconfigCostModel` (routed
reshard pairs) and the discrete-event simulator (per-hop transfers
claiming each physical edge's serialization domain — relay traffic
contends with direct traffic).  The coarse search tier computes its
sparse-graph ring caps from the direct link graph, but their
*admissibility* rests on the routed-pricing invariant above: a routed
pair's end-to-end bandwidth never exceeds its bottleneck hop's.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass

# sentinel distinguishing "not computed" from "computed: unreachable"
_MISS = object()


@dataclass(frozen=True)
class Route:
    """One directed multi-hop route between a device pair."""

    path: tuple[int, ...]        # device ids, endpoints included (len >= 1)
    bottleneck_bw: float         # min best-edge bandwidth over the hops
    latency: float               # sum of per-hop latencies
    resistance: float            # sum of per-hop inverse bandwidths

    @property
    def hops(self) -> int:
        return len(self.path) - 1

    @property
    def effective_bandwidth(self) -> float:
        """End-to-end *store-and-forward* bandwidth: ``1 / resistance``.
        Kept as the un-pipelined reference aggregate (and the pre-fabric
        pricing, via ``FabricModel(pipelining=False)``); never exceeds
        :attr:`bottleneck_bw`, equals it for single-hop routes."""
        if self.resistance <= 0:
            return math.inf
        return 1.0 / self.resistance

    def transfer_time(self, size_bytes: float) -> float:
        """Thin delegate to the default fabric's routed pricing
        (:meth:`repro_torch.core.fabric.FabricModel.route_time`): chunked
        cut-through pipelining by default, never below any single hop's
        own time, never above the store-and-forward sum of hops."""
        from .fabric import default_fabric
        return default_fabric().route_time(self, size_bytes)


class RoutingTable:
    """Widest-path routes over one topology *state* (no temporal events).

    Built from the alive device set and the links' current effective
    bandwidths; per-hop pricing uses each link's best live edge (max
    effective bandwidth, deterministic tie-break by latency then tag).
    Per-source shortest-widest trees are computed lazily and memoized, as
    are reconstructed :class:`Route` objects.  Instances are immutable
    snapshots — :meth:`repro_torch.core.cluster.ClusterTopology.routing` handles
    cache invalidation against the live topology.
    """

    def __init__(self, topo) -> None:
        alive = {d.device_id for d in topo.devices.values() if d.alive}
        self._adj: dict[int, list[tuple[int, float, float]]] = \
            {d: [] for d in sorted(alive)}
        self._pair: dict[tuple[int, int], tuple[float, float]] = {}
        for (a, b), link in sorted(topo.links.items()):
            if a not in alive or b not in alive:
                continue
            best: tuple[float, float] | None = None
            for e in link.edges:
                bw = e.effective_bandwidth
                if bw <= 0:
                    continue                      # dead edge: not routable
                if best is None or (bw, -e.latency) > (best[0], -best[1]):
                    best = (bw, e.latency)
            if best is None:
                continue
            self._pair[(a, b)] = best
            self._adj[a].append((b, best[0], best[1]))
            self._adj[b].append((a, best[0], best[1]))
        for lst in self._adj.values():
            lst.sort()
        # src -> (best: node -> (bw, hops), prev: node -> predecessor)
        self._trees: dict[int, tuple[dict, dict]] = {}
        self._routes: dict[tuple[int, int], Route | None] = {}

    def hop_price(self, u: int, v: int) -> tuple[float, float] | None:
        """(bandwidth, latency) of the best live edge this table priced the
        direct hop ``u``-``v`` at, or ``None`` when the pair has no live
        direct link.  The fabric's ring-capacity load accounting uses this
        so collective pricing sees exactly the edges the routes priced."""
        return self._pair.get((min(u, v), max(u, v)))

    # -- widest-path trees -----------------------------------------------------

    def _tree(self, src: int) -> tuple[dict[int, tuple[float, int]],
                                       dict[int, int]]:
        """Shortest-widest-path tree from ``src``: maximize bottleneck
        bandwidth, break ties by hop count, then by deterministic pop order
        (device id) — identical across processes for identical states."""
        state = self._trees.get(src)
        if state is not None:
            return state
        best: dict[int, tuple[float, int]] = {src: (math.inf, 0)}
        prev: dict[int, int] = {}
        heap: list[tuple[float, int, int]] = [(-math.inf, 0, src)]
        while heap:
            nbw, nh, u = heapq.heappop(heap)
            nbw = -nbw
            cur = best.get(u)
            if cur is None or (-cur[0], cur[1]) < (-nbw, nh):
                continue                          # stale entry
            for v, bw, _lat in self._adj.get(u, ()):
                cb = min(nbw, bw)
                ch = nh + 1
                old = best.get(v)
                if old is None or (-cb, ch) < (-old[0], old[1]):
                    best[v] = (cb, ch)
                    prev[v] = u
                    heapq.heappush(heap, (-cb, ch, v))
        state = (best, prev)
        self._trees[src] = state
        return state

    # -- routes ----------------------------------------------------------------

    def _compute(self, a: int, b: int) -> Route | None:
        best, prev = self._tree(a)
        if b not in best:
            return None
        path = [b]
        while path[-1] != a:
            path.append(prev[path[-1]])
        path.reverse()
        lat = res = 0.0
        for u, v in zip(path, path[1:]):
            bw, hop_lat = self._pair[(min(u, v), max(u, v))]
            lat += hop_lat
            res += 1.0 / bw
        return Route(path=tuple(path), bottleneck_bw=best[b][0],
                     latency=lat, resistance=res)

    def route(self, a: int, b: int) -> Route | None:
        """The widest route ``a -> b`` (``None`` when disconnected).
        Canonicalized: ``route(b, a)`` is always the exact reverse of
        ``route(a, b)`` no matter the query order."""
        if a == b:
            return Route(path=(a,), bottleneck_bw=math.inf,
                         latency=0.0, resistance=0.0)
        key = (min(a, b), max(a, b))
        r = self._routes.get(key, _MISS)
        if r is _MISS:
            r = self._compute(*key)
            self._routes[key] = r
        if r is None or a == key[0]:
            return r
        return Route(path=tuple(reversed(r.path)),
                     bottleneck_bw=r.bottleneck_bw,
                     latency=r.latency, resistance=r.resistance)
