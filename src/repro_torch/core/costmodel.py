"""Simulation cost model: per-op roofline + multi-edge collective timing.

The paper (§2.1) argues execution time is a nonlinear multivariate function of
(operator, device) that defeats ILP/DP planners, and uses a simulator (SimAI)
for deterministic predictions.  We provide the same interface:

  * ``op_time(op, device)``         — T_exec(v, d_j), roofline Eq. 1-2 with
                                      per-kind efficiency and fusion awareness,
  * ``transfer_time(...)``          — T_comm(size, l_alpha) on a chosen edge,
  * ``collective_time(...)``        — ring/tree collectives over the bottleneck
                                      edge of the participant set, with the
                                      naive vs decomposed all-reduce split the
                                      paper highlights (Fig. 3),

plus TPU-mesh helpers used by the planner when targeting the production mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from .cluster import ClusterTopology, DeviceInstance, Edge
from .fabric import default_fabric
from .opgraph import CommOp, OpNode

# ---------------------------------------------------------------------------
# Compute
# ---------------------------------------------------------------------------


def op_time(op: OpNode, device: DeviceInstance) -> float:
    """T_exec(v, d_j): deterministic per-op time on a device (paper §3.2.1)."""
    if not device.alive:
        return math.inf
    return device.spec.roofline_time(
        op.flops, op.bytes_accessed,
        is_matmul=op.is_matmul, perf_factor=device.perf_factor)


def graph_compute_lower_bound(total_flops: float,
                              devices: Sequence[DeviceInstance]) -> float:
    """Perfectly-balanced work bound: total flops / aggregate throughput.
    Admissible lower bound used by the branch-and-bound (§3.3)."""
    agg = sum(d.spec.peak_flops * d.spec.matmul_eff * d.perf_factor
              for d in devices if d.alive)
    return total_flops / agg if agg > 0 else math.inf


# ---------------------------------------------------------------------------
# Point-to-point communication
# ---------------------------------------------------------------------------


def _has_live_edge(topo: ClusterTopology, a: int, b: int) -> bool:
    """True iff the pair has a direct link with positive effective
    bandwidth (a fully degraded link routes like a missing one); alias of
    the fabric layer's liveness predicate."""
    from .fabric import _has_live_direct
    return _has_live_direct(topo, a, b)


def transfer_time(topo: ClusterTopology, a: int, b: int, size: float,
                  *, edge: Edge | None = None, routing=None) -> float:
    """T_comm(size, l_alpha): transfer over a selected physical edge.

    Thin delegate to the default :class:`repro_torch.core.fabric.FabricModel` —
    the single transfer-pricing implementation.  Pairs without a live
    direct link are priced over the topology's widest multi-hop route
    (:mod:`repro_torch.core.routing`) with chunked cut-through pipelining:
    never below any single hop's own time, never above the
    store-and-forward sum of hops.  Unreachable pairs (partitioned
    cluster, dead relay) price at ``inf``.  Hot loops pricing many pairs
    should fetch ``topo.routing()`` once and pass it as ``routing`` — the
    cached lookup re-checks the topology state signature per call."""
    return default_fabric().transfer_time(topo, a, b, size,
                                          edge=edge, routing=routing)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _bottleneck_bw(topo: ClusterTopology, ranks: Sequence[int]) -> tuple[float, float]:
    """(bandwidth, latency) of the slowest pair on the participant ring.

    Thin delegate to the default fabric's
    :meth:`repro_torch.core.fabric.FabricModel.ring_capacity`: relayed pairs
    stream at their route's bottleneck rate (cut-through pipelining) but
    share every physical link they relay over with the other ring pairs
    routed across it — more faithful than the old independent
    resistance-sum pricing (a streaming relay is not store-and-forward),
    and never above any hop's bandwidth, which is what keeps the coarse
    search tier's ring caps admissible.  A ring
    crossing a partition (no route) returns bandwidth 0 — the collective
    is unpriceable and the candidate infeasible."""
    return default_fabric().ring_capacity(topo, ranks)


def collective_time(topo: ClusterTopology, comm: CommOp) -> float:
    """Deterministic collective cost on the multi-edge topology.

    ring reduce-scatter / all-gather move (n-1)/n of the data over the
    bottleneck edge; the naive reduce/broadcast pair funnels the full tensor
    through the root's single link (the single-node bottleneck the paper's
    Fig. 3 decomposition removes).
    """
    ranks = comm.participants
    n = len(ranks)
    if n <= 1 or comm.size <= 0:
        return 0.0
    bw, lat = _bottleneck_bw(topo, ranks)
    if bw <= 0:
        return math.inf
    steps_lat = (n - 1) * lat
    if comm.kind in ("reduce_scatter", "all_gather"):
        return steps_lat + (n - 1) / n * comm.size / bw
    if comm.kind == "all_reduce":
        return 2 * steps_lat + 2 * (n - 1) / n * comm.size / bw
    if comm.kind == "reduce":
        # gather full tensor at root: (n-1) peers each send size (serialized
        # on the root's ingress link).
        return steps_lat + (n - 1) * comm.size / bw
    if comm.kind == "broadcast":
        return steps_lat + (n - 1) * comm.size / bw
    if comm.kind == "all_to_all":
        return steps_lat + (n - 1) / n * comm.size / bw
    if comm.kind == "p2p":
        return transfer_time(topo, ranks[0], ranks[1], comm.size)
    raise ValueError(f"unknown collective kind {comm.kind}")


def collective_floor(kind: str, size: float, n: int, bw: float) -> float:
    """Latency-free linear floor of :func:`collective_time` over an
    ``n``-member ring at bottleneck bandwidth ``bw`` — the shared pricing
    primitive of the admissible search bounds (the coarse and LP tiers in
    :mod:`repro_torch.core.search` / :mod:`repro_torch.core.mip`), kept here so bound
    and simulator collective models cannot drift apart.  ``rs_ag`` is the
    decomposed reduce-scatter + all-gather pair; ``reduce_broadcast`` the
    naive root-funnel pair (Fig. 3)."""
    if n <= 1 or size <= 0:
        return 0.0
    if bw <= 0:
        return math.inf
    if kind in ("reduce_scatter", "all_gather", "all_to_all"):
        return (n - 1) / n * size / bw
    if kind in ("all_reduce", "rs_ag"):
        return 2.0 * (n - 1) / n * size / bw
    if kind in ("reduce", "broadcast"):
        return (n - 1) * size / bw
    if kind == "reduce_broadcast":
        return 2.0 * (n - 1) * size / bw
    raise ValueError(f"unknown collective kind {kind}")


def allreduce_time(topo: ClusterTopology, size: float, ranks: Sequence[int],
                   *, decomposed: bool = True) -> float:
    """Fig. 3 comparison entry point."""
    if decomposed:
        rs = CommOp("rs", "reduce_scatter", size, tuple(ranks))
        ag = CommOp("ag", "all_gather", size, tuple(ranks))
        return collective_time(topo, rs) + collective_time(topo, ag)
    rd = CommOp("r", "reduce", size, tuple(ranks))
    bc = CommOp("b", "broadcast", size, tuple(ranks))
    return collective_time(topo, rd) + collective_time(topo, bc)


# ---------------------------------------------------------------------------
# TPU mesh shorthand (used when planning for the production pod)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshCollectiveModel:
    """Analytic collective costs on a TPU mesh axis.

    On a torus each mesh axis has its own ICI links (multi-edge!), so
    collectives on different axes do not contend; collectives on the same
    axis serialize.  This is the TPU analogue of the paper's conflicting
    NVLink/PCIe edges.
    """

    ici_bw: float = 50e9             # bytes/s per link per direction
    dci_bw: float = 12.5e9
    latency: float = 1e-6

    def axis_allreduce(self, size: float, axis_size: int,
                       *, inter_pod: bool = False) -> float:
        if axis_size <= 1:
            return 0.0
        bw = self.dci_bw if inter_pod else self.ici_bw
        # bidirectional ring: effective 2x link bw
        return 2 * (axis_size - 1) / axis_size * size / (2 * bw) \
            + 2 * (axis_size - 1) * self.latency

    def axis_allgather(self, size: float, axis_size: int,
                       *, inter_pod: bool = False) -> float:
        if axis_size <= 1:
            return 0.0
        bw = self.dci_bw if inter_pod else self.ici_bw
        return (axis_size - 1) / axis_size * size / (2 * bw) \
            + (axis_size - 1) * self.latency

    def axis_reduce_scatter(self, size: float, axis_size: int,
                            *, inter_pod: bool = False) -> float:
        return self.axis_allgather(size, axis_size, inter_pod=inter_pod)

    def axis_all_to_all(self, size: float, axis_size: int,
                        *, inter_pod: bool = False) -> float:
        if axis_size <= 1:
            return 0.0
        bw = self.dci_bw if inter_pod else self.ici_bw
        return (axis_size - 1) / axis_size * size / (2 * bw) / axis_size \
            + (axis_size - 1) * self.latency
