"""Multi-edge heterogeneous cluster model (paper §3.1).

The paper's first contribution is a *multi-edge* physical-link abstraction:
a pair of devices may be connected by several physical links (NVLink + PCIe,
multiple NVSwitch ports, TPU torus axes) with unequal bandwidth, which may be
concurrently usable or mutually conflicting.  We model:

  * ``DeviceSpec``    — a device *type* (peak FLOP/s, HBM bandwidth, memory),
  * ``DeviceInstance``— one physical device with a dynamic performance factor,
  * ``Edge``          — one physical link with bandwidth/latency/tag,
  * ``MultiEdgeLink`` — the bundle of edges between a device pair,
  * ``ClusterTopology``— the temporal graph G(t): devices + multi-edge links +
                         a timeline of :class:`NetworkEvent`.

Dynamic behaviour (paper §2.2): bandwidth fluctuation (S1), heterogeneous
performance (S2) and node failure / join (S3) are all expressed as events on
the topology; the simulator and planner consume ``snapshot(t)`` views.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
from dataclasses import dataclass, field, replace
from typing import Callable, Iterable, Mapping, Sequence

GB = 1e9
TB = 1e12
TFLOPS = 1e12

# ---------------------------------------------------------------------------
# Device types
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceSpec:
    """A device *type*: the paper's per-device roofline parameters (Eq. 1)."""

    name: str
    peak_flops: float          # FLOP/s at the training dtype (bf16/fp16 tensor)
    hbm_bw: float              # bytes/s peak memory bandwidth (memBW_p)
    mem_bytes: float           # device memory capacity (Eq. 6 bound M_dj)
    # Fraction of peak realistically attained by large matmuls / small ops.
    matmul_eff: float = 0.80
    vector_eff: float = 0.25
    # Whether fused attention kernels are available (sm80+/TPU).  Without
    # fusion the S x S score matrix round-trips HBM (paper §2.3 / Fig. 2:
    # the same attention kernel performs very differently across devices).
    supports_fusion: bool = True

    def roofline_time(self, flops: float, bytes_moved: float,
                      *, is_matmul: bool = True, perf_factor: float = 1.0) -> float:
        """Attainable execution time via the roofline model (paper Eq. 1-2).

        time = max(flops / attained_flops, bytes / memBW)  which is equivalent
        to flops / min(K * memBW, FLOPs_p) with K = flops/bytes.
        """
        eff = self.matmul_eff if is_matmul else self.vector_eff
        peak = self.peak_flops * eff * perf_factor
        t_compute = flops / peak if peak > 0 else math.inf
        t_memory = bytes_moved / self.hbm_bw if self.hbm_bw > 0 else math.inf
        return max(t_compute, t_memory)


# Device profiles.  GPU profiles follow the paper's evaluation hardware
# (§4 Environment Setup) plus the Fig. 2 pair; TPU v5e is our deployment
# target (roofline constants from the assignment).
DEVICE_PROFILES: dict[str, DeviceSpec] = {
    # paper §4: 14592 cores Ada @2.52 GHz, 24 GB GDDR6X (fp16 tensor, fp32 acc).
    "RTX4090D": DeviceSpec("RTX4090D", peak_flops=147 * TFLOPS, hbm_bw=1008 * GB,
                           mem_bytes=24 * GB),
    # paper §4: 11776 cores Ada @2.52 GHz, 48 GB GDDR6.
    "L20": DeviceSpec("L20", peak_flops=119.5 * TFLOPS, hbm_bw=864 * GB,
                      mem_bytes=48 * GB),
    # paper §4: Volta, 32 GB HBM2; sm70 — no fused flash attention.
    "V100": DeviceSpec("V100", peak_flops=112 * TFLOPS, hbm_bw=900 * GB,
                       mem_bytes=32 * GB, matmul_eff=0.65,
                       supports_fusion=False),
    # paper Fig. 2 comparison device.
    "H100": DeviceSpec("H100", peak_flops=989 * TFLOPS, hbm_bw=3350 * GB,
                       mem_bytes=80 * GB),
    # Deployment target: TPU v5e (197 TFLOP/s bf16, 819 GB/s HBM, 16 GB).
    "TPUv5e": DeviceSpec("TPUv5e", peak_flops=197 * TFLOPS, hbm_bw=819 * GB,
                         mem_bytes=16 * GB),
}

# Intra-node interconnect per device type: consumer Ada cards have no NVLink
# (PCIe 4.0 x16 only); V100/H100 DGX nodes have NVLink.  The paper's
# Scenario 2 explicitly uses "V100-32G-PCIe" — pass an override map there.
DEVICE_INTRA_BW: dict[str, tuple[float, str]] = {
    "RTX4090D": (25 * GB, "pcie"),
    "L20": (25 * GB, "pcie"),
    "V100": (300 * GB, "nvlink"),
    "H100": (450 * GB, "nvlink"),
    "TPUv5e": (100 * GB, "ici"),
}


@dataclass
class DeviceInstance:
    """One physical device.  ``perf_factor`` models dynamic slowdown (S2/S3);
    ``alive`` models failures (S3)."""

    device_id: int
    spec: DeviceSpec
    perf_factor: float = 1.0
    alive: bool = True

    @property
    def name(self) -> str:
        return f"{self.spec.name}:{self.device_id}"


# ---------------------------------------------------------------------------
# Multi-edge links
# ---------------------------------------------------------------------------


@dataclass
class Edge:
    """One physical link between a device pair.

    ``tag`` identifies the physical resource class (e.g. ``nvlink``, ``pcie``,
    ``ici-x``, ``ici-y``, ``dci``).  ``conflicts_with`` lists tags that cannot
    be active simultaneously with this edge on the same device (the paper's
    NVLink-vs-PCIe example, Fig. 5b).
    """

    bandwidth: float                     # bytes/s
    latency: float = 1e-6                # seconds per message
    tag: str = "link"
    conflicts_with: tuple[str, ...] = ()
    # dynamic state: multiplicative factor applied by bandwidth events (S1)
    bw_factor: float = 1.0

    @property
    def effective_bandwidth(self) -> float:
        return self.bandwidth * self.bw_factor

    def transfer_time(self, size_bytes: float) -> float:
        bw = self.effective_bandwidth
        if bw <= 0:
            return math.inf
        return self.latency + size_bytes / bw


@dataclass
class MultiEdgeLink:
    """All physical edges between an (unordered) device pair."""

    a: int
    b: int
    edges: list[Edge] = field(default_factory=list)

    def best_edge(self, size_bytes: float) -> Edge:
        return min(self.edges, key=lambda e: e.transfer_time(size_bytes))

    def aggregate_bandwidth(self) -> float:
        """Upper bound when non-conflicting edges are used concurrently."""
        # Group by conflict class: edges that conflict share a class budget.
        best_per_class: dict[frozenset, float] = {}
        for e in self.edges:
            cls = frozenset((e.tag, *e.conflicts_with))
            best_per_class[cls] = max(best_per_class.get(cls, 0.0),
                                      e.effective_bandwidth)
        return sum(best_per_class.values())


# ---------------------------------------------------------------------------
# Dynamic events (temporal graph, paper §2.2)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NetworkEvent:
    """A change to the topology at time ``t``.

    kinds:
      * ``bandwidth``:  adjust edges matching ``selector`` by ``factor`` (S1)
      * ``slowdown``:   adjust device ``device_id`` perf by ``factor`` (S2)
      * ``fail``:       device ``device_id`` leaves the cluster (S3)
      * ``join``:       device ``device_id`` (re-)joins (S3)

    ``mode`` makes composition explicit for ``bandwidth``/``slowdown``:

      * ``"set"`` (default, the historical semantics): the factor is an
        *absolute* level — ``bw_factor = factor``.  Two overlapping events
        clobber each other; use it for single-source conditions (a sampled
        diurnal curve, the fig6c sweep).
      * ``"scale"``: the factor *multiplies* the current level —
        ``bw_factor *= factor``.  Overlapping events compose, and an event
        with the reciprocal factor restores the previous level exactly
        (multi-tenant congestion bursts, straggler churn).
    """

    time: float
    kind: str
    device_id: int | None = None
    factor: float = 1.0
    selector: str | None = None          # edge tag selector, e.g. "dci"
    mode: str = "set"                    # "set" (absolute) | "scale" (compose)


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------


class ClusterTopology:
    """Temporal multi-edge device graph G(t) = (V_D, E(t))."""

    def __init__(self, devices: Sequence[DeviceInstance],
                 links: Mapping[tuple[int, int], MultiEdgeLink] | None = None,
                 events: Sequence[NetworkEvent] = ()) -> None:
        self.devices: dict[int, DeviceInstance] = {d.device_id: d for d in devices}
        self.links: dict[tuple[int, int], MultiEdgeLink] = dict(links or {})
        self._events: list[NetworkEvent] = sorted(events, key=lambda e: e.time)
        # incremental-snapshot cache (see snapshot()): a private materialized
        # state at time _snap_t, valid while _snap_sig matches.
        self._version = 0
        self._snap_state: "ClusterTopology | None" = None
        self._snap_t = -math.inf
        self._snap_sig: tuple | None = None
        self._snap_events: list[NetworkEvent] = []
        # the planner simulates candidates from a thread pool and every
        # simulate call snapshots its topology — the cache must not tear
        self._snap_lock = threading.Lock()
        # cached widest-path routing table (repro_torch.core.routing), invalidated
        # by the same state signature as the snapshot cache
        self._route_table = None
        self._route_sig: tuple | None = None

    # -- construction -------------------------------------------------------

    @property
    def events(self) -> list[NetworkEvent]:
        return self._events

    @events.setter
    def events(self, events: Sequence[NetworkEvent]) -> None:
        self._events = sorted(events, key=lambda e: e.time)
        self._version += 1

    def add_link(self, a: int, b: int, *edges: Edge) -> None:
        key = (min(a, b), max(a, b))
        link = self.links.setdefault(key, MultiEdgeLink(a=key[0], b=key[1]))
        link.edges.extend(edges)
        self._version += 1

    def link(self, a: int, b: int) -> MultiEdgeLink | None:
        return self.links.get((min(a, b), max(a, b)))

    # -- queries -------------------------------------------------------------

    @property
    def alive_devices(self) -> list[DeviceInstance]:
        return [d for d in self.devices.values() if d.alive]

    def alive_ids(self) -> list[int]:
        return sorted(d.device_id for d in self.alive_devices)

    def device(self, device_id: int) -> DeviceInstance:
        return self.devices[device_id]

    def device_types(self) -> dict[str, list[int]]:
        out: dict[str, list[int]] = {}
        for d in self.alive_devices:
            out.setdefault(d.spec.name, []).append(d.device_id)
        return out

    def is_heterogeneous(self) -> bool:
        return len(self.device_types()) > 1

    def min_link_bandwidth(self, ids: Sequence[int] | None = None) -> float:
        """Bottleneck single-edge bandwidth among the given devices."""
        ids = list(ids if ids is not None else self.alive_ids())
        idset = set(ids)
        best = math.inf
        for (a, b), link in self.links.items():
            if a in idset and b in idset and link.edges:
                best = min(best, max(e.effective_bandwidth for e in link.edges))
        return best if best < math.inf else 0.0

    def total_memory(self) -> float:
        return sum(d.spec.mem_bytes for d in self.alive_devices)

    # -- routing ---------------------------------------------------------------

    def routing(self):
        """Cached :class:`repro_torch.core.routing.RoutingTable` over the *current*
        state (alive devices, current effective edge bandwidths).

        Invalidation follows the snapshot-cache signature: ``apply_event`` /
        ``add_link`` / events assignment and direct device-field mutation
        all produce a fresh table, so dynamic events (link death,
        degradation, device fail/join) re-route mid-trace.  Direct edge
        mutation is not tracked — call :meth:`invalidate_snapshots` after
        doing that (same caveat as the snapshot cache)."""
        from .routing import RoutingTable
        with self._snap_lock:
            sig = self._state_sig()
            if self._route_table is None or self._route_sig != sig:
                self._route_table = RoutingTable(self)
                self._route_sig = sig
            return self._route_table

    # -- islands (hierarchical search, repro_torch.core.islands) ---------------------

    def island_partition(self, *, fast_frac: float = 0.5
                         ) -> list[tuple[int, ...]]:
        """Partition the alive devices into homogeneous *islands*.

        An island is a maximal set of same-class devices connected by *fast*
        links: within each device class, a link counts as fast when its best
        live edge reaches at least ``fast_frac`` times the fastest live
        same-class link bandwidth.  Slower links (and every cross-class
        link) become inter-island edges.  On a multi-pod TPU fleet the
        12.5 GB/s DCI edges fall under half the 50 GB/s ICI links, so each
        pod is one island; in a mixed GPU cluster each device class splits
        further wherever its nodes only meet over the slow fabric.

        Args:
            fast_frac: fraction of the per-class maximum link bandwidth a
                link must reach to be island-internal (0 < fast_frac <= 1).

        Returns:
            Sorted-id tuples, one per island, ordered by smallest member id.
            Every alive device appears in exactly one island; devices whose
            class has no live intra-class link form single-device islands.
        """
        by_class: dict[str, list[int]] = {}
        for d in self.alive_devices:
            by_class.setdefault(d.spec.name, []).append(d.device_id)
        out: list[tuple[int, ...]] = []
        for name in sorted(by_class):
            ids = sorted(by_class[name])
            idset = set(ids)
            pair_bw: dict[tuple[int, int], float] = {}
            for (a, b), link in self.links.items():
                if a in idset and b in idset and link.edges:
                    bw = max(e.effective_bandwidth for e in link.edges)
                    if bw > 0:
                        pair_bw[(a, b)] = bw
            parent = {i: i for i in ids}

            def find(x: int) -> int:
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            if pair_bw:
                thresh = fast_frac * max(pair_bw.values())
                for (a, b), bw in pair_bw.items():
                    if bw >= thresh:
                        ra, rb = find(a), find(b)
                        if ra != rb:
                            parent[max(ra, rb)] = min(ra, rb)
            comps: dict[int, list[int]] = {}
            for i in ids:
                comps.setdefault(find(i), []).append(i)
            out.extend(tuple(sorted(c)) for c in comps.values())
        out.sort(key=lambda ids: ids[0])
        return out

    def island_signature(self, ids: Sequence[int], *, bw_quant: float = 0.25,
                         perf_quant: float = 0.05) -> tuple:
        """Canonical id-free signature of the sub-cluster over ``ids``.

        Two islands with equal signatures hold the same multiset of
        (device class, quantized perf factor), the same multiset of
        internal (edge tag, log2-quantized bandwidth) edges, and the same
        internal link-degree sequence — i.e. they are indistinguishable to
        the planner up to device renaming (identical pods, identical DGX
        nodes).  The hierarchical search scores one representative per
        signature and reuses its sub-plan for the twins.

        Args:
            ids: member device ids (alive or not; order irrelevant).
            bw_quant: bandwidth bucket width in log2(bytes/s), matching
                :func:`repro_torch.core.engine.fingerprint_topology`.
            perf_quant: linear bucket width for device perf factors.

        Returns:
            A hashable tuple; equality means "isomorphic for planning".
        """
        idset = set(ids)
        devs = sorted(
            (self.devices[i].spec.name,
             int(round(self.devices[i].perf_factor / perf_quant)))
            for i in idset)
        edges = []
        degree = {i: 0 for i in idset}
        for (a, b), link in self.links.items():
            if a in idset and b in idset:
                for e in link.edges:
                    bw = e.effective_bandwidth
                    bucket = int(round(math.log2(bw) / bw_quant)) \
                        if bw > 0 else -1
                    edges.append((e.tag, bucket))
                if link.edges:
                    degree[a] += 1
                    degree[b] += 1
        return (len(idset), tuple(devs), tuple(sorted(edges)),
                tuple(sorted(degree.values())))

    def subtopology(self, ids: Iterable[int]) -> "ClusterTopology":
        """Deep-copied topology restricted to ``ids``: the member devices
        (current perf/alive state) plus every link whose endpoints are both
        members.  The event timeline is NOT carried over — snapshot first if
        a particular time matters.  The hierarchical planner searches each
        island on its subtopology."""
        idset = set(ids)
        devs = [replace(d) for i, d in sorted(self.devices.items())
                if i in idset]
        links = {
            k: MultiEdgeLink(v.a, v.b, [replace(e) for e in v.edges])
            for k, v in self.links.items()
            if k[0] in idset and k[1] in idset
        }
        return ClusterTopology(devs, links, events=[])

    # -- temporal behaviour ---------------------------------------------------

    def events_between(self, t0: float, t1: float) -> list[NetworkEvent]:
        return [e for e in self.events if t0 <= e.time < t1]

    def apply_event(self, ev: NetworkEvent) -> None:
        """Apply an event in place (the simulator calls this at event time).

        ``mode="set"`` events overwrite the dynamic factor; ``mode="scale"``
        events multiply into it (see :class:`NetworkEvent`)."""
        scale = ev.mode == "scale"
        if ev.mode not in ("set", "scale"):
            raise ValueError(f"unknown event mode: {ev.mode}")
        if ev.kind == "bandwidth":
            for link in self.links.values():
                for e in link.edges:
                    if ev.selector is None or e.tag == ev.selector:
                        e.bw_factor = e.bw_factor * ev.factor if scale \
                            else ev.factor
        elif ev.kind == "slowdown":
            assert ev.device_id is not None
            d = self.devices[ev.device_id]
            d.perf_factor = d.perf_factor * ev.factor if scale else ev.factor
        elif ev.kind == "fail":
            assert ev.device_id is not None
            self.devices[ev.device_id].alive = False
        elif ev.kind == "join":
            assert ev.device_id is not None
            self.devices[ev.device_id].alive = True
            self.devices[ev.device_id].perf_factor = ev.factor or 1.0
        else:
            raise ValueError(f"unknown event kind: {ev.kind}")
        self._version += 1

    # -- snapshots (incremental) ----------------------------------------------

    def _copy_state(self) -> "ClusterTopology":
        """Deep copy of devices + links, no events attached."""
        devs = [replace(d) for d in self.devices.values()]
        links = {
            k: MultiEdgeLink(v.a, v.b, [replace(e) for e in v.edges])
            for k, v in self.links.items()
        }
        return ClusterTopology(devs, links, events=[])

    def copy(self) -> "ClusterTopology":
        """Deep copy of the full topology (devices, links, event timeline);
        the copy's snapshot cache starts cold."""
        c = self._copy_state()
        c.events = list(self._events)
        return c

    def _state_sig(self) -> tuple:
        """Cheap validity signature for the snapshot cache.  ``_version``
        covers apply_event/add_link/events-assignment; the events tuple
        catches in-place list mutation (append/insert, possibly out of
        order) and the device tuple direct mutation of device fields
        (templates toggling ``alive``).  Direct edge mutation is not
        tracked — call :meth:`invalidate_snapshots` after doing that."""
        return (self._version, tuple(self._events),
                tuple((d.device_id, d.alive, d.perf_factor)
                      for d in self.devices.values()))

    def invalidate_snapshots(self) -> None:
        with self._snap_lock:
            self._snap_state = None
            self._snap_sig = None
            self._snap_t = -math.inf
            self._snap_events = []
            self._route_table = None
            self._route_sig = None

    def snapshot(self, t: float) -> "ClusterTopology":
        """Deep-copied topology with all events up to time ``t`` applied.

        Replays are incremental: a private materialized state advances from
        the last queried time, so a monotone sequence of ``snapshot`` calls
        over an N-event timeline applies each event once (O(N) *event
        applications* total, each O(links); every call still pays an O(N)
        signature compare with tiny constants) instead of replaying the
        whole prefix per call (O(N^2) applications) — the regime scenario
        traces with hundreds of events put us in.  Going back in time or
        mutating the base topology rebuilds from scratch."""
        with self._snap_lock:
            sig = self._state_sig()
            if self._snap_state is None or self._snap_sig != sig \
                    or t < self._snap_t:
                self._snap_state = self._copy_state()
                self._snap_t = -math.inf
                self._snap_sig = sig
                # private sorted view: in-place appends may have left the
                # caller-visible list unsorted (any such mutation changes
                # the signature and lands here, so the view is always fresh)
                self._snap_events = sorted(self._events,
                                           key=lambda e: e.time)
            if self._snap_t < t:
                for ev in self._snap_events:
                    if self._snap_t < ev.time <= t:
                        self._snap_state.apply_event(ev)
                    elif ev.time > t:
                        break
                self._snap_t = t
                # applying events bumps the *base* signature only via our
                # own private copy, so the cache signature stays as computed
            return self._snap_state._copy_state()

    # -- pickling (search workers ship topologies to spawn processes) ----------

    def __getstate__(self) -> dict:
        """Drop the snapshot cache and its lock: a worker process rebuilds
        both lazily on first :meth:`snapshot` call."""
        return {"devices": list(self.devices.values()),
                "links": self.links,
                "events": list(self._events)}

    def __setstate__(self, state: dict) -> None:
        self.__init__(state["devices"], state["links"], state["events"])

    # -- pretty ----------------------------------------------------------------

    def describe(self) -> str:
        lines = [f"ClusterTopology: {len(self.alive_devices)} alive devices, "
                 f"{len(self.links)} links, {len(self.events)} events"]
        for name, ids in sorted(self.device_types().items()):
            lines.append(f"  {name} x{len(ids)}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Topology factories
# ---------------------------------------------------------------------------


def homogeneous_cluster(n: int, spec_name: str = "V100", *,
                        intra_bw: float | None = None,
                        inter_bw: float = 25 * GB,
                        gpus_per_node: int = 8) -> ClusterTopology:
    """n identical GPUs in nodes of ``gpus_per_node``.

    Intra-node links default to the device type's native interconnect
    (NVLink for DGX parts, PCIe for consumer cards); every pair also gets
    the conflicting PCIe edge (paper Fig. 5b)."""
    return hetero_cluster({spec_name: n},
                          intra_bw_map={spec_name: intra_bw} if intra_bw else None,
                          inter_bw=inter_bw, gpus_per_node=gpus_per_node)


def hetero_cluster(counts: Mapping[str, int], *,
                   intra_bw_map: Mapping[str, float | None] | None = None,
                   inter_bw: float = 25 * GB,
                   gpus_per_node: int = 8) -> ClusterTopology:
    """Mixed-type cluster: each node holds one device type (paper §4.1).

    Intra-node bandwidth follows :data:`DEVICE_INTRA_BW` per type unless
    overridden (e.g. ``{"V100": 25e9}`` for the paper's V100-32G-PCIe)."""
    devices: list[DeviceInstance] = []
    i = 0
    for name, count in counts.items():
        spec = DEVICE_PROFILES[name]
        for _ in range(count):
            devices.append(DeviceInstance(i, spec))
            i += 1
    topo = ClusterTopology(devices)
    node_of = {d.device_id: d.device_id // gpus_per_node for d in devices}
    for a, b in itertools.combinations(range(i), 2):
        if node_of[a] == node_of[b]:
            tname = devices[a].spec.name
            bw, tag = DEVICE_INTRA_BW.get(tname, (300 * GB, "nvlink"))
            if intra_bw_map and intra_bw_map.get(tname) is not None:
                bw = float(intra_bw_map[tname])  # type: ignore[arg-type]
            if tag == "pcie":
                # consumer card: PCIe is the only edge
                topo.add_link(a, b, Edge(bw, 5e-6, "pcie"))
            else:
                topo.add_link(a, b, Edge(bw, 1e-6, tag, ("pcie",)),
                              Edge(16 * GB, 5e-6, "pcie", (tag,)))
        else:
            topo.add_link(a, b, Edge(inter_bw, 5e-6, "ib"))
    return topo


def tpu_pod(chips: int = 256, *, ici_bw_per_link: float = 50 * GB,
            torus: tuple[int, int] = (16, 16)) -> ClusterTopology:
    """One TPU v5e pod as a 2-D torus with per-axis ICI edges (multi-edge:
    each torus axis is a distinct physical link class — paper §3.1 cites the
    TPU torus as a multi-edge case)."""
    assert torus[0] * torus[1] == chips
    spec = DEVICE_PROFILES["TPUv5e"]
    devices = [DeviceInstance(i, spec) for i in range(chips)]
    topo = ClusterTopology(devices)
    X, Y = torus
    for x in range(X):
        for y in range(Y):
            i = x * Y + y
            jx = ((x + 1) % X) * Y + y          # +x neighbour
            jy = x * Y + (y + 1) % Y            # +y neighbour
            topo.add_link(i, jx, Edge(ici_bw_per_link, 1e-6, "ici-x"))
            topo.add_link(i, jy, Edge(ici_bw_per_link, 1e-6, "ici-y"))
    return topo


def multi_pod_tpu(pods: int = 2, chips_per_pod: int = 256, *,
                  dci_bw: float = 12.5 * GB,
                  ici_bw_per_link: float = 50 * GB) -> ClusterTopology:
    """Multiple TPU pods; slow DCI edges between pod boundary chips."""
    base = None
    all_devices: list[DeviceInstance] = []
    topo = ClusterTopology([])
    spec = DEVICE_PROFILES["TPUv5e"]
    X = Y = int(math.isqrt(chips_per_pod))
    assert X * Y == chips_per_pod, "chips_per_pod must be a square"
    for p in range(pods):
        off = p * chips_per_pod
        for i in range(chips_per_pod):
            topo.devices[off + i] = DeviceInstance(off + i, spec)
        for x in range(X):
            for y in range(Y):
                i = off + x * Y + y
                jx = off + ((x + 1) % X) * Y + y
                jy = off + x * Y + (y + 1) % Y
                topo.add_link(i, jx, Edge(ici_bw_per_link, 1e-6, "ici-x"))
                topo.add_link(i, jy, Edge(ici_bw_per_link, 1e-6, "ici-y"))
    # DCI: connect corresponding chips of adjacent pods (optical/DCN).
    for p in range(pods - 1):
        for i in range(chips_per_pod):
            topo.add_link(p * chips_per_pod + i, (p + 1) * chips_per_pod + i,
                          Edge(dci_bw, 50e-6, "dci"))
    return topo


def dgx_h100_node() -> ClusterTopology:
    """A single DGX-H100: 8 GPUs, uneven NVSwitch connectivity (paper Fig. 5a).

    GPUs 0/7 sit next to the edge NVSwitches with more ports: we model this as
    an extra NVLink edge for pairs touching GPU 0 or 7."""
    spec = DEVICE_PROFILES["H100"]
    devices = [DeviceInstance(i, spec) for i in range(8)]
    topo = ClusterTopology(devices)
    for a, b in itertools.combinations(range(8), 2):
        edges = [Edge(450 * GB, 1e-6, "nvlink", ("pcie",)),
                 Edge(32 * GB, 5e-6, "pcie", ("nvlink",))]
        if a in (0, 7) or b in (0, 7):
            edges.insert(0, Edge(450 * GB, 1e-6, "nvlink-extra", ("pcie",)))
        topo.add_link(a, b, *edges)
    return topo
