"""Shared cross-job strategy cache with event-driven invalidation.

The engine ships per-search read-only materialization snapshots; this module
extends them into the *shared, versioned* store the planner service
multiplexes jobs over.  Two layers:

  * the inner :class:`repro_torch.core.engine.StrategyCache` (one instance shared
    by every per-job :class:`~repro_torch.core.engine.ReplanEngine`) memoizes
    enumeration / materialized plans / simulator scores per topology
    fingerprint — jobs replanning on the *same* device slice under the same
    conditions reuse each other's work for free;
  * the **finished-plan store** keyed by
    ``(island_signature(slice), JobSpec.signature())`` — id-free on both
    axes, so a job admitted onto *any* slice isomorphic to one already
    planned gets the stored plan remapped onto its own device ids
    (sorted-order correspondence, exactly the hierarchical search's twin
    dedup) instead of a cold search.

Invalidation is event-driven and *exact*: every stored entry records which
device ids and edge tags its source slice touched, and
:meth:`SharedStrategyCache.invalidate` drops precisely the entries the
:class:`~repro_torch.core.cluster.NetworkEvent` can affect — a failed device
kills the entries whose slice contains it, a selector-tagged bandwidth
event kills the entries whose slice crosses that fabric, and everything
else survives.  Each invalidation bumps :attr:`SharedStrategyCache.version`
so operators can correlate store generations with the event timeline.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, replace

from repro_torch.core.cluster import NetworkEvent
from repro_torch.core.engine import StrategyCache
from repro_torch.core.plans import ParallelPlan, StageAssignment
from repro_torch.core.simulator import StepSim
from repro_torch.obs import Obs, resolve_obs


@dataclass(frozen=True)
class StoredPlan:
    """One finished-plan store entry: the representative's plan + score,
    plus the fingerprint facts invalidation matches against (``devices``:
    the slice's ids; ``tags``: its internal edge tags)."""

    plan: ParallelPlan
    sim: StepSim
    device_ids: tuple[int, ...]          # sorted representative slice ids
    devices: frozenset[int]
    tags: frozenset[str]
    version: int                         # store generation at write time


def _remap(plan: ParallelPlan, mapping: dict[int, int]) -> ParallelPlan:
    # sorted-order correspondence; meta untouched so a remapped plan is
    # byte-identical to a cold search on the isomorphic target slice
    stages = tuple(
        StageAssignment(st.layers, tuple(mapping[d] for d in st.device_ids))
        for st in plan.stages)
    return replace(plan, stages=stages)


class SharedStrategyCache:
    """The service's cross-job cache: shared inner :class:`StrategyCache`
    plus the versioned finished-plan store (see module docstring).

    Thread-safe.  :meth:`acquire` is the single-flight entry point: under
    concurrent admission of twins, exactly one caller is told ``"cold"``
    (it must :meth:`complete` or :meth:`abandon` the key) and every other
    caller blocks until the search lands, then gets the remapped hit.
    """

    def __init__(self, *, max_entries: int = 256,
                 strategy_cache: StrategyCache | None = None,
                 obs: Obs | None = None):
        self.obs = resolve_obs(obs)
        self.strategy = strategy_cache if strategy_cache is not None \
            else StrategyCache(max_entries=max_entries, obs=self.obs)
        self.max_entries = max_entries
        self.version = 0
        self.hits = 0
        self.misses = 0
        self._plans: "OrderedDict[tuple, StoredPlan]" = OrderedDict()
        self._pending: dict[tuple, threading.Event] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._plans)

    @property
    def hit_rate(self) -> float:
        """Finished-plan store hit rate over every lookup so far."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    # -- lookup / single-flight ----------------------------------------------

    def _serve(self, entry: StoredPlan, target_ids) -> tuple[ParallelPlan,
                                                             StepSim]:
        ids = tuple(sorted(target_ids))
        if ids == entry.device_ids:
            return entry.plan, entry.sim
        mapping = dict(zip(entry.device_ids, ids))
        return _remap(entry.plan, mapping), entry.sim

    def lookup(self, key: tuple, target_ids) -> tuple[ParallelPlan,
                                                      StepSim] | None:
        """The stored plan for ``key`` remapped onto ``target_ids``
        (sorted-order correspondence), or ``None``.  Counts hit/miss
        telemetry (``service.plan_cache.hit`` / ``.miss``)."""
        with self._lock:
            entry = self._plans.get(key)
            if entry is not None:
                self._plans.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        self.obs.inc("service.plan_cache.hit" if entry is not None
                     else "service.plan_cache.miss")
        if entry is None:
            return None
        return self._serve(entry, target_ids)

    def acquire(self, key: tuple, target_ids
                ) -> tuple[str, tuple[ParallelPlan, StepSim] | None]:
        """Single-flight lookup: ``("hit", (plan, sim))`` or
        ``("cold", None)``.

        The first caller for an absent key becomes its owner and MUST call
        :meth:`complete` (or :meth:`abandon` on failure); concurrent
        callers for the same key block until then and re-resolve — so N
        twins admitted at once cost exactly one cold search.
        """
        while True:
            with self._lock:
                entry = self._plans.get(key)
                if entry is not None:
                    self._plans.move_to_end(key)
                    self.hits += 1
                    self.obs.inc("service.plan_cache.hit")
                    return "hit", self._serve(entry, target_ids)
                ev = self._pending.get(key)
                if ev is None:
                    self._pending[key] = threading.Event()
                    self.misses += 1
                    self.obs.inc("service.plan_cache.miss")
                    return "cold", None
            ev.wait()

    def complete(self, key: tuple, plan: ParallelPlan, sim: StepSim,
                 device_ids, tags) -> None:
        """Land a cold search's result under ``key`` and release any
        waiters.  ``device_ids``/``tags`` become the entry's invalidation
        fingerprint."""
        ids = tuple(sorted(device_ids))
        entry = StoredPlan(plan=plan, sim=sim, device_ids=ids,
                           devices=frozenset(ids),
                           tags=frozenset(tags), version=self.version)
        with self._lock:
            self._plans[key] = entry
            self._plans.move_to_end(key)
            while len(self._plans) > self.max_entries:
                self._plans.popitem(last=False)
                self.obs.inc("service.plan_cache.eviction")
            ev = self._pending.pop(key, None)
        if ev is not None:
            ev.set()

    def abandon(self, key: tuple) -> None:
        """Release ``key``'s waiters without storing (the owner's search
        failed); the next caller becomes the new owner."""
        with self._lock:
            ev = self._pending.pop(key, None)
        if ev is not None:
            ev.set()

    # -- event-driven invalidation --------------------------------------------

    def invalidate(self, event: NetworkEvent) -> list[tuple]:
        """Drop exactly the entries ``event`` can affect; returns their
        keys and bumps :attr:`version`.

        Matching rules (the documented invalidation contract,
        ``docs/service.md``):

        * ``fail`` / ``join`` / ``slowdown`` — entries whose slice contains
          ``event.device_id``;
        * ``bandwidth`` with a selector — entries whose slice has an edge
          tagged ``event.selector``;
        * ``bandwidth`` with no selector (whole-fabric) — every entry with
          any internal edge.

        Entries on disjoint device slices / untouched fabrics survive — the
        store is never cleared wholesale.
        """
        dropped: list[tuple] = []
        with self._lock:
            for key, entry in list(self._plans.items()):
                hit = False
                if event.kind in ("fail", "join", "slowdown"):
                    hit = event.device_id in entry.devices
                elif event.kind == "bandwidth":
                    hit = (event.selector in entry.tags
                           if event.selector is not None else bool(entry.tags))
                if hit:
                    del self._plans[key]
                    dropped.append(key)
            self.version += 1
        if dropped:
            self.obs.inc("service.plan_cache.invalidated", len(dropped))
        return dropped

    def counters(self) -> dict[str, int]:
        """Snapshot of the store's telemetry (size, hits, misses,
        version)."""
        with self._lock:
            return {"size": len(self._plans), "hits": self.hits,
                    "misses": self.misses, "version": self.version}
