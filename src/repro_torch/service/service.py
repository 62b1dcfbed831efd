"""`PlannerService`: one planner daemon, many concurrent jobs, one fabric.

Everything below ``repro_torch.service`` plans exactly one training job; this
module multiplexes N of them over one shared
:class:`~repro_torch.core.cluster.ClusterTopology`:

  * **admission** — submissions enter a bounded
    :class:`~repro_torch.service.admission.AdmissionQueue` (priority + FIFO,
    backpressure on overload); when devices free up, the head bucket is
    admitted onto a deterministic slice of the free pool and isomorphic
    twins ride the head's single cold search via the
    :class:`~repro_torch.service.cache.SharedStrategyCache`;
  * **replanning** — every :class:`~repro_torch.core.cluster.NetworkEvent` is
    applied to the shared topology once, invalidates exactly the affected
    cache entries, and triggers warm
    :meth:`~repro_torch.core.engine.ReplanEngine.replan` calls on the affected
    jobs only (optionally in a thread pool — results are byte-identical to
    the serial order, gated in CI);
  * **contention charging** — each job's keep/switch hysteresis prices its
    reshard against the *other* jobs' in-flight reshard bytes on shared
    links (:class:`LinkLoadBoard` + :meth:`repro_torch.core.reconfig.
    ReconfigCostModel.cost`'s ``edge_load``), and switches decided in the
    same round are re-priced jointly — no job ever sees an empty fabric
    that is actually busy.

Telemetry rides ``repro_torch.obs``: per-job span lanes (``lane=<job>`` attrs
render as one Perfetto lane per job), ``service.queue_depth`` /
``service.replan.latency_s`` histograms and ``service.*`` counters — see
``docs/service.md`` for the operator runbook.
"""

from __future__ import annotations

import heapq
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from repro_torch.core.cluster import ClusterTopology, NetworkEvent
from repro_torch.core.engine import ReplanEngine, ReplanResult
from repro_torch.core.plans import ParallelPlan
from repro_torch.core.reconfig import ReconfigCostModel
from repro_torch.core.simulator import StepSim
from repro_torch.obs import Obs, resolve_obs

from .admission import AdmissionQueue
from .cache import SharedStrategyCache
from .jobs import JobSpec


class LinkLoadBoard:
    """Per-link in-flight reshard bytes, by owning job, with expiry.

    When a job switches plans the service charges its route-expanded
    reshard traffic here for the switch's modeled duration; any other job
    pricing a switch meanwhile sees those bytes as background load on the
    shared links (:meth:`load` excludes the asking job's own traffic).
    Purely deterministic — entries expire by the service clock, not wall
    time.
    """

    def __init__(self) -> None:
        self._entries: list[tuple[str, float, dict[tuple[int, int],
                                                   float]]] = []
        self._lock = threading.Lock()

    def charge(self, owner: str, traffic: dict[tuple[int, int], float],
               now: float, duration: float) -> None:
        """Register ``owner``'s reshard ``traffic`` as in-flight for
        ``duration`` seconds of service-clock time."""
        if not traffic or duration <= 0:
            return
        with self._lock:
            self._entries.append((owner, now + duration, dict(traffic)))

    def gc(self, now: float) -> None:
        """Drop entries that have fully drained by ``now``."""
        with self._lock:
            self._entries = [e for e in self._entries if e[1] > now]

    def load(self, now: float, *, exclude: str | None = None
             ) -> dict[tuple[int, int], float]:
        """Aggregate in-flight bytes per link at ``now``, excluding
        ``exclude``'s own entries (a job never queues behind itself)."""
        out: dict[tuple[int, int], float] = {}
        with self._lock:
            for owner, expires, traffic in self._entries:
                if expires <= now or owner == exclude:
                    continue
                for key, v in traffic.items():
                    out[key] = out.get(key, 0.0) + v
        return out


class ContentionChargedReconfig(ReconfigCostModel):
    """A per-job :class:`~repro_torch.core.reconfig.ReconfigCostModel` whose
    :meth:`cost` defaults ``edge_load`` to the background load the service
    froze for the current replan round (:meth:`set_background`).

    Freezing before the round dispatches keeps threaded rounds
    deterministic: every job prices against the same board snapshot no
    matter which thread finishes first.
    """

    def __init__(self, model, **kwargs):
        super().__init__(model, **kwargs)
        self._background: dict[tuple[int, int], float] = {}

    def set_background(self, edge_load: dict[tuple[int, int], float] | None
                       ) -> None:
        """Install the frozen per-link background bytes for the next
        pricing round (``None`` clears it)."""
        self._background = dict(edge_load) if edge_load else {}

    def cost(self, old, new, topo, *, edge_load=None):
        """:meth:`ReconfigCostModel.cost`, defaulting ``edge_load`` to the
        round's frozen background when the caller passes none."""
        if edge_load is None:
            edge_load = self._background
        return super().cost(old, new, topo, edge_load=edge_load)


@dataclass
class JobHandle:
    """One admitted job: its spec, device slice, per-job engine, and the
    current plan.  ``digests`` accumulates ``repr(plan)`` after admission
    and every replan — the byte-level identity record the serial ==
    threaded determinism gate compares."""

    spec: JobSpec
    device_ids: tuple[int, ...]
    engine: ReplanEngine
    reconfig: ContentionChargedReconfig
    tags: frozenset[str]
    state: str                           # running | finished
    plan: ParallelPlan
    predicted: StepSim
    admitted_s: float
    finish_s: float
    cold: bool
    replans: int = 0
    contended_switch_s: float = 0.0
    digests: list[str] = field(default_factory=list)


@dataclass
class ServiceReport:
    """Aggregate outcome of one :meth:`PlannerService.replay`."""

    arrivals: int = 0
    admitted: int = 0
    rejected: int = 0
    finished: int = 0
    events: int = 0
    replans: int = 0
    cold_searches: int = 0
    cache_hits: int = 0
    cache_hit_rate: float = 0.0
    invalidated: int = 0
    max_queue_depth: int = 0
    replan_walls: list[float] = field(default_factory=list)
    admit_walls: list[float] = field(default_factory=list)
    # job name -> tuple of repr(plan) after admission + each replan
    plan_digests: dict[str, tuple[str, ...]] = field(default_factory=dict)

    def percentile(self, q: float) -> float:
        """``q``-th percentile of the measured replan wall times (0 when
        no replans ran)."""
        if not self.replan_walls:
            return 0.0
        xs = sorted(self.replan_walls)
        i = min(len(xs) - 1, max(0, round(q / 100 * (len(xs) - 1))))
        return xs[int(i)]


class PlannerService:
    """In-process planner daemon multiplexing jobs on one shared cluster.

    The service owns the topology: callers :meth:`submit` job specs and
    feed :meth:`handle_event` the network timeline (or drive both at once
    with :meth:`replay`).  Per-job state lives in :class:`JobHandle`\\ s —
    one warm :class:`~repro_torch.core.engine.ReplanEngine` per job, all sharing
    one :class:`~repro_torch.service.cache.SharedStrategyCache` — and the
    :class:`LinkLoadBoard` carries cross-job reshard contention.

    ``workers > 1`` replans the affected jobs of one event concurrently;
    inputs are frozen before dispatch (per-job subtopologies, the board
    snapshot), so the outcome is byte-identical to ``workers=1``.
    """

    def __init__(self, topo: ClusterTopology, *, queue_capacity: int = 64,
                 workers: int = 1, max_candidates: int | None = None,
                 switch_horizon_s: float | None = None,
                 cache: SharedStrategyCache | None = None,
                 cache_entries: int = 512,
                 obs: Obs | None = None):
        # private copy: handle_event mutates topology state in place, and a
        # caller-shared instance would leak one replay's events into the next
        self.topo = topo.copy()
        self.obs = resolve_obs(obs)
        self.cache = cache if cache is not None \
            else SharedStrategyCache(max_entries=cache_entries, obs=self.obs)
        self.queue = AdmissionQueue(queue_capacity)
        self.board = LinkLoadBoard()
        self.workers = max(1, workers)
        self.max_candidates = max_candidates
        self.switch_horizon_s = switch_horizon_s
        self.clock = 0.0
        self.jobs: dict[str, JobHandle] = {}
        self._free: set[int] = set(topo.alive_ids())
        self._seq = 0
        self.report = ServiceReport()

    # -- admission -------------------------------------------------------------

    def submit(self, spec: JobSpec) -> bool:
        """Queue ``spec``; ``False`` = rejected (queue full, backpressure).
        Call :meth:`admit_ready` (or let :meth:`replay`) to actually admit."""
        if spec.name in self.jobs:
            raise ValueError(f"duplicate job name {spec.name!r}")
        ok = self.queue.offer(spec)
        self.report.arrivals += 1
        self.obs.inc("service.submitted")
        if not ok:
            self.report.rejected += 1
            self.obs.inc("service.rejected")
        self.obs.observe("service.queue_depth", self.queue.depth)
        self.report.max_queue_depth = max(self.report.max_queue_depth,
                                          self.queue.depth)
        return ok

    def _allocate(self, n: int) -> tuple[int, ...]:
        ids = tuple(sorted(self._free)[:n])
        self._free.difference_update(ids)
        return ids

    def admit_ready(self, now: float | None = None) -> list[JobHandle]:
        """Admit queued buckets while the head fits the free device pool.

        Head-of-line semantics: a high-priority job too big for the
        current free pool blocks lower-priority jobs behind it (no
        starvation of big jobs).  Twins in the head's bucket that do not
        fit re-enter the queue at the tail of their priority level.
        """
        now = self.clock if now is None else now
        admitted: list[JobHandle] = []
        while True:
            head = self.queue.peek()
            if head is None or head.n_devices > len(self._free):
                break
            spec, twins = self.queue.pop_bucket()
            for s in (spec, *twins):
                if s.n_devices <= len(self._free):
                    admitted.append(self._admit(s, now))
                else:
                    self.queue.offer(s)
        if admitted:
            self.obs.observe("service.queue_depth", self.queue.depth)
        return admitted

    def _admit(self, spec: JobSpec, now: float) -> JobHandle:
        t0 = time.perf_counter()
        ids = self._allocate(spec.n_devices)
        sub = self.topo.subtopology(ids)
        tags = frozenset(e.tag for link in sub.links.values()
                         for e in link.edges)
        reconfig = ContentionChargedReconfig(spec.model)
        engine = ReplanEngine(
            spec.model, global_batch=spec.global_batch, seq=spec.seq,
            cache=self.cache.strategy, max_candidates=self.max_candidates,
            gpus_per_node=spec.gpus_per_node, reconfig=reconfig,
            switch_horizon_s=self.switch_horizon_s, obs=self.obs)
        key = (self.topo.island_signature(ids), spec.signature())
        status, served = self.cache.acquire(key, ids)
        if status == "hit":
            plan, sim = served  # type: ignore[misc]
            engine.seed_incumbent(sub, plan, sim)
        else:
            try:
                res = engine.plan(sub)
            except Exception:
                self.cache.abandon(key)
                self._free.update(ids)
                raise
            plan, sim = res.plan, res.predicted
            self.cache.complete(key, plan, sim, ids, tags)
            self.report.cold_searches += 1
        wall = time.perf_counter() - t0
        job = JobHandle(spec=spec, device_ids=ids, engine=engine,
                        reconfig=reconfig, tags=tags, state="running",
                        plan=plan, predicted=sim, admitted_s=now,
                        finish_s=now + spec.duration_s
                        if spec.duration_s > 0 else float("inf"),
                        cold=(status != "hit"))
        job.digests.append(repr(plan))
        self.jobs[spec.name] = job
        self.report.admitted += 1
        self.report.admit_walls.append(wall)
        self.obs.inc("service.admitted")
        self.obs.inc("service.admit.cold" if job.cold
                     else "service.admit.cache_hit")
        self.obs.observe("service.admit.latency_s", wall)
        if self.obs.enabled:
            # the cold/hit outcome is only known now, so the span is
            # backdated to cover the whole admission (engine.py idiom)
            handle = self.obs.span("service.admit", job=spec.name,
                                   lane=spec.name, cold=job.cold,
                                   devices=len(ids))
            handle.span.t0 = time.perf_counter() - wall
            handle.__exit__(None, None, None)
        return job

    def finish_job(self, name: str, now: float | None = None) -> None:
        """Mark ``name`` finished and return its devices to the free pool
        (queued jobs may now admit — call :meth:`admit_ready`)."""
        job = self.jobs[name]
        if job.state == "finished":
            return
        job.state = "finished"
        self._free.update(d for d in job.device_ids
                          if self.topo.devices[d].alive)
        self.report.finished += 1
        self.obs.inc("service.finished")

    # -- event handling --------------------------------------------------------

    def _affected(self, event: NetworkEvent) -> list[JobHandle]:
        running = [j for j in self.jobs.values() if j.state == "running"]
        if event.kind in ("fail", "join", "slowdown"):
            return [j for j in running if event.device_id in j.device_ids]
        if event.selector is None:
            return running
        return [j for j in running if event.selector in j.tags]

    def handle_event(self, event: NetworkEvent
                     ) -> list[tuple[str, ReplanResult]]:
        """Apply ``event`` to the shared topology, invalidate exactly the
        affected cache entries, and replan the affected jobs (one frozen
        contention round — see class docstring).  Returns the per-job
        replan results in deterministic job-admission order."""
        self.clock = max(self.clock, event.time)
        self.topo.apply_event(event)
        self.board.gc(self.clock)
        dropped = self.cache.invalidate(event)
        self.report.invalidated += len(dropped)
        # pool bookkeeping: fail removes free devices, join returns a
        # device owned by no running job to the pool
        if event.kind == "fail":
            self._free.discard(event.device_id)
        elif event.kind == "join" and event.device_id is not None:
            owned = {d for j in self.jobs.values()
                     if j.state == "running" for d in j.device_ids}
            if event.device_id not in owned:
                self._free.add(event.device_id)
        affected = self._affected(event)
        self.report.events += 1
        self.obs.inc("service.events")
        if not affected:
            return []
        # freeze round inputs before dispatch: per-job subtopologies and
        # the board snapshot each job prices hysteresis against
        subs = [self.topo.subtopology(j.device_ids) for j in affected]
        for job in affected:
            job.reconfig.set_background(
                self.board.load(self.clock, exclude=job.spec.name))
        prev_plans = [j.plan for j in affected]

        def _one(i: int) -> ReplanResult:
            return affected[i].engine.replan(subs[i], event)

        if self.workers > 1 and len(affected) > 1:
            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                results = list(pool.map(_one, range(len(affected))))
        else:
            results = [_one(i) for i in range(len(affected))]
        # joint re-pricing of the switches this round actually decided:
        # each switching job's reshard is charged onto the board for its
        # contended duration, so later rounds queue behind it
        switching = [i for i, res in enumerate(results)
                     if res.plan.structural_key()
                     != prev_plans[i].structural_key()]
        if switching:
            traffics = {i: affected[i].reconfig.edge_traffic(
                prev_plans[i], results[i].plan, subs[i]) for i in switching}
            for i in switching:
                load = dict(affected[i].reconfig._background)
                for j in switching:
                    if j == i:
                        continue
                    for key, v in traffics[j].items():
                        load[key] = load.get(key, 0.0) + v
                priced = affected[i].reconfig.cost(
                    prev_plans[i], results[i].plan, subs[i], edge_load=load)
                affected[i].contended_switch_s += priced.total_s
                self.board.charge(affected[i].spec.name, traffics[i],
                                  self.clock, priced.total_s)
                self.obs.observe("service.switch.contended_s",
                                 priced.total_s)
        out: list[tuple[str, ReplanResult]] = []
        for job, res in zip(affected, results):
            job.plan, job.predicted = res.plan, res.predicted
            job.replans += 1
            job.digests.append(repr(res.plan))
            job.reconfig.set_background(None)
            self.report.replans += 1
            self.report.replan_walls.append(res.wall_time)
            self.obs.observe("service.replan.latency_s", res.wall_time)
            if self.obs.enabled:
                # backdated to cover the engine's measured replan wall, so
                # each job's lane shows the replan as a real region
                handle = self.obs.span("service.replan", job=job.spec.name,
                                       lane=job.spec.name, path=res.path,
                                       kept=res.kept, event=event.kind)
                handle.span.t0 = time.perf_counter() - res.wall_time
                handle.__exit__(None, None, None)
            out.append((job.spec.name, res))
        return out

    # -- replay driver ---------------------------------------------------------

    def replay(self, specs: list[JobSpec],
               events: list[NetworkEvent] | None = None) -> ServiceReport:
        """Drive the whole timeline: merge job arrivals (``spec.arrival_s``)
        and network ``events`` in time order, admit / replan / finish as
        the clock advances, and return the filled :class:`ServiceReport`.

        Fully deterministic for a given input (ties break arrivals before
        events before finishes, then input order) — the serial == threaded
        identity gate replays the same inputs at ``workers=1`` and
        ``workers=N`` and compares ``plan_digests`` byte-for-byte.
        """
        timeline: list[tuple[float, int, int, str, object]] = []
        for k, spec in enumerate(specs):
            timeline.append((spec.arrival_s, 0, k, "arrival", spec))
        for k, ev in enumerate(events or []):
            timeline.append((ev.time, 1, k, "event", ev))
        timeline.sort(key=lambda it: (it[0], it[1], it[2]))
        finish_heap: list[tuple[float, int, str]] = []

        def _note_finishes(limit: float) -> None:
            while finish_heap and finish_heap[0][0] <= limit:
                t, _, name = heapq.heappop(finish_heap)
                self.clock = max(self.clock, t)
                self.finish_job(name, t)
                for job in self.admit_ready(t):
                    self._push_finish(finish_heap, job)

        for t, _kind_rank, _k, kind, payload in timeline:
            _note_finishes(t)
            self.clock = max(self.clock, t)
            if kind == "arrival":
                self.submit(payload)                 # type: ignore[arg-type]
                for job in self.admit_ready(t):
                    self._push_finish(finish_heap, job)
            else:
                self.handle_event(payload)           # type: ignore[arg-type]
        _note_finishes(float("inf"))
        rep = self.report
        rep.cache_hits = self.cache.hits
        rep.cache_hit_rate = self.cache.hit_rate
        rep.plan_digests = {name: tuple(j.digests)
                            for name, j in self.jobs.items()}
        return rep

    def _push_finish(self, heap: list, job: JobHandle) -> None:
        if job.finish_s != float("inf"):
            self._seq += 1
            heapq.heappush(heap, (job.finish_s, self._seq, job.spec.name))
