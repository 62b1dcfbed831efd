"""Multi-tenant job-arrival generation + the ``multi_tenant`` catalog
family: the workload side of planner-as-a-service.

The network-event generators in :mod:`repro_torch.scenarios.generators` model
what the *cluster* does; this module models what the *tenants* do — a
seeded Poisson stream of :class:`JobArrival`\\ s drawn from a small pool of
job shapes, with a tunable twin probability (a new arrival clones an
earlier arrival's shape) so isomorphic-bucketing and cross-job cache reuse
have something real to bite on.  A :class:`TenantScenarioSpec` bundles a
topology factory, an arrival generator and a network-event generator into
one named, seeded, reproducible multi-tenant scenario — the substrate of
``benchmarks/bench_service.py``'s arrival storm.

Identical seeds produce identical arrival lists and identical event
traces (the same determinism contract as :mod:`repro_torch.scenarios.catalog`).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Sequence

from repro_torch.core import (ClusterTopology, ModelDesc, NetworkEvent,
                        hetero_cluster, homogeneous_cluster)

from . import generators as gen
from .generators import _poisson_times, _r
from .trace import Trace

# Small tenant model pool: planner-friendly sizes so a 32-job storm's cold
# searches stay in benchmark budget while still spanning distinct shapes.
TENANT_MODELS: dict[str, ModelDesc] = {
    "tenant_tiny": ModelDesc("tenant_tiny", n_layers=8, d_model=512,
                             n_heads=8, n_kv_heads=8, d_ff=2048, vocab=32000),
    "tenant_small": ModelDesc("tenant_small", n_layers=12, d_model=1024,
                              n_heads=16, n_kv_heads=16, d_ff=4096,
                              vocab=32000),
    "tenant_wide": ModelDesc("tenant_wide", n_layers=8, d_model=2048,
                             n_heads=16, n_kv_heads=16, d_ff=8192,
                             vocab=32000),
}


@dataclass(frozen=True)
class JobShape:
    """One drawable job template: model + batch geometry + slice size."""

    model: ModelDesc
    global_batch: int
    seq: int
    n_devices: int


@dataclass(frozen=True)
class JobArrival:
    """One tenant job arriving at ``time`` (all times in seconds on the
    scenario clock).  ``duration`` is how long the job holds its devices
    once admitted; the service frees them afterwards."""

    time: float
    name: str
    model: ModelDesc
    global_batch: int
    seq: int
    n_devices: int
    priority: int
    duration: float


DEFAULT_SHAPES: tuple[JobShape, ...] = (
    JobShape(TENANT_MODELS["tenant_tiny"], global_batch=32, seq=1024,
             n_devices=4),
    JobShape(TENANT_MODELS["tenant_small"], global_batch=64, seq=1024,
             n_devices=4),
    JobShape(TENANT_MODELS["tenant_wide"], global_batch=64, seq=1024,
             n_devices=8),
)


def job_arrivals(rng: random.Random, horizon: float, *, rate: float,
                 shapes: Sequence[JobShape] = DEFAULT_SHAPES,
                 twin_prob: float = 0.5,
                 priorities: Sequence[int] = (0, 1, 2),
                 duration_mean: float = 240.0,
                 max_jobs: int | None = None,
                 name_prefix: str = "job") -> list[JobArrival]:
    """Seeded Poisson stream of tenant jobs.

    With probability ``twin_prob`` a new arrival clones the *shape* of a
    uniformly-drawn earlier arrival (its own name/priority/duration) —
    the isomorphic twins the service's bucketing and cross-job cache
    dedup; otherwise the shape is drawn uniformly from ``shapes``.
    ``max_jobs`` caps the stream length (the arrival storm benches pin an
    exact job count).  Deterministic per ``rng`` seed.
    """
    out: list[JobArrival] = []
    for i, t in enumerate(_poisson_times(rng, rate, horizon)):
        if max_jobs is not None and len(out) >= max_jobs:
            break
        if out and rng.random() < twin_prob:
            proto = out[rng.randrange(len(out))]
            model, batch = proto.model, proto.global_batch
            seq, n_dev = proto.seq, proto.n_devices
        else:
            shape = shapes[rng.randrange(len(shapes))]
            model, batch = shape.model, shape.global_batch
            seq, n_dev = shape.seq, shape.n_devices
        out.append(JobArrival(
            time=_r(t), name=f"{name_prefix}-{i:03d}", model=model,
            global_batch=batch, seq=seq, n_devices=n_dev,
            priority=priorities[rng.randrange(len(priorities))],
            duration=_r(rng.expovariate(1.0 / duration_mean))))
    return out


def to_job_specs(arrivals: Sequence[JobArrival], *,
                 gpus_per_node: int = 4) -> list:
    """Convert arrivals into the service's
    :class:`repro_torch.service.jobs.JobSpec` list (imported lazily — the
    scenarios layer stays importable without the service package)."""
    from repro_torch.service.jobs import JobSpec
    return [JobSpec(name=a.name, model=a.model, global_batch=a.global_batch,
                    seq=a.seq, n_devices=a.n_devices, priority=a.priority,
                    arrival_s=a.time, duration_s=a.duration,
                    gpus_per_node=gpus_per_node)
            for a in arrivals]


# ---------------------------------------------------------------------------
# Named multi-tenant scenario registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TenantScenarioSpec:
    """One named multi-tenant scenario: topology + seeded arrival stream +
    seeded network-event timeline (the service benchmark's input triple)."""

    name: str
    description: str
    make_topology: Callable[[], ClusterTopology]
    make_arrivals: Callable[[random.Random, float], list[JobArrival]]
    make_events: Callable[[random.Random, float], list[NetworkEvent]]
    horizon: float = 600.0
    gpus_per_node: int = 4
    tags: tuple[str, ...] = ()


_TENANT_REGISTRY: dict[str, TenantScenarioSpec] = {}


def register_tenant(spec: TenantScenarioSpec) -> TenantScenarioSpec:
    """Register a multi-tenant scenario (unique name)."""
    if spec.name in _TENANT_REGISTRY:
        raise ValueError(f"tenant scenario {spec.name!r} already registered")
    _TENANT_REGISTRY[spec.name] = spec
    return spec


def get_tenant_scenario(name: str) -> TenantScenarioSpec:
    """Lookup by name; ``KeyError`` lists what is available."""
    try:
        return _TENANT_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown tenant scenario {name!r}; available: "
                       f"{sorted(_TENANT_REGISTRY)}") from None


def list_tenant_scenarios() -> list[str]:
    """Sorted registered multi-tenant scenario names."""
    return sorted(_TENANT_REGISTRY)


def build_tenant(name: str, seed: int = 0
                 ) -> tuple[ClusterTopology, list[JobArrival], Trace]:
    """(topology, arrivals, network-event trace) for ``(name, seed)``.

    Arrivals are generated first, events second, from one seeded rng —
    the order is part of the determinism contract (identical seeds give
    byte-identical triples)."""
    spec = get_tenant_scenario(name)
    rng = random.Random(seed)
    arrivals = spec.make_arrivals(rng, spec.horizon)
    events = spec.make_events(rng, spec.horizon)
    trace = Trace(name=spec.name, horizon=spec.horizon,
                  events=tuple(events), seed=seed,
                  meta=(("family", spec.name), ("jobs", len(arrivals))))
    return spec.make_topology(), arrivals, trace


register_tenant(TenantScenarioSpec(
    name="multi_tenant_small",
    description="8 tenant jobs on a 16-GPU cluster, light congestion "
                "(quick smoke config)",
    make_topology=lambda: homogeneous_cluster(16, "V100", gpus_per_node=4),
    make_arrivals=lambda rng, horizon: job_arrivals(
        rng, horizon, rate=24.0 / horizon, twin_prob=0.5, max_jobs=8,
        duration_mean=horizon / 2),
    make_events=lambda rng, horizon: gen.congestion_bursts(
        rng, horizon, burst_rate=4.0 / horizon, selector="ib",
        depth_range=(0.3, 0.6), duration_range=(horizon / 20, horizon / 8),
        decay_steps=2),
    tags=("multi_tenant", "S1"),
))

register_tenant(TenantScenarioSpec(
    name="multi_tenant_storm",
    description="32-job arrival storm with heavy twin reuse on a 64-GPU "
                "cluster + multi-tenant congestion (the bench_service "
                "acceptance config)",
    make_topology=lambda: homogeneous_cluster(64, "V100", gpus_per_node=4),
    make_arrivals=lambda rng, horizon: job_arrivals(
        rng, horizon, rate=96.0 / horizon, twin_prob=0.65, max_jobs=32,
        duration_mean=horizon / 3),
    # congestion on the shared ib fabric + straggler churn across the fleet
    # (device-level events reach single-node jobs the ib selector cannot);
    # sequential generation from one rng keeps the composition seeded
    make_events=lambda rng, horizon: sorted(
        gen.congestion_bursts(
            rng, horizon, burst_rate=6.0 / horizon, selector="ib",
            depth_range=(0.3, 0.6),
            duration_range=(horizon / 20, horizon / 8), decay_steps=2)
        + gen.straggler_churn(
            rng, list(range(64)), horizon, rate=12.0 / horizon,
            slow_range=(0.4, 0.7), recover_mean=horizon / 8),
        key=lambda e: e.time),
    tags=("multi_tenant", "S1", "S2", "storm"),
))

register_tenant(TenantScenarioSpec(
    name="multi_tenant_churn",
    description="16 tenant jobs under straggler churn on a mixed fleet "
                "(device events exercise per-job replan routing)",
    make_topology=lambda: hetero_cluster({"RTX4090D": 16, "V100": 16},
                                         gpus_per_node=4),
    make_arrivals=lambda rng, horizon: job_arrivals(
        rng, horizon, rate=48.0 / horizon, twin_prob=0.5, max_jobs=16,
        duration_mean=horizon / 2),
    make_events=lambda rng, horizon: gen.straggler_churn(
        rng, list(range(32)), horizon, rate=8.0 / horizon,
        slow_range=(0.4, 0.7), recover_mean=horizon / 8),
    tags=("multi_tenant", "S2"),
))
