"""Named scenario catalog: cloud-environment families ready to replay.

Each :class:`ScenarioSpec` bundles a topology factory with a seeded event
generator; :func:`build_trace` turns (name, seed) into a reproducible
:class:`Trace` and :func:`build` additionally instantiates the topology.
Identical seeds produce byte-identical traces (the determinism gate).

Registered families:

===================== ======================================================
name                  what
===================== ======================================================
cloud_spot            spot-instance preemption/rejoin churn on a mixed
                      RTX4090D + V100 fleet (Poisson arrivals, S3)
diurnal_wan           day/night WAN bandwidth curve on the inter-node "ib"
                      fabric of a 16x V100 cluster (S1, absolute-set)
congested_multitenant overlapping multi-tenant congestion bursts with staged
                      decay on "ib" (S1, scale-mode composition)
straggler_churn       devices degrade and recover on a heterogeneous node
                      pair (S2, scale-mode)
cross_region          cross-region DCI link flaps between two TPU pods (S1)
fig6c_dynamic_bw      the fig6c benchmark timeline re-expressed as a trace:
                      nominal -> 0.2x -> 4x fabric bandwidth (deterministic)
diurnal_wan_crossover deep diurnal trough on the ``ib`` fabric joining two
                      NVLink islands — crosses the fig6c TP-vs-bandwidth
                      boundary, so the plan actually flips mid-trace (S1)
congested_crossover   deep multi-tenant bursts on the same ``ib`` fabric;
                      burst floors cross the DP-across-nodes vs
                      PP-across-nodes boundary (S1)
diurnal_spot_storm    composed timeline: diurnal WAN curve + spot
                      preemption churn on one mixed fleet (S1+S3)
congested_flaky       composed timeline: multi-tenant bursts + link flaps
                      on the same fabric, scale-mode composition (S1)
===================== ======================================================

The ``*_crossover`` variants exist because the original bandwidth families
ended in "keep" on every event: the cold plan stays bandwidth-robust on
their fabrics at any swing the generators produce.  With fast NVLink
islands and only the inter-island ``ib`` link swinging, the crossover is
inside the swing range — at a comm-heavy replay scale (small global batch)
a deep trough flips DP-across-nodes to PP-across-nodes and the adapted
policy has a real S1 win to collect.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Sequence

from repro_torch.core import (ClusterTopology, NetworkEvent, hetero_cluster,
                        homogeneous_cluster, multi_pod_tpu)

from . import generators as gen
from .trace import Trace, compose_traces


@dataclass(frozen=True)
class ScenarioSpec:
    """One catalog entry: topology factory + seeded event generator."""

    name: str
    description: str
    make_topology: Callable[[], ClusterTopology]
    make_events: Callable[[random.Random, float], list[NetworkEvent]]
    horizon: float = 600.0
    deterministic: bool = False        # events independent of the seed
    tags: tuple[str, ...] = ()


_REGISTRY: dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    """Register a scenario spec under its (unique) name; returns it."""
    if spec.name in _REGISTRY:
        raise ValueError(f"scenario {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    """Lookup by name; ``KeyError`` lists what is available."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{sorted(_REGISTRY)}") from None


def list_scenarios() -> list[str]:
    """Sorted registered scenario names."""
    return sorted(_REGISTRY)


def build_trace(name: str, seed: int = 0) -> Trace:
    """Generate the named scenario's trace for ``seed`` (reproducible)."""
    spec = get_scenario(name)
    rng = random.Random(seed)
    events = spec.make_events(rng, spec.horizon)
    return Trace(name=spec.name, horizon=spec.horizon, events=tuple(events),
                 seed=seed, meta=(("deterministic", spec.deterministic),
                                  ("family", spec.name)))


def build(name: str, seed: int = 0) -> tuple[ClusterTopology, Trace]:
    """Topology + trace for the named scenario; the trace's events are
    attached to the topology's timeline, ready for replay."""
    spec = get_scenario(name)
    trace = build_trace(name, seed)
    topo = spec.make_topology()
    topo.events = trace.to_events()
    return topo, trace


# ---------------------------------------------------------------------------
# Registered families
# ---------------------------------------------------------------------------


register(ScenarioSpec(
    name="cloud_spot",
    description="spot-instance preemption/rejoin churn, mixed fleet (S3)",
    make_topology=lambda: hetero_cluster({"RTX4090D": 8, "V100": 8},
                                         gpus_per_node=4),
    make_events=lambda rng, horizon: gen.spot_preemptions(
        rng, list(range(16)), horizon, preempt_rate=5.0 / horizon,
        restore_mean=horizon / 4),
    tags=("S3", "fail", "join"),
))

register(ScenarioSpec(
    name="diurnal_wan",
    description="day/night WAN bandwidth curve on the ib fabric (S1)",
    make_topology=lambda: homogeneous_cluster(16, "V100", gpus_per_node=8),
    make_events=lambda rng, horizon: gen.diurnal_bandwidth(
        rng, horizon, period=horizon / 2, floor=0.25, selector="ib",
        samples_per_period=7),
    tags=("S1", "bandwidth"),
))

register(ScenarioSpec(
    name="congested_multitenant",
    description="overlapping multi-tenant congestion bursts on ib (S1)",
    make_topology=lambda: homogeneous_cluster(8, "V100", gpus_per_node=4),
    make_events=lambda rng, horizon: gen.congestion_bursts(
        rng, horizon, burst_rate=7.0 / horizon, selector="ib",
        depth_range=(0.3, 0.7), duration_range=(horizon / 20, horizon / 6),
        decay_steps=2),
    tags=("S1", "bandwidth", "scale"),
))

register(ScenarioSpec(
    name="straggler_churn",
    description="devices degrade and recover on a hetero node pair (S2)",
    make_topology=lambda: hetero_cluster({"RTX4090D": 4, "V100": 4},
                                         gpus_per_node=4),
    make_events=lambda rng, horizon: gen.straggler_churn(
        rng, list(range(8)), horizon, rate=6.0 / horizon,
        slow_range=(0.3, 0.7), recover_mean=horizon / 8),
    tags=("S2", "slowdown"),
))

register(ScenarioSpec(
    name="cross_region",
    description="cross-region DCI link flaps between two TPU pods (S1)",
    make_topology=lambda: multi_pod_tpu(pods=2, chips_per_pod=16),
    make_events=lambda rng, horizon: gen.link_degradation(
        rng, horizon, selector="dci", rate=4.0 / horizon,
        severity_range=(0.1, 0.5), repair_mean=horizon / 6),
    tags=("S1", "bandwidth", "dci"),
))


def _crossover_fabric() -> ClusterTopology:
    """Two NVLink-backed 4-GPU V100 boxes joined by a 25 GB/s WAN-class
    ``ib`` fabric.  With the intra-node fabric fast and only ``ib``
    swinging, the fig6c crossover sits inside the swing: at nominal
    bandwidth DP-across-nodes wins, in a deep trough the planner flips to
    pipeline-across-nodes (drops the cross-``ib`` gradient sync).  Replay
    this family at a comm-heavy scale (small global batch) — at large
    batches the step is compute-bound and no bandwidth level flips it."""
    return hetero_cluster({"V100": 8}, inter_bw=25e9, gpus_per_node=4)


register(ScenarioSpec(
    name="diurnal_wan_crossover",
    description="deep diurnal WAN swing across NVLink islands (S1)",
    make_topology=_crossover_fabric,
    make_events=lambda rng, horizon: gen.diurnal_bandwidth(
        rng, horizon, period=horizon / 2, floor=0.10, selector="ib",
        samples_per_period=7),
    tags=("S1", "bandwidth", "crossover"),
))

register(ScenarioSpec(
    name="congested_crossover",
    description="deep multi-tenant bursts across NVLink islands (S1)",
    make_topology=_crossover_fabric,
    make_events=lambda rng, horizon: gen.congestion_bursts(
        rng, horizon, burst_rate=5.0 / horizon, selector="ib",
        depth_range=(0.6, 0.9),
        duration_range=(horizon / 10, horizon / 4), decay_steps=2),
    tags=("S1", "bandwidth", "scale", "crossover"),
))


# ---------------------------------------------------------------------------
# Composed timelines (ROADMAP open item): one scenario, several families
# ---------------------------------------------------------------------------


def _composed_events(rng: random.Random, horizon: float, name: str,
                     parts: Sequence[tuple[str, Callable[
                         [random.Random, float], list[NetworkEvent]]]]
                     ) -> list[NetworkEvent]:
    """Generate each component family with the shared rng (order is part of
    the scenario's determinism contract) and merge via
    :func:`repro_torch.scenarios.trace.compose_traces`."""
    traces = [Trace.from_events(pname, fn(rng, horizon), horizon=horizon)
              for pname, fn in parts]
    return compose_traces(traces, name=name, horizon=horizon).to_events()


register(ScenarioSpec(
    name="diurnal_spot_storm",
    description="diurnal WAN trough + spot preemption churn, one timeline "
                "(S1+S3 composed)",
    make_topology=lambda: hetero_cluster({"RTX4090D": 8, "V100": 8},
                                         gpus_per_node=4),
    make_events=lambda rng, horizon: _composed_events(
        rng, horizon, "diurnal_spot_storm", [
            ("diurnal_wan", lambda r, h: gen.diurnal_bandwidth(
                r, h, period=h / 2, floor=0.3, selector="ib",
                samples_per_period=5)),
            ("spot", lambda r, h: gen.spot_preemptions(
                r, list(range(16)), h, preempt_rate=4.0 / h,
                restore_mean=h / 4)),
        ]),
    tags=("S1", "S3", "bandwidth", "fail", "join", "composed"),
))

register(ScenarioSpec(
    name="congested_flaky",
    description="multi-tenant congestion bursts + link flaps on the same "
                "fabric (S1 composed, scale-mode)",
    make_topology=lambda: homogeneous_cluster(8, "V100", gpus_per_node=4),
    make_events=lambda rng, horizon: _composed_events(
        rng, horizon, "congested_flaky", [
            ("congestion", lambda r, h: gen.congestion_bursts(
                r, h, burst_rate=5.0 / h, selector="ib",
                depth_range=(0.3, 0.6),
                duration_range=(h / 20, h / 6), decay_steps=2)),
            ("flaps", lambda r, h: gen.link_degradation(
                r, h, selector="ib", rate=3.0 / h,
                severity_range=(0.25, 0.6), repair_mean=h / 8)),
        ]),
    tags=("S1", "bandwidth", "scale", "composed"),
))


def _fig6c_events(rng: random.Random,
                  horizon: float) -> list[NetworkEvent]:
    # the fig6c benchmark's two network conditions as one timeline:
    # nominal fabric, then the 0.2x low-bandwidth leg, then 4x unconstrained
    del rng  # deterministic family
    return [
        NetworkEvent(round(horizon / 3, 6), "bandwidth", factor=0.2,
                     mode="set"),
        NetworkEvent(round(2 * horizon / 3, 6), "bandwidth", factor=4.0,
                     mode="set"),
    ]


register(ScenarioSpec(
    name="fig6c_dynamic_bw",
    description="fig6c bandwidth sweep (0.2x / 4x) as a trace (S1)",
    make_topology=lambda: hetero_cluster({"V100": 8},
                                         intra_bw_map={"V100": 25e9},
                                         inter_bw=12.5e9, gpus_per_node=8),
    make_events=_fig6c_events,
    deterministic=True,
    tags=("S1", "bandwidth", "paper"),
))
