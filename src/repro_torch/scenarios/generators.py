"""Seeded stochastic generators for cloud scenario families (paper §2.2).

Each generator turns a ``random.Random`` (stdlib — deterministic across
platforms) plus shape parameters into a sorted list of
:class:`repro_torch.core.NetworkEvent`, composable into one timeline.  Families:

  * :func:`spot_preemptions`       — spot-instance preemption/rejoin churn
                                     via Poisson arrivals (S3 fail/join).
  * :func:`diurnal_bandwidth`      — day/night WAN bandwidth curve, sampled
                                     into absolute ``mode="set"`` levels (S1).
  * :func:`congestion_bursts`      — multi-tenant congestion bursts with
                                     staged decay; overlapping bursts compose
                                     multiplicatively (``mode="scale"``) (S1).
  * :func:`straggler_churn`        — devices degrade and recover; overlapping
                                     slowdowns on one device compose (S2).
  * :func:`link_degradation`       — cross-region (dci/ib) link flaps:
                                     degrade, then repair (S1).

Event *times* are rounded to 6 decimals for readable traces; *scale-mode
factor pairs* are kept at full precision so a burst's reciprocal recovery
restores the previous level exactly (rounding one side of the pair would
make levels drift across long multi-burst traces).
"""

from __future__ import annotations

import math
import random
from typing import Sequence

from repro_torch.core import NetworkEvent


def _poisson_times(rng: random.Random, rate: float,
                   horizon: float) -> list[float]:
    """Poisson arrival times in (0, horizon) at ``rate`` events/second."""
    times: list[float] = []
    t = 0.0
    if rate <= 0:
        return times
    while True:
        t += rng.expovariate(rate)
        if t >= horizon:
            return times
        times.append(t)


def _r(x: float) -> float:
    return round(x, 6)


# ---------------------------------------------------------------------------
# S3: spot-instance preemption / rejoin
# ---------------------------------------------------------------------------


def spot_preemptions(rng: random.Random, device_ids: Sequence[int],
                     horizon: float, *, preempt_rate: float,
                     restore_mean: float,
                     min_alive_frac: float = 0.5) -> list[NetworkEvent]:
    """Poisson preemption arrivals; each preempted device rejoins after an
    exponential restore delay.  Never preempts below ``min_alive_frac`` of
    the fleet (a spot pool retains a reserved core)."""
    ids = list(device_ids)
    min_alive = max(1, math.ceil(len(ids) * min_alive_frac))
    events: list[NetworkEvent] = []
    # (rejoin_time, device) for devices currently out
    out: list[tuple[float, int]] = []
    for t in _poisson_times(rng, preempt_rate, horizon):
        out = [(rt, d) for rt, d in out if rt > t]
        alive = [d for d in ids if d not in {d for _, d in out}]
        if len(alive) <= min_alive:
            continue
        victim = rng.choice(alive)
        events.append(NetworkEvent(_r(t), "fail", device_id=victim))
        back = t + rng.expovariate(1.0 / restore_mean)
        if back < horizon:
            events.append(NetworkEvent(_r(back), "join", device_id=victim,
                                       factor=1.0))
            out.append((back, victim))
        else:
            out.append((math.inf, victim))
    return sorted(events, key=lambda e: e.time)


# ---------------------------------------------------------------------------
# S1: diurnal WAN bandwidth fluctuation
# ---------------------------------------------------------------------------


def diurnal_bandwidth(rng: random.Random, horizon: float, *,
                      period: float, floor: float = 0.3,
                      selector: str | None = "ib",
                      samples_per_period: int = 8,
                      jitter: float = 0.05) -> list[NetworkEvent]:
    """Sampled day/night curve: the link level swings between 1.0 (off-peak)
    and ``floor`` (peak) on a cosine of ``period`` seconds, with
    multiplicative noise.  Each sample is an absolute ``mode="set"`` level —
    a single-source condition, so absolute-set is the documented semantics
    here (composition with *other* sources belongs in scale-mode events)."""
    events: list[NetworkEvent] = []
    n = max(1, int(horizon / period * samples_per_period))
    dt = horizon / (n + 1)
    for i in range(1, n + 1):
        t = i * dt
        phase = 2 * math.pi * t / period
        level = floor + (1.0 - floor) * (0.5 + 0.5 * math.cos(phase))
        level *= 1.0 + jitter * rng.uniform(-1.0, 1.0)
        events.append(NetworkEvent(_r(t), "bandwidth",
                                   factor=_r(max(0.05, level)),
                                   selector=selector, mode="set"))
    return events


# ---------------------------------------------------------------------------
# S1: multi-tenant congestion bursts with overlapping decay
# ---------------------------------------------------------------------------


def congestion_bursts(rng: random.Random, horizon: float, *,
                      burst_rate: float, selector: str | None = "ib",
                      depth_range: tuple[float, float] = (0.3, 0.7),
                      duration_range: tuple[float, float] = (20.0, 90.0),
                      decay_steps: int = 2) -> list[NetworkEvent]:
    """Each burst multiplies the link level by ``1 - depth`` at onset, then
    recovers in ``decay_steps`` equal multiplicative steps spread over its
    duration, so the net effect of a completed burst is exactly 1.0 and
    *overlapping* bursts from different tenants compose — this is the family
    that requires ``mode="scale"`` semantics."""
    events: list[NetworkEvent] = []
    for t in _poisson_times(rng, burst_rate, horizon):
        depth = rng.uniform(*depth_range)
        dur = rng.uniform(*duration_range)
        onset = 1.0 - depth
        events.append(NetworkEvent(_r(t), "bandwidth", factor=onset,
                                   selector=selector, mode="scale"))
        step = (1.0 / onset) ** (1.0 / decay_steps)
        for k in range(1, decay_steps + 1):
            tk = t + dur * k / decay_steps
            if tk >= horizon:
                break
            events.append(NetworkEvent(_r(tk), "bandwidth", factor=step,
                                       selector=selector, mode="scale"))
    return sorted(events, key=lambda e: e.time)


# ---------------------------------------------------------------------------
# S2: straggler churn
# ---------------------------------------------------------------------------


def straggler_churn(rng: random.Random, device_ids: Sequence[int],
                    horizon: float, *, rate: float,
                    slow_range: tuple[float, float] = (0.3, 0.7),
                    recover_mean: float = 60.0) -> list[NetworkEvent]:
    """Poisson straggler onsets: a device's perf is multiplied by a slowdown
    factor, then restored by the reciprocal after an exponential recovery
    delay.  Scale-mode keeps overlapping slowdowns on one device honest."""
    ids = list(device_ids)
    events: list[NetworkEvent] = []
    for t in _poisson_times(rng, rate, horizon):
        dev = rng.choice(ids)
        s = rng.uniform(*slow_range)
        events.append(NetworkEvent(_r(t), "slowdown", device_id=dev,
                                   factor=s, mode="scale"))
        back = t + rng.expovariate(1.0 / recover_mean)
        if back < horizon:
            events.append(NetworkEvent(_r(back), "slowdown", device_id=dev,
                                       factor=1.0 / s, mode="scale"))
    return sorted(events, key=lambda e: e.time)


# ---------------------------------------------------------------------------
# S1: cross-region link degradation (dci / ib flaps)
# ---------------------------------------------------------------------------


def link_degradation(rng: random.Random, horizon: float, *,
                     selector: str = "dci", rate: float,
                     severity_range: tuple[float, float] = (0.1, 0.5),
                     repair_mean: float = 90.0) -> list[NetworkEvent]:
    """Cross-region links flap: degrade to ``severity`` of nominal, repair
    after an exponential delay (scale-mode pair, so concurrent flaps on the
    same selector compose instead of clobbering)."""
    events: list[NetworkEvent] = []
    for t in _poisson_times(rng, rate, horizon):
        sev = rng.uniform(*severity_range)
        events.append(NetworkEvent(_r(t), "bandwidth", factor=sev,
                                   selector=selector, mode="scale"))
        back = t + rng.expovariate(1.0 / repair_mean)
        if back < horizon:
            events.append(NetworkEvent(_r(back), "bandwidth",
                                       factor=1.0 / sev,
                                       selector=selector, mode="scale"))
    return sorted(events, key=lambda e: e.time)
