"""Versioned JSONL trace format for cloud-scenario event timelines.

One trace = one header line + one line per :class:`NetworkEvent`, so
generated and hand-written timelines share a single on-disk representation
that diffs cleanly, streams line-by-line, and round-trips byte-identically
(``loads(dumps(t)).dumps() == t.dumps()`` — the determinism gate in
``tests/test_scenarios.py`` relies on this).

Schema (version 1)::

    {"format": "repro-scenario-trace", "version": 1, "name": ...,
     "seed": ..., "horizon": ..., "meta": {...}}
    {"t": 12.5, "kind": "bandwidth", "device_id": null, "factor": 0.4,
     "selector": "ib", "mode": "scale"}
    ...

All keys are always emitted and serialized with ``sort_keys``, so identical
event timelines produce identical bytes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable, Mapping, Sequence

from repro_torch.core import NetworkEvent

TRACE_FORMAT = "repro-scenario-trace"
TRACE_VERSION = 1


def _event_to_obj(ev: NetworkEvent) -> dict[str, Any]:
    return {"t": ev.time, "kind": ev.kind, "device_id": ev.device_id,
            "factor": ev.factor, "selector": ev.selector, "mode": ev.mode}


def _event_from_obj(obj: Mapping[str, Any]) -> NetworkEvent:
    return NetworkEvent(time=float(obj["t"]), kind=str(obj["kind"]),
                        device_id=obj.get("device_id"),
                        factor=float(obj.get("factor", 1.0)),
                        selector=obj.get("selector"),
                        mode=str(obj.get("mode", "set")))


@dataclass(frozen=True)
class Trace:
    """An immutable, named event timeline over ``[0, horizon]`` seconds."""

    name: str
    horizon: float
    events: tuple[NetworkEvent, ...]
    seed: int | None = None
    meta: tuple[tuple[str, Any], ...] = ()   # frozen key/value metadata

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(
            sorted(self.events, key=lambda e: e.time)))

    # -- views -----------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.events)

    def to_events(self) -> list[NetworkEvent]:
        return list(self.events)

    def to_step_events(self, steps: int) -> list[tuple[int, NetworkEvent]]:
        """Map event times onto a ``steps``-long training run: time ``t``
        lands on step ``floor(t / horizon * steps)`` (clamped).  This is how
        the :class:`repro_torch.runtime.trainer.Trainer` consumes a trace."""
        out = []
        for ev in self.events:
            frac = ev.time / self.horizon if self.horizon > 0 else 0.0
            step = min(steps - 1, max(0, int(frac * steps)))
            out.append((step, ev))
        return out

    def event_times(self) -> list[float]:
        """Distinct event times within the horizon, ascending."""
        seen: list[float] = []
        for ev in self.events:
            if ev.time <= self.horizon and \
                    (not seen or ev.time != seen[-1]):
                seen.append(ev.time)
        return seen

    # -- serialization ---------------------------------------------------------

    def dumps(self) -> str:
        header = {"format": TRACE_FORMAT, "version": TRACE_VERSION,
                  "name": self.name, "seed": self.seed,
                  "horizon": self.horizon, "meta": dict(self.meta)}
        lines = [json.dumps(header, sort_keys=True)]
        lines += [json.dumps(_event_to_obj(ev), sort_keys=True)
                  for ev in self.events]
        return "\n".join(lines) + "\n"

    def record(self, path: str | Path) -> Path:
        """Write the trace as JSONL; returns the path."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.dumps())
        return p

    @staticmethod
    def loads(text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty trace")
        header = json.loads(lines[0])
        if header.get("format") != TRACE_FORMAT:
            raise ValueError(f"not a scenario trace: "
                             f"format={header.get('format')!r}")
        if header.get("version") != TRACE_VERSION:
            raise ValueError(f"unsupported trace version "
                             f"{header.get('version')!r} "
                             f"(supported: {TRACE_VERSION})")
        events = tuple(_event_from_obj(json.loads(ln)) for ln in lines[1:])
        return Trace(name=str(header["name"]),
                     horizon=float(header["horizon"]),
                     events=events, seed=header.get("seed"),
                     meta=tuple(sorted(dict(header.get("meta") or {})
                                       .items())))

    @staticmethod
    def load(path: str | Path) -> "Trace":
        return Trace.loads(Path(path).read_text())

    @staticmethod
    def from_events(name: str, events: Iterable[NetworkEvent], *,
                    horizon: float | None = None, seed: int | None = None,
                    meta: Mapping[str, Any] | None = None) -> "Trace":
        evs = tuple(sorted(events, key=lambda e: e.time))
        if horizon is None:
            horizon = max((e.time for e in evs), default=0.0)
        return Trace(name=name, horizon=float(horizon), events=evs,
                     seed=seed, meta=tuple(sorted((meta or {}).items())))

    def describe(self) -> str:
        kinds: dict[str, int] = {}
        for ev in self.events:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        ks = " ".join(f"{k}x{v}" for k, v in sorted(kinds.items()))
        return (f"Trace '{self.name}': {len(self.events)} events over "
                f"{self.horizon:.0f}s ({ks}), seed={self.seed}")


def compose_traces(traces: Sequence[Trace], *, name: str | None = None,
                   horizon: float | None = None,
                   seed: int | None = None) -> Trace:
    """Merge several traces into one timeline.

    Generators return plain event lists, so composition is concatenation:
    events are merged time-sorted (ties keep input order — the sort is
    stable), the horizon defaults to the longest component's, and the
    component names are recorded in ``meta["components"]``.  Scale-mode
    events from different sources compose multiplicatively by construction
    (``NetworkEvent.mode``), which is what makes naive concatenation
    semantically sound."""
    traces = list(traces)
    if not traces:
        raise ValueError("compose_traces needs at least one trace")
    h = horizon if horizon is not None else max(t.horizon for t in traces)
    events = tuple(e for t in traces for e in t.events if e.time <= h)
    return Trace(
        name=name or "+".join(t.name for t in traces),
        horizon=float(h), events=events, seed=seed,
        meta=(("components", "|".join(t.name for t in traces)),
              ("composed", True)))
