"""Exporters: Chrome-trace/Perfetto JSON, JSONL event log, metrics files.

The Chrome trace format (``{"traceEvents": [...]}``) loads directly in
Perfetto (https://ui.perfetto.dev) and ``chrome://tracing``: each span
becomes one complete ``"ph": "X"`` event with microsecond timestamps, and
events keep their originating process id, so spans adopted from
:class:`repro_torch.core.search.SearchExecutor` workers render as one lane per
worker process under the parent's timeline.  Extra top-level keys are
allowed by the format, so the metrics snapshot rides along under
``"reproMetrics"`` — one self-contained file per traced run that
:mod:`tools.trace_report` can summarize without a second artifact.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import TYPE_CHECKING

if TYPE_CHECKING:                              # pragma: no cover
    from . import Obs

# Key the metrics snapshot is embedded under in the combined trace file.
METRICS_KEY = "reproMetrics"


# Base tid for named lanes — far above any real thread id so the synthetic
# rows never collide with OS thread lanes in the same process group.
_LANE_TID_BASE = 1_000_000


def chrome_trace(obs: "Obs") -> dict:
    """The combined Chrome-trace/Perfetto document for ``obs``:
    ``traceEvents`` (one ``X`` event per finished span, µs timestamps,
    span/parent ids in ``args``) plus the metrics snapshot under
    :data:`METRICS_KEY`.

    Spans carrying a ``lane`` attribute (e.g. the planner service's
    per-job ``service.replan`` spans, ``lane=<job name>``) are grouped
    onto one synthetic named row per distinct lane value instead of their
    OS thread id — a ``thread_name`` metadata event labels each row, so
    Perfetto shows one timeline per job regardless of which worker thread
    ran the replan."""
    events = []
    lanes: dict[tuple[int, str], int] = {}       # (pid, lane) -> tid
    for s in obs.tracer.spans:
        if s.t1 is None:
            continue
        tid = s.tid
        lane = s.attrs.get("lane")
        if lane is not None:
            key = (s.pid, str(lane))
            tid = lanes.get(key)
            if tid is None:                       # first-seen order, stable
                tid = _LANE_TID_BASE + len(lanes)
                lanes[key] = tid
                events.append({
                    "ph": "M", "name": "thread_name", "pid": s.pid,
                    "tid": tid, "args": {"name": str(lane)},
                })
        events.append({
            "ph": "X", "name": s.name,
            "ts": s.t0 * 1e6, "dur": (s.t1 - s.t0) * 1e6,
            "pid": s.pid, "tid": tid,
            "args": {"span_id": s.span_id, "parent_id": s.parent_id,
                     **s.attrs},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            METRICS_KEY: obs.metrics.snapshot()}


def write_trace(obs: "Obs", path: str | Path) -> Path:
    """Write the combined Perfetto trace + metrics file; returns the path."""
    p = Path(path)
    if p.parent != Path("."):
        p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(chrome_trace(obs), sort_keys=True))
    return p


def write_jsonl(obs: "Obs", path: str | Path) -> Path:
    """Write the structured event log: one JSON object per line — every
    finished span (``{"kind": "span", ...}``) followed by one final
    ``{"kind": "metrics", ...}`` snapshot record."""
    p = Path(path)
    if p.parent != Path("."):
        p.parent.mkdir(parents=True, exist_ok=True)
    lines = [json.dumps({"kind": "span", **s.to_dict()})
             for s in obs.tracer.spans]
    lines.append(json.dumps({"kind": "metrics",
                             "metrics": obs.metrics.snapshot()}))
    p.write_text("\n".join(lines) + "\n")
    return p


def write_metrics(obs: "Obs", path: str | Path) -> Path:
    """Write the metrics snapshot alone (the CI artifact next to the
    trace); returns the path."""
    p = Path(path)
    if p.parent != Path("."):
        p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(obs.metrics.snapshot(), indent=2,
                            sort_keys=True))
    return p
