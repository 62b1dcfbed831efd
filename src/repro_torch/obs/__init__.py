"""``repro_torch.obs`` — unified tracing + metrics for the planner stack.

A zero-dependency telemetry layer with two halves:

* a **span tracer** (:mod:`repro_torch.obs.tracer`): ``with obs.span("search.tier3",
  n_tasks=40):`` records monotonic-clock nested spans, thread-safe, and
  spawn-worker-safe — :class:`repro_torch.core.search.SearchExecutor` workers
  trace locally, ship span dicts back with their result payload, and the
  parent re-parents them under the enqueuing span;
* a **metrics registry** (:mod:`repro_torch.obs.metrics`): named counters
  (``cache.hit``, ``search.pruned.coarse``, ``replan.path.*``) and
  fixed-bucket histograms (``replan.latency_s``) that absorb the repo's
  previously hand-rolled accounting.

The :class:`Obs` bundle ties the two together and is what every
instrumented entry point accepts (``plan_hybrid(obs=...)``,
``ReplanEngine(obs=...)``, ``HarnessConfig.obs``).  **Off by default** with
near-zero disabled overhead: the module-level :data:`NULL_OBS` singleton
answers every call with shared no-op objects — no span allocation, no
counter writes.  Set ``REPRO_TRACE=/path/trace.json`` to enable the
process-wide default and dump a combined Perfetto trace + metrics file at
exit; see ``docs/observability.md`` for the span/metric taxonomy and
``tools/trace_report.py`` for the CLI summarizer.
"""

from __future__ import annotations

import atexit
import os

from .export import (METRICS_KEY, chrome_trace, write_jsonl,  # noqa: F401
                     write_metrics, write_trace)
from .metrics import (DEFAULT_BUCKETS, Counter, Histogram,  # noqa: F401
                      MetricsRegistry)
from .tracer import NULL_HANDLE, Span, Tracer, _NullHandle  # noqa: F401

__all__ = [
    "Obs", "NULL_OBS", "resolve_obs", "default_obs",
    "Tracer", "Span", "MetricsRegistry", "Counter", "Histogram",
    "chrome_trace", "write_trace", "write_jsonl", "write_metrics",
    "METRICS_KEY", "DEFAULT_BUCKETS",
]


class Obs:
    """Tracer + metrics bundle — the handle instrumented code passes down.

    ``enabled=False`` turns every operation into a no-op that allocates
    nothing (use the shared :data:`NULL_OBS` instead of constructing one).
    Picklable: locks/thread-locals are dropped and re-created, so a frozen
    :class:`repro_torch.scenarios.harness.HarnessConfig` holding one ships to
    spawn workers (each worker records into its own copy).
    """

    __slots__ = ("enabled", "tracer", "metrics")

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.tracer = Tracer() if enabled else None
        self.metrics = MetricsRegistry() if enabled else None

    # -- pickling --------------------------------------------------------------

    def __getstate__(self) -> dict:
        return {"enabled": self.enabled, "tracer": self.tracer,
                "metrics": self.metrics}

    def __setstate__(self, state: dict) -> None:
        self.enabled = state["enabled"]
        self.tracer = state["tracer"]
        self.metrics = state["metrics"]

    # -- recording -------------------------------------------------------------

    def span(self, name: str, **attrs):
        """Open a nested span context manager (shared no-op when
        disabled)."""
        if not self.enabled:
            return NULL_HANDLE
        return self.tracer.span(name, **attrs)

    def inc(self, name: str, n: int = 1) -> None:
        """Increment counter ``name`` by ``n`` (no-op when disabled)."""
        if self.enabled and n:
            self.metrics.inc(name, n)

    def observe(self, name: str, value: float) -> None:
        """Record ``value`` into histogram ``name`` (no-op when
        disabled)."""
        if self.enabled:
            self.metrics.observe(name, value)

    def current_span_id(self):
        """Innermost open span id on this thread (None when disabled or at
        root) — the parent id worker spans are adopted under."""
        if not self.enabled:
            return None
        return self.tracer.current_span_id()

    def adopt(self, span_dicts, parent_id, metrics_snapshot=None) -> None:
        """Fold a worker's shipped telemetry into this bundle: re-parent
        its spans under ``parent_id`` and merge its metrics snapshot."""
        if not self.enabled:
            return
        if span_dicts:
            self.tracer.adopt(span_dicts, parent_id)
        if metrics_snapshot:
            self.metrics.merge(metrics_snapshot)

    def export_delta(self) -> tuple[list[dict], dict] | None:
        """(span dicts, metrics snapshot) for shipping across a process
        boundary; None when disabled (nothing to ship)."""
        if not self.enabled:
            return None
        return self.tracer.span_dicts(), self.metrics.snapshot()


NULL_OBS = Obs(enabled=False)

_DEFAULT: Obs | None = None


def default_obs() -> Obs:
    """The process-wide default bundle: enabled iff the ``REPRO_TRACE``
    environment variable is set (its value is the trace output path,
    written at interpreter exit); :data:`NULL_OBS` otherwise."""
    global _DEFAULT
    if _DEFAULT is None:
        path = os.environ.get("REPRO_TRACE", "")
        if path:
            _DEFAULT = Obs(enabled=True)
            atexit.register(write_trace, _DEFAULT, path)
        else:
            _DEFAULT = NULL_OBS
    return _DEFAULT


def resolve_obs(obs: "Obs | None") -> Obs:
    """The bundle instrumented code should record into: an explicit ``obs``
    wins, otherwise the ``REPRO_TRACE``-driven process default."""
    return obs if obs is not None else default_obs()
