"""Span tracer: nested monotonic-clock spans, thread- and worker-safe.

A :class:`Span` is one timed region (``perf_counter`` start/end) with a
name, free-form attributes, and a parent link; a :class:`Tracer` maintains
a per-thread span stack so ``with tracer.span("search.tier3")`` nests
correctly under whatever span the calling thread currently has open.

Spawn-worker spans cannot share the parent's tracer, so workers trace into
their own local tracer, export with :meth:`Tracer.span_dicts`, ship the
dicts back with their result payload, and the parent **re-parents** them
under the span that enqueued the work (:meth:`Tracer.adopt`) — worker span
ids are remapped into the parent's id space, worker pids are preserved so
exporters can draw one lane per worker process.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence


@dataclass
class Span:
    """One finished (or open) timed region."""

    name: str
    t0: float                                  # perf_counter seconds
    span_id: int
    parent_id: int | None
    pid: int
    tid: int
    t1: float | None = None                    # None while open
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        """Span length in seconds (0.0 while still open)."""
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def to_dict(self) -> dict:
        """Plain-JSON form (the worker shipping + JSONL event format)."""
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "pid": self.pid, "tid": self.tid, "attrs": self.attrs}


class _SpanHandle:
    """Context manager returned by :meth:`Tracer.span`; exposes the live
    span so callers can attach attributes discovered mid-region
    (``handle.set(simulated=12)``)."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    @property
    def span_id(self) -> int:
        """Id of the underlying span (parent for adopted worker spans)."""
        return self.span.span_id

    def set(self, **attrs) -> None:
        """Attach/overwrite attributes on the live span."""
        self.span.attrs.update(attrs)

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._close(self.span)


class _NullHandle:
    """Shared no-op stand-in for :class:`_SpanHandle` when tracing is off:
    allocates nothing, records nothing."""

    __slots__ = ()
    span_id = None

    def set(self, **attrs) -> None:
        """No-op."""

    def __enter__(self) -> "_NullHandle":
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_HANDLE = _NullHandle()


class Tracer:
    """Collects finished spans; one per :class:`repro_torch.obs.Obs` bundle."""

    def __init__(self) -> None:
        self._spans: list[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    # -- pickling (drop lock + thread-local; spans survive) -------------------

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        del state["_local"], state["_lock"]
        state["_next_id"] = next(self._ids)
        del state["_ids"]
        return state

    def __setstate__(self, state: dict) -> None:
        nxt = state.pop("_next_id")
        self.__dict__.update(state)
        self._ids = itertools.count(nxt)
        self._local = threading.local()
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------------

    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs) -> _SpanHandle:
        """Open a nested span; use as a context manager."""
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        with self._lock:
            sid = next(self._ids)
        sp = Span(name=name, t0=time.perf_counter(), span_id=sid,
                  parent_id=parent, pid=os.getpid(),
                  tid=threading.get_ident(), attrs=dict(attrs))
        stack.append(sp)
        return _SpanHandle(self, sp)

    def _close(self, span: Span) -> None:
        span.t1 = time.perf_counter()
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        else:                                   # mis-nested exit: best effort
            try:
                stack.remove(span)
            except ValueError:
                pass
        with self._lock:
            self._spans.append(span)

    def current_span_id(self) -> int | None:
        """Id of the calling thread's innermost open span (None at root)."""
        stack = self._stack()
        return stack[-1].span_id if stack else None

    # -- reading / shipping ---------------------------------------------------

    @property
    def spans(self) -> list[Span]:
        """All finished spans, in close order."""
        with self._lock:
            return list(self._spans)

    def span_dicts(self) -> list[dict]:
        """Finished spans as plain dicts (the worker shipping format)."""
        return [s.to_dict() for s in self.spans]

    def adopt(self, span_dicts: Sequence[Mapping],
              parent_id: int | None) -> None:
        """Re-parent shipped worker spans under ``parent_id``.

        Worker span ids are remapped into this tracer's id space (two
        workers may both have used id 1); spans that were roots in the
        worker get ``parent_id`` as their parent; worker pids/tids are kept
        so the Perfetto export draws one lane per worker process.
        """
        remap: dict[int, int] = {}
        with self._lock:
            for d in span_dicts:
                remap[d["span_id"]] = next(self._ids)
            for d in span_dicts:
                wparent = d.get("parent_id")
                self._spans.append(Span(
                    name=d["name"], t0=d["t0"], t1=d["t1"],
                    span_id=remap[d["span_id"]],
                    parent_id=remap.get(wparent, parent_id)
                    if wparent is not None else parent_id,
                    pid=d["pid"], tid=d["tid"],
                    attrs=dict(d.get("attrs", {}))))

    def clear(self) -> None:
        """Drop every finished span (open spans are unaffected)."""
        with self._lock:
            self._spans.clear()
