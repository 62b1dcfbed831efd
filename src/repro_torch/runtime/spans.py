"""Spans of the training loop, with the card's work on the host's clock.

``phase(obs, name, clock, **attrs)`` is the context manager the Trainer and the
train step open around each phase of a step.  It

* opens ``obs.span(name, **attrs)`` (a host span of ``repro_torch.obs``);
* while a ``torch.profiler`` records, also enters ``record_function(name)``, so the
  phase is a ``user_annotation`` range above the kernels it launched in the
  profiler's own trace;
* while ``obs`` is on and a :class:`CardClock` is given, records a timing event on
  the current stream at each end: the card's interval of the phase.

The clock reads its intervals only where the caller has synchronised
(:meth:`CardClock.synced`, and :meth:`CardClock.flush` at the end of a run), and
places each on the host clock by an anchor: an event recorded right after a
synchronisation, while the card is idle, beside ``time.perf_counter()``, so that a
card time ``e`` is host time ``h0 + e0.elapsed_time(e)``.  The anchor of one
synchronisation is read at the next, which has completed it, so placing adds no
synchronisation of its own; ``flush`` adds one, and only when intervals still wait.
Each interval is adopted into its ``obs`` as a child of its host span, with the host
span's attrs and ``lane="cuda:<index>"``: ``chrome_trace`` draws one card row under
the host rows.

With ``obs`` off and no profiler recording, ``phase`` returns the shared
``NULL_HANDLE``: it allocates nothing, records no event and adds no
synchronisation.  ``docs/observability_torch.md`` lists the spans and their attrs.
"""

from __future__ import annotations

import os
import threading
import time

import torch
from torch.autograd import profiler as _profiler

from repro_torch.obs import NULL_HANDLE, Obs


def _event():
    return torch.cuda.Event(enable_timing=True)


class CardClock:
    """The card intervals of one CUDA device's phases, waiting to be placed on the
    host clock."""

    def __init__(self, device: torch.device):
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        self.lane = f"cuda:{self.index}"
        # (obs, host span id, name, attrs, start event, end event)
        self._pending: list[tuple] = []
        self._anchor: tuple | None = None          # (event, host seconds)

    def _drop_anchor(self) -> tuple:
        ev = _event()
        ev.record(torch.cuda.current_stream(self.index))
        return ev, time.perf_counter()

    def _place(self, anchor: tuple) -> None:
        a, h0 = anchor
        pid, tid = os.getpid(), threading.get_ident()
        for obs, parent, name, attrs, ev0, ev1 in self._pending:
            obs.adopt([{"name": name, "t0": h0 + a.elapsed_time(ev0) * 1e-3,
                        "t1": h0 + a.elapsed_time(ev1) * 1e-3, "span_id": 0,
                        "parent_id": None, "pid": pid, "tid": tid,
                        "attrs": {**attrs, "lane": self.lane}}], parent)
        self._pending.clear()

    def synced(self) -> None:
        """Call right after a synchronisation, the card idle: place the waiting
        intervals by the last call's anchor and drop a new one.  With nothing
        waiting the anchor goes too: nothing is being recorded."""
        if not self._pending:
            self._anchor = None
            return
        last, self._anchor = self._anchor, self._drop_anchor()
        if last is not None:
            self._place(last)

    def flush(self) -> None:
        """End of a run: place every waiting interval, with one synchronisation."""
        if not self._pending:
            return
        if self._anchor is None:
            torch.cuda.synchronize(self.index)
            self._anchor = self._drop_anchor()
        self._anchor[0].synchronize()
        self._place(self._anchor)


class _Phase:
    __slots__ = ("obs", "name", "attrs", "clock", "span", "rf", "ev0")

    def __init__(self, obs: Obs, name: str, clock: CardClock | None, attrs: dict):
        self.obs, self.name, self.attrs, self.clock = obs, name, attrs, clock
        self.span, self.rf, self.ev0 = NULL_HANDLE, None, None

    def set(self, **attrs) -> None:
        """Attach attributes to the host span (and so to its card interval)."""
        self.span.set(**attrs)

    def __enter__(self) -> "_Phase":
        if self.obs.enabled:
            self.span = self.obs.span(self.name, **self.attrs)
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        if self.clock is not None:
            self.ev0 = _event()
            self.ev0.record()
        return self

    def __exit__(self, *exc) -> None:
        if self.clock is not None:
            ev1 = _event()
            ev1.record()
            self.clock._pending.append((self.obs, self.span.span_id, self.name,
                                        dict(self.span.span.attrs), self.ev0, ev1))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.span.__exit__(*exc)


def phase(obs: Obs, name: str, clock: CardClock | None = None, **attrs):
    """A span ``name`` with ``attrs`` over the block, and with ``obs`` on and a
    ``clock``, the card's interval of the work the block enqueued."""
    if not obs.enabled:
        if not _profiler._is_profiler_enabled:
            return NULL_HANDLE
        return _Phase(obs, name, None, attrs)
    return _Phase(obs, name, clock, attrs)
