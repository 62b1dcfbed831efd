"""Bounded admission queue: priority + FIFO tie-break, twin bucketing,
backpressure.

The service cannot plan an unbounded backlog — a full queue *rejects* new
submissions (backpressure: the caller sees the rejection immediately
instead of queueing into an ever-growing latency tail).  Queued specs pop
in ``(-priority, arrival order)`` order, and :meth:`AdmissionQueue.pop_bucket`
additionally drains every queued spec whose :meth:`~repro_torch.service.jobs.
JobSpec.signature` matches the head — isomorphic twins admitted in one
round share a single cold search (the tensor2tensor batching idiom of
bucketing same-shaped work, applied to plan searches instead of examples).
"""

from __future__ import annotations

import heapq
import threading

from .jobs import JobSpec


class AdmissionQueue:
    """Bounded priority queue of :class:`~repro_torch.service.jobs.JobSpec`.

    ``capacity`` bounds the backlog; :meth:`offer` returns ``False`` (and
    counts a rejection) when full.  Pop order is highest ``priority``
    first, FIFO within a priority level (a monotone sequence number breaks
    ties, so two equal-priority twins pop in submission order —
    deterministic across replays).  Thread-safe.
    """

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self.rejected = 0
        self._heap: list[tuple[int, int, JobSpec]] = []
        self._seq = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def depth(self) -> int:
        """Current backlog size (the ``service.queue_depth`` metric)."""
        return len(self._heap)

    def offer(self, spec: JobSpec) -> bool:
        """Enqueue ``spec``; ``False`` = queue full, spec rejected
        (backpressure — the service never buffers past ``capacity``)."""
        with self._lock:
            if len(self._heap) >= self.capacity:
                self.rejected += 1
                return False
            heapq.heappush(self._heap, (-spec.priority, self._seq, spec))
            self._seq += 1
            return True

    def peek(self) -> JobSpec | None:
        """The spec :meth:`pop` would return, without removing it."""
        with self._lock:
            return self._heap[0][2] if self._heap else None

    def pop(self) -> JobSpec | None:
        """Highest-priority (FIFO within level) spec, or ``None``."""
        with self._lock:
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def pop_bucket(self) -> tuple[JobSpec, list[JobSpec]]:
        """Pop the head plus every queued twin (equal ``signature()``).

        Returns ``(head, twins)``; the twins keep their pop order.  The
        service admits the whole bucket in one round so the head's cold
        search is the only one — each twin's plan is a shared-cache remap.
        Raises ``IndexError`` on an empty queue.
        """
        with self._lock:
            if not self._heap:
                raise IndexError("pop_bucket on empty AdmissionQueue")
            neg_pri, seq, head = heapq.heappop(self._heap)
            sig = head.signature()
            twins: list[tuple[int, int, JobSpec]] = []
            keep: list[tuple[int, int, JobSpec]] = []
            for item in self._heap:
                (twins if item[2].signature() == sig else keep).append(item)
            twins.sort()
            self._heap = keep
            heapq.heapify(self._heap)
            return head, [t[2] for t in twins]
