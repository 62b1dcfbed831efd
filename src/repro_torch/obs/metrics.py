"""Metrics registry: named counters + fixed-bucket histograms.

The registry is the single tally point for the repo's scattered hand-rolled
counters: the search cascade's per-tier prune counts, the strategy cache's
hit/miss pair, and the re-planning engine's per-path latency all flow
through one :class:`MetricsRegistry` when observability is enabled (see
:mod:`repro_torch.obs`).  Everything here is stdlib-only and cheap enough to sit
on hot paths — a counter increment is one dict lookup + int add under a
lock, and histograms keep a bounded raw-sample reservoir so percentile
queries stay exact for the sample counts the planner actually produces.

Percentile math matches :func:`statistics.quantiles` with
``method="inclusive"`` (linear interpolation between closest ranks), so the
numbers :mod:`tools.trace_report` prints agree with what a user would
compute from the raw samples.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_right, insort
from typing import Mapping, Sequence

# Default histogram bucket upper bounds (seconds): spans replan latencies
# from sub-millisecond warm re-scores to multi-minute fleet searches.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

# Raw-sample reservoir cap per histogram.  The planner's per-search sample
# counts (replans per scenario, intervals per trace) sit far below this, so
# percentiles are exact in practice; past the cap the earliest samples are
# kept (deterministic, unlike random reservoir sampling).
RESERVOIR_CAP = 4096


class Counter:
    """A monotonically increasing named counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        """Add ``n`` (default 1) to the counter."""
        self.value += n


class Histogram:
    """Fixed-bucket histogram with an exact bounded sample reservoir.

    ``bucket_counts[i]`` counts observations ``<= bounds[i]``; the final
    slot counts overflows.  ``count``/``total``/``min``/``max`` are exact
    over every observation; percentiles interpolate over the (sorted)
    reservoir, which is exact until :data:`RESERVOIR_CAP` observations.
    """

    __slots__ = ("name", "bounds", "bucket_counts", "count", "total",
                 "min", "max", "_samples")

    def __init__(self, name: str,
                 bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.bounds = tuple(bounds)
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: list[float] = []        # kept sorted (insort)

    def observe(self, value: float) -> None:
        """Record one observation."""
        self.bucket_counts[bisect_right(self.bounds, value)] += 1
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if len(self._samples) < RESERVOIR_CAP:
            insort(self._samples, value)

    @property
    def mean(self) -> float:
        """Arithmetic mean of every observation (NaN when empty)."""
        return self.total / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """The ``q``-th percentile (``0 <= q <= 100``) over the reservoir.

        Uses the same inclusive linear interpolation as
        ``statistics.quantiles(samples, n=100, method="inclusive")``:
        rank ``(n - 1) * q / 100`` between sorted closest samples.
        """
        s = self._samples
        if not s:
            return math.nan
        if len(s) == 1:
            return s[0]
        rank = (len(s) - 1) * (q / 100.0)
        lo = math.floor(rank)
        hi = min(lo + 1, len(s) - 1)
        frac = rank - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac

    def to_dict(self) -> dict:
        """Snapshot as a plain-JSON dict (see ``MetricsRegistry.snapshot``)."""
        return {
            "type": "histogram", "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean if self.count else None,
            "p50": self.percentile(50) if self.count else None,
            "p95": self.percentile(95) if self.count else None,
            "p99": self.percentile(99) if self.count else None,
            "bounds": list(self.bounds),
            "bucket_counts": list(self.bucket_counts),
            "samples": list(self._samples),
        }

    def merge_dict(self, d: Mapping) -> None:
        """Fold a ``to_dict`` snapshot (same bounds) into this histogram."""
        if tuple(d.get("bounds", ())) != self.bounds:
            raise ValueError(
                f"histogram {self.name}: bucket bounds mismatch on merge")
        for i, c in enumerate(d.get("bucket_counts", ())):
            self.bucket_counts[i] += c
        self.count += d.get("count", 0)
        self.total += d.get("sum", 0.0)
        if d.get("min") is not None and d["min"] < self.min:
            self.min = d["min"]
        if d.get("max") is not None and d["max"] > self.max:
            self.max = d["max"]
        for v in d.get("samples", ()):
            if len(self._samples) >= RESERVOIR_CAP:
                break
            insort(self._samples, v)


class MetricsRegistry:
    """Named counters + histograms with snapshot/merge for worker shipping.

    Thread-safe; picklable (the lock is dropped and re-created, the same
    treatment :class:`repro_torch.obs.Obs` gets so a harness config holding one
    can ship to spawn workers).
    """

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    # -- pickling (drop the lock) -------------------------------------------

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------------

    def counter(self, name: str) -> Counter:
        """Get or create the counter ``name``."""
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        """Get or create the histogram ``name``."""
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name, bounds))
        return h

    def inc(self, name: str, n: int = 1) -> None:
        """Increment counter ``name`` by ``n``."""
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters.setdefault(name, Counter(name))
            c.value += n

    def observe(self, name: str, value: float) -> None:
        """Record ``value`` into histogram ``name``."""
        self.histogram(name).observe(value)

    # -- reading / shipping ---------------------------------------------------

    def counter_value(self, name: str) -> int:
        """Current value of counter ``name`` (0 when absent)."""
        c = self._counters.get(name)
        return c.value if c is not None else 0

    def counters_with_prefix(self, prefix: str) -> dict[str, int]:
        """``{name: value}`` for every counter whose name starts with
        ``prefix`` — how callers take before/after deltas on a shared
        registry (e.g. the harness's per-scenario replan-path counts)."""
        with self._lock:
            return {n: c.value for n, c in self._counters.items()
                    if n.startswith(prefix)}

    def snapshot(self) -> dict:
        """Plain-JSON view of every metric: counters as ints, histograms
        as their ``to_dict`` summaries.  This is the metrics exporter."""
        with self._lock:
            out: dict = {n: c.value for n, c in self._counters.items()}
            for n, h in self._histograms.items():
                out[n] = h.to_dict()
        return out

    def merge(self, snap: Mapping) -> None:
        """Fold a ``snapshot()`` (e.g. shipped back from a search worker)
        into this registry."""
        for name, val in snap.items():
            if isinstance(val, Mapping) and val.get("type") == "histogram":
                self.histogram(name, val.get("bounds", DEFAULT_BUCKETS)) \
                    .merge_dict(val)
            else:
                self.inc(name, int(val))
