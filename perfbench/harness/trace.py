"""Reading a ``torch.profiler`` trace of whole training steps.

The profiler's Chrome trace is parsed for three kinds of event: the device's
operations (kernels, copies, fills), the host's calls that launched them (linked by
their correlation id), and the host's operators (``cpu_op``).  The traced window is
the span of a ``record_function`` range the harness opens around the traced steps;
in a trace of the device alone, which has no such range, it runs from the first
device operation (a marker the harness launches after a synchronise) to the start of
the last (a marker launched after the steps' own synchronise), neither counted.
From them: each device operation with its time, the device's busy time as the union
of the operations' intervals (overlapping operations are counted once), and every
idle gap between them, named by the innermost host operator that was running when
the operation after the gap was launched.
"""

from __future__ import annotations

import bisect
import json
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """Times in seconds.  ``ops``: (name, start, duration, is a kernel) of every
    device operation in the window; ``gaps``: (host operator, seconds) of every
    idle stretch in it."""
    window_s: float
    steps: int
    ops: list[tuple[str, float, float, bool]] = field(default_factory=list)
    gaps: list[tuple[str, float]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.ops))

    def kernels(self) -> list[tuple[str, float]]:
        return [(name, dur) for name, _, dur, kernel in self.ops if kernel]


def _union(ops) -> list[tuple[float, float]]:
    spans: list[list[float]] = []
    for _, start, dur, _ in sorted(ops, key=lambda o: o[1]):
        end = start + dur
        if spans and start <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], end)
        else:
            spans.append([start, end])
    return [(a, b) for a, b in spans]


def _innermost(ops_sorted, starts, t: float) -> str:
    """The innermost host operator running at ``t`` (the latest-starting one that
    covers it)."""
    i = bisect.bisect_right(starts, t) - 1
    best = None
    # host operators nest, so walk back over those that started before t
    for j in range(i, max(i - 512, -1), -1):
        ts, end, name = ops_sorted[j]
        if end >= t:
            best = name
            break
    return best or "(no host operator)"


def read(prof, steps: int) -> Trace:
    """Export ``prof``'s trace to a temporary file, read it, delete it."""
    with tempfile.TemporaryDirectory(prefix="perfbench_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return parse(events, steps)


def parse(events: list[dict], steps: int) -> Trace:
    windows = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
               and e.get("cat") != "gpu_user_annotation"]
    if windows:
        w0 = float(windows[0]["ts"])
        w1 = w0 + float(windows[0]["dur"])
    else:
        marks = sorted(float(e["ts"]) for e in events
                       if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
        if len(marks) < 2:
            raise ValueError(f"the trace has no {WINDOW!r} range and no markers")
        first = min((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                    key=lambda e: float(e["ts"]))
        w0 = float(first["ts"]) + float(first.get("dur", 0.0))
        w1 = marks[-1]
    device, launch, host = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            if w0 <= ts < w1:
                device.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = ts
        elif cat == "cpu_op":
            host.append((ts, ts + dur, e["name"]))
    host.sort()
    starts = [h[0] for h in host]
    device.sort(key=lambda e: float(e["ts"]))
    trace = Trace(window_s=(w1 - w0) * 1e-6, steps=steps)
    covered = w0
    for e in device:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        trace.ops.append((e["name"], ts * 1e-6, dur * 1e-6, e["cat"] == "kernel"))
        if ts > covered:
            at = launch.get(e.get("args", {}).get("correlation"))
            name = _innermost(host, starts, at) if at is not None else "(no launch found)"
            trace.gaps.append((name, (ts - covered) * 1e-6))
        covered = max(covered, ts + dur)
    if w1 > covered:
        trace.gaps.append(("(after the last operation)", (w1 - covered) * 1e-6))
    return trace


def top(pairs, n: int = 10) -> list[list]:
    """The ``n`` names with the most seconds, summed by name, as [name, seconds]."""
    sums: dict[str, float] = {}
    for name, seconds in pairs:
        sums[name] = sums.get(name, 0.0) + seconds
    return [[name[:160], s] for name, s in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def ms_per_step(trace: Trace, match, skip) -> float:
    """Device ms a step of the kernels whose lowercased name holds a piece of
    ``match`` and none of ``skip``; None where no kernel's does."""
    total, found = 0.0, False
    for name, seconds in trace.kernels():
        low = name.lower()
        if any(p in low for p in match) and not any(p in low for p in skip):
            total += seconds
            found = True
    return total * 1e3 / trace.steps if found else None
