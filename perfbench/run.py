#!/usr/bin/env python3
"""The benchmark of the port (``repro_torch``): one run of one cell.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout.  The cell, its configuration, traffic, metrics and
limits are found by name from ``BENCHMARK.json`` (``perfbench/README.md``).  Prints
earlier lines (the planner's plan, each step's loss, the step-time sample count,
launch counts), then, as the last lines of standard error, each compared number
beside its limit, and as the last line of standard output one JSON object: the
result.  Exits 2 and prints no result when the cell's CUDA devices are missing, 3
when a module of JAX or of the JAX package was loaded.  A record of the run goes to
``bench_out/<cell>/`` in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")

from harness import spec  # noqa: E402

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    try:
        pieces = spec.resolve(spec.benchmark(ROOT), args.workload)
        out, run = spec.runner(pieces["traffic"]).run(
            **pieces, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
            t_start=T_START)
    except spec.NoDevice as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    found = loaded_forbidden()
    if found:
        print(f"perfbench: modules of JAX or of the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    record = ROOT / "bench_out" / args.workload
    record.mkdir(parents=True, exist_ok=True)
    name = f"seed{args.seed}_trace{args.trace}.json"
    (record / name).write_text(json.dumps(
        {"result": out, "step_s": run.step_s, "window_s": run.window_s,
         "setup_s": run.setup_s, "plan_s": run.plan_s, **run.extra}, indent=1))
    print(f"perfbench: record in {record / name}")
    for key, c in out["checks"].items():
        print(f"{key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
