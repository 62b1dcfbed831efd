#!/usr/bin/env python3
"""Readings that the limits of a training cell's check are set from (needs the
cell's chips; not run by the benchmark's runs).

For each seed: the program's first ``check_steps`` steps through the Trainer at the
cell's own size, then the configuration's float32 reference on the same weights and
batches, and every number of ``harness.compare`` between them, ``grad_proj_gap``
among them (the lower readings).  For the first ``--control-seeds`` seeds also, each
of these put in the program's place and compared with the same reference (the upper
readings):

* ``control``: the reference with every tensor the program holds in bfloat16 held in
  float8 (e4m3 forward, e5m2 backward), the precision below the configuration's;
* ``bfloat16``: the same rounding to bfloat16, the configuration's own precision: a
  second witness of what the program's rounding alone gives (not an upper reading);
* ``half_batch``: the first half of each batch's rows, the mean over them;
* ``labels``: labels altered where the feed makes them (each label the token it
  follows, the shift left out);
* ``double``: one parameter's update applied twice.

(A step that returns its state unchanged reads 1 by ``change_gap``'s measure and
needs no run.)  One JSON line a reading, to standard output and to ``--out``:

    python3 perfbench/calibrate.py --workload train.qwen2_7b_l8.b2s4096 \\
        --seeds 12 --control-seeds 3 --out calibrate.jsonl
"""

import argparse
import gc
import json
import math
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]

import torch  # noqa: E402

from harness import compare, feed, reference, spec, train_cell, weights  # noqa: E402

FIRST_SEED = 7_000_000_000


def biggest_leaf(specs) -> str:
    """The largest parameter but the embedding: the one whose update is doubled."""
    return max((math.prod(s.shape), s.name) for s in specs if s.name != "embed.tok")[1]


def variants(ref_model, cfg: dict, traffic: dict) -> dict:
    """name -> (precision, rows, labels altered, doubled parameter)."""
    doubled = biggest_leaf(ref_model.param_specs(cfg))
    half = slice(0, traffic["global_batch"] // 2)
    everything = slice(None)
    return {"control": (reference.FLOAT8, everything, False, None),
            "bfloat16": (reference.BF16, everything, False, None),
            "half_batch": (reference.EXACT, half, False, None),
            "labels": (reference.EXACT, everything, True, None),
            "double": (reference.EXACT, everything, False, doubled)}


def leaves(r: reference.Readings) -> dict:
    """Each leaf's first-gradient norm and projection and its change norm, for a
    look afterwards."""
    return {n: [r.grad_norms[n], r.grad_proj[n], r.change_norms[n]] for n in r.grad_norms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=FIRST_SEED)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    out = open(args.out, "a") if args.out else None
    bench = spec.benchmark()

    def emit(record: dict) -> None:
        line = json.dumps(record)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for name in args.workload:
        pieces = spec.resolve(bench, name)
        cfg, traffic = pieces["cfg"], pieces["traffic"]
        arch = train_cell.port_config(cfg)
        ref_model = spec.reference(cfg)
        specs = ref_model.param_specs(cfg)
        B, S, V = traffic["global_batch"], traffic["seq_len"], cfg["vocab_size"]
        n = traffic["check_steps"]
        for i in range(args.seeds):
            seed = args.first_seed + i
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as ckpt:
                trainer, state = train_cell.build(arch, cfg, traffic, seed, "cuda", ckpt)
                state, prog, _ = train_cell.program_readings(
                    trainer, state, specs, seed, reference.AdamW(), n)
                del trainer, state
            gc.collect()
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            params0 = weights.initial(cfg, specs, seed, "cuda")
            batches = [feed.synthetic_batch(seed, s, B, S, V) for s in range(n)]
            ref = ref_model.train(cfg, params0, batches, reference.AdamW(), seed)
            t2 = time.perf_counter()
            numbers, where = compare.gaps(prog, ref)
            emit({"workload": name, "seed": seed, "side": "program", **numbers,
                  "where": where, "losses": prog.losses,
                  "program_s": t1 - t0, "reference_s": t2 - t1, "leaves": leaves(prog)})
            emit({"workload": name, "seed": seed, "side": "reference", "losses": ref.losses,
                  "leaves": leaves(ref)})
            if i < args.control_seeds:
                for side, (pr, rows, labels, doubled) in variants(ref_model, cfg,
                                                                  traffic).items():
                    t3 = time.perf_counter()
                    fed = [dict(b, labels=b["tokens"]) if labels else b for b in batches]
                    got = ref_model.train(cfg, params0, fed, reference.AdamW(), seed,
                                          pr=pr, rows=rows, double=doubled)
                    numbers, where = compare.gaps(got, ref)
                    emit({"workload": name, "seed": seed, "side": side, **numbers,
                          "where": where, "losses": got.losses,
                          "seconds": time.perf_counter() - t3, "leaves": leaves(got)})
            del params0
            gc.collect()
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
