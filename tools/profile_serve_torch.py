#!/usr/bin/env python3
"""Where the time of the port's serving path goes on the GPU.

Builds a ported architecture (qwen2-7b unless --arch says otherwise; random
weights from a seed, bf16; a cross-attention model's vision patches / audio
frames are random embeddings at 0.02 scale) through the port's entry points,
then traces one prefill and a few decode steps with torch.profiler and prints,
per phase: wall time, device-busy time and idle share, and the device kernels
by total time.  Needs a CUDA device.

    PYTHONPATH=src python tools/profile_serve_torch.py [--arch qwen2_7b] [--layers N]
        [--batch 4] [--seq 2048] [--steps 4] [--out DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import modality_inputs  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.parallel.trainstep import (make_prefill_step,  # noqa: E402
                                            make_serve_step)


def device_time_us(evt) -> float:
    """Total device time of one profiler row, in microseconds."""
    return float(getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0)))


def traced(fn, top: int) -> dict:
    """Run ``fn`` under torch.profiler: wall time, device-busy time, number
    of device kernels and the ``top`` kernels by device time."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and "cuda" in str(e.device_type).lower()]
    busy_ms = sum(device_time_us(e) for e in kernels) / 1e3
    rows = sorted(kernels, key=device_time_us, reverse=True)[:top]
    return {"wall_ms_traced": wall_ms, "device_busy_ms": busy_ms,
            "n_device_kernels": sum(e.count for e in kernels),
            "top": [{"name": e.key[:90], "calls": e.count,
                     "ms": device_time_us(e) / 1e3} for e in rows]}


def untraced_ms(fn, reps: int) -> float:
    """Host-clock milliseconds per call of ``fn``, synchronized, untraced."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> None:
    """Build the model, trace one prefill and ``--steps`` decode steps."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_serve_torch: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    B, S = args.batch, args.seq
    tokens = torch.randint(0, cfg.vocab, (B, S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    mods = modality_inputs(cfg, B, torch.Generator(device=dev).manual_seed(2), dev)
    state = {}

    def do_prefill():
        state["logits"], state["stacked"] = prefill({"tokens": tokens, **mods})

    def make_cache():
        state["cache"], state["t"] = model.serving_cache(state["stacked"], S, S + 64), 0

    def do_decode():
        pos = torch.full((B,), S + state["t"], device=dev)
        state["logits"], _ = serve(state["cache"],
                                   {"tokens": tokens[:, :1], "pos": pos, **mods})
        state["t"] += 1

    do_prefill()
    make_cache()
    do_decode()                                   # warm-up
    result = {"device": smi, "config": cfg.name, "layers": cfg.n_layers,
              "batch": B, "seq": S}
    result["prefill"] = traced(do_prefill, args.top)
    result["prefill"]["wall_ms"] = untraced_ms(do_prefill, 3)
    result["decode"] = traced(lambda: [do_decode() for _ in range(args.steps)],
                              args.top)
    for key in ("wall_ms_traced", "device_busy_ms", "n_device_kernels"):
        result["decode"][key] /= args.steps
    for row in result["decode"]["top"]:
        row["ms"] /= args.steps
        row["calls"] /= args.steps
    result["decode"]["wall_ms"] = untraced_ms(do_decode, 8)
    for phase in ("prefill", "decode"):
        r = result[phase]
        r["device_idle_share"] = max(0.0, 1.0 - r["device_busy_ms"] / r["wall_ms"])
    print(json.dumps(result, indent=1))
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / f"profile_serve_{args.arch}.json").write_text(
            json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
