#!/usr/bin/env python3
"""Where the time of the port's training step goes on the GPU.

Builds qwen2-7b at full width (random weights from a seed, bf16; 8 of 28 layers by
default, as ``chip_smoke.py``'s train phase) and the train step the Trainer runs
(``make_train_step`` with its default AdamW and no remat, SyntheticLM batches), runs
two warm-up steps, then
  * traces ``--steps`` steps with torch.profiler: wall time, device-busy time and
    idle share, device time by kind of kernel (the port's kernels by name, matrix
    products, elementwise, reductions, ...) and the top kernels by device time;
  * times the step's three parts untraced with CUDA events (forward + loss,
    backward, AdamW update), the way ``make_train_step`` runs them.
Needs a CUDA device.

    PYTHONPATH=src python tools/profile_train_torch.py [--layers 8] [--batch 2]
        [--seq 4096] [--steps 3] [--out DIR]
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
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_update  # noqa: E402
from repro_torch.parallel.trainstep import (init_train_state,  # noqa: E402
                                            make_train_step)

#: kinds of device kernels, by a piece of their name; the first match wins
KINDS = (("flash_attention_bwd", ("flash_bwd",)),
         ("flash_attention", ("flash_fwd",)),
         ("rmsnorm_bwd", ("rmsnorm_bwd", "rmsnorm_dw")),
         ("rmsnorm", ("rmsnorm",)),
         ("matrix products", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
         ("embedding", ("embedding",)),
         ("reductions", ("reduce", "norm_kernel")),
         ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise",
                          "copy", "fill", "cat", "index")))


def device_time_us(evt) -> float:
    """Total device time of one profiler row, in microseconds."""
    return float(getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0)))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, pieces in KINDS:
        if any(piece in low for piece in pieces):
            return kind
    return "other"


def traced(fn, steps: int, top: int) -> dict:
    """Run ``fn`` under torch.profiler; per-step wall, busy and kernel times."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and "cuda" in str(e.device_type).lower()]
    busy_ms = sum(device_time_us(e) for e in kernels) / 1e3
    by_kind: dict = {}
    for e in kernels:
        row = by_kind.setdefault(kind_of(e.key), {"ms": 0.0, "calls": 0})
        row["ms"] += device_time_us(e) / 1e3 / steps
        row["calls"] += e.count / steps
    rows = sorted(kernels, key=device_time_us, reverse=True)[:top]
    return {"wall_ms_traced": wall_ms / steps, "device_busy_ms": busy_ms / steps,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "n_device_kernels": sum(e.count for e in kernels) / steps,
            "by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1]["ms"])),
            "top": [{"name": e.key[:90], "calls": e.count / steps,
                     "ms": device_time_us(e) / 1e3 / steps} for e in rows]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train_torch: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cfg = dataclasses.replace(get_config("qwen2_7b"), n_layers=args.layers)
    dev = torch.device("cuda", 0)
    model, opt, remat = LM(cfg, device=dev), AdamWConfig(), "none"  # the Trainer's defaults
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=0))
    train_step = make_train_step(model, opt, remat=remat)
    box = {"state": init_train_state(model, torch.Generator(device=dev).manual_seed(0)),
           "i": 0}

    def next_batch() -> dict:
        box["i"] += 1
        return {k: torch.from_numpy(v).to(dev) for k, v in data.batch(box["i"] - 1).items()}

    def step():
        box["state"], _ = train_step(box["state"], next_batch())

    step()
    step()                                      # warm-up
    result = {"device": smi, "config": cfg.name, "layers": cfg.n_layers,
              "batch": args.batch, "seq": args.seq, "remat": remat,
              "step": traced(step, args.steps, args.top)}

    # the step's parts, untraced, as make_train_step runs them (one microbatch)
    params = dict(model.named_parameters())
    parts = {"forward_and_loss": [], "backward": [], "adamw": []}
    for _ in range(args.steps):
        batch = next_batch()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = model.loss(batch["tokens"], batch["labels"], remat=remat)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(params.values()))
        ev[2].record()
        _, new_opt, _ = adamw_update(params, dict(zip(params, grads)),
                                     box["state"]["opt"], opt)
        ev[3].record()
        box["state"] = {"params": params, "opt": new_opt}
        torch.cuda.synchronize()
        for k, (a, b) in zip(parts, zip(ev, ev[1:])):
            parts[k].append(a.elapsed_time(b))
        del loss, grads
    result["parts_ms"] = {k: sum(v) / len(v) for k, v in parts.items()}
    result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(result, indent=1))
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "profile_train.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
