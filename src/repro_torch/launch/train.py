"""Training launcher CLI (the reference's ``launch/train.py``).

Plans with the paper's search (over the analytic cluster model), then trains
the selected architecture on the card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_125m --steps 50 \\
      --global-batch 8 --seq 256 [--reduced] [--plan auto|megatron] [--device cuda|cpu]

``--reduced`` uses the smoke-scale config (CPU-friendly).  Two departures from
the reference:

  * ``--device`` (default ``cuda``): the hand-written kernels on the card, or
    ``cpu`` for their plain versions;
  * the analytic cluster planned on is ``hetero_cluster({"H100": max(n, 4)},
    gpus_per_node=4)`` in place of the reference's TPU v5e one, where ``n`` is
    ``torch.cuda.device_count()`` on ``cuda`` and 1 on ``cpu`` (as
    ``jax.devices()`` counts on a CPU).

``main`` takes an optional ``argv`` and returns the :class:`Trainer` it ran, so
that it can be driven in-process.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import hetero_cluster, plan_hybrid
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv: list[str] | None = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm_125m", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU)")
    ap.add_argument("--plan", default="auto", choices=["auto", "megatron"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "selective", "full"])
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    # Plan against the analytic cluster (the paper's planning step); the
    # run then uses the plan's execution knobs.
    n = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
    topo = hetero_cluster({"H100": max(n, 4)}, gpus_per_node=4)
    plan = None
    if args.plan == "auto":
        res = plan_hybrid(topo, cfg.to_model_desc(),
                          global_batch=args.global_batch, seq=args.seq,
                          with_baseline=False)
        plan = res.plan
        print(f"[plan] {plan.describe()} "
              f"(predicted step {res.predicted.step_time*1e3:.1f} ms)")

    tcfg = TrainerConfig(
        arch=cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq, ckpt_dir=args.ckpt_dir,
        microbatches=args.microbatches, remat=args.remat,
        opt=AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                        total_steps=args.steps),
        device=args.device)
    trainer = Trainer(tcfg, plan=plan)
    _, hist = trainer.run()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"[train] loss {first:.4f} -> {last:.4f} over {args.steps} steps")
    return trainer


if __name__ == "__main__":
    main()
