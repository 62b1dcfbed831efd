#!/usr/bin/env python3
"""The clip norm's cost on the mesh path's training step, on one card.

    PYTHONPATH=src python tools/train_mesh_norm.py [--layers 8] [--steps 6]

Runs ``chip_smoke.py``'s train and train_mesh setting (qwen2-7b at full width,
``--layers`` of 28 layers, bf16, SyntheticLM 2 x 4096, no remat) through the
``Trainer`` three ways, in turns A B C C B A:
  train      no mesh (plain tensors);
  mesh       a one-rank NCCL group and a (1, 1) mesh, ZeRO-3, with the port's
             ``global_norm`` (one reduction over the mesh);
  per_leaf   the same with the clip norm gathering one sum of squares a
             parameter (``full_tensor()`` each), patched in for the run.
Each run's ms a step is the wall from the first logged step to the last over the
steps between (the first step, which builds DTensor's caches, excluded).  Also
counts, with DTensor's ``CommDebugMode``, the collectives one step of each mesh
variant issues.  Prints the card's name and power limit, then one JSON line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import socket
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402


def per_leaf_norm(tensors) -> torch.Tensor:
    """The clip norm with one gathered sum of squares a tensor."""
    def sumsq(x):
        s = torch.sum(torch.square(x.float()))
        return s.full_tensor() if isinstance(s, DTensor) else s
    return torch.sqrt(sum(sumsq(x) for x in tensors))


def run(cfg, steps: int, mesh, norm) -> dict:
    """One Trainer run; returns its ms a step, losses and the collectives of one
    more step."""
    keep = adamw.global_norm
    adamw.global_norm = norm
    try:
        tc = TrainerConfig(arch=cfg, steps=steps, global_batch=2, seq_len=4096,
                           ckpt_every=0, log_every=1, remat="none", seed=0,
                           device="cuda", zero3=mesh is not None)
        with contextlib.redirect_stdout(io.StringIO()):
            tr = Trainer(tc, mesh=mesh)
            state, hist = tr.run()
        torch.cuda.synchronize()
        walls = [h["wall"] for h in hist]
        out = {"ms_per_step": 1e3 * (walls[-1] - walls[0]) / (len(walls) - 1),
               "losses": [h["loss"] for h in hist]}
        if mesh is not None:
            with CommDebugMode() as comm:
                state, _ = tr._step(state, tr._place(tr.data.batch(steps)))
                torch.cuda.synchronize()
            out["collectives"] = {str(k).rsplit(".", 1)[-1]: v
                                  for k, v in comm.get_comm_counts().items() if v}
        del tr, state
        torch.cuda.empty_cache()
        return out
    finally:
        adamw.global_norm = keep


def main() -> None:
    """Run the three variants in turns and print one JSON line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = dataclasses.replace(get_config("qwen2_7b"), n_layers=args.layers)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh()
        variants = {"train": (None, adamw.global_norm),
                    "mesh": (mesh, adamw.global_norm),
                    "per_leaf": (mesh, per_leaf_norm)}
        runs = []
        for name in ("train", "mesh", "per_leaf", "per_leaf", "mesh", "train"):
            runs.append({"variant": name, **run(cfg, args.steps, *variants[name])})
            print(f"  {name}: {runs[-1]['ms_per_step']:.1f} ms a step", flush=True)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "layers": args.layers,
                      "steps": args.steps, "runs": runs}))


if __name__ == "__main__":
    main()
