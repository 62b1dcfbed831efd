#!/usr/bin/env python3
"""The collectives one sharded train step issues, by kind, on CPU ranks.

    PYTHONPATH=src python tools/count_collectives.py [--mesh 4 2] [--layers 2]

Starts one gloo rank a mesh position (``torch.multiprocessing``, a localhost
rendezvous), builds qwen2-7b reduced to ``--layers`` layers of width 64 in
float32, places it on a ``("data", "model")`` mesh under the reference's axis
rules, and counts with DTensor's ``CommDebugMode`` what the second of two steps
issues (the first builds DTensor's caches), with ZeRO-3 on and off.  Prints one
JSON line: ``{"zero3": {kind: count}, "zero1": {...}}``.  The counts are a
property of the program, not of the backend, so the CPU reads what NCCL ranks
would issue; their times are not measured here.
"""

from __future__ import annotations

import argparse
import json
import math
import socket
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, shape: tuple, layers: int, out) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.axes import distribute
    from repro_torch.parallel.trainstep import make_train_step
    from repro_torch.models.lm import LM

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    cfg = get_config("qwen2_7b").reduced(n_layers=layers, d_model=64, vocab=128, d_ff=128,
                                         n_heads=4, n_kv_heads=2, head_dim=16,
                                         dtype="float32")
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32))).long()
             for k in ("tokens", "labels")}
    counts = {}
    for zero3 in (True, False):
        model = LM(cfg, device="cpu")
        model.init(torch.Generator().manual_seed(0))
        prof = shd.profile_for(cfg, mesh, zero3=zero3)
        shd.distribute_params(model, shd.module_shardings(
            model, shd.param_shardings(model, mesh, prof.rules)))
        params = dict(model.named_parameters())
        osh = shd.module_shardings(model, shd.opt_state_shardings(model, mesh, prof.opt_rules).m)
        state = {"params": params, "opt": init_opt_state(params, osh)}
        step = make_train_step(model, AdamWConfig(), remat="none", mesh=mesh, rules=prof.rules)
        placed = distribute(batch, shd.batch_shardings(mesh, batch, prof.rules))
        state, _ = step(state, placed)
        with CommDebugMode() as comm:
            state, _ = step(state, placed)
        counts["zero3" if zero3 else "zero1"] = {
            str(k).rsplit(".", 1)[-1]: v for k, v in sorted(
                comm.get_comm_counts().items(), key=lambda kv: str(kv[0])) if v}
    if rank == 0:
        out.put(counts)
    dist.destroy_process_group()


def main() -> None:
    """Spawn the ranks and print rank 0's counts as one JSON line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", type=int, nargs=2, default=(4, 2))
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()
    import torch.multiprocessing as mp

    shape = tuple(args.mesh)
    world = math.prod(shape)
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    mp.start_processes(_rank, args=(world, _free_port(), shape, args.layers, out),
                       nprocs=world, start_method="spawn")
    print(json.dumps({"mesh": list(shape), "layers": args.layers, **out.get()}))


if __name__ == "__main__":
    main()
