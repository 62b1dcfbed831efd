#!/usr/bin/env python3
"""Fig. 3 with the port: naive all-reduce against reduce-scatter + all-gather.

    PYTHONPATH=src python tools/fig3_allreduce_torch.py              # on the card
    PYTHONPATH=src python tools/fig3_allreduce_torch.py --ranks 8    # gloo CPU ranks

Two views, as ``benchmarks/fig3_allreduce_decomp.py`` gives them:

  (a) the analytic multi-edge cost model the planner optimizes
      (``repro_torch.core.allreduce_time``): the benchmark's rows, 8 V100s in one
      NVLink node and 16 over two nodes joined by InfiniBand, 16 / 128 / 1024 MB;
  (b) ``repro_torch.parallel.collectives.sync_grads``' three schedules
      ("allreduce", "rs_ag", "int8") timed on a gradient tree: on the card's
      one-rank NCCL group (a one-rank collective moves nothing, so the int8
      passes are the only device work), or on ``--ranks`` gloo CPU ranks (one
      process each, a localhost rendezvous).  Each rank's gradients differ; the
      schedules' results are held to the numpy mean (allreduce and rs_ag within
      1e-6 of each other, int8 within its ranks' mean half-scale).

Prints one JSON line per row, then one with the timings (median ms of 5, on a
64 MiB tree).
"""

from __future__ import annotations

import argparse
import json
import socket
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

NUMEL = 1 << 24            # fp32 entries in the timed tree: 64 MiB
REPEATS = 5


def analytic_rows() -> list[dict]:
    """The reference benchmark's rows from the port's multi-edge cost model."""
    from repro_torch.core import allreduce_time, homogeneous_cluster
    rows = []
    for n, label in ((8, "nvlink-node"), (16, "two-nodes-ib")):
        topo = homogeneous_cluster(n, "V100", gpus_per_node=8)
        ranks = topo.alive_ids()
        for size_mb in (16, 128, 1024):
            size = size_mb * 1e6
            naive = allreduce_time(topo, size, ranks, decomposed=False)
            dec = allreduce_time(topo, size, ranks, decomposed=True)
            rows.append({"cluster": label, "n": n, "size_mb": size_mb,
                         "naive_ms": naive * 1e3, "decomposed_ms": dec * 1e3,
                         "speedup": naive / dec})
    return rows


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def time_schedules(mesh, device) -> dict:
    """Median ms of each schedule on a two-leaf tree of NUMEL fp32 entries in all
    (one leaf of odd length, which the reduce-scatter pads), drawn per rank, and
    the largest error of each against the mean over the ranks."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.collectives import SCHEDULES, sync_grads

    rank, world = dist.get_rank(), dist.get_world_size()
    shapes = {"w": (NUMEL // 2 // 1024, 1024), "b": (NUMEL - NUMEL // 2 // 1024 * 1024,)}

    def grads(r):
        g = torch.Generator(device=device).manual_seed(r)
        return {k: torch.randn(s, generator=g, device=device) for k, s in shapes.items()}

    mine = grads(rank)
    mean = {k: sum(grads(r)[k] for r in range(world)) / world for k in shapes}
    half = {k: sum(float(grads(r)[k].abs().max()) for r in range(world)) / world / 254
            for k in shapes}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    out = {}
    for schedule in SCHEDULES:
        got, _ = sync_grads(mine, mesh, "data", schedule=schedule)
        err = max(float((got[k] - mean[k]).abs().max()) for k in shapes)
        bound = 1e-6 if schedule != "int8" else max(half.values()) + 1e-6
        if not err <= bound:
            raise SystemExit(f"{schedule}: max error {err:.3e} against the mean "
                             f"exceeds {bound:.3e}")
        ts = []
        for _ in range(REPEATS):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            sync_grads(mine, mesh, "data", schedule=schedule)
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[schedule] = {"ms": statistics.median(ts), "max_err_vs_mean": err}
    return {"ranks": world, "device": device.type, "tree_bytes": NUMEL * 4,
            "schedules": out}


def _gloo_rank(rank: int, world: int, port: int, q) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    mesh = make_mesh((world,), ("data",), device_type="cpu")
    res = time_schedules(mesh, torch.device("cpu"))
    if rank == 0:
        q.put(res)
    dist.destroy_process_group()


def run_gloo(world: int) -> dict:
    """The schedules timed on ``world`` gloo CPU ranks, one spawned process each."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_gloo_rank, args=(r, world, port, q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        res = q.get(timeout=900)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    if any(p.exitcode for p in procs):
        raise SystemExit(f"a rank failed: exit codes {[p.exitcode for p in procs]}")
    return res


def run_card() -> dict:
    """The schedules timed on the card's one-rank NCCL group."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --ranks N for gloo CPU ranks")
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        return time_schedules(make_mesh((1,), ("data",)), dev)
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    """CLI entry point: the analytic rows, then the measured schedules."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=0,
                    help="time on N gloo CPU ranks instead of the card")
    args = ap.parse_args(argv)
    for row in analytic_rows():
        print(json.dumps({"analytic": row}), flush=True)
    res = run_gloo(args.ranks) if args.ranks else run_card()
    print(json.dumps({"measured": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
