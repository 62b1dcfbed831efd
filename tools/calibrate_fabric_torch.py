#!/usr/bin/env python3
"""Fabric calibration with torch: fit the planner's ``FabricModel`` terms from
measured transfers and collectives (the torch counterpart of
``tools/calibrate_fabric.py``, whose fit math this file copies).

The fabric prices every hop as ``t = alpha * latency + size / (beta *
bandwidth)`` (``repro_torch.core.fabric``).  Three stages, as in the reference:

1. **sweep** -- transfers and all-reduces over a size ladder (1 KiB .. 64 MiB,
   median of repeats), each sample priced against a nominal link:
   * on the card (the default): pinned host<->card copies, class ``"pcie"``,
     against the planner's own H100 PCIe edge (16 GB/s, 5 us:
     ``repro_torch.core.cluster.hetero_cluster``); and an all-reduce on a
     one-rank NCCL group, class ``"nccl"``, whose ring moves no bytes
     (``2 (p - 1) / p`` of the buffer at p = 1), so it calibrates the latency
     term only;
   * on N gloo CPU ranks (``--ranks N``): rank-to-rank ``send`` / ``recv`` and
     all-reduces over every rank, class ``"host"``, against the reference's
     nominal host link.
2. **fit** -- least squares on the hop model (:func:`fit_alpha_beta`), beta
   clamped to <= 1; per-class ceilings (:func:`roofline_terms`).
3. **gate** -- re-price the composite step (the largest transfer and its
   all-reduce, back to back) on the calibrated model and fail (exit 1) when the
   simulated against measured relative error exceeds ``--gate``.

The fit functions are the reference's, byte for byte under the module rename
the planner copies use; ``--fit-only samples.json`` re-fits a recorded sweep
without importing torch.  Sample records are ``{"size", "bw", "lat", "t"}`` plus
``"cls"`` and ``"kind"``.

Usage::

    PYTHONPATH=src python tools/calibrate_fabric_torch.py --out calib.json
    PYTHONPATH=src python tools/calibrate_fabric_torch.py --ranks 4
    python tools/calibrate_fabric_torch.py --fit-only sweep.json
"""

from __future__ import annotations

import argparse
import json
import socket
import statistics
import sys
import time
from pathlib import Path

# nominal host link the gloo sweep is fitted against (the reference's)
HOST_NOMINAL_BW = 10e9        # B/s
HOST_NOMINAL_LAT = 5e-6       # s
# the planner's H100 PCIe edge (core/cluster.py: Edge(16 * GB, 5e-6, "pcie"))
PCIE_NOMINAL_BW = 16e9
PCIE_NOMINAL_LAT = 5e-6
# the planner's H100 NVLink edge (core/cluster.py: DEVICE_INTRA_BW, 1 us)
NCCL_NOMINAL_BW = 450e9
NCCL_NOMINAL_LAT = 1e-6

SIZES = [1 << k for k in range(10, 27, 2)]       # 1 KiB .. 64 MiB
REPEATS = 5


# ---------------------------------------------------------------------------
# Fit math (pure stdlib; the reference's)
# ---------------------------------------------------------------------------


def fit_alpha_beta(samples: list[dict], *, clamp_beta: float = 1.0
                   ) -> tuple[float, float]:
    """Least-squares fit of ``t = alpha*lat + size/(beta*bw)`` over
    ``samples`` (dicts with ``size``, ``bw``, ``lat``, ``t``).

    Linear in ``x = (alpha, 1/beta)`` with design rows ``(lat_i,
    size_i/bw_i)``; solved via the 2x2 normal equations.  ``alpha`` is
    floored at 0 and ``beta`` capped at ``clamp_beta`` (default 1 — the
    admissibility ceiling: the search tier's coarse caps assume the sim
    never prices a hop *faster* than its nominal bandwidth)."""
    if not samples:
        raise ValueError("no samples to fit")
    a11 = a12 = a22 = b1 = b2 = 0.0
    for s in samples:
        l, u, t = float(s["lat"]), float(s["size"]) / float(s["bw"]), \
            float(s["t"])
        a11 += l * l
        a12 += l * u
        a22 += u * u
        b1 += l * t
        b2 += u * t
    det = a11 * a22 - a12 * a12
    if abs(det) < 1e-30:
        # degenerate sweep (single size, or zero latency everywhere):
        # fall back to the bandwidth-only fit
        inv_beta = b2 / a22 if a22 > 0 else 1.0
        alpha = 1.0
    else:
        alpha = (b1 * a22 - b2 * a12) / det
        inv_beta = (a11 * b2 - a12 * b1) / det
    alpha = max(0.0, alpha)
    beta = 1.0 / inv_beta if inv_beta > 0 else clamp_beta
    return alpha, min(beta, clamp_beta)


def roofline_terms(samples: list[dict]) -> dict[str, dict[str, float]]:
    """Per-class empirical roofline ceilings, berkeley-ert style: the best
    sustained bandwidth (and, where ``flops`` is recorded, compute rate)
    each class achieved anywhere on the sweep — plus its efficiency
    against the nominal spec, capped at 1."""
    out: dict[str, dict[str, float]] = {}
    for s in samples:
        cls = s.get("cls", "host")
        row = out.setdefault(cls, {"peak_bw": 0.0, "peak_flops": 0.0,
                                   "bw_eff": 0.0})
        t = float(s["t"])
        if t <= 0:
            continue
        bw = float(s["size"]) / t
        if bw > row["peak_bw"]:
            row["peak_bw"] = bw
            row["bw_eff"] = min(1.0, bw / float(s["bw"]))
        if s.get("flops"):
            row["peak_flops"] = max(row["peak_flops"], float(s["flops"]) / t)
    return out


def fit_report(samples: list[dict], *, gate: float | None = None,
               measured_step: float | None = None) -> dict:
    """The full fit artifact: alpha/beta, per-class rooflines, residuals,
    and (when a measured composite step is supplied) the sim-vs-measured
    gate verdict."""
    alpha, beta = fit_alpha_beta(samples)
    resid = []
    for s in samples:
        pred = alpha * float(s["lat"]) + float(s["size"]) / (beta *
                                                             float(s["bw"]))
        resid.append(abs(pred - float(s["t"])) / max(float(s["t"]), 1e-12))
    report = {
        "alpha": alpha,
        "beta": beta,
        "n_samples": len(samples),
        "median_residual": statistics.median(resid) if resid else 0.0,
        "classes": roofline_terms(samples),
    }
    if measured_step is not None:
        pred = predict_step(samples, alpha, beta)
        err = abs(pred - measured_step) / max(measured_step, 1e-12)
        report["step"] = {"measured_s": measured_step, "simulated_s": pred,
                          "rel_error": err}
        if gate is not None:
            report["step"]["gate"] = gate
            report["step"]["passed"] = err <= gate
    return report


def predict_step(samples: list[dict], alpha: float, beta: float) -> float:
    """Price the composite gate step — one max-size transfer per sampled
    class — on the calibrated hop model (what the simulator would charge
    for the same traffic on an uncontended fabric)."""
    per_cls: dict[str, dict] = {}
    for s in samples:
        cur = per_cls.get(s.get("cls", "host"))
        if cur is None or float(s["size"]) > float(cur["size"]):
            per_cls[s.get("cls", "host")] = s
    total = 0.0
    for s in per_cls.values():
        total += alpha * float(s["lat"]) + float(s["size"]) / (beta *
                                                               float(s["bw"]))
    return total


# ---------------------------------------------------------------------------
# torch microbenchmark sweep
# ---------------------------------------------------------------------------


def _median_s(fn, sync, *, repeats: int = REPEATS) -> float:
    """Median wall time of ``fn()``, ``sync()`` after each (and a warm-up)."""
    fn()
    sync()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card_group():
    """A one-rank NCCL group on the card unless a process group exists; returns
    whether this call made it (and must destroy it)."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    return True


def latency_only(samples: list[dict]) -> dict[str, float]:
    """The classes whose every sample moves no bytes (a one-rank all-reduce:
    2(p-1)/p of the buffer is 0), each with its median seconds: they price
    latency alone and have no bandwidth to report."""
    by_cls: dict[str, list[dict]] = {}
    for s in samples:
        by_cls.setdefault(s.get("cls", "host"), []).append(s)
    return {c: statistics.median(float(s["t"]) for s in rows)
            for c, rows in by_cls.items() if all(float(s["size"]) == 0 for s in rows)}


def run_card_sweep(*, sizes: list[int] | None = None) -> tuple[list[dict], float]:
    """Pinned host->card and card->host copies and one-rank NCCL all-reduces on
    the current card; returns fit-ready samples and the composite step's
    measured seconds (the largest host->card copy and its all-reduce).  On one
    rank the all-reduce moves no bytes: its samples are latency only
    (:func:`latency_only`)."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    sync = torch.cuda.synchronize
    made = _card_group()
    try:
        p = dist.get_world_size()
        samples: list[dict] = []
        for size in sizes or SIZES:
            n = max(1, size // 4)
            host = torch.zeros(n, dtype=torch.float32).pin_memory()
            card = torch.zeros(n, dtype=torch.float32, device=dev)
            for kind, fn in (("h2d", lambda: card.copy_(host, non_blocking=True)),
                             ("d2h", lambda: host.copy_(card, non_blocking=True))):
                samples.append({"size": float(n * 4), "bw": PCIE_NOMINAL_BW,
                                "lat": PCIE_NOMINAL_LAT, "t": _median_s(fn, sync),
                                "cls": "pcie", "kind": kind})
            # ring all-reduce: 2(p-1)/p of the buffer crosses each link
            t = _median_s(lambda: dist.all_reduce(card), sync)
            samples.append({"size": float(n * 4) * 2 * (p - 1) / p, "bw": NCCL_NOMINAL_BW,
                            "lat": NCCL_NOMINAL_LAT * p, "t": t, "cls": "nccl",
                            "kind": "allreduce"})
        n = max(1, (sizes or SIZES)[-1] // 4)
        host = torch.zeros(n, dtype=torch.float32).pin_memory()
        card = torch.zeros(n, dtype=torch.float32, device=dev)

        def step():
            card.copy_(host, non_blocking=True)
            dist.all_reduce(card)

        return samples, _median_s(step, sync)
    finally:
        if made:
            dist.destroy_process_group()


def _gloo_rank(rank: int, world: int, port: int, sizes: list[int], out) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)

    def timed(fn) -> float:
        """Median over repeats of ``fn`` started together on every rank
        (a barrier first), as rank 0 or the receiving rank 1 clocks it."""
        fn()
        ts = []
        for _ in range(REPEATS):
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    samples = []
    for size in sizes:
        n = max(1, size // 4)
        x = torch.zeros(n, dtype=torch.float32)
        xfer = {0: lambda: dist.send(x, 1), 1: lambda: dist.recv(x, 0)}.get(rank,
                                                                              lambda: None)
        t = timed(xfer)
        if rank == 1:
            samples.append({"size": float(n * 4), "bw": HOST_NOMINAL_BW,
                            "lat": HOST_NOMINAL_LAT, "t": t, "cls": "host",
                            "kind": "transfer"})
        t = timed(lambda: dist.all_reduce(x))
        if rank == 0:
            samples.append({"size": float(n * 4) * 2 * (world - 1) / world,
                            "bw": HOST_NOMINAL_BW, "lat": HOST_NOMINAL_LAT * world,
                            "t": t, "cls": "host", "kind": "allreduce"})
    # the composite step: the largest transfer and its all-reduce, back to back
    n = max(1, sizes[-1] // 4)
    x = torch.zeros(n, dtype=torch.float32)

    def step():
        if rank == 0:
            dist.send(x, 1)
        elif rank == 1:
            dist.recv(x, 0)
        dist.all_reduce(x)

    t = timed(step)
    gathered = [None] * world
    dist.all_gather_object(gathered, samples)
    if rank == 0:
        out.put(([s for part in gathered for s in part], t))
    dist.destroy_process_group()


def run_host_sweep(n_ranks: int, *, sizes: list[int] | None = None
                   ) -> tuple[list[dict], float]:
    """Rank-to-rank transfers and all-reduces over ``n_ranks`` gloo CPU ranks
    (one process each, a localhost rendezvous); returns the samples and the
    composite step's measured seconds."""
    import torch.multiprocessing as mp

    if n_ranks < 2:
        raise SystemExit("the host sweep needs >= 2 ranks (--ranks N)")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_gloo_rank, args=(r, n_ranks, port, sizes or SIZES, out))
             for r in range(n_ranks)]
    for pr in procs:
        pr.start()
    try:
        result = out.get(timeout=600)
    finally:
        for pr in procs:
            pr.join(timeout=60)
            if pr.is_alive():
                pr.kill()
    if any(pr.exitcode for pr in procs):
        raise SystemExit(f"a rank failed: exit codes {[pr.exitcode for pr in procs]}")
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    """CLI entry point: sweep (or load), fit, report, gate (exit 1 when the
    sim-vs-measured step error exceeds ``--gate``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=0,
                    help="sweep N gloo CPU ranks instead of the card")
    ap.add_argument("--fit-only", metavar="SAMPLES_JSON",
                    help="skip the sweep; fit a recorded sample file")
    ap.add_argument("--gate", type=float, default=0.75,
                    help="max allowed sim-vs-measured step relative error")
    ap.add_argument("--no-gate", action="store_true",
                    help="report the step error but never fail on it")
    ap.add_argument("--out", metavar="JSON",
                    help="write the fit report (and raw samples) here")
    args = ap.parse_args(argv)

    if args.fit_only:
        payload = json.loads(Path(args.fit_only).read_text())
        samples = payload["samples"] if isinstance(payload, dict) else payload
        measured = payload.get("measured_step") \
            if isinstance(payload, dict) else None
    else:
        if args.ranks:
            samples, measured = run_host_sweep(args.ranks)
        else:
            import torch
            if not torch.cuda.is_available():
                raise SystemExit("no CUDA device: pass --ranks N for gloo CPU ranks")
            samples, measured = run_card_sweep()

    report = fit_report(samples, gate=None if args.no_gate else args.gate,
                        measured_step=measured)

    print(f"fit over {report['n_samples']} samples: "
          f"alpha={report['alpha']:.4g} beta={report['beta']:.4g} "
          f"(median residual {report['median_residual']:.1%})")
    latency = latency_only(samples)
    for cls, row in report["classes"].items():
        if cls in latency:
            print(f"  class {cls}: latency only, median {latency[cls] * 1e6:.1f} us "
                  f"(its samples move no bytes)")
        else:
            print(f"  class {cls}: peak {row['peak_bw'] / 1e9:.2f} GB/s "
                  f"({row['bw_eff']:.0%} of nominal)")
    step = report.get("step")
    if step:
        verdict = "" if "passed" not in step else \
            ("  [ok]" if step["passed"] else "  [FAIL]")
        print(f"step gate: measured {step['measured_s'] * 1e3:.2f} ms, "
              f"simulated {step['simulated_s'] * 1e3:.2f} ms, "
              f"error {step['rel_error']:.1%}{verdict}")

    if args.out:
        Path(args.out).write_text(json.dumps(
            {"report": report, "samples": samples,
             "measured_step": measured}, indent=2) + "\n")
        print(f"wrote {args.out}")

    if step and step.get("passed") is False:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
