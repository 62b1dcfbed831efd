#!/usr/bin/env python3
"""Checks the chunked SSD kernels (``kernels/ssd.py``, ``csrc/ssd.cu``) against the
model's plain chunkwise form on the card, forward and backward, and times both.

    python3 tools/ssd_bench.py [--cases NAME ...] [--iters 10] [--no-time] [--out FILE]

A case (``CASES``) draws x, B, C, dt (softplus of a normal, as the model's), A_log, D,
an incoming state when it has one, and the gradients of y and of the final state from
its seed, in its type, on the card.  The reference is
``models.layers._ssd_chunked_groups`` on the same tensors (PyTorch on the card, float32
inside; autograd for the gradients) and, for one-group cases, also the sequential form
``_mamba_scan_seq``.  Each output and gradient is compared as its largest difference
over the reference's largest entry, against the case's tolerance (``TOL``): float32
1e-4, the products being float32 on both sides and only their order differing;
16 bits the output's rounding, one unit in the last place on either side (bf16 2^-8,
fp16 2^-11), with room for the sums over heads that dB and dC round once.

With timing: CUDA-event ms over ``--iters`` calls after a warm-up of the kernels'
forward and of forward + backward, the plain form's (under its checkpoint, as the
model ran it), the kernels' device ms by name from the profiler, and the share of the
bound: the products the decomposition needs (``flops``) over the 495 / 3 = 165 TFLOP/s
of float32-accurate work on the TF32 tensor cores (3xTF32, as the kernels run them).  Prints the card's name and power limit, then one JSON line per
case.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_TF32X3_FLOPS = 495e12 / 3

#: name -> (batch, seqlen, heads, head_dim, groups, state, dtype, with h0, seed)
CASES = {
    "zamba2_7b": (2, 4096, 112, 64, 2, 64, "bf16", False, 1),    # the cell's training shape
    "zamba2_7b_fp16": (2, 4096, 112, 64, 2, 64, "fp16", False, 2),
    "zamba2_2p7b": (2, 4096, 80, 64, 1, 64, "fp32", False, 3),   # train_zamba's, float32
    "one_group_h0": (2, 512, 16, 64, 1, 64, "fp32", True, 4),
    "ragged_bf16_h0": (1, 256, 12, 32, 2, 16, "bf16", True, 5),  # 6 heads a group
    "state128": (1, 512, 16, 64, 2, 128, "bf16", False, 6),
    "hd128_fp16": (1, 256, 8, 128, 1, 64, "fp16", True, 7),
    "small": (2, 128, 4, 16, 1, 16, "fp32", True, 8),
}
TOL = {"fp32": 1e-4, "bf16": 1.6e-2, "fp16": 2e-3}
SEQ_CASES = ("one_group_h0", "small")    # also held against the sequential form


def flops(Bb: int, S: int, nh: int, hd: int, G: int, N: int, chunk: int) -> tuple:
    """(forward, backward) operations of the decomposition, the causal halves once:
    per (chunk, head) the chunk state and C h_in (4 c hd N) and the masked W u
    (c^2 hd) forward; backward the state again, the pull, du's state part, the cross
    term and dB's state part (10 c hd N), dW and W^T dy (2 c^2 hd); per (chunk, group)
    C B^T (2 c^2 N) forward, and with dS^T C and dS B 6 c^2 N backward; the state
    passes 2 hd N a chunk and head each way."""
    n = S // chunk
    per_head = Bb * n * nh
    per_group = Bb * n * G
    fwd = per_head * (4 * chunk * hd * N + chunk * chunk * hd + 2 * hd * N) \
        + per_group * 2 * chunk * chunk * N
    bwd = per_head * (10 * chunk * hd * N + 2 * chunk * chunk * hd + 4 * hd * N) \
        + per_group * 6 * chunk * chunk * N
    return float(fwd), float(bwd)


def inputs(torch, case: tuple, dev):
    """The case's inputs (x, B, C, dt, A_log, D, h0), and the gradients of y and of
    the final state, drawn from its seed on ``dev``."""
    Bb, S, nh, hd, G, N, dtype, with_h0, seed = case
    dt_ = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}[dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(Bb, S, nh, hd).to(dt_)
    Bm = randn(Bb, S, G, N, scale=N ** -0.5).to(dt_)
    Cm = randn(Bb, S, G, N, scale=N ** -0.5).to(dt_)
    dt = torch.nn.functional.softplus(randn(Bb, S, nh) - 3.0).to(dt_)
    A_log = (randn(nh) * 0.5 + 1.0).to(dt_)
    D = randn(nh).to(dt_)
    h0 = randn(Bb, nh, hd, N) if with_h0 else None
    dy = randn(Bb, S, nh, hd).to(dt_)
    dh = randn(Bb, nh, hd, N, scale=0.1) if with_h0 else None
    return (x, Bm, Cm, dt, A_log, D, h0), dy, dh


def run(torch, fn, args, dy, dh):
    """fn's outputs and the gradients of sum(y dy) + sum(h dh) by every input."""
    leaves = [a.detach().clone().requires_grad_() if a is not None else None for a in args]
    y, h = fn(*leaves)
    loss = (y.float() * dy.float()).sum() + ((h * dh).sum() if dh is not None else 0.0)
    want = [a for a in leaves if a is not None]
    grads = torch.autograd.grad(loss, want)
    return y.detach(), h.detach(), grads


def check_case(name: str, case: tuple | None = None) -> dict:
    """One case against the plain forms: its errors and tolerance, and whether every
    error is within it."""
    import torch
    from repro_torch.kernels import ssd
    from repro_torch.models import layers as L

    case = case or CASES[name]
    dev = torch.device("cuda", 0)
    args, dy, dh = inputs(torch, case, dev)
    hd = case[3]
    before = (ssd.launches, ssd.bwd_launches)
    got = run(torch, lambda *a: ssd.ssd_chunked(*a, chunk=L.MAMBA_CHUNK), args, dy, dh)
    launched = (ssd.launches - before[0], ssd.bwd_launches - before[1])
    refs = {"chunked": run(torch, lambda *a: L._ssd_chunked_groups(*a[:6], hd, a[6],
                                                                   L.MAMBA_CHUNK),
                           args, dy, dh)}
    if name in SEQ_CASES:
        refs["sequential"] = run(torch, lambda *a: L._mamba_scan_seq(
            a[0], a[1][:, :, 0], a[2][:, :, 0], *a[3:6], hd, h0=a[6]), args, dy, dh)
    names = ["y", "h_fin", "dx", "dB", "dC", "ddt", "dA_log", "dD"] + \
        (["dh0"] if args[6] is not None else [])
    tol = TOL[case[6]]
    errors = {}
    for ref_name, (y, h, grads) in refs.items():
        for key, a, b in zip(names, (got[0], got[1], *got[2]), (y, h, *grads)):
            scale = float(b.float().abs().max()) or 1.0
            errors[f"{ref_name}.{key}"] = float((a.float() - b.float()).abs().max()) / scale
    torch.cuda.synchronize()
    return {"case": name, "shape": dict(zip(("B", "S", "nh", "hd", "G", "N"), case[:6])),
            "dtype": case[6], "h0": case[7], "launches": list(launched), "tol": tol,
            "errors": errors, "ok": launched == (1, 1) and all(e <= tol for e in
                                                                 errors.values())}


def time_case(name: str, iters: int) -> dict:
    """The case's times: the kernels' and the plain form's, forward and forward +
    backward, the kernels' device ms by name, and the share of the bound."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import ssd
    from repro_torch.models import layers as L

    case = CASES[name]
    dev = torch.device("cuda", 0)
    args, dy, dh = inputs(torch, case, dev)
    hd = case[3]
    leaves = [a.detach().clone().requires_grad_() if a is not None else None for a in args]

    def kernel_fwd():
        with torch.no_grad():
            ssd.ssd_chunked(*args, chunk=L.MAMBA_CHUNK)

    def kernel_both():
        y, _ = ssd.ssd_chunked(*leaves, chunk=L.MAMBA_CHUNK)
        y.backward(dy)

    def plain_fwd():
        with torch.no_grad():
            L._ssd_chunked_groups(*args[:6], hd, args[6], L.MAMBA_CHUNK)

    def plain_both():
        y, _ = checkpoint(L._ssd_chunked_groups, *leaves[:6], hd, leaves[6], L.MAMBA_CHUNK,
                          use_reentrant=False)
        y.backward(dy)

    def ms(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    out = {"kernel_fwd_ms": ms(kernel_fwd), "kernel_fwd_bwd_ms": ms(kernel_both),
           "plain_fwd_ms": ms(plain_fwd), "plain_fwd_bwd_ms": ms(plain_both)}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        kernel_both()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.key_averages():
        if "repro_ssd" in e.key:
            short = e.key.split("repro_ssd_")[1].split("<")[0].split("(")[0]
            by_name[short] = by_name.get(short, 0.0) + e.self_device_time_total / 1e3
    out["kernel_device_ms"] = by_name
    f_fwd, f_bwd = flops(*case[:6], ssd.CHUNK)
    out["flops_fwd"], out["flops_bwd"] = f_fwd, f_bwd
    out["bound_fwd_ms"] = 1e3 * f_fwd / PEAK_TF32X3_FLOPS
    out["bound_fwd_bwd_ms"] = 1e3 * (f_fwd + f_bwd) / PEAK_TF32X3_FLOPS
    out["share_of_bound_fwd_bwd"] = out["bound_fwd_bwd_ms"] / out["kernel_fwd_bwd_ms"]
    return out


def main() -> int:
    """Checks (and times) the cases asked for; 1 if any fails its tolerance."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", nargs="*", default=list(CASES))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    failed = 0
    for name in args.cases:
        row = check_case(name)
        if not args.no_time:
            row.update(time_case(name, args.iters))
        failed += not row["ok"]
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
