#!/usr/bin/env python3
"""Where the time of one RMSNorm call at the decode shape goes, on the card.

    python3 tools/rmsnorm_launch_cost.py [--rows 4] [--d 3584] [--calls 4000]

At (4, 3584) bf16 the kernel runs ~2 µs and a call costs what the host needs to
issue it.  Host microseconds per call (``time.perf_counter`` over back-to-back
calls; the card keeps up, so this is the issue rate) for:

  wrapper        ``ops.rmsnorm(x, w)``, the whole call;
  alloc          ``torch.empty_like(x)`` alone;
  stream         the raw current-stream handle alone;
  ctypes         filling the argument block and calling the C launcher with
                 rows = 0, which returns before any CUDA call;
  ctypes_launch  the same with the real rows: adds cudaGetDevice, the launch
                 (cudaLaunchKernel) and cudaGetLastError;
  library        ``F.rms_norm`` on the same tensors (a yardstick only);
and, from a CUDA graph of 200 calls replayed, the device's time per call.  The
checks' share is the wrapper minus alloc, stream and ctypes_launch.  Prints the
card's name and power limit, then one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    """Time each piece of the call and print the split as one JSON line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--d", type=int, default=3584)
    ap.add_argument("--calls", type=int, default=4000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("rmsnorm_launch_cost: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import rmsnorm as rms_mod

    dev = torch.device("cuda", 0)
    x = torch.randn(args.rows, args.d, device=dev).bfloat16()
    w = torch.ones(args.d, device=dev).bfloat16()
    y = torch.empty_like(x)
    eps = 1e-6
    ops.rmsnorm(x, w, eps=eps)          # builds and binds
    call, addr = rms_mod._local.call
    fwd, stream = rms_mod._fwd, rms_mod._stream
    xp, wp, yp = x.data_ptr(), w.data_ptr(), y.data_ptr()

    def launcher(rows: int):
        def run():
            call.x, call.w, call.y = xp, wp, yp
            call.stream = stream(0)
            call.rows, call.d, call.eps = rows, args.d, eps
            call.x_dtype, call.w_dtype, call.device = 1, 1, 0
            fwd(addr)
        return run

    pieces = {
        "wrapper": lambda: ops.rmsnorm(x, w, eps=eps),
        "alloc": lambda: torch.empty_like(x),
        "stream": lambda: stream(0),
        "ctypes": launcher(0),
        "ctypes_launch": launcher(args.rows),
        "library": lambda: F.rms_norm(x, (args.d,), w, eps),
    }

    def host_us(fn) -> float:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / args.calls * 1e6

    # two rounds in turn; the lower of the two is kept (the host is shared)
    rounds = [{name: host_us(fn) for name, fn in pieces.items()} for _ in range(2)]
    us = {name: min(r[name] for r in rounds) for name in pieces}

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.rmsnorm(x, w, eps=eps)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(200):
            ops.rmsnorm(x, w, eps=eps)
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    us["device_in_graph"] = start.elapsed_time(end) * 1e3 / 2000
    us["checks"] = us["wrapper"] - us["alloc"] - us["stream"] - us["ctypes_launch"]
    us["launch_calls"] = us["ctypes_launch"] - us["ctypes"]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: nothing")
    print(json.dumps({"shape": [args.rows, args.d], "dtype": "bfloat16",
                      "calls": args.calls, "rounds": rounds, "us_per_call": us,
                      "built": _build.build_info.get("built")}))


if __name__ == "__main__":
    main()
