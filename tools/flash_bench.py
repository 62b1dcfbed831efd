#!/usr/bin/env python3
"""Times the port's flash-attention forward on the card across shapes, to see what
bounds it: causal against bidirectional, short against long sequences, and how
many query heads share one K/V head (the K/V bytes each tile brings in).

    python3 tools/flash_bench.py [--dtype bf16|fp16] [--iters 20] [--out FILE]

For each shape: the kernel variant that ran, its time (CUDA events over --iters
launches after a warm-up), TFLOP/s over the (query, key) pairs the mask leaves
visible (4 * hd operations each), the share of the 989 TFLOP/s bound, and
``F.scaled_dot_product_attention`` on the same tensors as a yardstick (the port
never calls it).  Prints the card's name and power limit, then one JSON line per
shape.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PEAK_TENSOR_16BIT_FLOPS = 989e12

# (B, S, H, KV, hd, causal): the serving shape first, then one change at a time
SHAPES = [
    (4, 2048, 28, 4, 128, True),     # qwen2-7b prefill
    (4, 2048, 28, 4, 128, False),    # the same, bidirectional: no diagonal tiles
    (1, 8192, 28, 4, 128, True),     # long: blocks run 4x longer
    (4, 2048, 28, 28, 128, True),    # one K/V head per query head: 7x the K/V bytes
    (4, 2048, 28, 1, 128, True),     # one K/V head for all
    (4, 2048, 56, 8, 64, True),      # head_dim 64, same model width
]


def main() -> None:
    """Time every shape of SHAPES and print one JSON line each."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bf16", "fp16"), default="bf16")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_bench: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float16
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: nothing")
    rows = []
    for B, S, H, KV, hd, causal in SHAPES:
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dtype)
        ops.reset_launch_counts()
        ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
        by_variant = getattr(ops, "flash_launches_by_variant", dict)()  # older trees: none
        ran = [name for name, n in by_variant.items() if n]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = 4.0 * hd * pairs * B * H
        row = {"shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd, "causal": causal},
               "dtype": args.dtype, "variant": ran, "ms": ms,
               "tflops": flops / (ms * 1e-3) / 1e12,
               "share_of_bound": flops / PEAK_TENSOR_16BIT_FLOPS / (ms * 1e-3),
               "library_ms": lib_ms}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, qt, kt, vt
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
