#!/usr/bin/env python3
"""Times the port's flash-attention forward, or its backward, on the card across
shapes, to see what bounds it: causal against bidirectional, short against long
sequences, and how many query heads share one K/V head (the K/V bytes each tile
brings in).

    python3 tools/flash_bench.py [--backward] [--dtype bf16|fp16] [--iters 20] [--out FILE]

For each shape: the kernel variant that ran, its time (CUDA events over --iters
launches after a warm-up), TFLOP/s over the (query, key) pairs the mask leaves
visible (4 * hd operations each forward, 10 * hd backward), the share of the 989
TFLOP/s bound, and ``F.scaled_dot_product_attention`` (its backward, through
autograd, with --backward) on the same tensors as a yardstick (the port never calls
it).  The forward's shapes include gemma-7b's head_dim 256 and zamba2-2.7b's head_dim
80.  The backward's shapes hold 8192 tokens a call: S in 1024..8192, causal and
not, head_dim 128 (28 query heads on 4 K/V heads) and 64 (56 on 8), then zamba2's
training shape (head_dim 80, 32 heads on 32) and gemma's (head_dim 256).  Prints the
card's name and power limit, then one JSON line per shape.  Needs a CUDA device.
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
    (4, 2048, 16, 16, 256, True),    # gemma-7b prefill: head_dim 256
    (4, 2048, 16, 16, 256, False),   # the same, bidirectional
    (4, 2048, 32, 32, 80, True),     # zamba2-2.7b prefill: head_dim 80 (its 4096-token
                                     # window does not bite at 2048)
]
# the backward's: (B, S, H, KV, hd, causal), 8192 tokens a call
BWD_SHAPES = [(8192 // S, S, H, KV, hd, causal)
              for H, KV, hd in ((28, 4, 128), (56, 8, 64))
              for causal in (True, False)
              for S in (1024, 2048, 4096, 8192)]
BWD_SHAPES += [(2, 4096, 32, 32, 80, True),     # zamba2-2.7b's training shape
               (2, 4096, 16, 16, 256, True)]    # gemma-7b's


def main() -> None:
    """Time every shape of SHAPES and print one JSON line each."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernels (beside the library's backward)")
    ap.add_argument("--dtype", choices=("bf16", "fp16"), default="bf16")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_bench: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash_mod
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
    for B, S, H, KV, hd, causal in BWD_SHAPES if args.backward else SHAPES:
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ops.reset_launch_counts()
        if args.backward:
            do = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
            o, lse = flash_mod.launch_forward(q, k, v, causal, 0, 0.0, with_lse=True)
            ms = time_ms(lambda: flash_mod.launch_backward(q, k, v, o, lse, do, causal, 0, 0.0))
            by_variant = ops.flash_bwd_launches_by_variant()
            leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
            dot = do.transpose(1, 2)
            lib_ms = time_ms(lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True))
            del do, o, lse, leaves, out, dot
        else:
            ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
            by_variant = getattr(ops, "flash_launches_by_variant", dict)()  # older trees: none
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
        ran = [name for name, n in by_variant.items() if n]
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = (10.0 if args.backward else 4.0) * hd * pairs * B * H
        row = {"pass": "backward" if args.backward else "forward",
               "shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd, "causal": causal},
               "dtype": args.dtype, "variant": ran, "ms": ms,
               "tflops": flops / (ms * 1e-3) / 1e12,
               "share_of_bound": flops / PEAK_TENSOR_16BIT_FLOPS / (ms * 1e-3),
               "library_ms": lib_ms}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
