#!/usr/bin/env python3
"""Times the port's flash-attention forward, or its backward, on the card across
shapes, to see what bounds it: causal against bidirectional, short against long
sequences, and how many query heads share one K/V head (the K/V bytes each tile
brings in).

    python3 tools/flash_bench.py [--backward] [--dtype bf16|fp16|fp32] [--iters 20]
                                 [--head-dims 32 16] [--src DIR] [--out FILE]

For each shape: the kernel variant that ran, its time (CUDA events over --iters
calls after a warm-up, the wrapper's host work included), the same calls replayed
from one CUDA graph (``graph_ms``: the device's time alone), TFLOP/s over the
(query, key) pairs the mask leaves visible (4 * hd operations each forward, 10 * hd
backward), the share of the bound, and ``F.scaled_dot_product_attention`` (its
backward, through autograd, with --backward) on the same tensors as a yardstick (the
port never calls it).  The bound is the larger of the bytes over 3.35 TB/s and the
operations over the peak: 989 TFLOP/s in 16 bits; in float32, whose kernels run
3xTF32 (three TF32 products a float32 product), 495 / 3 = 165 TFLOP/s.  The forward's
16-bit shapes include gemma-7b's head_dim 256, zamba2-2.7b's head_dim 80 and head_dim
32 and 16 at (2, 2048, 16/16), causal.  The backward's hold 8192 tokens a call: S in
1024..8192, causal and not, head_dim 128 (28 query heads on 4 K/V heads) and 64 (56
on 8), then zamba2's training shape (head_dim 80, 32 heads on 32), gemma's (head_dim
256) and head_dim 32 and 16 at (2, 2048, 16/16), causal.  At head_dim 32 and 16 the
row also gives the floor the exponentials set (``ex2_floor_ms``: one a visible pair
at 16 a clock on each of 132 SMs at 1.83 GHz).  --head-dims keeps the shapes of those
head_dims only.  float32 (--dtype fp32), both ways:
launch_reduced's (8, 256, 4/2, 32) and qwen2-7b's training shape (2, 4096, 28/4,
128), both causal.  --src times another checkout's kernels (its ``src``, e.g. a
parent commit unpacked under ``_cmp/``) with this script, so two trees can be timed
in turns in one call.  Prints the card's name and power limit, then one JSON line per
shape.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PEAK_BYTES_PER_S = 3.35e12
PEAK_TENSOR_16BIT_FLOPS = 989e12
PEAK_TF32X3_FLOPS = 495e12 / 3   # float32-accurate work on the TF32 tensor cores
PEAK_EX2_PER_S = 16 * 132 * 1.83e9   # MUFU exponentials: 16 a clock an SM

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
    (2, 2048, 16, 16, 32, True),     # head_dim 32: one 32-column box
    (2, 2048, 16, 16, 16, True),     # head_dim 16: one 16-column box
]
# the backward's: (B, S, H, KV, hd, causal), 8192 tokens a call
BWD_SHAPES = [(8192 // S, S, H, KV, hd, causal)
              for H, KV, hd in ((28, 4, 128), (56, 8, 64))
              for causal in (True, False)
              for S in (1024, 2048, 4096, 8192)]
BWD_SHAPES += [(2, 4096, 32, 32, 80, True),     # zamba2-2.7b's training shape
               (2, 4096, 16, 16, 256, True),    # gemma-7b's
               (2, 2048, 16, 16, 32, True),     # head_dim 32 and 16
               (2, 2048, 16, 16, 16, True)]
# float32, both ways: launch_reduced's shape (the reduced qwen2-7b, 8 x 256 tokens)
# and qwen2-7b's training shape
FP32_SHAPES = [(8, 256, 4, 2, 32, True), (2, 4096, 28, 4, 128, True)]


def main() -> None:
    """Time every shape of SHAPES and print one JSON line each."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernels (beside the library's backward)")
    ap.add_argument("--dtype", choices=("bf16", "fp16", "fp32"), default="bf16")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--head-dims", type=int, nargs="*", default=[],
                    help="time only the shapes of these head_dims")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_bench: no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops

    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}[args.dtype]
    peak = PEAK_TF32X3_FLOPS if dtype == torch.float32 else PEAK_TENSOR_16BIT_FLOPS
    torch.backends.cuda.matmul.allow_tf32 = False   # the yardstick in full float32
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

    def graph_ms(fn) -> float:
        """Per-call time of --iters calls captured in one CUDA graph, replayed."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(args.iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (3 * args.iters)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: nothing")
    rows = []
    shapes = FP32_SHAPES if dtype == torch.float32 else BWD_SHAPES if args.backward else SHAPES
    if args.head_dims:
        shapes = [s for s in shapes if s[4] in args.head_dims]
    for B, S, H, KV, hd, causal in shapes:
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ops.reset_launch_counts()
        if args.backward:
            do = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
            o, lse = flash_mod.launch_forward(q, k, v, causal, 0, 0.0, with_lse=True)
            call = lambda: flash_mod.launch_backward(  # noqa: E731
                q, k, v, o, lse, do, causal, 0, 0.0)
            ms, dev_ms = time_ms(call), graph_ms(call)
            by_variant = ops.flash_bwd_launches_by_variant()
            nbytes = q.element_size() * (5 * q.numel() + 4 * k.numel()) + 4.0 * lse.numel()
            leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
            dot = do.transpose(1, 2)
            lib_ms = time_ms(lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True))
            del do, o, lse, leaves, out, dot
        else:
            call = lambda: ops.flash_attention(q, k, v, causal=causal)  # noqa: E731
            ms, dev_ms = time_ms(call), graph_ms(call)
            by_variant = getattr(ops, "flash_launches_by_variant", dict)()  # older trees: none
            nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
        ran = [name for name, n in by_variant.items() if n]
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = (10.0 if args.backward else 4.0) * hd * pairs * B * H
        bounds = {"operations": flops / peak * 1e3, "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
        bound_ms = max(bounds.values())
        row = {"pass": "backward" if args.backward else "forward",
               "shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd, "causal": causal},
               "dtype": args.dtype, "src": args.src, "variant": ran, "ms": ms,
               "graph_ms": dev_ms, "tflops": flops / (ms * 1e-3) / 1e12,
               "bound_ms": bound_ms, "bound_by": max(bounds, key=bounds.get),
               "share_of_bound": bound_ms / ms, "graph_share_of_bound": bound_ms / dev_ms,
               "library_ms": lib_ms}
        if hd <= 32:
            row["ex2_floor_ms"] = pairs * B * H / PEAK_EX2_PER_S * 1e3
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
