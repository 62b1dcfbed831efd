#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # everything, as below
    python3 chip_smoke.py --layers 4      # cut the served model's depth (never its width)
    python3 chip_smoke.py --skip-serve --skip-train   # build and check the kernels only
    python3 chip_smoke.py --out DIR       # also write report.json(l) and nvcc's log there

What it does, one JSON line per phase on standard output:

  device   the card's name and power limit (nvidia-smi), torch and CUDA versions;
  build    builds the kernels' shared library from src/repro_torch/kernels/csrc/
           with nvcc (first use of the library);
  kernels  holds each hand-written kernel against its plain PyTorch version on the
           card, at the reference's test cases and cases across the wgmma kernel's
           tile edges (fp32, bf16, fp16) and at the shapes the serving and training
           paths give it: the forwards, the attention forward's lse, and the two
           backwards (dq, dk, dv; dx, dw); records which flash variant each case
           launched, forward and backward (one rule: 16-bit head_dim 64/128 wgmma,
           other 16-bit mma.sync, fp32 scalar), shows that a call either wgmma kernel
           cannot take raises instead of running another variant, that two backward
           calls on the same inputs give dk, dv, dx and dw bit for bit (dq within
           tolerance: its sum runs through atomics), and times kernel, plain version,
           one library call (a yardstick only; the port never calls it; for the
           RMSNorm backward three readings in turns with the kernel, and the names of
           the kernels it launches) and the card's bound, and the device time of each
           kernel an attention backward call launches; RMSNorm at the decode shape
           also device-only, from a CUDA graph;
  small    a reduced fp32 model on the card (through the kernels) against the same
           weights on the CPU (plain versions): prefill + decode, then three train
           steps (loss, grad norm, every parameter, exact launch counts per step)
           and a checkpoint round trip of the card's train state, bit for bit;
  serve    qwen2-7b at full width and depth in bf16, random weights from a seed:
           4 requests of 2048 tokens through make_prefill_step, 16 greedy steps
           through make_serve_step, with the kernels' launch counts set to 0 just
           before and read just after (every prefill flash launch must be the
           wgmma variant); then the prefill/decode agreement check;
  train    (the serve model freed first) qwen2-7b at full width, 8 of 28 layers,
           bf16: the Trainer over SyntheticLM batches of 2 x 4096 tokens for 6
           steps, counts at 0 just before; exact launches of every kernel, forward
           and backward, per step; finite losses, the step-0 loss where a random
           init puts it; ms per step, tokens/s, MFU and peak memory.

Then the card's name and power limit, a {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}.  Any failed check ends the run with a non-zero exit
code and without that last line.  Without a CUDA device the script exits at once:
it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
PEAK_BYTES_PER_S = 3.35e12
PEAK_TENSOR_16BIT_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

# The reference's kernel test cases: (B, Sq, Skv, H, KV, hd, causal, window)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 64, 256, 8, 8, 32, True, 0),       # queries aligned to the end of the keys
    (2, 128, 128, 4, 4, 64, True, 48),     # sliding window
    (1, 1, 128, 4, 2, 64, True, 0),        # single-token decode
    (2, 96, 96, 6, 2, 32, False, 0),       # bidirectional
    (1, 256, 256, 2, 1, 128, True, 0),     # MQA
    (1, 32, 32, 4, 4, 16, True, 8),        # tiny window
    (1, 100, 100, 2, 2, 256, True, 0),     # head_dim 256 (needs > 48 KB shared memory)
    (1, 70, 200, 4, 2, 64, False, 33),     # window without causal, ragged sizes
]
# Cases across the TMA + wgmma kernel's 128-row q tile and 128-key kv tile edges
# (head_dim 64 and 128, the shapes that kernel takes in 16 bits).
FLASH_TILE_EDGE_CASES = [
    (1, 129, 129, 4, 2, 128, True, 0),     # one row and one key past a tile
    (2, 255, 383, 28, 4, 128, True, 0),    # Sq < Skv, both ragged, qwen2-7b's heads
    (1, 300, 300, 4, 1, 64, True, 100),    # a window that spans tiles
    (2, 200, 200, 8, 8, 128, False, 0),    # bidirectional, ragged
]
# Cases across the wgmma backward's tiles (128 keys; 64 query rows at head_dim 128,
# 128 at 64): ragged GQA with Sq < Skv, and a head_dim 64 window spanning two key tiles.
FLASH_BWD_EDGE_CASES = [
    (2, 191, 321, 28, 4, 128, True, 0),
    (2, 260, 260, 8, 2, 64, True, 150),
]
# softcap 20 on scores scaled by 3 x 3, as the reference's test has it
FLASH_SOFTCAP_CASES = [(1, 64, 64, 2, 2, 32, True, 0), (1, 200, 200, 4, 2, 128, True, 0)]
SM90_HEAD_DIMS = (64, 128)   # 16-bit head_dims that must run on the wgmma kernel
RMSNORM_SHAPES = [(4, 37, 128), (1, 1, 256), (8, 512), (2, 3, 5, 64)]

# Tolerances (absolute and relative, as in the reference's tests), with reasons:
#  fp32: kernel and plain version both compute in fp32 but sum in another order
#        (per 32-key tile with a running maximum, against one softmax over the row);
#  softcap: tanh of scores scaled by 3 amplifies that difference;
#  16-bit: the kernel rounds the probabilities to the input type for the p*v
#        product and its output once at the end (one bf16 ulp at O(1) values is
#        0.008-0.016); it is held against the plain version run on the same values
#        in fp32.
TOL_FLASH_FP32, TOL_FLASH_SOFTCAP, TOL_16BIT, TOL_RMSNORM_FP32 = 2e-5, 1e-4, 2e-2, 1e-5
# The backwards and the forward's lse are held as a share of the reference's largest
# magnitude (a gradient's small entries are differences of large terms):
#  fp32: 1e-4 for attention -- sums over up to 4,096 keys in another order and
#        expf / tanhf against torch's; 1e-5 for RMSNorm (sums over one row, and dw
#        over the rows in a fixed other order);
#  16-bit: 2e-2 -- the kernels round p and ds to the input type for the products
#        and D is taken from the 16-bit output, against the plain version run in fp32
#        on the same values;
#  lse: 1e-4 in fp32 and 1e-3 in 16 bits (the wgmma kernel's exponentials are the
#        approximate ex2 instruction).
TOL_BWD_FP32, TOL_RMSNORM_BWD_FP32, TOL_LSE_FP32, TOL_LSE_16BIT = 1e-4, 1e-5, 1e-4, 1e-3

FAILURES: list[str] = []


#: where emit() also appends its lines (--out): the end of a long standard output
#: may be all a caller gets back
REPORT_LINES: list[Path] = []


def emit(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    for path in REPORT_LINES:
        with path.open("a") as f:
            f.write(line + "\n")


def fail(msg: str) -> None:
    FAILURES.append(msg)
    print("FAIL: " + msg, file=sys.stderr, flush=True)


def stop_if_failed(phase: str) -> None:
    if FAILURES:
        print(f"chip_smoke: phase {phase!r} failed: {len(FAILURES)} check(s)",
              file=sys.stderr)
        sys.exit(1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the served model's depth to this many layers")
    ap.add_argument("--skip-serve", action="store_true")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit("chip_smoke: src/repro_torch is not beside this script")
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script measures on the "
                 "card only")
    sys.path.insert(0, str(ROOT / "src"))
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        REPORT_LINES.append(Path(args.out) / "report.jsonl")
        REPORT_LINES[0].write_text("")
    run(args, torch)


def run(args, torch) -> None:
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import rmsnorm as rms_mod
    from repro_torch.checkpoint.store import restore as restore_state
    from repro_torch.checkpoint.store import save as save_state
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.convert import (export_jax_train_state,
                                            jax_train_state_like, load_jax_train_state)
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.trainstep import (init_train_state, make_prefill_step,
                                                make_serve_step, make_train_step)
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 checks need fp32
    report: dict = {}

    # ------------------------------------------------------------- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave nothing"
    report["device"] = {
        "phase": "device", "nvidia_smi": smi_line,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(report["device"])

    # -------------------------------------------------------------- build
    t0 = time.perf_counter()
    _build.load()
    report["build"] = {
        "phase": "build", "built": _build.build_info["built"],
        "nvcc_seconds": round(_build.build_info["seconds"], 2),
        "seconds": round(time.perf_counter() - t0, 2),
        "sources": [str(s.relative_to(ROOT)) for s in _build.sources()]}
    emit(report["build"])
    if args.out:
        (Path(args.out) / "nvcc.log").write_text(_build.build_info["log"])

    # ------------------------------------------------------------ helpers
    def time_ms(fn, iters: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def graph_ms(fn, calls: int, replays: int = 10) -> float:
        """Per-call time of `calls` calls of fn captured in one CUDA graph."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * calls)

    def compare_share(name: str, got, want, tol: float) -> float:
        """Max abs error as a share of want's largest magnitude; a failure above tol."""
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"{name}: bad shape {tuple(g.shape)} or non-finite values")
            return float("inf")
        share = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if not share <= tol:
            fail(f"{name}: max abs err {share:.3e} of the largest magnitude exceeds {tol:g}")
        return share

    def compare(name: str, got, want, tol: float) -> float:
        """Max abs error; records a failure unless |got-want| <= tol + tol*|want|."""
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"{name}: bad shape {tuple(g.shape)} or non-finite values")
            return float("inf")
        err = (g - w).abs()
        excess = float((err - (tol + tol * w.abs())).max())
        worst = float(err.max())
        if excess > 0:
            fail(f"{name}: max abs err {worst:.3e} exceeds tolerance {tol:g}")
        return worst

    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    # ------------------------------------------------------------ kernels
    def flash_inputs(case, dtype, scale=1.0):
        B, Sq, Skv, H, KV, hd, _, _ = case
        return (randn((B, Sq, H, hd), dtype, scale),
                randn((B, Skv, KV, hd), dtype, scale),
                randn((B, Skv, KV, hd), dtype))

    def truth(q, k, v, **kw):
        """The plain version on the same values held in fp32: a 16-bit plain
        version rounds its scores to 16 bits, which is its error, not the kernel's."""
        return ops.mha_reference(q.float(), k.float(), v.float(), **kw)

    def expected_variant(dtype, hd) -> str:
        if dtype == torch.float32:
            return "scalar"
        return "sm90_wgmma" if hd in SM90_HEAD_DIMS else "mma_sync"

    def flash_case(case, dtype, tol, scale=1.0, softcap=0.0) -> dict:
        """One checked call; records the variant it launched and fails if that is
        not the one the split by shape names."""
        q, k, v = flash_inputs(case, dtype, scale)
        kw = dict(causal=case[6], window=case[7], softcap=softcap)
        before = ops.flash_launches_by_variant()
        got = ops.flash_attention(q, k, v, **kw)
        after = ops.flash_launches_by_variant()
        ran = [key for key in after if after[key] != before[key]]
        want_variant = expected_variant(dtype, case[5])
        if ran != [want_variant] or flash_mod.variant(dtype, case[5]) != want_variant:
            fail(f"flash {case} {dtype}: launched {ran}, expected [{want_variant!r}]")
        name = f"flash {case} {dtype}" + (f" softcap {softcap:g}" if softcap else "")
        err = compare(name, got, truth(q, k, v, **kw), tol)
        return {"case": list(case) + ([f"softcap {softcap:g}"] if softcap else []),
                "dtype": str(dtype), "variant": ran[0] if len(ran) == 1 else ran,
                "max_abs_err": err, "tol": tol}

    flash_cases = []
    for dtype, tol in ((torch.float32, TOL_FLASH_FP32),
                       (torch.bfloat16, TOL_16BIT), (torch.float16, TOL_16BIT)):
        for case in FLASH_CASES + FLASH_TILE_EDGE_CASES:
            flash_cases.append(flash_case(case, dtype, tol))
        stol = TOL_FLASH_SOFTCAP if dtype == torch.float32 else TOL_16BIT
        for case in FLASH_SOFTCAP_CASES:
            flash_cases.append(flash_case(case, dtype, stol, scale=3.0, softcap=20.0))

    # Backward kernels, and the forward's lse, against the plain versions held in fp32
    def flash_bwd_case(case, dtype, scale=1.0, softcap=0.0) -> dict:
        fp32 = dtype == torch.float32
        tol, lse_tol = (TOL_BWD_FP32, TOL_LSE_FP32) if fp32 else (TOL_16BIT, TOL_LSE_16BIT)
        q, k, v = flash_inputs(case, dtype, scale)
        do = randn(q.shape, dtype)
        causal, window = case[6], case[7]
        o, lse = flash_mod.launch_forward(q, k, v, causal, window, softcap, with_lse=True)
        before = ops.flash_bwd_launches_by_variant()
        grads = flash_mod.launch_backward(q, k, v, o, lse, do, causal, window, softcap)
        after = ops.flash_bwd_launches_by_variant()
        ran = [key for key in after if after[key] != before[key]]
        want_variant = expected_variant(dtype, case[5])
        if ran != [want_variant] or flash_mod.bwd_variant(dtype, case[5]) != want_variant:
            fail(f"flash backward {case} {dtype}: launched {ran}, expected [{want_variant!r}]")
        kw = dict(causal=causal, window=window, softcap=softcap)
        qf, kf, vf = q.float(), k.float(), v.float()
        o_ref = ops.mha_reference(qf, kf, vf, **kw)
        lse_ref = ops.flash_attention_lse_reference(qf, kf, **kw)
        want = ops.flash_attention_bwd_reference(qf, kf, vf, o_ref, lse_ref, do.float(), **kw)
        name = f"flash backward {case} {dtype}" + (f" softcap {softcap:g}" if softcap else "")
        errs = {"lse": compare_share(name + " lse", lse, lse_ref, lse_tol)}
        for gname, got, ref_ in zip(("dq", "dk", "dv"), grads, want):
            errs[gname] = compare_share(f"{name} {gname}", got, ref_, tol)
        worst = max(float((got.float() - ref_).abs().max()) for got, ref_ in zip(grads, want))
        del q, k, v, do, o, lse, grads, want, o_ref, lse_ref
        return {"case": list(case) + ([f"softcap {softcap:g}"] if softcap else []),
                "dtype": str(dtype), "variant": ran[0] if len(ran) == 1 else ran,
                "max_err_share": errs, "max_abs_err": worst, "tol": tol, "lse_tol": lse_tol}

    flash_bwd_cases = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for case in FLASH_CASES + FLASH_TILE_EDGE_CASES + FLASH_BWD_EDGE_CASES:
            flash_bwd_cases.append(flash_bwd_case(case, dtype))
        for case in FLASH_SOFTCAP_CASES:
            flash_bwd_cases.append(flash_bwd_case(case, dtype, scale=3.0, softcap=20.0))

    # A call the wgmma kernel cannot take must raise, never run another variant:
    # q one element past a 16-byte boundary (the wrapper refuses it first, so the
    # C launcher is called directly) cannot be described by a tensor map.
    case = FLASH_TILE_EDGE_CASES[0]
    q, k, v = flash_inputs(case, torch.bfloat16)
    q_off = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
    q_off.copy_(q)
    o = torch.full_like(q, float("nan"))
    torch.cuda.synchronize()
    lib = _build.load()
    code = lib.repro_flash_attention_fwd(
        q_off.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, case[0], case[1],
        case[2], case[3], case[4], case[5], *q_off.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *o.stride()[:3], 1, 0, 0.0, _build.DTYPE_CODES[torch.bfloat16],
        0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    try:
        _build.check(code, "flash_attention")
        raised = ""
    except RuntimeError as exc:
        raised = str(exc)
    if code != -3 or not raised or not bool(torch.isnan(o).all()):
        fail(f"misaligned q: launcher returned {code} (want -3, a refusal), "
             f"raised {raised!r}, output touched: {not bool(torch.isnan(o).all())}")
    refusal = {"case": list(case), "dtype": "torch.bfloat16", "q_offset_bytes": 2,
               "code": code, "raised": raised}

    # the same for the backward's wgmma kernel: its launcher refuses before it
    # launches anything, and dq, dk, dv stay untouched
    o, lse = flash_mod.launch_forward(q, k, v, True, 0, 0.0, with_lse=True)
    do = randn(q.shape, torch.bfloat16)
    grads = [torch.full_like(t, float("nan")) for t in (q, k, v)]
    delta, dq_acc = flash_mod._bwd_scratch("sm90_wgmma", q)
    call = _build.FlashBwdCall(
        q=q_off.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        dout=do.data_ptr(), lse=lse.data_ptr(), delta=delta.data_ptr(),
        dq_acc=dq_acc.data_ptr(), dq=grads[0].data_ptr(), dk=grads[1].data_ptr(),
        dv=grads[2].data_ptr(), stream=torch.cuda.current_stream().cuda_stream,
        B=case[0], Sq=case[1], Skv=case[2], H=case[3], KV=case[4], hd=case[5], causal=1,
        window=0, softcap=0.0, dtype=_build.DTYPE_CODES[torch.bfloat16], device=0)
    for name, t in zip(_build.FLASH_BWD_TENSORS, (q_off, k, v, o, do, *grads)):
        for i, part in enumerate(("sb", "ss", "sh")):
            setattr(call, f"{name}_{part}", t.stride(i))
    torch.cuda.synchronize()
    code = lib.repro_flash_attention_bwd(ctypes.addressof(call))
    torch.cuda.synchronize()
    try:
        _build.check(code, "flash_attention backward")
        raised = ""
    except RuntimeError as exc:
        raised = str(exc)
    untouched = all(bool(torch.isnan(t).all()) for t in grads)
    if code != -3 or not raised or not untouched:
        fail(f"misaligned q, backward: launcher returned {code} (want -3, a refusal), "
             f"raised {raised!r}, gradients untouched: {untouched}")
    bwd_refusal = {"case": list(case), "dtype": "torch.bfloat16", "q_offset_bytes": 2,
                   "code": code, "raised": raised}
    del q, k, v, q_off, o, lse, do, grads, delta, dq_acc

    rms_cases = []
    for dtype, tol in ((torch.float32, TOL_RMSNORM_FP32),
                       (torch.bfloat16, TOL_16BIT), (torch.float16, TOL_16BIT)):
        for shape in RMSNORM_SHAPES + [(3, 3584), (5, 7, 100), (2, 1027)]:
            for wdtype in {dtype, torch.float32}:
                x = randn(shape, dtype)
                w = randn(shape[-1:], wdtype, 0.1) + 1
                err = compare(f"rmsnorm {shape} {dtype} w {wdtype}", ops.rmsnorm(x, w),
                              ops.rmsnorm_reference(x, w), tol)
                rms_cases.append({"shape": list(shape), "dtype": str(dtype),
                                  "w_dtype": str(wdtype), "max_abs_err": err,
                                  "tol": tol})

    rms_bwd_cases = []
    for dtype, tol in ((torch.float32, TOL_RMSNORM_BWD_FP32),
                       (torch.bfloat16, TOL_16BIT), (torch.float16, TOL_16BIT)):
        # (2, 1027): the row pipeline at 4 packs a thread; (2, 2051): past its reach,
        # the block-per-row kernel
        for shape in RMSNORM_SHAPES + [(3, 3584), (5, 7, 100), (2, 1027), (2, 2051),
                                       (8192, 3584)]:
            for wdtype in {dtype, torch.float32}:
                x = randn(shape, dtype)
                w = randn(shape[-1:], wdtype, 0.1) + 1
                dy = randn(shape, dtype)
                dx, dw = rms_mod.launch_backward(
                    x, w, dy, 1e-6, 0, _build.DTYPE_CODES[dtype], _build.DTYPE_CODES[wdtype])
                dx_ref, dw_ref = ops.rmsnorm_bwd_reference(x.float(), w.float(), dy.float())
                name = f"rmsnorm backward {shape} {dtype} w {wdtype}"
                rms_bwd_cases.append({
                    "shape": list(shape), "dtype": str(dtype), "w_dtype": str(wdtype),
                    "max_err_share": {"dx": compare_share(name + " dx", dx, dx_ref, tol),
                                      "dw": compare_share(name + " dw", dw, dw_ref, tol)},
                    "max_abs_err": max(float((dx.float() - dx_ref).abs().max()),
                                       float((dw.float() - dw_ref).abs().max())),
                    "tol": tol})
                del x, w, dy, dx, dw, dx_ref, dw_ref

    # the serving path's own shapes, bf16
    cfg = get_config("qwen2_7b")
    B_REQ, S_REQ, GEN_STEPS, CACHE_EXTRA = 4, 2048, 16, 32
    B_TRAIN, S_TRAIN = 2, 4096   # TRAIN_4K's length; its global batch of 256 cut to 2
    TRAIN_LAYERS = 8
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    bf16 = torch.bfloat16

    def visible_pairs(Sq, Skv, causal, window):
        qpos = np.arange(Sq)[:, None] + (Skv - Sq)
        kpos = np.arange(Skv)[None, :]
        m = np.ones((Sq, Skv), bool)
        if causal:
            m &= qpos >= kpos
        if window:
            m &= qpos - kpos < window
        return int(m.sum())

    main_case = (B_REQ, S_REQ, S_REQ, H, KV, hd, cfg.causal, 0)
    main_entry = flash_case(main_case, bf16, TOL_16BIT)
    flash_err = main_entry["max_abs_err"]
    q, k, v = flash_inputs(main_case, bf16)
    flash_ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=cfg.causal), 20)
    flash_plain_ms = time_ms(lambda: ops.mha_reference(q, k, v, causal=cfg.causal), 3, 1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        flash_lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qt, kt, vt, is_causal=cfg.causal, enable_gqa=True)
        flash_lib()
    except TypeError:   # an older torch without enable_gqa: repeat k/v beforehand
        kr, vr = (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
        flash_lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qt, kr, vr, is_causal=cfg.causal)
    flash_lib_ms = time_ms(flash_lib, 20)
    pairs = visible_pairs(S_REQ, S_REQ, cfg.causal, 0)
    flash_flops = 4.0 * hd * pairs * B_REQ * H
    flash_bytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    flash_bounds = {"operations": flash_flops / PEAK_TENSOR_16BIT_FLOPS * 1e3,
                    "bytes": flash_bytes / PEAK_BYTES_PER_S * 1e3}
    flash_bound_by = max(flash_bounds, key=flash_bounds.get)

    ragged = (1, S_REQ + 1, S_REQ + 1, H, KV, hd, cfg.causal, 0)
    flash_cases += [main_entry, flash_case(ragged, bf16, TOL_16BIT)]
    del q, k, v, qt, kt, vt

    # the training path's attention shape, bf16: the backward checked and timed, the
    # forward timed with and without lse
    train_case = (B_TRAIN, S_TRAIN, S_TRAIN, H, KV, hd, cfg.causal, 0)
    train_bwd_entry = flash_bwd_case(train_case, bf16)
    flash_bwd_cases.append(train_bwd_entry)
    torch.cuda.empty_cache()
    q, k, v = flash_inputs(train_case, bf16)
    do = randn(q.shape, bf16)
    o, lse = flash_mod.launch_forward(q, k, v, cfg.causal, 0, 0.0, with_lse=True)
    fwd_train = {
        "ms_with_lse": time_ms(lambda: flash_mod.launch_forward(
            q, k, v, cfg.causal, 0, 0.0, with_lse=True), 20),
        "ms_without_lse": time_ms(lambda: flash_mod.launch_forward(
            q, k, v, cfg.causal, 0, 0.0, with_lse=False), 20)}
    bwd_ms = time_ms(lambda: flash_mod.launch_backward(
        q, k, v, o, lse, do, cfg.causal, 0, 0.0), 10)
    # two calls on the same inputs: dk and dv bit for bit (summed in registers in a
    # fixed order); dq within tolerance (the wgmma kernel sums it with atomics)
    first = flash_mod.launch_backward(q, k, v, o, lse, do, cfg.causal, 0, 0.0)
    again = flash_mod.launch_backward(q, k, v, o, lse, do, cfg.causal, 0, 0.0)
    bwd_repeat = {"dk_bit_exact": bool(torch.equal(first[1], again[1])),
                  "dv_bit_exact": bool(torch.equal(first[2], again[2])),
                  "dq_bit_exact": bool(torch.equal(first[0], again[0])),
                  "dq_max_err_share": compare_share("flash backward repeat dq", again[0],
                                                    first[0], TOL_16BIT)}
    if not (bwd_repeat["dk_bit_exact"] and bwd_repeat["dv_bit_exact"]):
        fail(f"flash backward repeat at the training shape: {bwd_repeat}")
    del first, again
    # the device time of each kernel a backward call launches (one profiled call)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_mod.launch_backward(q, k, v, o, lse, do, cfg.causal, 0, 0.0)
        torch.cuda.synchronize()
    bwd_kernel_ms: dict = {}
    for e in prof.events():
        name = re.search(r"flash_bwd\w*", e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and name:
            bwd_kernel_ms[name.group()] = (bwd_kernel_ms.get(name.group(), 0.0)
                                           + e.time_range.elapsed_us() / 1e3)
    bwd_plain_ms = time_ms(lambda: ops.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=cfg.causal), 2, 1)
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=cfg.causal,
                                             enable_gqa=True)
    except TypeError:   # an older torch without enable_gqa
        out = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(H // KV, dim=1), vt.repeat_interleave(H // KV, dim=1),
            is_causal=cfg.causal)
    bwd_lib_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                     retain_graph=True), 10)
    pairs_train = visible_pairs(S_TRAIN, S_TRAIN, cfg.causal, 0) * B_TRAIN * H
    bwd_flops = 10.0 * hd * pairs_train
    bwd_bytes = 2.0 * (3 * q.numel() + 2 * (k.numel() + v.numel()) + 2 * o.numel()) \
        + 4.0 * lse.numel()
    bwd_bounds = {"operations": bwd_flops / PEAK_TENSOR_16BIT_FLOPS * 1e3,
                  "bytes": bwd_bytes / PEAK_BYTES_PER_S * 1e3}
    fwd_train_flops = 4.0 * hd * pairs_train
    fwd_train["bound_ms"] = max(fwd_train_flops / PEAK_TENSOR_16BIT_FLOPS * 1e3,
                                2.0 * (2 * q.numel() + k.numel() + v.numel()) / PEAK_BYTES_PER_S
                                * 1e3 + 4.0 * lse.numel() / PEAK_BYTES_PER_S * 1e3)
    del q, k, v, do, o, lse, qt, kt, vt, dot, out
    torch.cuda.empty_cache()

    rms_shapes = {}
    for rows in (B_REQ * S_REQ, B_REQ):
        x = randn((rows, d), bf16)
        w = randn((d,), bf16, 0.1) + 1
        err = compare(f"rmsnorm ({rows},{d}) bf16", ops.rmsnorm(x, w, eps=cfg.norm_eps),
                      ops.rmsnorm_reference(x, w, cfg.norm_eps), TOL_16BIT)
        iters = 50 if rows > 100 else 200
        nbytes = 2.0 * (2 * x.numel() + w.numel())
        bounds = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
                  "operations": 4.0 * x.numel() / PEAK_FP32_FLOPS * 1e3}
        rms_shapes[rows] = {
            "shape": [rows, d], "max_abs_err": err,
            "ms": time_ms(lambda: ops.rmsnorm(x, w, eps=cfg.norm_eps), iters),
            "plain_ms": time_ms(lambda: ops.rmsnorm_reference(x, w, cfg.norm_eps), iters),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, cfg.norm_eps), iters),
            "bound_ms": max(bounds.values()),
            "bound_by": max(bounds, key=bounds.get)}
        if rows == B_REQ:
            # the same calls replayed from a CUDA graph: the device's share of a call
            # without the host's launch path (the wrapper's share is the difference)
            rms_shapes[rows]["graph_ms"] = graph_ms(
                lambda: ops.rmsnorm(x, w, eps=cfg.norm_eps), 200)
        del x, w
    torch.cuda.empty_cache()

    # RMSNorm backward at the training path's shape (2 x 4096 rows of d_model), bf16
    rows = B_TRAIN * S_TRAIN
    x, dy = randn((rows, d), bf16), randn((rows, d), bf16)
    w = randn((d,), bf16, 0.1) + 1
    bcodes = (0, _build.DTYPE_CODES[bf16], _build.DTYPE_CODES[bf16])
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    y_lib = F.rms_norm(xr, (d,), wr, cfg.norm_eps)
    rms_bwd_bounds = {"bytes": 2.0 * (3 * x.numel() + 2 * w.numel()) / PEAK_BYTES_PER_S * 1e3,
                      "operations": 10.0 * x.numel() / PEAK_FP32_FLOPS * 1e3}
    # the kernel and its library yardstick (autograd of F.rms_norm) in turns, three
    # readings each: the yardstick read 0.134 ms in one run and 0.41-0.45 in others
    rms_bwd_ms, rms_bwd_lib_ms = [], []
    for _ in range(3):
        rms_bwd_ms.append(time_ms(lambda: rms_mod.launch_backward(
            x, w, dy, cfg.norm_eps, *bcodes), 50))
        rms_bwd_lib_ms.append(time_ms(lambda: torch.autograd.grad(
            y_lib, (xr, wr), dy, retain_graph=True), 50))
    # which kernels the yardstick launches (one profiled call)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(y_lib, (xr, wr), dy, retain_graph=True)
        torch.cuda.synchronize()
    lib_kernels = sorted({e.name for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA})
    rms_bwd_entry = {
        "shape": [rows, d],
        "ms": float(np.median(rms_bwd_ms)), "ms_readings": rms_bwd_ms,
        "plain_ms": time_ms(lambda: ops.rmsnorm_bwd_reference(x, w, dy, cfg.norm_eps), 20),
        "library_ms": float(np.median(rms_bwd_lib_ms)),
        "library_ms_readings": rms_bwd_lib_ms, "library_kernels": lib_kernels,
        "bound_ms": max(rms_bwd_bounds.values()),
        "bound_by": max(rms_bwd_bounds, key=rms_bwd_bounds.get)}
    first = rms_mod.launch_backward(x, w, dy, cfg.norm_eps, *bcodes)
    again = rms_mod.launch_backward(x, w, dy, cfg.norm_eps, *bcodes)
    rms_bwd_entry["repeat_bit_exact"] = {"dx": bool(torch.equal(first[0], again[0])),
                                         "dw": bool(torch.equal(first[1], again[1]))}
    if not all(rms_bwd_entry["repeat_bit_exact"].values()):
        fail(f"rmsnorm backward repeat: {rms_bwd_entry['repeat_bit_exact']}")
    del first, again
    main_rms_bwd = next(
        c for c in rms_bwd_cases
        if c["shape"] == [rows, d] and c["dtype"] == str(bf16) and c["w_dtype"] == str(bf16))
    rms_bwd_entry["max_abs_err"] = main_rms_bwd["max_abs_err"]
    rms_bwd_entry["max_err_share"] = main_rms_bwd["max_err_share"]
    del x, dy, w, xr, wr, y_lib
    torch.cuda.empty_cache()

    kernels = {
        "rmsnorm": {
            "name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:38",
            "launches": 0, "dtype": "bfloat16",
            **rms_shapes[B_REQ * S_REQ],
            "tol": TOL_16BIT,
            "worst_err_all_cases": max(c["max_abs_err"] for c in rms_cases),
            "decode_shape": rms_shapes[B_REQ]},
        "flash_attention": {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:155",
            "launches": 0, "dtype": "bfloat16",
            "shape": {"q": [B_REQ, S_REQ, H, hd], "kv": [B_REQ, S_REQ, KV, hd],
                      "causal": cfg.causal},
            "max_abs_err": flash_err, "tol": TOL_16BIT,
            "ms": flash_ms, "plain_ms": flash_plain_ms,
            "bound_ms": max(flash_bounds.values()), "bound_by": flash_bound_by,
            "library_ms": flash_lib_ms,
            "tflops": flash_flops / (flash_ms * 1e-3) / 1e12,
            "variant": main_entry["variant"], "launches_by_variant": {},
            "worst_err_all_cases": max(c["max_abs_err"] for c in flash_cases),
            "train_shape": {"q": [B_TRAIN, S_TRAIN, H, hd], **fwd_train}},
        "rmsnorm_bwd": {
            "name": "rmsnorm_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:38",
            "launches": 0, "dtype": "bfloat16", **rms_bwd_entry,
            "tol": TOL_16BIT, "err_is": "share of the largest magnitude (dx, dw)",
            "worst_err_all_cases": max(max(c["max_err_share"].values())
                                       for c in rms_bwd_cases)},
        "flash_attention_bwd": {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:102",
            "launches": 0, "dtype": "bfloat16",
            "shape": {"q": [B_TRAIN, S_TRAIN, H, hd], "kv": [B_TRAIN, S_TRAIN, KV, hd],
                      "causal": cfg.causal},
            "max_abs_err": train_bwd_entry["max_abs_err"],
            "max_err_share": train_bwd_entry["max_err_share"], "tol": TOL_16BIT,
            "err_is": "share of the largest magnitude (lse, dq, dk, dv)",
            "ms": bwd_ms, "plain_ms": bwd_plain_ms,
            "bound_ms": max(bwd_bounds.values()),
            "bound_by": max(bwd_bounds, key=bwd_bounds.get),
            "library_ms": bwd_lib_ms,
            "tflops": bwd_flops / (bwd_ms * 1e-3) / 1e12,
            "variant": train_bwd_entry["variant"], "launches_by_variant": {},
            "repeat": bwd_repeat, "kernel_ms": bwd_kernel_ms,
            "worst_err_all_cases": max(max(c["max_err_share"].values())
                                       for c in flash_bwd_cases)},
    }
    report["kernels_checked"] = {
        "phase": "kernels", "ok": not FAILURES,
        "tolerances": {"flash_fp32": TOL_FLASH_FP32, "flash_softcap_fp32": TOL_FLASH_SOFTCAP,
                       "rmsnorm_fp32": TOL_RMSNORM_FP32, "16bit": TOL_16BIT,
                       "bwd_fp32_share": TOL_BWD_FP32,
                       "rmsnorm_bwd_fp32_share": TOL_RMSNORM_BWD_FP32,
                       "lse_fp32_share": TOL_LSE_FP32, "lse_16bit_share": TOL_LSE_16BIT},
        "flash_cases": flash_cases, "flash_refusal": refusal,
        "flash_bwd_refusal": bwd_refusal, "rmsnorm_cases": rms_cases,
        "flash_bwd_cases": flash_bwd_cases, "rmsnorm_bwd_cases": rms_bwd_cases,
        "kernels": list(kernels.values())}
    emit(report["kernels_checked"])
    stop_if_failed("kernels")

    # -------------------------------------------------------------- small
    # A reduced fp32 model, same weights on the card (kernels) and on the CPU
    # (plain versions): prefill logits, cache and a few decode steps agree.
    small_cfg = get_config("qwen2_7b").reduced()
    cpu_model = LM(small_cfg, device="cpu").init(torch.Generator().manual_seed(args.seed))
    gpu_model = LM(small_cfg, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    toks = torch.randint(0, small_cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(args.seed + 1))
    ops.reset_launch_counts()
    outs = {}
    for name, model, tk in (("cpu", cpu_model, toks), ("gpu", gpu_model, toks.to(dev))):
        logits, stacked = model.prefill(tk[:, :32])
        cache = model.init_cache(2, 40, device=tk.device)
        for dst, src in zip(cache, model.unstack_cache(stacked)):
            for key in dst:
                dst[key][:, :32] = src[key]
        steps = [logits]
        for t in range(32, 40):
            lg, cache = model.decode_step(
                cache, tk[:, t:t + 1], torch.full((2,), t, device=tk.device))
            steps.append(lg)
        outs[name] = torch.stack(steps).float().cpu()
    small_err = compare("small model: card (kernels) vs CPU (plain)",
                        outs["gpu"], outs["cpu"], 1e-3)
    small_counts = ops.launch_counts()
    n_norms = 2 * small_cfg.n_layers + 1
    if small_counts != {"rmsnorm": 9 * n_norms, "flash_attention": small_cfg.n_layers,
                        "rmsnorm_bwd": 0, "flash_attention_bwd": 0}:
        fail(f"small model: unexpected launch counts {small_counts}")
    del cpu_model, gpu_model

    # Three train steps of the same reduced fp32 model on the card (kernels, forward
    # and backward) against the CPU (plain versions), from the same weights and
    # SyntheticLM batches: loss, grad_norm and every new parameter within 1e-3.  A
    # peak lr of 1e-4: AdamW's first steps move a parameter by up to lr whatever the
    # size of its gradient, so a gradient entry at rounding level may move it by lr
    # on one device and not the other; 3 steps at <= 1e-4 stay inside the tolerance.
    cpu_model = LM(small_cfg, device="cpu")
    cpu_state = init_train_state(cpu_model, torch.Generator().manual_seed(args.seed))
    gpu_model = LM(small_cfg, device=dev)
    gpu_state = load_jax_train_state(gpu_model, export_jax_train_state(cpu_model, cpu_state))
    small_opt = AdamWConfig(peak_lr=1e-4, warmup_steps=2, total_steps=10)
    data = SyntheticLM(DataConfig(vocab=small_cfg.vocab, seq_len=64, global_batch=4,
                                  seed=args.seed))
    steps = {"cpu": make_train_step(cpu_model, small_opt, remat="none"),
             "gpu": make_train_step(gpu_model, small_opt, remat="none")}
    per_step = {"rmsnorm": 2 * small_cfg.n_layers + 1, "rmsnorm_bwd": 2 * small_cfg.n_layers + 1,
                "flash_attention": small_cfg.n_layers,
                "flash_attention_bwd": small_cfg.n_layers}
    train_metrics = {"cpu": [], "gpu": []}
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        cpu_state, m_cpu = steps["cpu"](cpu_state, batch)
        ops.reset_launch_counts()
        gpu_state, m_gpu = steps["gpu"](gpu_state, {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        moved = ops.launch_counts()
        if moved != per_step or ops.flash_bwd_launches_by_variant()["scalar"] != \
                small_cfg.n_layers:
            fail(f"small train step {i}: launched {moved} "
                 f"(backward by variant {ops.flash_bwd_launches_by_variant()}), "
                 f"expected {per_step}, every backward on the scalar kernel")
        for name, m in (("cpu", m_cpu), ("gpu", m_gpu)):
            train_metrics[name].append({k: float(v) for k, v in m.items()})
    for key in ("loss", "grad_norm"):
        compare(f"small train: {key} card vs CPU",
                torch.tensor([m[key] for m in train_metrics["gpu"]]),
                torch.tensor([m[key] for m in train_metrics["cpu"]]), 1e-3)
    param_err = max(compare(f"small train: parameter {name} card vs CPU",
                            gpu_state["params"][name].detach().cpu(), p.detach(), 1e-3)
                    for name, p in cpu_state["params"].items())

    # the card's train state through a checkpoint and back, bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        save_state(tmp, export_jax_train_state(gpu_model, gpu_state), step=3)
        again = LM(small_cfg, device=dev)
        tree, manifest = restore_state(tmp, jax_train_state_like(again))
        restored = load_jax_train_state(again, tree)
    same = (manifest["step"] == 3 and torch.equal(restored["opt"].step, gpu_state["opt"].step)
            and all(torch.equal(restored[part][name], gpu_state[part][name])
                    for part in ("params",) for name in gpu_state["params"])
            and all(torch.equal(getattr(restored["opt"], mom)[name],
                                getattr(gpu_state["opt"], mom)[name])
                    for mom in ("m", "v") for name in gpu_state["params"]))
    if not same:
        fail("small train: the card's train state did not come back from a checkpoint "
             "bit for bit")
    report["small"] = {"phase": "small", "config": small_cfg.name, "dtype": "float32",
                       "max_abs_err": small_err, "tol": 1e-3, "launches": small_counts,
                       "train": {"steps": 3, "batch": [4, 64], "metrics": train_metrics,
                                 "max_abs_err_params": param_err, "tol": 1e-3,
                                 "launches_per_step": per_step,
                                 "checkpoint_round_trip_bit_exact": same}}
    emit(report["small"])
    stop_if_failed("small")
    del cpu_model, gpu_model, again, cpu_state, gpu_state, restored, tree

    # launches of each main path, counted from 0 just before it and read just after
    path_counts: dict = {}
    path_variants: dict = {}
    path_bwd_variants: dict = {}

    # -------------------------------------------------------------- serve
    if not args.skip_serve:
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        L_ = cfg.n_layers
        t0 = time.perf_counter()
        model = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(args.seed))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prefill_step, serve_step = make_prefill_step(model), make_serve_step(model)
        requests = torch.randint(0, cfg.vocab, (B_REQ, S_REQ), generator=gen, device=dev)

        def right_size(stacked, filled: int, max_len: int):
            cache = model.init_cache(B_REQ, max_len, device=dev)
            for dst, src in zip(cache, model.unstack_cache(stacked)):
                for key in dst:
                    dst[key][:, :filled] = src[key]
            return cache

        # warm-up (cuBLAS handles and work space), not counted
        logits, stacked = prefill_step({"tokens": requests})
        cache = right_size(stacked, S_REQ, S_REQ + CACHE_EXTRA)
        serve_step(cache, {"tokens": requests[:, :1],
                           "pos": torch.full((B_REQ,), S_REQ, device=dev)})
        del logits, stacked, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # the main path, with the counts at 0
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, stacked = prefill_step({"tokens": requests})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        counts_prefill = ops.launch_counts()
        variants_prefill = ops.flash_launches_by_variant()
        want_prefill = {"rmsnorm": 2 * L_ + 1, "flash_attention": L_,
                        "rmsnorm_bwd": 0, "flash_attention_bwd": 0}
        if counts_prefill != want_prefill:
            fail(f"prefill launched {counts_prefill}, expected {want_prefill}")
        if variants_prefill["sm90_wgmma"] != L_ or sum(variants_prefill.values()) != L_:
            fail(f"prefill flash launches by variant {variants_prefill}: all {L_} "
                 "must be the wgmma kernel")
        if tuple(logits.shape) != (B_REQ, cfg.vocab) or not bool(torch.isfinite(logits).all()):
            fail("prefill logits have the wrong shape or are not finite")
        cache = right_size(stacked, S_REQ, S_REQ + CACHE_EXTRA)
        del stacked
        tok = logits.argmax(-1, keepdim=True)
        generated = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(GEN_STEPS):
            before = ops.launch_counts()
            logits, cache = serve_step(
                cache, {"tokens": tok, "pos": torch.full((B_REQ,), S_REQ + t, device=dev)})
            after = ops.launch_counts()
            moved = {key: after[key] - before[key] for key in after}
            if moved != {"rmsnorm": 2 * L_ + 1, "flash_attention": 0,
                         "rmsnorm_bwd": 0, "flash_attention_bwd": 0}:
                fail(f"decode step {t} launched {moved}")
            tok = logits.argmax(-1, keepdim=True)
            generated.append(tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / GEN_STEPS
        counts = ops.launch_counts()
        path_counts["serve"] = counts
        path_variants["serve"] = ops.flash_launches_by_variant()
        peak_bytes = torch.cuda.max_memory_allocated()
        if not bool(torch.isfinite(logits).all()):
            fail("decode logits are not finite")
        for name in ("rmsnorm", "flash_attention"):
            if counts[name] == 0:
                fail(f"kernel {name} was not launched on the serving path")
        ids = torch.cat(generated, dim=1)
        del cache, logits

        # prefill/decode agreement through the kernels: the last position of a
        # 257-token prefill (flash kernel) against a 256-token prefill plus one
        # decode step over the cache (plain attention with per-row positions).
        n = 257
        full_logits, _ = prefill_step({"tokens": requests[:, :n]})
        _, stacked = prefill_step({"tokens": requests[:, :n - 1]})
        cache = right_size(stacked, n - 1, n + 7)
        step_logits, _ = serve_step(
            cache, {"tokens": requests[:, n - 1:n],
                    "pos": torch.full((B_REQ,), n - 1, device=dev)})
        torch.cuda.synchronize()
        diff = float((full_logits.float() - step_logits.float()).abs().max())
        spread = float(full_logits.float().std())
        # bf16 keeps 8 bits: each of the 2 * depth residual updates is rounded at
        # ~0.4 % and the two paths use different matrix-product shapes, so the
        # logits may differ by a few percent of their spread, not more.
        agree_tol = 0.08 * spread
        if not diff <= agree_tol:
            fail(f"prefill/decode disagree: max |diff| {diff:.4f} > {agree_tol:.4f}")
        report["serve"] = {
            "phase": "serve", "config": cfg.name, "dtype": cfg.dtype,
            "layers": L_, "layers_published": get_config("qwen2_7b").n_layers,
            "d_model": d, "n_params": model.n_params(),
            "requests": B_REQ, "prompt_tokens": S_REQ, "decode_steps": GEN_STEPS,
            "init_s": round(init_s, 2),
            "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": B_REQ * S_REQ / (prefill_ms * 1e-3),
            "decode_ms_per_step": decode_ms,
            "decode_tokens_per_s": B_REQ / (decode_ms * 1e-3),
            "peak_memory_bytes": peak_bytes,
            "launches_prefill": counts_prefill,
            "flash_launches_prefill_by_variant": variants_prefill,
            "launches_total": counts,
            "agreement": {"tokens": n, "max_abs_diff": diff, "logit_std": spread,
                          "tol": agree_tol},
            "generated_ids_request0": ids[0].tolist()}
        emit(report["serve"])
        stop_if_failed("serve")
        del model, prefill_step, serve_step, full_logits, step_logits, stacked, cache, requests
        torch.cuda.empty_cache()

    # -------------------------------------------------------------- train
    if not args.skip_train:
        # full width, 8 of 28 layers: at 12 bytes a parameter (bf16 parameters and
        # gradients, fp32 moments) the full depth's 7.07 G would need 85 GB
        tcfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
        L_ = tcfg.n_layers
        TRAIN_STEPS = 6
        t0 = time.perf_counter()
        trainer = Trainer(TrainerConfig(
            arch=tcfg, steps=TRAIN_STEPS, global_batch=B_TRAIN, seq_len=S_TRAIN,
            ckpt_every=0, log_every=1, remat="none", seed=args.seed, device="cuda"))
        state = trainer.init_state()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = trainer.model.n_params()
        torch.cuda.reset_peak_memory_stats()
        # the main path, with the counts at 0
        ops.reset_launch_counts()
        state, hist = trainer.run(state)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        path_counts["train"] = counts
        path_variants["train"] = ops.flash_launches_by_variant()
        path_bwd_variants["train"] = ops.flash_bwd_launches_by_variant()
        peak_bytes = torch.cuda.max_memory_allocated()
        per_step = {"rmsnorm": 2 * L_ + 1, "rmsnorm_bwd": 2 * L_ + 1,
                    "flash_attention": L_, "flash_attention_bwd": L_}
        want = {k: TRAIN_STEPS * n for k, n in per_step.items()}
        if counts != want:
            fail(f"train: {TRAIN_STEPS} steps launched {counts}, expected {want}")
        if path_variants["train"]["sm90_wgmma"] != TRAIN_STEPS * L_:
            fail(f"train: flash forward launches by variant {path_variants['train']}: "
                 "all must be the wgmma kernel")
        if path_bwd_variants["train"]["sm90_wgmma"] != TRAIN_STEPS * L_:
            fail(f"train: flash backward launches by variant {path_bwd_variants['train']}")
        losses = [h["loss"] for h in hist]
        if [h["step"] for h in hist] != list(range(TRAIN_STEPS)) or not all(
                math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
            fail(f"train: losses or grad norms missing or not finite: {hist}")
        # at init the logits of the random tied unembedding (N(0, 0.02^2) entries)
        # against RMS-normalised hidden states are ~N(0, d * 0.02^2), so the
        # log-sum-exp over the vocabulary, and the loss, sit at ln V + d * 0.02^2 / 2
        loss0_expected = math.log(tcfg.vocab) + tcfg.d_model * 0.02 ** 2 / 2
        if not abs(losses[0] - loss0_expected) <= 0.5:
            fail(f"train: step-0 loss {losses[0]:.4f} is not within 0.5 of "
                 f"{loss0_expected:.4f}")
        walls = [h["wall"] for h in hist]
        step_ms = (walls[-1] - walls[0]) * 1e3 / (TRAIN_STEPS - 1)   # steps 2..6
        tokens = B_TRAIN * S_TRAIN
        attn_flops = 12.0 * tcfg.hd * visible_pairs(S_TRAIN, S_TRAIN, tcfg.causal, 0) \
            * B_TRAIN * tcfg.n_heads * L_
        model_flops = 6.0 * n_params * tokens + attn_flops
        report["train"] = {
            "phase": "train", "config": tcfg.name, "dtype": tcfg.dtype,
            "layers": L_, "layers_published": get_config("qwen2_7b").n_layers,
            "d_model": tcfg.d_model, "n_params": n_params,
            "global_batch": B_TRAIN, "seq_len": S_TRAIN, "steps": TRAIN_STEPS,
            "remat": "none", "init_s": round(init_s, 2),
            "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
            "lrs": [h["lr"] for h in hist],
            "step0_loss_expected": loss0_expected, "ln_vocab": math.log(tcfg.vocab),
            "step_walls_s": walls,
            "ms_per_step": step_ms, "tokens_per_s": tokens / (step_ms * 1e-3),
            "model_flops_per_step": model_flops,
            "mfu": model_flops / (step_ms * 1e-3) / PEAK_TENSOR_16BIT_FLOPS,
            "peak_memory_bytes": peak_bytes,
            "launches": counts, "launches_per_step": per_step,
            "flash_launches_by_variant": path_variants["train"],
            "flash_bwd_launches_by_variant": path_bwd_variants["train"]}
        emit(report["train"])
        stop_if_failed("train")
        del trainer, state
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- verdict
    if args.skip_serve or args.skip_train:
        print("chip_smoke: --skip-serve / --skip-train: a main path was not driven, so "
              "no result is printed", file=sys.stderr)
        sys.exit(4)
    for name, kern in kernels.items():
        kern["launches_by_path"] = {path: c[name] for path, c in path_counts.items()}
        kern["launches"] = sum(kern["launches_by_path"].values())
        if kern["launches_by_path"]["train"] == 0:
            fail(f"kernel {name} was not launched on the training path")
    kernels["flash_attention"]["launches_by_variant"] = {
        path: v for path, v in path_variants.items()}
    kernels["flash_attention_bwd"]["launches_by_variant"] = path_bwd_variants["train"]
    stop_if_failed("verdict")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "dtype", "tol")
    keys += ("variant", "launches_by_path", "launches_by_variant")
    kernels_line = {"kernels": [{key: kern[key] for key in keys if key in kern}
                                for kern in kernels.values()]}
    final = {"ok": True, "device": {"platform": "gpu",
                                    "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}}
    if args.out:
        report["kernels"] = kernels_line["kernels"]
        (Path(args.out) / "report.json").write_text(json.dumps(report, indent=1))
    print(smi_line, flush=True)
    emit(kernels_line)
    emit(final)


if __name__ == "__main__":
    main()
