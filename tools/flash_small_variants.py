#!/usr/bin/env python3
"""Times the attention kernels' head_dim-32 and -16 layouts on the card, each beside SDPA.

    python3 tools/flash_small_variants.py [--backward] [--iters 20] [--rounds 2]
                                          [--variants NAME ...] [--out FILE]

At head_dim 32 and 16 the wgmma kernels (``csrc/flash_attention_sm90.cu``,
``csrc/flash_attention_bwd_sm90.cu``) do one exponential a visible (query, key) pair
against 4 * hd (forward) or 10 * hd (backward) tensor-core operations, so the
exponentials, 16 a clock an SM on the MUFU, set the pace rather than the products.
The layouts in ``LAYOUTS`` (``BWD_LAYOUTS`` with --backward) are the shipped kernel
and copies of it patched at the small head_dims only: the forward at head_dim 32 as
two 16-column boxes under the 32-byte swizzle (sixteen m64n16k16 P V products a tile
instead of eight m64n32k16 over one 32-column box under the 64-byte one), its two consumer
warpgroups taking turns at the tensor cores (as at head_dim 80) or at the softmax,
a third consumer warpgroup (192-row q tiles, registers 24 / 160, as FlashAttention-3
takes head_dim 64), a share of the exponentials on the FMA pipe (``ex2_fma``, which
the patch adds to ``sm90.cuh``: one 8-key group in 4 or in 8), a K/V ring of four
stages instead of two, and 192-key tiles (an m64n192k16 product, added the same
way); the backward's share of P^T's exponentials on the FMA pipe and a third Q / dO
stage; and the forward's unmasked softmax with its row max as a tree and its row sum
as four partial sums.  The patches are the tool's own.

Each variant is the package copied under ``_cmp/small_variants/<variant>/``
(git-ignored) with its sources patched, built there, held against the plain version
at ragged cases of both head_dims (forward: o; backward: lse, dq, dk, dv as a share of
the largest magnitude), and timed (CUDA events over --iters launches after a warm-up)
at (2, 2048, 16/16, hd), causal, hd 32 and 16, with SDPA (its backward, through
autograd, with --backward) beside each.  Every copy runs in a process of its own, the
builds together first, then the copies in turns, forwards and backwards, --rounds
times in all.  Prints the card's name and power limit, ptxas' registers and spills of
each copy's head_dim-32 kernel, then one JSON line per variant, round and shape.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC, SRC_BWD, SM90 = "flash_attention_sm90.cu", "flash_attention_bwd_sm90.cu", "sm90.cuh"
TURNS = (SRC, "static constexpr bool kTurns = HD == 80;",
         "static constexpr bool kTurns = HD == 80 || kSmall;")
STAGES_4 = (SRC, "static constexpr int kStages = HD == 80 ? 3 : 2;",
            "static constexpr int kStages = HD == 80 ? 3 : kSmall ? 4 : 2;")
# a third consumer warpgroup at head_dim <= 32: the file's consumer count becomes Cfg's
# own, and the registers FlashAttention-3 gives three (24 / 160)
CONSUMERS_3 = [
    (SRC, "constexpr int kConsumers = 2;     // consumer warpgroups of 64 query rows each\n", ""),
    (SRC, "  static constexpr int kBM = 64 * kConsumers;",
     "  static constexpr int kConsumers = kSmall ? 3 : 2;\n  static constexpr int kBM = 64 * kConsumers;"),
    (SRC, "static constexpr int kProducerRegs = kWide ? 24 : 40;",
     "static constexpr int kProducerRegs = kWide || kConsumers == 3 ? 24 : 40;"),
    (SRC, "static constexpr int kConsumerRegs = kWide ? 240 : 232;",
     "static constexpr int kConsumerRegs = kWide ? 240 : kConsumers == 3 ? 160 : 232;")]
CONSUMERS_3 += [(SRC, f"mbar_init({w}, 4 * kConsumers);", f"mbar_init({w}, 4 * C::kConsumers);")
                for w in ("q_empty(u)", "k_empty(s)", "v_empty(s)")]
# the two consumer warpgroups take turns at the softmax (the named barriers of
# head_dim 80's turns around each tile's softmax), so that one's exponentials run
# beside the other's issue and waits
SOFTMAX_TURNS = [
    (SRC, "    if constexpr (C::kTurns)\n      if (c == 1)",
     "    if constexpr (C::kTurns || C::kSmall)\n      if (c == 1)"),
    (SRC, "    auto softmax = [&](int n0, float (&alpha)[2]) {\n",
     "    auto softmax = [&](int n0, float (&alpha)[2]) {\n"
     "      if constexpr (C::kSmall) asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(1 + c) : \"memory\");\n"),
    (SRC, "#pragma unroll\n      for (int r = 0; r < 2; ++r) l_row[r] = l_row[r] * alpha[r] + rs[r];",
     "      if constexpr (C::kSmall) asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(2 - c) : \"memory\");\n"
     "#pragma unroll\n      for (int r = 0; r < 2; ++r) l_row[r] = l_row[r] * alpha[r] + rs[r];")]
# 2^x for x <= 0 on the FMA pipe: n = round(x) by the float adder (1.5 * 2^23 added),
# 2^(x - n) on [-0.5, 0.5] by a degree-3 polynomial (relative error 1.0e-4), n added
# into the exponent field; x clamped at -125 so that the exponent stays normal
EX2_FMA = """
__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -125.f);
  const float r = x + 12582912.f;
  const float f = x - (r - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.05500893f, f, 0.24221098f), f, 0.6932829f), f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(r) << 23));
}
"""


def fma_every(backward: bool, n: int) -> list:
    """Every n-th 8-key group of a thread's scores (the forward's P, the backward's
    P^T) takes its exponentials on the FMA pipe, in unmasked tiles."""
    ex2 = (SM90, "// ------------------------------------------------------------ wgmma instructions",
           EX2_FMA + "\n// ------------------------------------------------------------ wgmma instructions")
    if backward:
        arg, j = "fmaf(st[4 * jj + e], sl2, -((e & 1) ? l2.y : l2.x))", "jj"
        line = f"              const float pe = ex2({arg});"
        src = SRC_BWD
    else:
        arg, j = "fmaf(sc[4 * j + e], sl2, -m_l2[e >> 1])", "j"
        line = f"            const float pe = ex2({arg});"
        src = SRC
    new = line.replace(f"ex2({arg})", f"C::kSmall && {j} % {n} == {n - 1} ? ex2_fma({arg}) : ex2({arg})")
    return [ex2, (src, line, new)]


def wide_tile(n: int) -> list:
    """192- or 256-key K/V tiles at the small head_dims: the m64nNk16 product the
    forward's S then needs, added to sm90.cuh for both 16-bit types."""
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    binds = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    fns = ""
    for tag in ("bf16", "f16"):
        fns += (f"template <int TA, int TB>\n"
                f"__device__ __forceinline__ void ss_n{n}_{tag}(float (&d)[{regs}], uint64_t da, "
                f"uint64_t db, int acc) {{\n"
                f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
                f'               "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{tag}.{tag} '
                f'{{{outs}}}, %{regs}, %{regs + 1}, p, 1, 1, %{regs + 3}, %{regs + 4};\\n}}\\n"\n'
                f'               : {binds}\n'
                f'               : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));\n}}\n')
    patches = [(SM90, "template <typename T> struct Wg;\n", fns + "\ntemplate <typename T> struct Wg;\n")]
    for tag in ("bf16", "f16"):
        patches.append((SM90, f"    else ss_n128_{tag}<TA, TB>(d, da, db, acc);",
                        f"    else if constexpr (N == 128) ss_n128_{tag}<TA, TB>(d, da, db, acc);\n"
                        f"    else ss_n{n}_{tag}<TA, TB>(d, da, db, acc);"))
    patches.append((SRC, "static constexpr int kBN = kWide ? 64 : 128;",
                    f"static constexpr int kBN = kWide ? 64 : kSmall ? {n} : 128;"))
    return patches


# the unmasked softmax's row max as a tree (5 dependent steps, not 32) and its row sum
# as four partial sums, at head_dim <= 32
TREE_MAX = """\
      } else if constexpr (C::kSmall) {
        // each row's kBN / 4 scores of this thread: 5 dependent steps, not 32
        float t[2][kBN / 16];
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            t[r][j] = fmaxf(fmaxf(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]),
                            fmaxf(sc[8 * j + 4 + 2 * r], sc[8 * j + 5 + 2 * r]));
#pragma unroll
        for (int w = kBN / 32; w >= 1; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) t[r][j] = fmaxf(t[r][j], t[r][j + w]);
        mx[0] = t[0][0] * p.scale;  // raw scores: the scale is positive, so max commutes
        mx[1] = t[1][0] * p.scale;
"""
TREE_SUM = """\
      } else if constexpr (C::kSmall) {
        float part[2][4] = {};  // four running sums a row: chains of 8 adds, not 32
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = ex2(fmaf(sc[4 * j + e], sl2, -m_l2[e >> 1]));
            sc[4 * j + e] = pe;
            part[e >> 1][j & 3] += pe;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) rs[r] = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
"""
MAX_LOOP = """\
      } else {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);"""
SUM_LOOP = """\
      } else {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = ex2(fmaf(sc[4 * j + e], sl2, -m_l2[e >> 1]));"""
TREE_SOFTMAX = [(SRC, MAX_LOOP, TREE_MAX + MAX_LOOP), (SRC, SUM_LOOP, TREE_SUM + SUM_LOOP)]
NARROW_16 = (SRC, "static constexpr int kNarrow = HD == 32 ? 32 : kNarrowCols;",
             "static constexpr int kNarrow = kNarrowCols;")
LAYOUTS = {"shipped": [],
           "16-column boxes at 32": [NARROW_16],
           "tree softmax": TREE_SOFTMAX,
           "3 consumers": CONSUMERS_3,
           "3 consumers, 4 stages": CONSUMERS_3 + [STAGES_4],
           "turns": [TURNS],
           "softmax turns": SOFTMAX_TURNS,
           "softmax turns, fma 1 in 4": SOFTMAX_TURNS + fma_every(False, 4),
           "softmax turns, fma 1 in 8": SOFTMAX_TURNS + fma_every(False, 8),
           "fma 1 in 4": fma_every(False, 4),
           "fma 1 in 8": fma_every(False, 8),
           "4 stages": [STAGES_4],
           "192-key tiles": wide_tile(192)}
BWD_LAYOUTS = {"shipped": [],
               "fma 1 in 4": fma_every(True, 4),
               "fma 1 in 8": fma_every(True, 8),
               "3 stages": [(SRC_BWD, "static constexpr int kStages = 2;",
                             "static constexpr int kStages = kSmall ? 3 : 2;")]}
CHECKS = [(2, 191, 321, 8, 2, 32, True, 0), (1, 300, 300, 4, 2, 16, True, 100),
          (1, 200, 130, 4, 4, 16, False, 0)]
TIMED = [(2, 2048, 2048, 16, 16, 32, True, 0), (2, 2048, 2048, 16, 16, 16, True, 0)]


def patched_copy(variant: str, backward: bool) -> Path:
    """The package under _cmp/small_variants/<variant>/src with its sources patched."""
    dst = ROOT / "_cmp" / "small_variants" / re.sub(r"\W+", "_", variant) / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = dst / "repro_torch" / "kernels" / "csrc"
    for name, anchor, replacement in (BWD_LAYOUTS if backward else LAYOUTS)[variant]:
        text = (csrc / name).read_text()
        if text.count(anchor) != 1:
            sys.exit(f"flash_small_variants: {name} no longer has the anchor:\n{anchor}")
        (csrc / name).write_text(text.replace(anchor, replacement))
    return dst


def measure(iters: int, backward: bool) -> None:
    """In a process whose path starts at one copy: check, then time every shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def inputs(case):
        B, Sq, Skv, H, KV, hd = case[:6]
        return [torch.randn(shape, generator=gen, device=dev).bfloat16()
                for shape in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd), (B, Sq, H, hd))]

    for case in CHECKS + TIMED:
        causal, window = case[6], case[7]
        q, k, v, do = inputs(case)
        kw = dict(causal=causal, window=window)
        o, lse = flash_mod.launch_forward(q, k, v, causal, window, 0.0, with_lse=True)
        row = {"case": list(case), "variant_launched": (flash_mod.bwd_variant if backward
                                                        else flash_mod.variant)(q.dtype, case[5])}
        if case in CHECKS:
            qf, kf, vf = q.float(), k.float(), v.float()
            of = ops.mha_reference(qf, kf, vf, **kw)
            if backward:
                lf = ops.flash_attention_lse_reference(qf, kf, **kw)
                want = ops.flash_attention_bwd_reference(qf, kf, vf, of, lf, do.float(), **kw)
                got = flash_mod.launch_backward(q, k, v, o, lse, do, causal, window, 0.0)
                shares = [float((g.float() - w).abs().max()) / float(w.abs().max())
                          for g, w in zip((lse, *got), (lf, *want))]
                row["max_err_share"] = max(shares)
                row["ok"] = shares[0] <= 1e-3 and max(shares[1:]) <= 2e-2
            else:
                err = (o.float() - of).abs()
                row["max_abs_err"] = float(err.max())
                row["ok"] = bool((err <= 2e-2 + 2e-2 * of.abs()).all())
        else:
            row["ok"] = True
            leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
            if backward:
                row["ms"] = time_ms(lambda: flash_mod.launch_backward(
                    q, k, v, o, lse, do, causal, window, 0.0))
                out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
                dot = do.transpose(1, 2)
                row["library_ms"] = time_ms(lambda: torch.autograd.grad(
                    out, leaves, dot, retain_graph=True))
            else:
                row["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
                row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                    *leaves, is_causal=causal, enable_gqa=True))
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


def main() -> None:
    """Build every variant's copy together, then measure them in turns."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backward", action="store_true", help="the backward's layouts")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2, help="times each variant is measured")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="measure only these layouts (and the shipped one)")
    ap.add_argument("--out", default="")
    ap.add_argument("--measure", default="", help=argparse.SUPPRESS)  # one copy's process
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_small_variants: no CUDA device")
    if args.measure:
        sys.path.insert(0, args.measure)
        measure(args.iters, args.backward)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: nothing")
    variants = list(BWD_LAYOUTS if args.backward else LAYOUTS)
    if args.variants:
        variants = ["shipped"] + [v for v in variants if v in args.variants and v != "shipped"]
    copies = {v: patched_copy(v, args.backward) for v in variants}
    builds = {v: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; _build.load(); "
         "print(_build.build_info['log'])", str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, path in copies.items()}
    failed = False
    kernel = "flash_bwd_sm90_kernel" if args.backward else "flash_fwd_sm90_kernel"
    for v, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"flash_small_variants: {v} did not build:\n{out}", file=sys.stderr)
            failed = True
            continue
        lines = out.splitlines()
        for i, line in enumerate(lines):   # ptxas' registers and spills at head_dim 32, bf16
            if "Compiling entry function" in line and kernel in line \
                    and "nv_bfloat16Li32E" in line:
                usage = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "registers" in x]
                print(json.dumps({"variant": v, "ptxas": usage}), flush=True)
            if re.search(r"C75(18|19|20)", line):
                print(json.dumps({"variant": v, "ptxas_note": line.strip()}), flush=True)
    if failed:
        sys.exit(1)
    rows = []
    order = [v for rnd in range(args.rounds)
             for v in (list(copies) if rnd % 2 == 0 else list(copies)[::-1])]
    for rnd, v in enumerate(order):
        run = subprocess.run(
            [sys.executable, __file__, "--iters", str(args.iters), "--measure", str(copies[v]),
             *(["--backward"] if args.backward else [])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in run.stdout.splitlines():
            if line.startswith("{"):
                row = {"variant": v, "round": rnd // len(copies), **json.loads(line)}
                rows.append(row)
                print(json.dumps(row), flush=True)
                failed |= not row["ok"]
        if run.returncode:
            print(f"flash_small_variants: {v} failed:\n{run.stdout}", file=sys.stderr)
            failed = True
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
