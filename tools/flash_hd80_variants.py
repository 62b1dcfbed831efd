#!/usr/bin/env python3
"""Times the attention forward's head_dim-80 layouts on the card, each beside SDPA.

    python3 tools/flash_hd80_variants.py [--iters 20] [--rounds 2] [--out FILE]

The wgmma forward (``csrc/flash_attention_sm90.cu``) cuts head_dim 80's 160-byte rows
into a 64-column TMA box under the 128-byte swizzle and a 16-column one under the
32-byte swizzle, keeps three stages in its K/V ring and lets its two consumer
warpgroups take turns at issuing their products.  The layouts in ``LAYOUTS`` are
that kernel and copies of it patched to two stages, to no turns, or both; beside
them a yardstick: head_dim 128's body over tensor maps of 80 columns, whose second
64-column box TMA fills with zeros past column 80 (1.6x the products; its epilogue
stores 80 columns).

Each variant is the package copied under ``_cmp/hd80_variants/<variant>/``
(git-ignored) with the source patched, built there, held
against the plain version at a ragged case and at zamba2-2.7b's serving shape, and
timed (CUDA events over --iters launches after a warm-up) at that shape, (4, 2048,
32/32, 80), causal, window 4096 (not biting), and where the window bites, (1, 6144,
32/32, 80); SDPA beside each (given the window as a boolean mask where it bites).
Every copy runs in a process of its own, the builds together first, then the copies
in turns, forwards and backwards, --rounds times in all.  Prints the
card's name and power limit, then one JSON line per variant and shape.  Needs a CUDA
device.  The padded copy serves head_dim 80 only.
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
SRC = "flash_attention_sm90.cu"
# (anchor, replacement) pairs that turn the kernel into each layout variant
STAGES_2 = ("static constexpr int kStages = HD == 80 ? 3 : 2;",
            "static constexpr int kStages = 2;")
NO_TURNS = ("static constexpr bool kTurns = HD == 80;", "static constexpr bool kTurns = false;")
LAYOUTS = {"64+16, 3 stages, turns": [],
           "64+16, 2 stages, turns": [STAGES_2],
           "64+16, 3 stages": [NO_TURNS],
           "64+16, 2 stages": [STAGES_2, NO_TURNS]}

# (anchor, replacement) pairs of the padded yardstick: the head_dim-80 calls run
# head_dim 128's kernel over maps whose dim 0 is the tensors' 80 columns
PADDED = [
    ("int launch(const Params& p, CUtensorMapDataType type, cudaStream_t st) {",
     "int launch(const Params& p, CUtensorMapDataType type, cudaStream_t st, int cols = HD) {"),
    ("encode(fn, &tq, p.q, type, HD,", "encode(fn, &tq, p.q, type, cols,"),
    ("encode(fn, &tk, p.k, type, HD,", "encode(fn, &tk, p.k, type, cols,"),
    ("encode(fn, &tv, p.v, type, HD,", "encode(fn, &tv, p.v, type, cols,"),
    ("if (hd == 80) return launch<__nv_bfloat16, 80>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);",
     "if (hd == 80) return launch<__nv_bfloat16, 128>(p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st, 80);"),
    ("if (hd == 80) return launch<__half, 80>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);",
     "if (hd == 80) return launch<__half, 128>(p, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st, 80);"),
    ("          for (int jj = 0; jj < HD / 8; ++jj)\n            *reinterpret_cast<uint32_t*>",
     "          for (int jj = 0; jj < (HD == 128 ? 10 : HD / 8); ++jj)\n"
     "            *reinterpret_cast<uint32_t*>"),
]
CASES = {"ragged": (1, 200, 200, 4, 4, 80, True, 0),
         "zamba2": (4, 2048, 2048, 32, 32, 80, True, 4096),
         "window_bites": (1, 6144, 6144, 32, 32, 80, True, 4096)}


def patched_copy(variant: str) -> Path:
    """The package under _cmp/hd80_variants/<variant>/src, its kernel source patched
    into a layout variant or the padded yardstick."""
    dst = ROOT / "_cmp" / "hd80_variants" / re.sub(r"\W+", "_", variant) / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dst / "repro_torch" / "kernels" / "csrc" / SRC
    text = src.read_text()
    patches = PADDED if variant == "padded" else LAYOUTS[variant]
    for anchor, replacement in patches:
        if text.count(anchor) != 1:
            sys.exit(f"flash_hd80_variants: the kernel source no longer has the anchor:\n"
                     f"{anchor}")
        text = text.replace(anchor, replacement)
    src.write_text(text)
    return dst


def measure(iters: int) -> None:
    """In a process whose path starts at one copy: check, then time every case."""
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

    for name, (B, Sq, Skv, H, KV, hd, causal, window) in CASES.items():
        q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).bfloat16()
        k = torch.randn((B, Skv, KV, hd), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, Skv, KV, hd), generator=gen, device=dev).bfloat16()
        kw = dict(causal=causal, window=window)
        got = ops.flash_attention(q, k, v, **kw)
        want = ops.mha_reference(q.float(), k.float(), v.float(), **kw)
        err = float((got.float() - want).abs().max())
        del want
        row = {"case": name, "shape": [B, Sq, Skv, H, KV, hd, causal, window],
               "variant_launched": flash_mod.variant(q.dtype, hd), "max_abs_err": err,
               "ok": err <= 2e-2}
        if name != "ragged":
            qpos = torch.arange(Sq, device=dev)[:, None] + (Skv - Sq)
            kpos = torch.arange(Skv, device=dev)[None, :]
            bites = bool(((qpos >= kpos) & (qpos - kpos >= window)).any())
            mask = ((qpos >= kpos) & (qpos - kpos < window)) if bites else None
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lkw = dict(attn_mask=mask) if bites else dict(is_causal=causal)
            row["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
            row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **lkw))
            pairs = int(((qpos >= kpos) & (qpos - kpos < window)).sum())
            row["tflops"] = 4.0 * hd * pairs * B * H / (row["ms"] * 1e-3) / 1e12
        print(json.dumps(row), flush=True)
        del q, k, v, got
        torch.cuda.empty_cache()


def main() -> None:
    """Build every variant's copy together, then measure them one after another."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2, help="times each variant is measured")
    ap.add_argument("--out", default="")
    ap.add_argument("--measure", default="", help=argparse.SUPPRESS)  # one copy's process
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_hd80_variants: no CUDA device")
    if args.measure:
        sys.path.insert(0, args.measure)
        measure(args.iters)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: nothing")
    copies = {v: patched_copy(v) for v in (*LAYOUTS, "padded")}
    builds = {v: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; _build.load(); "
         "print(_build.build_info['log'])", str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, path in copies.items()}
    failed = False
    for v, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"flash_hd80_variants: {v} did not build:\n{out}", file=sys.stderr)
            failed = True
            continue
        # ptxas' registers and spills of the head_dim-80 forward (bf16)
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "flash_fwd_sm90_kernel" in line \
                    and "nv_bfloat16Li80E" in line:
                usage = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "registers" in x]
                print(json.dumps({"variant": v, "ptxas": usage}), flush=True)
    if failed:
        sys.exit(1)
    rows = []
    # in turns: forwards, then backwards, and so on, so that a drift of the card's
    # clock over the run does not favour one variant
    order = [v for rnd in range(args.rounds)
             for v in (list(copies) if rnd % 2 == 0 else list(copies)[::-1])]
    for rnd, v in enumerate(order):
        path = copies[v]
        run = subprocess.run(
            [sys.executable, __file__, "--iters", str(args.iters), "--measure", str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in run.stdout.splitlines():
            if line.startswith("{"):
                row = {"variant": v, "round": rnd // len(copies), **json.loads(line)}
                rows.append(row)
                print(json.dumps(row), flush=True)
                failed |= not row["ok"]
        if run.returncode:
            print(f"flash_hd80_variants: {v} failed:\n{run.stdout}", file=sys.stderr)
            failed = True
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
