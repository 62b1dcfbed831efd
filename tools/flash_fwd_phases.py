#!/usr/bin/env python3
"""Where a kv step of the attention forward's wgmma kernel spends its time, on the card.

    python3 tools/flash_fwd_phases.py [--shape gemma|qwen2|zamba2|small] [--out FILE]

Where no profiler can attach to the card (ncu, nsys), stall reasons cannot be read,
so this tool instruments the kernel itself, as ``tools/flash_bwd_phases.py`` does
the backward's: it copies the package into ``_cmp/fwd_phases/`` (git-ignored),
inserts ``clock64()`` stamps at the phase boundaries of each steady-state kv step of
``csrc/flash_attention_sm90.cu`` (thread 0 of the first two consumer warpgroups of two blocks:
block 0 and the middle one), builds that copy, runs one forward at the shape (gemma:
q/k/v (4, 2048, 16, 256), causal; qwen2: q (4, 2048, 28, 128), k/v (4, 2048, 4, 128),
causal; zamba2: q/k/v (4, 2048, 32, 80), causal, whose 4096-token window does not bite
there; small: q/k/v (2, 2048, 16, 32), causal: head_dim 32's one 32-column box;
bf16) and prints, per block and warpgroup, the median SM cycles of each
phase over the steps stamped, the cycles of a whole step, and the SM clock the run
had (cycles over %globaltimer nanoseconds).  The stamps cost a few percent of the
kernel's time; the phases are what to compare, not the total.

Phases of a step i: the wait for K_i (k_wait); the wait for this warpgroup's turn
where the warpgroups take turns, S_i = Q K_i^T issued, the wait for V_{i-1},
P_{i-1} V_{i-1} issued (issue); the wait for S_i alone (s_wait); the online
softmax of S_i (softmax); the wait for P_{i-1} V_{i-1} (pv_wait); O rescaled and P_i
packed (rescale).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEPS, MARKS = 512, 7
PHASES = ["k_wait", "issue", "s_wait", "softmax", "pv_wait", "rescale"]
SHAPES = {"gemma": (4, 2048, 16, 16, 256), "qwen2": (4, 2048, 28, 4, 128),
          "zamba2": (4, 2048, 32, 32, 80), "small": (2, 2048, 16, 16, 32)}

# (anchor in the kernel source, the text that replaces it): stamps 0..6 in order
PATCHES = [
    ("""          const int gi = gt + i, s = stage(gi), sp = stage(gi - 1);
          mbar_wait(k_full(s), phase(gi));
          wgmma_fence();  // sc, o and pa were last touched by ordinary instructions
          turn_wait();
          issue_qk(s);
          mbar_wait(v_full(sp), phase(gi - 1));
          issue_pv(sp);
          turn_pass();
          asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");  // S_i only
          pin(sc);
          mbar_arrive_if(k_empty(s), lane == 0);
          softmax(tw.kv_lo + i * kBN, alpha);
          wgmma_wait0();  // P_{i-1} V_{i-1} is in O: only now may O be rescaled
          pv_done(sp);
          rescale_and_pack(alpha);
""", """          const int gi = gt + i, s = stage(gi), sp = stage(gi - 1);
          stamp(0);
          mbar_wait(k_full(s), phase(gi));
          stamp(1);
          wgmma_fence();  // sc, o and pa were last touched by ordinary instructions
          turn_wait();
          issue_qk(s);
          mbar_wait(v_full(sp), phase(gi - 1));
          issue_pv(sp);
          turn_pass();
          stamp(2);
          asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");  // S_i only
          pin(sc);
          stamp(3);
          mbar_arrive_if(k_empty(s), lane == 0);
          softmax(tw.kv_lo + i * kBN, alpha);
          stamp(4);
          wgmma_wait0();  // P_{i-1} V_{i-1} is in O: only now may O be rescaled
          stamp(5);
          pv_done(sp);
          rescale_and_pack(alpha);
          stamp(6);
          ++it_stamp;
"""),
    ("""    int gt = 0;
""", """    int gt = 0;
    int it_stamp = 0;
    const int slot = blockIdx.x == 0 ? 0 : blockIdx.x == gridDim.x / 2 ? 1 : -1;
    auto stamp = [&](int mark) {
      if (slot >= 0 && c < 2 && t == 0 && it_stamp < kStampSteps) {
        const long long at = ((slot * 2 + c) * kStampSteps + it_stamp) * kStampMarks + mark;
        g_stamp[at] = clock64();
        if (mark == 0) {
          long long ns;
          asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
          g_stamp_ns[at / kStampMarks] = ns;
        }
      }
    };
"""),
    ("namespace flash {\nnamespace {\n", f"""namespace flash {{
constexpr int kStampSteps = {STEPS}, kStampMarks = {MARKS};
__device__ long long g_stamp[2 * 2 * kStampSteps * kStampMarks];
__device__ long long g_stamp_ns[2 * 2 * kStampSteps];
namespace {{
"""),
]

COPY_OUT = """
extern "C" int repro_stamps_copy(void* cycles, void* ns) {
  cudaError_t e = cudaMemcpyFromSymbol(cycles, flash::g_stamp, sizeof(flash::g_stamp));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, flash::g_stamp_ns, sizeof(flash::g_stamp_ns));
  return (int)e;
}
"""


def instrumented_copy() -> Path:
    """The package copied under _cmp/fwd_phases/src with the stamps patched in."""
    dst = ROOT / "_cmp" / "fwd_phases" / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dst / "repro_torch" / "kernels" / "csrc" / "flash_attention_sm90.cu"
    text = src.read_text()
    for anchor, replacement in PATCHES:
        if text.count(anchor) != 1:
            sys.exit(f"flash_fwd_phases: the kernel source no longer has the anchor:\n{anchor}")
        text = text.replace(anchor, replacement)
    src.write_text(text + COPY_OUT)
    return dst


def main() -> None:
    """Build the instrumented copy, run it once at the shape, print the phases."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="gemma")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_phases: no CUDA device")
    sys.path.insert(0, str(instrumented_copy()))
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash_mod

    lib = _build.load()
    lib.repro_stamps_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: nothing")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, H, KV, hd = SHAPES[args.shape]
    q = torch.randn((B, S, H, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, KV, hd), generator=gen, device=dev).bfloat16()
    for _ in range(3):   # the last run's stamps are read
        flash_mod.launch_forward(q, k, v, True, 0, 0.0, with_lse=False)
    torch.cuda.synchronize()
    if flash_mod.variant(q.dtype, hd) != "sm90_wgmma":
        sys.exit(f"flash_fwd_phases: head_dim {hd} does not run on the wgmma kernel")
    cycles = np.zeros(2 * 2 * STEPS * MARKS, dtype=np.int64)
    ns = np.zeros(2 * 2 * STEPS, dtype=np.int64)
    _build.check(lib.repro_stamps_copy(cycles.ctypes.data, ns.ctypes.data), "stamps")
    cycles = cycles.reshape(2, 2, STEPS, MARKS).astype(np.float64)
    ns = ns.reshape(2, 2, STEPS).astype(np.float64)
    rows = []
    for blk in range(2):
        for c in range(2):
            stamped = int((cycles[blk, c, :, MARKS - 1] > 0).sum())
            st = cycles[blk, c, 4:stamped]       # the first steps warm up
            d = np.diff(st, axis=1)
            step_cycles = np.diff(st[:, 0])
            step_ns = np.diff(ns[blk, c, 4:stamped])
            keep = step_cycles < 4 * np.median(step_cycles)   # not across a work tile
            row = {"shape": args.shape, "block": "first" if blk == 0 else "middle",
                   "warpgroup": c, "steps": int(keep.sum()),
                   "cycles_per_step": float(np.median(step_cycles[keep])),
                   "ns_per_step": float(np.median(step_ns[keep])),
                   "sm_clock_ghz": float(np.median(step_cycles[keep])
                                         / np.median(step_ns[keep])),
                   **{name: float(np.median(d[:, i])) for i, name in enumerate(PHASES)}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
