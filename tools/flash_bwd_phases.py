#!/usr/bin/env python3
"""Where a step of the attention backward's wgmma kernel spends its time, on the card.

    python3 tools/flash_bwd_phases.py [--shape qwen2|zamba2|gemma|small] [--out FILE]

Where no profiler can attach to the card (ncu, nsys), stall reasons cannot be read,
so this tool instruments the kernel itself: it copies the package into
``_cmp/phases/`` (git-ignored), inserts ``clock64()`` stamps at the phase
boundaries of each step of ``csrc/flash_attention_bwd_sm90.cu`` (thread 0 of each
consumer warpgroup of two blocks: block 0 and the middle one), builds that copy,
runs one backward at a training shape (qwen2: q (2, 4096, 28, 128), k/v (2, 4096, 4,
128); zamba2: q/k/v (2, 4096, 32, 80), whose 4096-token window does not bite there;
gemma: q/k/v (2, 4096, 16, 256); small: q/k/v (2, 4096, 16, 32), head_dim 32's two
16-column boxes; causal, bf16) and prints, per block and warpgroup, the median SM
cycles of each phase over steps 20..219 (or the last stamped), the cycles of a whole step,
and the SM clock the run had (cycles over %globaltimer nanoseconds).  The stamps
cost a few percent of the kernel's time; the phases are what to compare, not the
total.

Phases of a step: the wait for its Q / dO stage (full_wait), S^T and dP^T issued
and waited for (s_dp), P^T and dS^T in registers (math), dS^T (and at head_dim 256
P^T) to shared memory (ds_store), dV and dK issued (dv_dk; at head_dim 256 after the
wait for the other warpgroup's half of P^T and dS^T), dQ issued (dq_issue; at the
other head_dims after the wait for the other warpgroup's dS^T), every product waited
for (wait, the stage released in between), dQ staged for the writer thread
(dq_stage: the wait for a free buffer, the stores).  At head_dim 256 the kernel
stamped is the dk / dv pass (dQ has a pass of its own): there dq_issue and dq_stage
are empty and wait is the wait for dV and dK.  Needs a CUDA device.
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
STEPS, MARKS = 512, 9
PHASES = ["full_wait", "s_dp", "math", "ds_store", "dv_dk", "dq_issue", "wait", "dq_stage"]
SHAPES = {"qwen2": (2, 4096, 28, 4, 128), "zamba2": (2, 4096, 32, 32, 80),
          "gemma": (2, 4096, 16, 16, 256), "small": (2, 4096, 16, 16, 32)}

# (anchor in the kernel source, the text that replaces it): stamps 0..8 in order
PATCHES = [
    ("""        mbar_wait(full(s), (it / kStages) & 1);
""", """        stamp(0);
        mbar_wait(full(s), (it / kStages) & 1);
        stamp(1);
"""),
    ("""        pin(st);
        pin(dpt);

        // P^T and dS^T in place""", """        pin(st);
        pin(dpt);
        stamp(2);

        // P^T and dS^T in place"""),
    ("""        if constexpr (C::kWide) {
          // P^T and dS^T to shared memory""", """        stamp(3);
        if constexpr (C::kWide) {
          // P^T and dS^T to shared memory"""),
    ("""        mbar_arrive_if(ds_full(u), true);

        // dV += P^T dO""", """        mbar_arrive_if(ds_full(u), true);
        stamp(4);

        // dV += P^T dO"""),
    ("""        wgmma_commit();

        if constexpr (C::kWide) {
          wgmma_wait0();  // dV and dK: Q, dO, lse and D of this stage are read
          pin(dk);
          pin(dv);
          mbar_arrive_if(empty(s), lane == 0);
        } else {""", """        wgmma_commit();
        stamp(5);

        if constexpr (C::kWide) {
          stamp(6);
          wgmma_wait0();  // dV and dK: Q, dO, lse and D of this stage are read
          pin(dk);
          pin(dv);
          mbar_arrive_if(empty(s), lane == 0);
          stamp(7);
          stamp(8);
        } else {"""),
    ("""          wgmma_commit();
          wgmma_wait<1>();""", """          wgmma_commit();
          stamp(6);
          wgmma_wait<1>();"""),
    ("""          const int b = it % kDqBufs;
          mbar_wait(dq_empty(c, b)""", """          stamp(7);
          const int b = it % kDqBufs;
          mbar_wait(dq_empty(c, b)"""),
    ("""          mbar_arrive_if(dq_full(c, b), true);
        }
      }
""", """          mbar_arrive_if(dq_full(c, b), true);
          stamp(8);
        }
      }
"""),
    ("""        const int s = it % kStages, u = it & 1;
""", """        const int s = it % kStages, u = it & 1;
        const int slot = blockIdx.x == 0 ? 0 : blockIdx.x == gridDim.x / 2 ? 1 : -1;
        auto stamp = [&](int mark) {
          if (slot >= 0 && t == 0 && it < kStampSteps) {
            const long long at = ((slot * 2 + c) * kStampSteps + it) * kStampMarks + mark;
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
    """The package copied under _cmp/phases/src with the stamps patched in."""
    dst = ROOT / "_cmp" / "phases" / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dst / "repro_torch" / "kernels" / "csrc" / "flash_attention_bwd_sm90.cu"
    text = src.read_text()
    for anchor, replacement in PATCHES:
        if text.count(anchor) != 1:
            sys.exit(f"flash_bwd_phases: the kernel source no longer has the anchor:\n{anchor}")
        text = text.replace(anchor, replacement)
    src.write_text(text + COPY_OUT)
    return dst


def main() -> None:
    """Build the instrumented copy, run it once at the training shape, print phases."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="qwen2")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_phases: no CUDA device")
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
    do = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    o, lse = flash_mod.launch_forward(q, k, v, True, 0, 0.0, with_lse=True)
    for _ in range(3):   # the last run's stamps are read
        flash_mod.launch_backward(q, k, v, o, lse, do, True, 0, 0.0)
    torch.cuda.synchronize()
    if flash_mod.bwd_variant(q.dtype, hd) != "sm90_wgmma":
        sys.exit(f"flash_bwd_phases: head_dim {hd} does not run on the wgmma backward")
    cycles = np.zeros(2 * 2 * STEPS * MARKS, dtype=np.int64)
    ns = np.zeros(2 * 2 * STEPS, dtype=np.int64)
    _build.check(lib.repro_stamps_copy(cycles.ctypes.data, ns.ctypes.data), "stamps")
    cycles = cycles.reshape(2, 2, STEPS, MARKS).astype(np.float64)
    ns = ns.reshape(2, 2, STEPS).astype(np.float64)
    rows = []
    for blk in range(2):
        for c in range(2):
            end = min(220, int((cycles[blk, c, :, MARKS - 1] > 0).sum()))
            st = cycles[blk, c, 20:end]
            d = np.diff(st, axis=1)
            step_cycles = np.diff(st[:, 0])
            step_ns = np.diff(ns[blk, c, 20:end])
            row = {"shape": args.shape, "block": "first" if blk == 0 else "middle",
                   "warpgroup": c,
                   "cycles_per_step": float(np.median(step_cycles)),
                   "ns_per_step": float(np.median(step_ns)),
                   "sm_clock_ghz": float(np.median(step_cycles) / np.median(step_ns)),
                   **{name: float(np.median(d[:, i])) for i, name in enumerate(PHASES)}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
