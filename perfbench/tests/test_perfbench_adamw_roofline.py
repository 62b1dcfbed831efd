"""``metrics/adamw_roofline.py`` on a synthetic trace: the bound at the cell's
configuration, what it counts and what it leaves out."""

import dataclasses

import pytest

from harness import spec, trace
from harness.train_cell import Run

BENCH = spec.benchmark()
QWEN = spec.config(BENCH, "qwen2_7b_l8")
READER = spec.reader("adamw_roofline")


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": ts}}


def run_of(events, steps=2):
    return Run(cfg=QWEN, traffic=spec.traffic("b2s4096"), setup_s=0.0, plan_s=0.0,
               window_s=0.0, step_s=[], tokens_per_step=0, peak_bytes=0,
               trace=trace.parse(events, steps=steps))


def test_the_bound_is_24_bytes_a_parameter_at_the_cells_config():
    # bf16 gradients read twice, bf16 parameters read and written, float32 m and v
    # read and written: 24 B x 2.409 G parameters at 3.35 TB/s
    assert READER.bound_s(QWEN) * 1e3 == pytest.approx(17.26, abs=0.005)


def test_only_the_fused_kernels_count():
    # two steps in a window between two markers: 17.26 ms of bound against 20 ms a
    # step of repro_adamw kernels; the elementwise kernel and the product are not counted
    events = [kernel("fill marker", 0, 1),
              kernel("void repro_adamw_sumsq<__nv_bfloat16>(AdamwTable, double*)", 10, 3000),
              kernel("void repro_adamw_update<__nv_bfloat16, __nv_bfloat16>(AdamwTable, "
                     "AdamwHyper)", 4000, 17000),
              kernel("void at::native::vectorized_elementwise_kernel<4, MulFunctor>", 22000,
                     9000),
              kernel("nvjet_tst_gemm", 32000, 5000),
              kernel("repro_adamw_clip(double const*, int, float*, float)", 40000, 20000),
              kernel("fill marker", 90000, 1)]
    got = READER.read(run_of(events))
    assert got == pytest.approx(100 * READER.bound_s(QWEN) * 1e3 / 20.0)


def test_none_without_a_fused_kernel():
    events = [kernel("fill marker", 0, 1),
              kernel("void at::native::vectorized_elementwise_kernel<4, MulFunctor>", 10, 90),
              kernel("fill marker", 200, 1)]
    assert READER.read(run_of(events)) is None
    assert READER.read(dataclasses.replace(run_of(events), trace=None)) is None
