"""``metrics/ssd_ms_per_step.py`` on a synthetic trace: what it counts and what it
leaves out."""

import dataclasses

import pytest

from harness import spec, trace
from harness.train_cell import Run

BENCH = spec.benchmark()
ZAMBA = spec.config(BENCH, "zamba2_7b_l18")
READER = spec.reader("ssd_ms_per_step")


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": ts}}


def run_of(events, steps=2):
    return Run(cfg=ZAMBA, traffic=spec.traffic("b2s4096"), setup_s=0.0, plan_s=0.0,
               window_s=0.0, step_s=[], tokens_per_step=0, peak_bytes=0,
               trace=trace.parse(events, steps=steps))


def test_only_the_ssd_kernels_count():
    # two steps between two markers: 3 + 7 + 10 ms of repro_ssd kernels (20 ms, 10 a
    # step); the elementwise kernel, the product and the AdamW update are not counted
    events = [kernel("fill marker", 0, 1),
              kernel("void (anonymous namespace)::repro_ssd_chunk_state<64, 64, false>("
                     "(anonymous namespace)::SsdArgs)", 10, 3000),
              kernel("void (anonymous namespace)::repro_ssd_chunk_grad<64, 64>("
                     "(anonymous namespace)::SsdArgs)", 4000, 7000),
              kernel("void at::native::vectorized_elementwise_kernel<4, MulFunctor>", 12000,
                     9000),
              kernel("nvjet_tst_gemm", 22000, 5000),
              kernel("(anonymous namespace)::repro_ssd_state_pass(float*, float const*, "
                     "float const*, float*, int, int, int, int, int)", 30000, 10000),
              kernel("void repro_adamw_update<__nv_bfloat16, __nv_bfloat16>(AdamwTable, "
                     "AdamwHyper)", 41000, 17000),
              kernel("fill marker", 90000, 1)]
    assert READER.read(run_of(events)) == pytest.approx(10.0)


def test_none_without_an_ssd_kernel():
    # the parent's program: its SSD is PyTorch's work, so nothing matches
    events = [kernel("fill marker", 0, 1),
              kernel("void at::native::vectorized_elementwise_kernel<4, MulFunctor>", 10, 90),
              kernel("fill marker", 200, 1)]
    assert READER.read(run_of(events)) is None
    assert READER.read(dataclasses.replace(run_of(events), trace=None)) is None


def test_the_elementwise_and_product_readers_leave_the_ssd_kernels_out():
    events = [kernel("fill marker", 0, 1),
              kernel("void (anonymous namespace)::repro_ssd_chunk_out<64, 64>("
                     "(anonymous namespace)::SsdArgs)", 10, 4000),
              kernel("fill marker", 9000, 1)]
    for other in ("elementwise_ms_per_step", "matmul_ms_per_step"):
        assert spec.reader(other).read(run_of(events)) is None
