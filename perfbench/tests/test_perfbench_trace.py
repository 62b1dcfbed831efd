"""Reading a profiler trace: the window, the device's busy time as a union of
intervals (overlaps counted once), the idle gaps named by the host operator that
launched the operation after them, and the kernel-time sums the metrics read."""

import pytest

from harness import trace


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1, "args": {"correlation": corr}}


def test_a_device_only_trace_between_markers():
    events = [kernel("fill marker", 100, 2, 1), kernel("nvjet_tst_gemm", 110, 50, 2),
              kernel("vectorized_elementwise_kernel add", 150, 20, 3),
              kernel("flash_fwd_sm90_kernel", 200, 30, 4), kernel("fill marker", 260, 2, 5)]
    t = trace.parse(events, steps=2)
    assert t.window_s == pytest.approx(158e-6)
    assert t.busy_s == pytest.approx(90e-6)              # 110..170 and 200..230
    assert [name for name, _ in t.kernels()] == ["nvjet_tst_gemm",
                                                 "vectorized_elementwise_kernel add",
                                                 "flash_fwd_sm90_kernel"]
    assert trace.ms_per_step(t, ("gemm",), ()) == pytest.approx(25e-3)
    assert trace.ms_per_step(t, ("flash_bwd",), ()) is None
    assert sum(s for _, s in t.gaps) == pytest.approx(t.window_s - t.busy_s)


def test_gaps_are_named_by_the_host_operator_that_launched_the_next_kernel():
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 5, "dur": 10},
              {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 40, "dur": 20},
              {"ph": "X", "cat": "cpu_op", "name": "aten::fill_", "ts": 45, "dur": 5},
              launch(8, 1), launch(47, 2), launch(55, 3),
              kernel("a", 10, 20, 1), kernel("b", 50, 5, 2), kernel("c", 58, 2, 3)]
    t = trace.parse(events, steps=1)
    assert t.window_s == pytest.approx(100e-6)
    assert t.gaps[0] == ("aten::mul", pytest.approx(10e-6))
    assert t.gaps[1] == ("aten::fill_", pytest.approx(20e-6))      # innermost at 47
    assert t.gaps[2] == ("aten::copy_", pytest.approx(3e-6))
    assert t.gaps[-1][0] == "(after the last operation)"
    assert trace.top(t.gaps, 2)[0] == ["(after the last operation)", pytest.approx(40e-6)]
