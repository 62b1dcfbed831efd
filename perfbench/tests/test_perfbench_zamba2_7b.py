"""The Zamba2-7B cell (``train.zamba2_7b_l18.b2s4096``): its figures pinned, the
head_dim-224 flash readers, and a run on the CPU at reduced widths and 512 tokens
(four chunks of the port's chunkwise SSD) whose port drops the state passed from
chunk to chunk: not correct under the cell's limits, where the sound run is."""

import dataclasses
import math
import sys
import time

import pytest

import cpu_cells
from harness import counts, spec, trace, train_cell
from harness.train_cell import Run

BENCH = spec.benchmark()
CELL = "train.zamba2_7b_l18.b2s4096"
ZAMBA = spec.config(BENCH, "zamba2_7b_l18")
QWEN = spec.config(BENCH, "qwen2_7b_l8")
MODEL = spec.reference(ZAMBA)
TRAFFIC = spec.traffic("b2s4096")


def test_parameters_held_and_run():
    # 18 Mamba2 layers of 78,437,456, two shared blocks of 333,982,208, three uses of
    # 16,973,824, the embedding and the final norm; block 0 runs twice a step
    held = sum(math.prod(s.shape) for s in MODEL.param_specs(ZAMBA))
    assert held == 18 * 78_437_456 + 2 * 333_982_208 + 3 * 16_973_824 + 114_688_000 + 3584
    assert held == 2_245_451_680
    assert MODEL.params_run(ZAMBA) == held + 333_982_208


def test_other_flops_by_hand():
    # the SSD at chunk 256 and the convolution, forward and backward, 2 sequences,
    # 18 layers (the reference module's docstring)
    S, Q, N, P, nh, G, W, ch = 4096, 256, 64, 64, 112, 2, 4, 7424
    fwd = (2 * S * Q * N * G + 2 * S * Q * P * nh + 2 * S * N * P * nh
           + 2 * (S // Q) * N * P * nh + 2 * S * N * P * nh + 2 * S * W * ch)
    assert MODEL.other_flops(ZAMBA, TRAFFIC) == 3 * fwd * 2 * 18
    assert MODEL.other_flops(ZAMBA, TRAFFIC) == pytest.approx(2.49e12, rel=1e-3)


@pytest.mark.parametrize("figure, want", [
    ("step_flops", 133606814515200.0),
    ("flash_fwd_bound_s", 0.0014595160090920122),
    ("flash_bwd_bound_s", 0.0036487900227300304),
    ("params_run", 2579433888),
])
def test_zamba2_figures_are_pinned(figure, want):
    got = {"step_flops": counts.step_flops(ZAMBA, TRAFFIC),
           "flash_fwd_bound_s": counts.flash_bound_s(ZAMBA, TRAFFIC, backward=False),
           "flash_bwd_bound_s": counts.flash_bound_s(ZAMBA, TRAFFIC, backward=True),
           "params_run": MODEL.params_run(ZAMBA)}[figure]
    assert got == want


def test_the_flash_bounds_by_hand():
    # three causal calls of (2, 4096, 32/32, 224): 4 (forward) or 10 (backward) * 224
    # operations a visible pair at 989 TFLOP/s
    pairs = 4096 * 4097 / 2 * 2 * 32 * 3
    assert counts.flash_bound_s(ZAMBA, TRAFFIC, backward=False) == \
        pytest.approx(4 * 224 * pairs / 989e12)
    assert counts.flash_bound_s(ZAMBA, TRAFFIC, backward=True) == \
        pytest.approx(10 * 224 * pairs / 989e12)


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": ts}}


def run_of(cfg, events, steps=2):
    return Run(cfg=cfg, traffic=TRAFFIC, setup_s=0.0, plan_s=0.0, window_s=0.0, step_s=[],
               tokens_per_step=0, peak_bytes=0, trace=trace.parse(events, steps=steps))


@pytest.mark.parametrize("way", ["fwd", "bwd"])
def test_the_head_dim_224_readers(way):
    reader = spec.reader(f"flash_{way}_roofline_hd224")
    events = [kernel("fill marker", 0, 1),
              kernel(f"void flash::flash_{way}_sm90_kernel<__nv_bfloat16, 256>", 10, 8000),
              kernel("nvjet_tst_gemm", 9000, 5000),
              kernel("fill marker", 90000, 1)]
    bound_ms = counts.flash_bound_s(ZAMBA, TRAFFIC, backward=way == "bwd") * 1e3
    assert reader.read(run_of(ZAMBA, events)) == pytest.approx(100 * bound_ms / 4.0)
    # silent in a cell whose attention is at another head_dim, and without a trace
    assert reader.read(run_of(QWEN, events)) is None
    assert reader.read(dataclasses.replace(run_of(ZAMBA, events), trace=None)) is None


def run(plant=None):
    pieces = cpu_cells.cell("zamba2_7b_l18")
    pieces["traffic"]["seq_len"] = 512
    pieces["limits"] = spec.limits(CELL)
    out, _ = train_cell.run(**pieces, seed=2**31 + 43, seconds=0.5, trace=False,
                            t_start=time.perf_counter(), device="cpu", plant=plant,
                            log=lambda *a, **k: None)
    return out


def test_the_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]


@pytest.fixture
def no_chunk_to_chunk(monkeypatch):
    """A plant that makes the port's chunkwise SSD take each chunk as a sequence of
    its own: the state passed from chunk to chunk left out.  It reaches the port's
    layers through the Trainer's model."""
    def plant(trainer):
        layers = sys.modules[type(trainer.model).__module__].L
        whole = layers._ssd_chunked_groups

        def dropped(x, B_in, C_in, dt, A_log, D, hd, h0, chunk):
            n = x.shape[1] // chunk

            def split(t):
                return t.reshape(t.shape[0] * n, chunk, *t.shape[2:])

            y, h = whole(split(x), split(B_in), split(C_in), split(dt), A_log, D, hd,
                         None, chunk)
            return y.reshape(x.shape), h[:x.shape[0]]
        monkeypatch.setattr(layers, "_ssd_chunked_groups", dropped)
    return plant


def test_dropping_the_chunk_to_chunk_term_is_not_correct(no_chunk_to_chunk):
    out = run(no_chunk_to_chunk)
    assert not out["correct"], out["checks"]
