"""The yardstick's arithmetic against figures worked by hand (PERF.md's kernel
table and the configurations' parameter counts), and qwen2's figures pinned to the
values they had before the counts asked the configuration's reference module."""

import math

import pytest

from harness import counts, spec

BENCH = spec.benchmark()
QWEN = spec.config(BENCH, "qwen2_7b_l8")
MODEL = spec.reference(QWEN)
#: one attention layer at zamba2-2.7b's heads (32 of head_dim 80) behind a 4096 window
HD80 = {"name": "hd80", "reference": "reference", "num_hidden_layers": 1,
        "layer_pattern": ["attn"], "num_attention_heads": 32, "num_key_value_heads": 32,
        "head_dim": 80, "attention_window": 4096, "torch_dtype": "bfloat16"}
TRAFFIC = spec.traffic("b2s4096")


@pytest.mark.parametrize("S, causal, window, want", [
    (4096, True, 0, 4096 * 4097 // 2),
    (4096, True, 4096, 4096 * 4097 // 2),          # the window does not bite at 4096
    (6144, True, 4096, 4096 * 4097 // 2 + 2048 * 4096),
    (5, True, 2, 1 + 2 * 4),
    (7, False, 0, 49),
])
def test_visible_pairs(S, causal, window, want):
    assert counts.visible_pairs(S, causal, window) == want


def test_zamba2_backward_bound_is_the_hand_worked_one():
    # PERF.md's kernel table: zamba2's (2, 4096, 32/32, 80) causal backward, 10 * 80 *
    # (4096 * 4097 / 2) * 2 * 32 = 4.30e11 operations, a 0.434 ms bound
    ops = 10 * 80 * (4096 * 4097 / 2) * 2 * 32
    assert ops == pytest.approx(4.30e11, rel=1e-3)
    assert counts.flash_bound_s(HD80, TRAFFIC, backward=True) * 1e3 == \
        pytest.approx(0.434, abs=5e-4)


def test_qwen2_forward_bound_is_operations():
    # 4 * 128 * 8390656 * 2 * 28 operations at 989 TFLOP/s, against 2 * (q + kv)
    # bf16 bytes and the lse at 3.35 TB/s: the operations bound it
    ops_s = 4 * 128 * (4096 * 4097 / 2) * 2 * 28 / 989e12
    assert counts.flash_bound_s(QWEN, TRAFFIC, backward=False) == pytest.approx(8 * ops_s)


def test_parameter_counts():
    # qwen2-7b at 8 layers: 2.409 G parameters (a tied head), each run once a step
    held = sum(math.prod(s.shape) for s in MODEL.param_specs(QWEN))
    assert held == pytest.approx(2.409e9, rel=1e-3)
    assert MODEL.params_run(QWEN) == held


def test_step_flops_match_the_smoke_runs_count():
    # chip_smoke.py's MFU count: 6 * N * T + 12 * hd * pairs * B * H * attention layers
    T = 2 * 4096
    pairs = 4096 * 4097 // 2
    assert counts.step_flops(QWEN, TRAFFIC) == pytest.approx(
        6 * MODEL.params_run(QWEN) * T + 12 * 128 * pairs * 2 * 28 * 8)
    # qwen2-7b at 8 layers: 1.18e14 operations a step in the products, 5.8e12 in
    # attention
    assert counts.step_flops(QWEN, TRAFFIC) == pytest.approx(1.18e14 + 5.8e12, rel=0.01)


def qwen2_figures() -> dict:
    return {"step_flops": counts.step_flops(QWEN, TRAFFIC),
            "flash_fwd_bound_s": counts.flash_bound_s(QWEN, TRAFFIC, backward=False),
            "flash_bwd_bound_s": counts.flash_bound_s(QWEN, TRAFFIC, backward=True),
            "adamw_bound_s": spec.reader("adamw_roofline").bound_s(QWEN),
            "params_run": MODEL.params_run(QWEN)}


@pytest.mark.parametrize("figure, want", [
    ("step_flops", 124203785256960.0),
    ("flash_fwd_bound_s", 0.0019460213454560163),
    ("flash_bwd_bound_s", 0.00486505336364004),
    ("adamw_bound_s", 0.017261826598208956),
    ("params_run", 2409463296),
])
def test_qwen2_figures_are_pinned(figure, want):
    # exactly what the harness computed while it called the dense model by name
    assert qwen2_figures()[figure] == want
