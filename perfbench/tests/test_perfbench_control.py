"""The control: the reference put in the program's place, each stated precision one
step down (the 16-bit class in float8, the float32 class in bfloat16), comes out not
correct under the limits the cells commit.

At the cell's own size it needs the cell's card, and skips without one (run it on the
card with ``python -m pytest -q perfbench/tests/test_perfbench_control.py``; about a
minute a cell).  On the CPU the precisions themselves are checked, and at the port's
reduced widths the control's first-order gradient gap against its norm gap.
"""

import pytest
import torch

import cpu_cells
from harness import compare, feed, reference, spec, weights

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]


def control_numbers(cfg: dict, traffic: dict, seed: int, device: str) -> dict:
    """Every number of the float8 control against the float32 reference, both the
    configuration's reference module, on the seed's weights and batches."""
    model = spec.reference(cfg)
    B, S, V = traffic["global_batch"], traffic["seq_len"], cfg["vocab_size"]
    batches = [feed.synthetic_batch(seed, s, B, S, V) for s in range(traffic["check_steps"])]
    params0 = weights.initial(cfg, model.param_specs(cfg), seed, device)
    want = model.train(cfg, params0, batches, reference.AdamW(), seed)
    got = model.train(cfg, params0, batches, reference.AdamW(), seed, pr=reference.FLOAT8)
    return compare.gaps(got, want)[0]


def test_each_precision_rounds_its_class():
    x = torch.linspace(-3, 3, 1001, dtype=torch.float32) * 1.2345
    assert torch.equal(reference.EXACT.r(x), x) and torch.equal(reference.EXACT.w(x), x)
    assert torch.equal(reference.BF16.w(x), x)
    assert torch.equal(reference.BF16.r(x), x.to(torch.bfloat16).float())
    assert torch.equal(reference.FLOAT8.w(x), x.to(torch.bfloat16).float())
    e8 = (reference.FLOAT8.r(x) - x).abs().max() / x.abs().max()
    e16 = (reference.BF16.r(x) - x).abs().max() / x.abs().max()
    assert 2**-6 < e8 < 2**-3 and e16 < 2**-8


def test_the_control_rounds_its_gradient_too():
    x = torch.linspace(0.1, 2, 64, requires_grad=True)
    g = torch.linspace(1, 3, 64) * 1.0001
    (reference.FLOAT8.r(x) * g).sum().backward()
    assert not torch.equal(x.grad, g)            # e5m2: two mantissa bits


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's size needs its card")
    pieces = spec.resolve(BENCH, name)
    numbers = control_numbers(pieces["cfg"], pieces["traffic"], 2**32 + 11, "cuda")
    correct, checks = compare.verdict(numbers, pieces["limits"])
    assert not correct, checks


@pytest.mark.parametrize("seed", [2**31 + 5, 2**33 + 7, 12345])
@pytest.mark.parametrize("name", CONFIGS)
def test_the_controls_first_order_gap_exceeds_its_norm_gap(name, seed):
    # the float8 control's gradient error lies mostly across the gradient, which a
    # norm reads at second order only
    numbers = control_numbers(cpu_cells.reduced_config(name), dict(cpu_cells.TRAFFIC),
                              seed, "cpu")
    assert numbers["grad_proj_gap"] > numbers["grad_gap"], numbers
