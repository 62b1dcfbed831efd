"""The reference agrees with the port's CPU path (its plain versions, float32) at
the widths of the port's ``reduced()`` configurations, for every configuration's
family: the loss, every gradient, and one AdamW update."""

import tempfile

import pytest
import torch

import cpu_cells
from harness import feed, reference, spec, train_cell, weights

SEED = 2**31 + 17


@pytest.fixture(params=[c["name"] for c in spec.benchmark()["configs"]])
def setup(request):
    cfg = cpu_cells.reduced_config(request.param)
    traffic = dict(cpu_cells.TRAFFIC, seq_len=128)
    arch = train_cell.port_config(cfg)
    return cfg, traffic, arch


def test_loss_and_gradients_agree(setup):
    from repro_torch.models.lm import LM
    cfg, traffic, arch = setup
    model_ref = spec.reference(cfg)
    specs = model_ref.param_specs(cfg)
    model = LM(arch, device="cpu")
    params = dict(model.named_parameters())
    weights.fill(params, specs, SEED)
    batch = feed.synthetic_batch(SEED, 0, 2, traffic["seq_len"], cfg["vocab_size"])
    tok, lab = (torch.as_tensor(batch[k]) for k in ("tokens", "labels"))
    got = model.loss(tok, lab)
    got_grads = torch.autograd.grad(got, list(params.values()))

    P = {n: t.clone().requires_grad_() for n, t in weights.initial(cfg, specs, SEED, "cpu").items()}
    want = model_ref.loss(P, cfg, tok, lab)
    want_grads = dict(zip(P, torch.autograd.grad(want, list(P.values()))))
    assert P.keys() == params.keys()
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    for name, g in zip(params, got_grads):
        w = want_grads[name]
        scale = float(w.abs().max()) + 1e-12
        assert float((g - w).abs().max()) <= 2e-4 * scale, name


def test_one_adamw_update_agrees(setup):
    cfg, traffic, arch = setup
    model_ref = spec.reference(cfg)
    specs = model_ref.param_specs(cfg)
    traffic = dict(traffic, check_steps=1)
    with tempfile.TemporaryDirectory() as ckpt:
        trainer, state = train_cell.build(arch, cfg, traffic, SEED, "cpu", ckpt)
        _, prog, _ = train_cell.program_readings(trainer, state, specs, SEED,
                                                 reference.AdamW(), 1)
    batches = [feed.synthetic_batch(SEED, 0, 2, traffic["seq_len"], cfg["vocab_size"])]
    ref = model_ref.train(cfg, weights.initial(cfg, specs, SEED, "cpu"), batches,
                          reference.AdamW(), SEED)
    assert prog.losses == pytest.approx(ref.losses, rel=1e-5)
    for name in ref.grad_norms:
        assert prog.grad_norms[name] == pytest.approx(ref.grad_norms[name], rel=1e-4), name
        assert prog.grad_proj[name] == pytest.approx(
            ref.grad_proj[name], abs=1e-4 * ref.grad_norms[name] + 1e-12), name
        # Adam's first step is g / (|g| + eps): entries of a gradient near eps carry
        # their last bits into the update
        assert prog.change_norms[name] == pytest.approx(ref.change_norms[name],
                                                        rel=1e-3, abs=1e-9), name
