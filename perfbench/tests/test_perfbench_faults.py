"""A run with the timed path broken underneath comes out not correct, under the
limits the cells commit.  Each test skips the look for a chip and drives the rest
of a run (set-up, window, check) on the CPU at reduced widths, with one fault
planted in the Trainer, once for each fault a one-chip training cell can have:

* the step returns its state unchanged;
* half of the batch left out, the mean taken over the rest;
* an answer altered where it is produced: one parameter's update applied twice;
* tokens altered where they are produced: the feed's labels are the tokens they
  should follow (the shift left out).

(A one-chip cell has no exchange between chips to leave out.)  The sound run passes.
"""

import time

import pytest
import torch

import cpu_cells
from harness import spec, train_cell

CELLS = {"qwen2_7b_l8": "train.qwen2_7b_l8.b2s4096"}


def unchanged(trainer):
    def step(state, batch):
        tokens = batch["tokens"]
        with torch.no_grad():
            loss = trainer.model.loss(tokens, batch["labels"])
        return state, {"loss": loss, "grad_norm": torch.ones(()), "lr": torch.zeros(()),
                       "tokens": torch.tensor(float(tokens.numel()))}
    trainer._step = step


def half_batch(trainer):
    real = trainer._step

    def step(state, batch):
        n = batch["tokens"].shape[0] // 2
        return real(state, {k: v[:n] for k, v in batch.items()})
    trainer._step = step


def doubled(trainer):
    real = trainer._step
    params = dict(trainer.model.named_parameters())
    param = params[max((p.numel(), n) for n, p in params.items() if n != "embed.tok")[1]]

    def step(state, batch):
        before = param.detach().clone()
        state, metrics = real(state, batch)
        with torch.no_grad():
            param.add_(param - before)
        return state, metrics
    trainer._step = step


def unshifted_labels(trainer):
    real = trainer.data.batch

    def batch(step):
        out = real(step)
        return dict(out, labels=out["tokens"])
    trainer.data.batch = batch


def run(config: str, plant=None):
    pieces = cpu_cells.cell(config, d_model=256)
    pieces["traffic"]["seq_len"] = 128
    pieces["limits"] = spec.limits(CELLS[config])
    out, _ = train_cell.run(**pieces, seed=2**31 + 29, seconds=0.5, trace=False,
                            t_start=time.perf_counter(), device="cpu", plant=plant,
                            log=lambda *a, **k: None)
    return out


@pytest.mark.parametrize("config", CELLS)
def test_the_sound_run_is_correct(config):
    out = run(config)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_batch, doubled, unshifted_labels],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("config", CELLS)
def test_a_fault_is_not_correct(config, fault):
    out = run(config, fault)
    assert not out["correct"], out["checks"]
