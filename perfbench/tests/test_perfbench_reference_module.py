"""A configuration brings its own reference: the harness asks the module that the
configuration's ``reference`` key names for the port check, the work count and the
loss, so a configuration with a reference of its own runs through
``train_cell.run`` with no edit to the harness.

The stand-in is the dense reference under another name, injected as
``harness.<name>`` (no file is written): its ``train`` is one call into the shared
AdamW loop with its own ``loss``, its ``other_flops`` a known constant, and its
``port_departures`` checks one field of its own, the FFN's kind, which a
configuration file can state against the port.
"""

import dataclasses
import hashlib
import sys
import time
import types

import pytest

import cpu_cells
from harness import counts, reference, spec, train_cell

NAME = "standin_dense"
#: the stand-in's operations a step beyond 6 a parameter and token and attention
OTHER = 3.0e9


def standin() -> types.ModuleType:
    mod = types.ModuleType(f"harness.{NAME}")
    for attr in ("param_specs", "params_run", "attention_calls"):
        setattr(mod, attr, getattr(reference, attr))
    mod.losses_taken = 0

    def loss(*args, **kw):
        mod.losses_taken += 1
        return reference.loss(*args, **kw)
    mod.loss = loss
    mod.train = lambda *args, **kw: reference.adamw_train(*args, loss_fn=mod.loss, **kw)
    mod.other_flops = lambda cfg, traffic: OTHER

    def port_departures(cfg, arch):
        wrong = reference.port_departures(cfg, arch)
        if arch.ffn_kind != cfg["ffn_kind"]:
            wrong["ffn_kind"] = (cfg["ffn_kind"], arch.ffn_kind)
        return wrong
    mod.port_departures = port_departures
    return mod


def harness_files() -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((spec.BENCH / "harness").glob("*.py"))}


@pytest.fixture
def pieces(monkeypatch):
    monkeypatch.setitem(sys.modules, f"harness.{NAME}", standin())
    out = cpu_cells.cell("qwen2_7b_l8", d_model=256)
    out["traffic"]["seq_len"] = 128
    out["cfg"].update(reference=NAME, ffn_kind="swiglu")
    out["limits"] = spec.limits("train.qwen2_7b_l8.b2s4096")
    return out


def run(pieces):
    return train_cell.run(**pieces, seed=2**31 + 41, seconds=0.5, trace=False,
                          t_start=time.perf_counter(), device="cpu",
                          log=lambda *a, **k: None)


def test_a_configuration_runs_on_its_own_reference_module(pieces):
    before = harness_files()
    out, result = run(pieces)
    assert out["correct"], out["checks"]
    assert spec.reference(result.cfg).losses_taken == 3      # the reference's 3 steps
    assert harness_files() == before and f"{NAME}.py" not in before
    # the work count asks the module: mfu_pct moves by exactly its other_flops' share
    mfu = spec.reader("mfu_pct")
    dense = dataclasses.replace(result, cfg=dict(result.cfg, reference="reference"))
    step = result.window_s / len(result.step_s)
    assert mfu.read(result) - mfu.read(dense) == pytest.approx(
        100.0 * OTHER / step / counts.PEAK_16BIT_FLOPS, rel=1e-9)
    assert counts.step_flops(result.cfg, result.traffic) == \
        counts.step_flops(dense.cfg, dense.traffic) + OTHER


def test_the_modules_departure_raises(pieces):
    pieces["cfg"]["ffn_kind"] = "geglu"
    with pytest.raises(ValueError, match="ffn_kind"):
        run(pieces)
