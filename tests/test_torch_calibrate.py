"""``tools/calibrate_fabric_torch.py`` against ``tools/calibrate_fabric.py``: its fit
functions are the reference's byte for byte under the planner copies' transform
(``_ported``), both give equal outputs on the reference tests' synthetic sweeps,
a 2-rank gloo sweep runs end to end through ``fit_report``, and a class whose
samples move no bytes (one rank's all-reduce) is reported as latency only."""

import ast
import json
import random
from pathlib import Path

import pytest

pytest.importorskip("torch")

import tools.calibrate_fabric as ref  # noqa: E402
import tools.calibrate_fabric_torch as port  # noqa: E402
from test_torch_planner import _ported  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIT_FUNCTIONS = ("fit_alpha_beta", "roofline_terms", "fit_report", "predict_step")


def _source(path: Path, name: str) -> str:
    text = path.read_text()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    return ast.get_source_segment(text, node)


@pytest.mark.parametrize("name", FIT_FUNCTIONS)
def test_fit_function_is_the_references(name):
    got = _source(ROOT / "tools" / "calibrate_fabric_torch.py", name)
    want = _source(ROOT / "tools" / "calibrate_fabric.py", name)
    assert got == _ported(want)


def _synthetic(alpha, beta, *, noise=0.0, seed=0, n=24):
    """The reference test's synthetic sweep."""
    rng = random.Random(seed)
    samples = []
    for _ in range(n):
        size = 10.0 ** rng.uniform(2, 8)
        bw = rng.choice([10e9, 25e9, 100e9])
        lat = rng.choice([1e-6, 5e-6, 2e-5])
        t = alpha * lat + size / (beta * bw)
        t *= 1.0 + rng.uniform(-noise, noise)
        samples.append({"size": size, "bw": bw, "lat": lat, "t": t})
    return samples


SWEEPS = {"exact": _synthetic(1.8, 0.6), "noisy": _synthetic(1.5, 0.8, noise=0.05, seed=3),
          "fast": _synthetic(1.0, 1.4),
          "degenerate": [{"size": 1e6, "bw": 10e9, "lat": 0.0, "t": 2e-4}] * 4,
          "classes": [
              {"size": 1e6, "bw": 10e9, "lat": 0, "t": 1e-6 + 1e6 / 8e9, "cls": "host"},
              {"size": 1e8, "bw": 10e9, "lat": 0, "t": 1e8 / 9e9, "cls": "host"},
              {"size": 1e8, "bw": 100e9, "lat": 0, "t": 1e8 / 50e9, "cls": "ib",
               "flops": 2e11}]}


@pytest.mark.parametrize("sweep", SWEEPS)
def test_equal_outputs_on_the_references_sweeps(sweep):
    s = SWEEPS[sweep]
    assert port.fit_alpha_beta(s) == ref.fit_alpha_beta(s)
    assert port.fit_alpha_beta(s, clamp_beta=2.0) == ref.fit_alpha_beta(s, clamp_beta=2.0)
    assert port.roofline_terms(s) == ref.roofline_terms(s)
    a, b = ref.fit_alpha_beta(s)
    assert port.predict_step(s, a, b) == ref.predict_step(s, a, b)
    step = ref.predict_step(s, a, b)
    for gate, measured in ((None, None), (0.25, step * 1.1), (0.25, step * 2.0)):
        assert port.fit_report(s, gate=gate, measured_step=measured) == \
            ref.fit_report(s, gate=gate, measured_step=measured)


def test_fit_rejects_an_empty_sweep():
    with pytest.raises(ValueError):
        port.fit_alpha_beta([])


@pytest.mark.parametrize("gate", [[], ["--gate", "0.25"], ["--no-gate"]],
                         ids=["default", "0.25", "no-gate"])
def test_cli_fit_only_equals_the_references(gate, tmp_path, capsys):
    """``--fit-only`` on a recorded sweep whose step is 10x the simulated one:
    the same exit code, printout and written report as the reference's CLI."""
    samples = _synthetic(1.0, 0.9, seed=5)
    good = ref.predict_step(samples, *ref.fit_alpha_beta(samples))
    src = tmp_path / "sweep.json"
    src.write_text(json.dumps({"samples": samples, "measured_step": good * 10}))
    outs = []
    for mod in (ref, port):
        dst = tmp_path / f"{mod.__name__}.json"
        rc = mod.main(["--fit-only", str(src), *gate, "--out", str(dst)])
        printed = capsys.readouterr().out.replace(str(dst), "OUT")
        outs.append((rc, printed, json.loads(dst.read_text())))
    assert outs[0] == outs[1]
    assert outs[0][0] == (0 if gate == ["--no-gate"] else 1)


def test_a_class_that_moves_no_bytes_is_latency_only(tmp_path, capsys):
    """One rank's all-reduce moves no bytes (2(p-1)/p of the buffer): its class
    has no bandwidth, so the CLI prints its median latency instead of a peak GB/s;
    a class with bytes keeps its peak."""
    samples = [{"size": 1e6, "bw": 16e9, "lat": 5e-6, "t": 1e-4, "cls": "pcie"},
               {"size": 0.0, "bw": 450e9, "lat": 1e-6, "t": 4e-5, "cls": "nccl"},
               {"size": 0.0, "bw": 450e9, "lat": 1e-6, "t": 6e-5, "cls": "nccl"},
               {"size": 0.0, "bw": 450e9, "lat": 1e-6, "t": 5e-5, "cls": "nccl"}]
    assert port.latency_only(samples) == {"nccl": 5e-5}
    src = tmp_path / "sweep.json"
    src.write_text(json.dumps({"samples": samples}))
    assert port.main(["--fit-only", str(src)]) == 0
    printed = capsys.readouterr().out
    assert "class nccl: latency only, median 50.0 us" in printed
    assert "class pcie: peak 10.00 GB/s" in printed


@pytest.mark.slow
def test_gloo_sweep_end_to_end(tmp_path):
    """Two gloo CPU ranks: transfers and all-reduces up to 1 MiB, class "host",
    every time positive; ``fit_report`` fits them and re-prices the measured
    composite step, and ``--fit-only`` re-fits the recorded sweep to the same
    report."""
    samples, measured = port.run_host_sweep(2, sizes=port.SIZES[:6])
    assert len(samples) == 12 and measured > 0
    assert {s["kind"] for s in samples} == {"transfer", "allreduce"}
    assert all(s["cls"] == "host" and s["t"] > 0 for s in samples)
    rep = port.fit_report(samples, measured_step=measured)
    assert rep["alpha"] >= 0 and 0 < rep["beta"] <= 1
    assert rep["classes"]["host"]["peak_bw"] > 0
    assert rep["step"]["measured_s"] == measured and rep["step"]["simulated_s"] > 0
    src, out = tmp_path / "sweep.json", tmp_path / "calib.json"
    src.write_text(json.dumps({"samples": samples, "measured_step": measured}))
    assert port.main(["--fit-only", str(src), "--no-gate", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["report"] == rep
