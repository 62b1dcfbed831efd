"""The port's planner-driven training path against the JAX package's, on the CPU:
the ``Trainer`` with ``topo`` / ``events`` / ``scenario`` / ``plan`` (S1/S2/S3
events: checkpoint, re-plan, rebuild, restore, calibrate), the orchestrator's
decisions, the plan -> train -> checkpoint -> resume loop, the launcher
(``launch.train``) and ``examples/dynamic_network_torch.py`` end to end.

Both trainers read one fake clock each, advanced by the same tick at every
reading: the engine's switch-cost hysteresis is priced from the run's step walls
and the measured restore, so only equal clocks make its decisions comparable."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.runtime.trainer as jtrainer  # noqa: E402
import repro.scenarios as jscen  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.parallel.trainstep import init_train_state as jax_init_state  # noqa: E402
import repro_torch.core as pcore  # noqa: E402
import repro_torch.runtime.trainer as ptrainer  # noqa: E402
import repro_torch.scenarios as pscen  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import planner as pplanner  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _same_search_space(monkeypatch):
    """tests/conftest.py shrinks the reference's default candidate list for the
    test session; the port's gets the same size, so both search the same space."""
    monkeypatch.setattr(pplanner, "DEFAULT_MAX_CANDIDATES",
                        jplanner.DEFAULT_MAX_CANDIDATES)


class _Clock:
    """Stands in for the ``time`` module of a trainer: each reading is one tick
    later than the last."""

    def __init__(self, tick: float = 0.05):
        self.now, self.tick = 0.0, tick

    def perf_counter(self) -> float:
        self.now += self.tick
        return self.now


@pytest.fixture
def clocks(monkeypatch):
    monkeypatch.setattr(jtrainer, "time", _Clock())
    monkeypatch.setattr(ptrainer, "time", _Clock())


def _tiny(get):
    return get("qwen2_7b").reduced(n_layers=2, d_model=64, vocab=128, d_ff=128)


def _opt(cls, lr):
    return cls(peak_lr=lr, warmup_steps=2, total_steps=20)


def _configs(tmp_path, steps, lr=1e-4, **over):
    kw = {**dict(steps=steps, global_batch=4, seq_len=32, ckpt_every=0, log_every=1), **over}
    jcfg = jtrainer.TrainerConfig(arch=_tiny(jax_config), ckpt_dir=str(tmp_path / "jax"),
                                  opt=_opt(JaxAdamWConfig, lr), **kw)
    pcfg = ptrainer.TrainerConfig(arch=_tiny(get_config), ckpt_dir=str(tmp_path / "port"),
                                  opt=_opt(AdamWConfig, lr), device="cpu", **kw)
    return jcfg, pcfg


def _hetero(core):
    return core.hetero_cluster({"RTX4090D": 4, "V100": 4}, gpus_per_node=4)


class _HeldTrainer(ptrainer.Trainer):
    """Holds a copy of the state at each event and checks the restore against it."""

    held: list

    def _handle_event(self, step, ev, state):
        saved = convert.export_jax_train_state(self.model, state)
        restored = super()._handle_event(step, ev, state)
        again = convert.export_jax_train_state(self.model, restored)
        flat = lambda t: dict(store._items(t))  # noqa: E731
        a, b = flat(saved), flat(again)
        assert a.keys() == b.keys()
        self.held = getattr(self, "held", []) + [
            all(np.array_equal(a[k], b[k]) for k in a)]
        return restored


def _events_of(core, case):
    """(topo, events, scenario, plan, steps) of one case, in ``core``'s types."""
    dp2 = core.ParallelPlan(dp=2, tp=2, pp=2, microbatches=2)
    scen = jscen if core is jcore else pscen
    if case == "fail":               # tests/test_runtime_ft.py:37
        return (_hetero(core), [(7, core.NetworkEvent(0.0, "fail", device_id=7))],
                None, dp2, 14)
    if case == "trace":              # tests/test_runtime_ft.py:90
        trace = scen.Trace.from_events(
            "unit", [core.NetworkEvent(5.0, "slowdown", device_id=2, factor=0.4)],
            horizon=10.0)
        return _hetero(core), (), trace, dp2, 10
    if case == "s1s2s3":             # examples/dynamic_network.py's trace, 12 steps
        trace = scen.Trace.from_events(
            "s1s2s3_demo",
            [core.NetworkEvent(6.0, "bandwidth", factor=0.3, selector="ib"),
             core.NetworkEvent(12.0, "slowdown", device_id=2, factor=0.4),
             core.NetworkEvent(18.0, "fail", device_id=7)], horizon=24.0)
        return _hetero(core), (), trace, dp2, 12
    assert case == "catalog"         # a catalog name: its own topology, no plan
    return None, (), "fig6c_dynamic_bw", None, 8


def _adaptations(tr):
    return [(r.time, r.event.kind, r.action, r.old_step_time, r.new_step_time,
             r.switch_cost) for r in tr.adaptations]


def _event_plans(ckpt_dir):
    return {p.name: json.loads((p / "manifest.json").read_text())["plan"]
            for p in sorted(Path(ckpt_dir).glob("step_*"))}


@pytest.mark.parametrize("case", ["fail", "trace", "s1s2s3", "catalog"])
def test_planned_trainer_matches_the_reference(tmp_path, clocks, case):
    """The same events through both trainers from one JAX-made state: the same
    re-plans, adaptations, engine paths, plans at each event and calibrated store
    bandwidth; losses within 1e-4 in float32 (peak lr 1e-4, the tolerance and
    reason of test_torch_runtime.py's trajectory test); each restore gives back
    the state saved at its event bit for bit."""
    jcfg, pcfg = _configs(tmp_path, _events_of(jcore, case)[-1])
    topo, events, scen, plan, _ = _events_of(jcore, case)
    jtr = jtrainer.Trainer(jcfg, topo=topo, events=events, scenario=scen, plan=plan)
    jstate = jtr.init_state()
    start = jax.tree.map(np.asarray, jstate)
    _, jhist = jtr.run(jstate)

    topo, events, scen, plan, _ = _events_of(pcore, case)
    tr = _HeldTrainer(pcfg, topo=topo, events=events, scenario=scen, plan=plan)
    assert [s for s, _ in tr.events] == [s for s, _ in jtr.events]
    _, hist = tr.run(convert.load_jax_train_state(tr.model, start))

    n_events = len(jtr.events)
    assert n_events >= 1
    assert tr.replans == jtr.replans == n_events
    assert _adaptations(tr) == _adaptations(jtr)
    assert len(tr.adaptations) == n_events
    assert [(r.path, r.kept, r.cold, r.plan.to_json(), r.switch_cost)
            for r in tr.engine.history] == \
        [(r.path, r.kept, r.cold, r.plan.to_json(), r.switch_cost)
         for r in jtr.engine.history]
    assert tr.engine.reconfig.io_bw == jtr.engine.reconfig.io_bw != 4e9
    assert (tr.plan.to_json() if tr.plan else None) == \
        (jtr.plan.to_json() if jtr.plan else None)
    assert _event_plans(pcfg.ckpt_dir) == _event_plans(jcfg.ckpt_dir)
    assert len(_event_plans(pcfg.ckpt_dir)) == len({s for s, _ in tr.events})
    assert tr.held == [True] * n_events
    assert [r["step"] for r in tr.restores] == [s for s, _ in tr.events]
    assert all(r["bytes"] > 0 and r["seconds"] > 0 for r in tr.restores)
    assert tr.engine.reconfig.io_bw == tr.restores[-1]["bytes"] / tr.restores[-1]["seconds"]
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               atol=1e-4, rtol=0)


def test_event_checkpoints_cross_between_the_packages(tmp_path, clocks):
    """An event's checkpoint, with the plan's JSON in its manifest, restores in the
    other package: the port's into JAX's state and the reference's into the port's."""
    jcfg, pcfg = _configs(tmp_path, 9)
    ev = lambda core: [(7, core.NetworkEvent(0.0, "fail", device_id=7))]  # noqa: E731
    plan = lambda core: core.ParallelPlan(dp=2, tp=2, pp=2, microbatches=2)  # noqa: E731
    jtr = jtrainer.Trainer(jcfg, topo=_hetero(jcore), events=ev(jcore), plan=plan(jcore))
    jtr.run()
    tr = ptrainer.Trainer(pcfg, topo=_hetero(pcore), events=ev(pcore), plan=plan(pcore))
    tr.run()
    port_ck, ref_ck = Path(pcfg.ckpt_dir) / "step_7", Path(jcfg.ckpt_dir) / "step_7"

    like_j = jax_init_state(jtr.model, jax.random.PRNGKey(1))
    tree_j, manifest = jstore.restore(port_ck, like_j)
    assert manifest["plan"] == plan(pcore).to_json() == plan(jcore).to_json()
    assert jcore.ParallelPlan.from_json(manifest["plan"]) == plan(jcore)
    tree_p, _ = store.restore(port_ck, convert.jax_train_state_like(tr.model))
    np.testing.assert_array_equal(np.asarray(tree_j["params"]["pos0"]["attn"]["wq"]),
                                  tree_p["params"]["pos0"]["attn"]["wq"].numpy())
    np.testing.assert_array_equal(np.asarray(tree_j["opt"].v["embed"]["tok"]),
                                  tree_p["opt"].v["embed"]["tok"].numpy())

    tree, manifest = store.restore(ref_ck, convert.jax_train_state_like(tr.model))
    assert pcore.ParallelPlan.from_json(manifest["plan"]) == plan(pcore)
    state = convert.load_jax_train_state(tr.model, tree)
    assert int(state["opt"].step) == 7


def _orch_cases(core):
    """tests/test_runtime_ft.py:62 and :77, in ``core``'s types."""
    desc = _tiny(jax_config if core is jcore else get_config).to_model_desc()
    out = []
    topo = _hetero(core)
    plan = core.plan_hybrid(topo, desc, global_batch=8, seq=32, with_baseline=False).plan
    orch = core.DynamicOrchestrator(model=desc, global_batch=8, seq=32)
    ev = core.NetworkEvent(1.0, "slowdown", device_id=0, factor=0.25)
    topo.apply_event(ev)
    out.append((plan, orch.adapt(plan, topo, ev), orch.history[-1]))
    topo = core.hetero_cluster({"V100": 8}, gpus_per_node=8)
    plan = core.plan_hybrid(topo, desc, global_batch=8, seq=32, with_baseline=False).plan
    orch = core.DynamicOrchestrator(model=desc, global_batch=8, seq=32,
                                    replan_threshold=1.10)
    ev = core.NetworkEvent(1.0, "bandwidth", factor=1.0, selector="ib")
    out.append((plan, orch.adapt(plan, topo, ev), orch.history[-1]))
    return [(old.to_json(), new.to_json(), rec.action, rec.old_step_time,
             rec.new_step_time) for old, new, rec in out]


def test_orchestrator_decisions_match_the_reference():
    got = _orch_cases(pcore)
    assert got == _orch_cases(jcore)
    (old, new, action, *_), (old2, new2, action2, *_) = got
    assert action == "straggler-reassign" and new != old
    assert action2 == "keep" and new2 == old2


def test_plan_train_checkpoint_resume(tmp_path):
    """tests/test_system.py:32: auto-plan on an analytic cluster, train, checkpoint
    (the plan in the manifest), a NEW trainer restores and continues the run."""
    desc = _tiny(get_config).to_model_desc()
    topo = pcore.hetero_cluster({"RTX4090D": 2, "V100": 2}, gpus_per_node=2)
    plan = pcore.plan_hybrid(topo, desc, global_batch=4, seq=32, with_baseline=False).plan
    want = jcore.plan_hybrid(jcore.hetero_cluster({"RTX4090D": 2, "V100": 2}, gpus_per_node=2),
                             _tiny(jax_config).to_model_desc(), global_batch=4, seq=32,
                             with_baseline=False).plan
    assert plan.to_json() == want.to_json()
    _, pcfg = _configs(tmp_path, 9, lr=1e-3)
    pcfg = dataclasses.replace(pcfg, ckpt_every=4)
    tr = ptrainer.Trainer(pcfg, plan=plan)
    _, hist = tr.run()
    step = store.latest_step(pcfg.ckpt_dir)
    assert step == 8
    tr2 = ptrainer.Trainer(dataclasses.replace(pcfg, steps=12, ckpt_dir=str(tmp_path / "b")),
                           plan=plan)
    tree, manifest = store.restore(Path(pcfg.ckpt_dir) / f"step_{step}",
                                   convert.jax_train_state_like(tr2.model))
    assert manifest["plan"] == plan.to_json()
    _, hist2 = tr2.run(convert.load_jax_train_state(tr2.model, tree), start_step=step + 1)
    assert [h["step"] for h in hist2] == [9, 10, 11]
    assert abs(hist2[0]["loss"] - hist[-1]["loss"]) < 0.6
    assert all(np.isfinite(h["loss"]) for h in hist2)


def test_planner_to_trainer_knobs_flow(tmp_path):
    """tests/test_system.py:61: the plan's world fits the cluster and the trainer
    runs with microbatches."""
    desc = _tiny(get_config).to_model_desc()
    res = pcore.plan_hybrid(pcore.hetero_cluster({"V100": 4}, gpus_per_node=4), desc,
                            global_batch=8, seq=32, with_baseline=False)
    want = jcore.plan_hybrid(jcore.hetero_cluster({"V100": 4}, gpus_per_node=4),
                             _tiny(jax_config).to_model_desc(), global_batch=8, seq=32,
                             with_baseline=False)
    assert res.plan.to_json() == want.plan.to_json()
    assert res.predicted.step_time == want.predicted.step_time
    assert res.plan.world <= 4 and res.plan.microbatches >= 1
    _, pcfg = _configs(tmp_path, 3, global_batch=8, microbatches=2)
    tr = ptrainer.Trainer(pcfg, plan=res.plan)
    _, hist = tr.run()
    assert np.isfinite(hist[-1]["loss"]) and tr.plan is res.plan


@pytest.mark.parametrize("case", ["unknown device", "trace without topo", "bad scenario"])
def test_bad_planner_arguments_raise_as_the_reference(tmp_path, case):
    jcfg, pcfg = _configs(tmp_path, 4)
    errors = []
    for core, scen, mod, cfg in ((jcore, jscen, jtrainer, jcfg),
                                 (pcore, pscen, ptrainer, pcfg)):
        kw = {"unknown device": dict(topo=core.hetero_cluster({"V100": 4}, gpus_per_node=4),
                                     events=[(1, core.NetworkEvent(0.0, "fail",
                                                                   device_id=9))]),
              "trace without topo": dict(scenario=scen.Trace.from_events(
                  "t", [core.NetworkEvent(1.0, "fail", device_id=1)], horizon=4.0)),
              "bad scenario": dict(scenario=3)}[case]
        with pytest.raises((ValueError, TypeError)) as exc:
            mod.Trainer(cfg, **kw)
        errors.append((type(exc.value), str(exc.value)))
    assert errors[0] == errors[1]


# ------------------------------------------------------------ the launcher


@pytest.mark.parametrize("plan", ["auto", "megatron"])
def test_launcher_trains_with_the_reference_plan(tmp_path, capsys, plan):
    """``launch.train.main`` reduced on the CPU: with ``--plan auto`` the plan is the
    reference's ``plan_hybrid`` on the launcher's cluster of four H100s."""
    tr = launch_train.main(["--reduced", "--plan", plan, "--steps", "3", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert [h["step"] for h in tr.history] == [0, 2]
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert tr.cfg.device == "cpu" and tr.cfg.arch == get_config("xlstm_125m").reduced()
    assert "[train] loss" in out
    if plan == "megatron":
        assert tr.plan is None and "[plan]" not in out
        return
    res = jcore.plan_hybrid(jcore.hetero_cluster({"H100": 4}, gpus_per_node=4),
                            jax_config("xlstm_125m").reduced().to_model_desc(),
                            global_batch=8, seq=256, with_baseline=False)
    assert tr.plan.to_json() == res.plan.to_json()
    assert (f"[plan] {res.plan.describe()} "
            f"(predicted step {res.predicted.step_time*1e3:.1f} ms)") in out.splitlines()


def test_dynamic_network_example_runs_on_the_cpu():
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "dynamic_network_torch.py"),
                          "--device", "cpu"], capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "3 re-plans" in out.stdout
    assert out.stdout.count("predicted step") == 3
    assert "calibrated store bandwidth" in out.stdout
