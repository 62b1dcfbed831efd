"""The port's planner stack (``repro_torch.core``, ``obs``, ``scenarios``,
``service``) against the JAX package's: each module is the reference's file with its
module paths renamed and its history tags dropped, nothing else; plans and predicted
step times are equal (``==``) on the
search tests' six clusters, the re-planning engine takes the same path to the same
plan at every S1/S2/S3 event, ``to_model_desc`` gives the same description for
every architecture, the scenario catalog the same traces and JSONL bytes, and the
four packages load neither torch nor JAX."""

import ast
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.scenarios as jscen  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
import repro_torch.core as pcore  # noqa: E402
import repro_torch.scenarios as pscen  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import planner as pplanner  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

CORE = ("__init__", "cluster", "routing", "fabric", "opgraph", "costmodel", "plans",
        "simulator", "planner", "search", "mip", "reconfig", "engine", "islands",
        "dynamic")
COPIED = ([f"obs/{m}.py" for m in ("__init__", "tracer", "metrics", "export")]
          + [f"core/{m}.py" for m in CORE]
          + [f"scenarios/{m}.py" for m in ("trace", "generators", "catalog",
                                           "tenancy", "harness", "__init__")]
          + [f"service/{m}.py" for m in ("jobs", "admission", "cache", "service",
                                         "__init__")])


@pytest.fixture(autouse=True)
def _same_search_space(monkeypatch):
    """tests/conftest.py shrinks the reference's default candidate list for the
    test session; the port's gets the same size, so both search the same space."""
    monkeypatch.setattr(pplanner, "DEFAULT_MAX_CANDIDATES",
                        jplanner.DEFAULT_MAX_CANDIDATES)


# The reference's comments and docstrings tag some lines with the numbered change
# that introduced them ("(ISSUE n tentpole)", "(PR n-m)"); the copies drop those tags.
HISTORY_TAGS = ((r" \(ISSUE \d+(?: tentpole)?\)", ""),
                (r", ISSUE \d+\)", ")"),
                (r" \(ISSUE \d+ satellite\)", ""),
                (r" \(ISSUE \d+ satellite —\n# ", "\n# ("),
                (r"ISSUE \d+ acceptance pins", "Its acceptance tests pin"),
                (r" \(PR \d+(?:-\d+)?\)", ""),
                (r"PR \d+'s ", ""),
                (r" PR-\d+\n", "\n"),
                (r"ISSUE \d+ tentpole; ", ""),
                (r"PR \d+ ships ", "The engine ships "))


def _ported(text: str) -> str:
    """The reference's source with every ``repro.`` module path spelled
    ``repro_torch.`` and its history tags dropped: the port's copy."""
    text = re.sub(r"\brepro\.", "repro_torch.", text)
    for pattern, repl in HISTORY_TAGS:
        text = re.sub(pattern, repl, text)
    return text


# ------------------------------------------------------------ (a) copies


@pytest.mark.parametrize("rel", COPIED)
def test_module_is_the_reference_renamed(rel):
    port = (PORT / rel).read_bytes().decode()
    assert port == _ported((REF / rel).read_text())
    assert not re.search(r"\b(ISSUE|PR) \d", port)


def test_every_planner_module_is_copied():
    for sub in ("core", "obs", "scenarios", "service"):
        assert sorted(p.name for p in (REF / sub).glob("*.py")) == \
            sorted(p.name for p in (PORT / sub).glob("*.py"))
    assert sorted(str(p.relative_to(PORT)) for sub in ("core", "obs", "scenarios",
                                                        "service")
                  for p in (PORT / sub).glob("*.py")) == sorted(COPIED)


def test_scenarios_export_the_three_modules_names():
    """The port's scenarios ``__init__`` exports what the reference's does: the
    names of trace, generators and catalog, and those of harness and tenancy."""
    tree = ast.parse((REF / "scenarios" / "__init__.py").read_text())
    mods = {"trace", "generators", "catalog", "harness", "tenancy"}
    want = set(mods)
    want |= {a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             and node.module in mods for a in node.names}
    assert set(pscen.__all__) == want == set(jscen.__all__)
    assert all(getattr(pscen, n) is not None for n in want)
    assert set(pcore.__all__) == set(jcore.__all__)


# ------------------------------------------------------------ (b) plans

DESC_FIELDS = dict(name="m", n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
                   d_ff=4096, vocab=32000)


def _line_cluster(core, n=4, spec="V100", bw=50e9):
    devs = [core.DeviceInstance(i, core.DEVICE_PROFILES[spec]) for i in range(n)]
    topo = core.ClusterTopology(devs)
    for i in range(n - 1):
        topo.add_link(i, i + 1, core.Edge(bw, 1e-6, "link"))
    return topo


CLUSTERS = {   # tests/test_search.py's six
    "hetero": lambda c: c.hetero_cluster({"RTX4090D": 4, "V100": 4}, gpus_per_node=4),
    "homo": lambda c: c.homogeneous_cluster(8, "V100", gpus_per_node=8),
    "slowlink": lambda c: c.hetero_cluster({"V100": 8}, inter_bw=5e9, gpus_per_node=4),
    "torus": lambda c: c.multi_pod_tpu(pods=2, chips_per_pod=16),
    "line": _line_cluster,
    "unique-fast-pair": lambda c: c.hetero_cluster({"H100": 2, "RTX4090D": 2},
                                                   gpus_per_node=2),
}
DESCS = {
    "DESC": (lambda: jcore.ModelDesc(**DESC_FIELDS), lambda: pcore.ModelDesc(**DESC_FIELDS)),
    "qwen2_7b": (lambda: jax_config("qwen2_7b").to_model_desc(),
                 lambda: get_config("qwen2_7b").to_model_desc()),
}


def _plan_or_error(core, topo, desc):
    try:
        res = core.plan_hybrid(topo, desc, global_batch=32, seq=1024)
    except RuntimeError as exc:
        return ("error", str(exc))
    return (res.plan.to_json(), res.predicted.step_time, res.predicted.breakdown,
            [(p.to_json(), s.step_time) for p, s in res.top_plans],
            *[(b.to_json(), s.step_time) if b else None for b, s in (
                (res.baseline, res.baseline_predicted),
                (res.tuned_baseline, res.tuned_baseline_predicted))])


@pytest.mark.parametrize("desc", sorted(DESCS))
@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_plan_hybrid_matches_the_reference(cluster, desc):
    make_j, make_p = DESCS[desc]
    want = _plan_or_error(jcore, CLUSTERS[cluster](jcore), make_j())
    got = _plan_or_error(pcore, CLUSTERS[cluster](pcore), make_p())
    assert got == want


# ------------------------------------------------------------ (c) re-planning


def _s1s2s3(core):
    return [core.NetworkEvent(6.0, "bandwidth", factor=0.3, selector="ib"),
            core.NetworkEvent(12.0, "slowdown", device_id=2, factor=0.4),
            core.NetworkEvent(18.0, "fail", device_id=7)]


def _engine_run(core, desc, horizon):
    topo = core.hetero_cluster({"RTX4090D": 4, "V100": 4}, gpus_per_node=4)
    engine = core.ReplanEngine(desc, global_batch=32, seq=512,
                               cache=core.StrategyCache(), switch_horizon_s=horizon)
    out = [engine.plan(topo)]
    for ev in _s1s2s3(core):
        topo.apply_event(ev)
        out.append(engine.replan(topo, ev))
    return [(r.path, r.cold, r.kept, r.plan.to_json(), r.predicted.step_time,
             r.switch_cost) for r in out]


@pytest.mark.parametrize("horizon", [None, 2.0, 30.0])
def test_replan_engine_matches_the_reference(horizon):
    got = _engine_run(pcore, pcore.ModelDesc(**DESC_FIELDS), horizon)
    want = _engine_run(jcore, jcore.ModelDesc(**DESC_FIELDS), horizon)
    assert got == want
    assert [p for p, *_ in got][0] == "cold-plan" and len(got) == 4


def _orchestrate(core, desc):
    topo = core.hetero_cluster({"RTX4090D": 4, "V100": 4}, gpus_per_node=4)
    engine = core.ReplanEngine(desc, global_batch=32, seq=512, cache=core.StrategyCache())
    engine.plan(topo)
    orch = core.DynamicOrchestrator(model=desc, global_batch=32, seq=512, engine=engine)
    plan = core.ParallelPlan(dp=2, tp=2, pp=2, microbatches=2)
    plans = []
    for ev in _s1s2s3(core):
        topo.apply_event(ev)
        plan = orch.adapt(plan, topo, ev)
        plans.append(plan.to_json())
    recs = [(r.time, r.event.kind, r.action, r.old_step_time, r.new_step_time,
             r.switch_cost) for r in orch.history]
    return plans, recs, [r.path for r in engine.history]


def test_orchestrator_matches_the_reference():
    got = _orchestrate(pcore, pcore.ModelDesc(**DESC_FIELDS))
    assert got == _orchestrate(jcore, jcore.ModelDesc(**DESC_FIELDS))
    assert len(got[1]) == 3


# ------------------------------------------------------------ (d) model descs


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_to_model_desc_matches_the_reference(arch, reduced):
    jcfg, pcfg = jax_config(arch), get_config(arch)
    if reduced:
        jcfg, pcfg = jcfg.reduced(), pcfg.reduced()
    want = dataclasses.asdict(jcfg.to_model_desc())
    got = dataclasses.asdict(pcfg.to_model_desc())
    assert got == want
    assert type(pcfg.to_model_desc()) is pcore.ModelDesc


# ------------------------------------------------------------ (e) traces


@pytest.mark.parametrize("name", jscen.list_scenarios())
def test_catalog_traces_match_the_reference(name, tmp_path):
    assert pscen.list_scenarios() == jscen.list_scenarios()
    want, got = jscen.build_trace(name, seed=0), pscen.build_trace(name, seed=0)
    assert got.dumps() == want.dumps()
    assert [dataclasses.asdict(e) for e in got.to_events()] == \
        [dataclasses.asdict(e) for e in want.to_events()]
    assert [(s, dataclasses.asdict(e)) for s, e in got.to_step_events(24)] == \
        [(s, dataclasses.asdict(e)) for s, e in want.to_step_events(24)]
    a = want.record(tmp_path / "ref.jsonl")
    b = got.record(tmp_path / "port.jsonl")
    assert b.read_bytes() == a.read_bytes()
    assert pscen.Trace.load(a).dumps() == want.dumps()      # each loads the other's
    assert jscen.Trace.load(b).dumps() == got.dumps()


# ------------------------------------------------------------ (f) no torch, no JAX


def test_planner_packages_load_neither_torch_nor_jax():
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
            "import repro_torch.core, repro_torch.obs, repro_torch.scenarios, "
            "repro_torch.scenarios.harness, repro_torch.scenarios.tenancy, "
            "repro_torch.service; "
            "print(sorted(m for m in ('torch', 'jax', 'jaxlib', 'repro') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
