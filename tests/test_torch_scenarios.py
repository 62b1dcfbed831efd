"""The port's scenario harness and tenancy (``repro_torch.scenarios``) against the
reference's: the same scenario and seed replay to the same static, adapted and
oracle timelines, re-plan counts and actions; a loaded trace replays as its
catalog entry does; the process-parallel sweep equals the sequential one; and
the tenant arrival streams are equal."""

import math
import random

import pytest

pytest.importorskip("torch")

import repro.scenarios as jscen  # noqa: E402
from repro.core import ModelDesc as JModelDesc  # noqa: E402
from repro.core import NetworkEvent as JNetworkEvent  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
import repro_torch.scenarios as pscen  # noqa: E402
from repro_torch.core import ModelDesc, NetworkEvent  # noqa: E402
from repro_torch.core import planner as pplanner  # noqa: E402

DESC = dict(name="tiny", n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
            d_ff=2048, vocab=32000)


@pytest.fixture(autouse=True)
def _same_search_space(monkeypatch):
    """tests/conftest.py shrinks the reference's default candidate list; the
    port's gets the same size."""
    monkeypatch.setattr(pplanner, "DEFAULT_MAX_CANDIDATES",
                        jplanner.DEFAULT_MAX_CANDIDATES)


def _harnesses():
    kw = dict(global_batch=32, seq=512, max_candidates=24)
    return (pscen.ScenarioHarness(ModelDesc(**DESC), **kw),
            jscen.ScenarioHarness(JModelDesc(**DESC), **kw))


def _same_report(a, b):
    assert a.scenario == b.scenario and a.seed == b.seed
    assert (a.n_events, a.adaptations, a.replans) == (b.n_events, b.adaptations,
                                                      b.replans)
    for pol in ("static", "adapted", "oracle"):
        assert getattr(a, pol).timeline == getattr(b, pol).timeline, pol
    assert a.switch_cost_s == b.switch_cost_s
    assert [repr(x) for x in a.actions] == [repr(x) for x in b.actions]


@pytest.mark.parametrize("name,seed", [("straggler_churn", 1),
                                       ("fig6c_dynamic_bw", 0),
                                       ("congested_flaky", 0)])
def test_harness_replay_equals_reference(name, seed):
    port, ref = _harnesses()
    got, want = port.run(name, seed=seed), ref.run(name, seed=seed)
    _same_report(got, want)
    assert got.n_events > 0 and got.adaptations == got.n_events
    assert math.isfinite(got.adapted.avg_step)
    # the policies' mean step charges the measured re-plan walls, so the
    # ratios are held to the reference's bound, not to its value
    assert got.adapted_over_oracle >= 0.95


def test_harness_trace_load_replay_matches_catalog_replay(tmp_path):
    """A trace the reference recorded, loaded by the port, replays as the
    port's catalog entry does."""
    port, _ = _harnesses()
    path = jscen.build_trace("straggler_churn", seed=2).record(tmp_path / "s.jsonl")
    topo, _ = pscen.build("straggler_churn", seed=2)
    via_trace = port.run(pscen.Trace.load(path), topo=topo)
    via_name = port.run("straggler_churn", seed=2)
    assert via_trace.adapted.timeline == via_name.adapted.timeline
    assert via_trace.replans == via_name.replans


def test_harness_parallel_matches_sequential_and_reference():
    port, ref = _harnesses()
    items = [("congested_flaky", 0), ("fig6c_dynamic_bw", 0)]
    seq = port.run_many(items, parallel=False)
    par = port.run_many(items, parallel=True)
    want = ref.run_many(items, parallel=False)
    assert [r.scenario for r in par] == [r.scenario for r in seq]
    for a, b, c in zip(seq, par, want):
        _same_report(a, b)
        _same_report(a, c)


def test_harness_delivers_event_at_horizon():
    topo, _ = pscen.build("straggler_churn", seed=0)
    tr = pscen.Trace.from_events(
        "edge", [NetworkEvent(50.0, "slowdown", device_id=1, factor=0.5),
                 NetworkEvent(100.0, "fail", device_id=0)])
    rep = _harnesses()[0].run(tr, topo=topo)
    assert rep.adaptations == 2
    assert len(rep.adapted.timeline) == 3


def test_harness_explicit_trace_requires_topo():
    with pytest.raises(ValueError, match="explicit topology"):
        _harnesses()[0].run(pscen.build_trace("straggler_churn", seed=0))


def test_summaries_equal_reference():
    """The seed sweep's summary: the same re-plan and switch-cost means (its
    ratios divide mean steps that charge measured walls)."""
    port, ref = _harnesses()
    items = [("congested_flaky", 0), ("congested_flaky", 1)]
    (got,) = pscen.summarize_reports(port.run_many(items, parallel=False))
    (want,) = jscen.summarize_reports(ref.run_many(items, parallel=False))
    assert (got.scenario, got.n, got.seeds, got.replans_mean, got.switch_cost_s_mean) \
        == (want.scenario, want.n, want.seeds, want.replans_mean,
            want.switch_cost_s_mean)


def test_job_arrivals_equal_reference():
    kw = dict(rate=96 / 600.0, twin_prob=0.65, max_jobs=32)
    got = pscen.job_arrivals(random.Random(7), 600.0, **kw)
    want = jscen.job_arrivals(random.Random(7), 600.0, **kw)
    assert len(got) == len(want) == 32
    assert repr(got).replace("repro_torch.", "repro.") == repr(want)


@pytest.mark.parametrize("name", pscen.list_tenant_scenarios())
def test_tenant_scenarios_equal_reference(name):
    ptopo, parr, ptrace = pscen.build_tenant(name, seed=0)
    jtopo, jarr, jtrace = jscen.build_tenant(name, seed=0)
    assert sorted(ptopo.alive_ids()) == sorted(jtopo.alive_ids())
    assert repr(parr) == repr(jarr)
    assert ptrace.dumps() == jtrace.dumps()
    got = pscen.to_job_specs(parr, gpus_per_node=4)
    want = jscen.to_job_specs(jarr, gpus_per_node=4)
    assert [s.signature() for s in got] == [s.signature() for s in want]


def test_events_are_the_references_type_renamed():
    assert NetworkEvent.__name__ == JNetworkEvent.__name__
    assert NetworkEvent.__module__.replace("repro_torch.", "repro.") == \
        JNetworkEvent.__module__
