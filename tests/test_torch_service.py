"""The port's planner service (``repro_torch.service``) against the reference's:
name-free signatures, the admission queue's order and back-pressure, the shared
cache's exact invalidation and single flight, and replays whose plan digests,
admissions, cold searches, hits, re-plans and invalidations equal the
reference's, serially and threaded."""

import threading

import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.scenarios as jscen  # noqa: E402
import repro.service as jsvc  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
import repro_torch.core as pcore  # noqa: E402
import repro_torch.scenarios as pscen  # noqa: E402
import repro_torch.service as psvc  # noqa: E402
from repro_torch.core import planner as pplanner  # noqa: E402

DESC = dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
            vocab=32000)
PKGS = {"port": (pcore, pscen, psvc), "ref": (jcore, jscen, jsvc)}


@pytest.fixture(autouse=True)
def _same_search_space(monkeypatch):
    monkeypatch.setattr(pplanner, "DEFAULT_MAX_CANDIDATES",
                        jplanner.DEFAULT_MAX_CANDIDATES)


def _spec(svc, core, name, *, n_devices=4, priority=0, model="tiny",
          global_batch=32, arrival_s=0.0, duration_s=0.0):
    return svc.JobSpec(name=name, model=core.ModelDesc(model, **DESC),
                       global_batch=global_batch, seq=512, n_devices=n_devices,
                       priority=priority, arrival_s=arrival_s,
                       duration_s=duration_s, gpus_per_node=4)


def test_model_signature_is_name_free():
    core, _, svc = PKGS["port"]
    a, b = core.ModelDesc("tiny", **DESC), core.ModelDesc("other-name", **DESC)
    assert svc.model_signature(a) == svc.model_signature(b)
    assert svc.model_signature(a) == jsvc.model_signature(jcore.ModelDesc("x", **DESC))
    assert _spec(svc, core, "a").signature() != \
        _spec(svc, core, "b", global_batch=64).signature()


@pytest.mark.parametrize("side", PKGS)
def test_admission_order_equals_reference(side):
    core, _, svc = PKGS[side]
    q = svc.AdmissionQueue(capacity=4)
    specs = [_spec(svc, core, "lo-0"), _spec(svc, core, "hi", priority=2),
             _spec(svc, core, "t1", model="renamed"),
             _spec(svc, core, "other", global_batch=64),
             _spec(svc, core, "overflow")]
    offered = [q.offer(s) for s in specs]
    assert offered == [True, True, True, True, False] and q.rejected == 1
    assert q.pop().name == "hi"
    head, twins = q.pop_bucket()
    assert head.name == "lo-0" and [t.name for t in twins] == ["t1"]
    assert q.pop().name == "other" and len(q) == 0


def _fake_entry(cache, key, ids, tags):
    status, _ = cache.acquire(key, ids)
    assert status == "cold"
    cache.complete(key, plan=("plan", key), sim=("sim", key), device_ids=ids,
                   tags=tags)


@pytest.mark.parametrize("side", PKGS)
def test_cache_invalidation(side):
    core, _, svc = PKGS[side]
    cache = svc.SharedStrategyCache(max_entries=16)
    _fake_entry(cache, ("a",), (0, 1, 2, 3), {"nvlink", "ib"})
    _fake_entry(cache, ("b",), (4, 5, 6, 7), {"nvlink"})
    _fake_entry(cache, ("c",), (8, 9), {"pcie"})
    assert cache.invalidate(core.NetworkEvent(1.0, "fail", device_id=1)) == [("a",)]
    ev = core.NetworkEvent(2.0, "bandwidth", selector="pcie", factor=0.5)
    assert cache.invalidate(ev) == [("c",)]
    assert len(cache) == 1 and cache.version == 2
    assert cache.invalidate(core.NetworkEvent(3.0, "bandwidth", factor=0.5)) \
        == [("b",)]


def test_acquire_single_flight_under_concurrency():
    cache = psvc.SharedStrategyCache(max_entries=16)
    statuses, lock = [], threading.Lock()

    def worker():
        status, _ = cache.acquire(("k",), (0, 1, 2, 3))
        if status == "cold":
            cache.complete(("k",), plan="P", sim="S", device_ids=(0, 1, 2, 3),
                           tags=("nvlink",))
        with lock:
            statuses.append(status)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert statuses.count("cold") == 1 and statuses.count("hit") == 7
    assert cache.counters()["misses"] == 1


def _replay(side, workers):
    core, scen, svc = PKGS[side]
    topo, arrivals, trace = scen.build_tenant("multi_tenant_small", seed=0)
    service = svc.PlannerService(topo, workers=workers, max_candidates=48)
    return service.replay(scen.to_job_specs(arrivals, gpus_per_node=4),
                          list(trace.to_events()))


def _counts(rep):
    return (rep.admitted, rep.cold_searches, rep.cache_hits, rep.replans,
            rep.invalidated)


def test_replay_serial_equals_threaded_equals_reference():
    serial, threaded = _replay("port", 1), _replay("port", 4)
    want = _replay("ref", 1)
    assert serial.plan_digests == threaded.plan_digests == want.plan_digests
    assert _counts(serial) == _counts(threaded) == _counts(want)
    assert serial.replans > 0


def test_twins_and_head_of_line_equal_reference():
    out = {}
    for side, (core, _, svc) in PKGS.items():
        service = svc.PlannerService(core.homogeneous_cluster(8, "V100",
                                                              gpus_per_node=4),
                                     max_candidates=48)
        specs = [_spec(svc, core, "first", duration_s=5.0),
                 _spec(svc, core, "twin", model="renamed", duration_s=0.5),
                 _spec(svc, core, "big", n_devices=8, priority=2, arrival_s=1.0,
                       duration_s=2.0),
                 _spec(svc, core, "small", arrival_s=1.0)]
        rep = service.replay(specs)
        jobs = service.jobs
        out[side] = (rep.plan_digests, _counts(rep),
                     {n: (j.admitted_s, j.device_ids, repr(j.plan))
                      for n, j in jobs.items()})
        assert rep.cold_searches == 2 and rep.cache_hits >= 1
        assert jobs["big"].admitted_s == 5.0 and jobs["small"].admitted_s == 7.0
        moved = service.handle_event(core.NetworkEvent(8.0, "slowdown", device_id=5,
                                                       factor=0.5))
        out[side] += ([name for name, _ in moved],)
    assert out["port"] == out["ref"]
