"""The training loop's spans (``repro_torch.runtime.spans``) on the CPU: each step's
span tree, nothing recorded and nothing changed with tracing off, ``Trainer.obs``
switched between runs, the phases as ranges of a running ``torch.profiler``, the
card's intervals placed on the host clock (fake CUDA events), and an event's
checkpoint, re-plan and restore under one ``train.event`` span."""

import json
import time

import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as pcore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import planner as pplanner  # noqa: E402
from repro_torch.obs import NULL_HANDLE, NULL_OBS, Obs, chrome_trace  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime import spans  # noqa: E402
from repro_torch.runtime.spans import phase  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

B, S = 4, 32
PHASES = ["train.data", "train.forward", "train.backward", "train.optimizer"]


def _tcfg(tmp_path, steps=3, **over):
    kw = dict(arch=get_config("qwen2_7b").reduced(n_layers=2, d_model=64, vocab=128,
                                                  d_ff=128),
              steps=steps, global_batch=B, seq_len=S, ckpt_dir=str(tmp_path),
              ckpt_every=0, log_every=1, device="cpu",
              opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20))
    return TrainerConfig(**{**kw, **over})


def _children(obs, parent):
    return sorted((s for s in obs.tracer.spans if s.parent_id == parent.span_id),
                  key=lambda s: s.t0)


def test_each_step_is_one_tree_of_its_phases(tmp_path):
    obs = Obs()
    tr = Trainer(_tcfg(tmp_path, steps=3, log_every=2), obs=obs)
    tr.run()
    steps = [s for s in obs.tracer.spans if s.name == "train.step"]
    assert [s.attrs for s in steps] == [{"step": n, "tokens": B * S} for n in range(3)]
    assert all(s.parent_id is None for s in steps)
    for s in steps:
        kids = _children(obs, s)
        logged = s.attrs["step"] in (0, 2)            # log_every 2, and the last step
        assert [k.name for k in kids] == PHASES + ["train.wait"] * logged
        assert all(k.attrs["step"] == s.attrs["step"] for k in kids)
        assert all(s.t0 <= k.t0 <= k.t1 <= s.t1 for k in kids)
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
        assert kids[0].attrs["bytes"] == 2 * B * S * 4               # tokens, labels
        assert kids[1].attrs["mb"] == kids[2].attrs["mb"] == 0
        assert not _children(obs, kids[1])              # no card row on the CPU
    assert len(obs.tracer.spans) == 3 * 5 + 2


def test_microbatches_each_record_their_forward_and_backward(tmp_path):
    obs = Obs()
    Trainer(_tcfg(tmp_path, steps=1, microbatches=2), obs=obs).run()
    (step,) = [s for s in obs.tracer.spans if s.name == "train.step"]
    kids = _children(obs, step)
    assert [(k.name, k.attrs.get("mb")) for k in kids] == [
        ("train.data", None), ("train.forward", 0), ("train.backward", 0),
        ("train.forward", 1), ("train.backward", 1), ("train.optimizer", None),
        ("train.wait", None)]


def test_tracing_changes_no_number_and_obs_switches_between_runs(tmp_path):
    assert phase(NULL_OBS, "train.step", step=0) is NULL_HANDLE
    plain = Trainer(_tcfg(tmp_path / "a", steps=6))
    assert plain.obs is NULL_OBS
    ref_state, ref_hist = plain.run()

    tr = Trainer(_tcfg(tmp_path / "b", steps=2))
    state, _ = tr.run()
    obs = tr.obs = Obs()
    tr.cfg.steps = 4
    state, _ = tr.run(state, start_step=2)
    tr.obs = NULL_OBS
    tr.cfg.steps = 6
    state, hist = tr.run(state, start_step=4)
    assert sorted({s.attrs["step"] for s in obs.tracer.spans}) == [2, 3]
    assert [h["loss"] for h in hist] == [h["loss"] for h in ref_hist]
    for name, p in ref_state["params"].items():
        assert torch.equal(p, state["params"][name]), name
    for name, m in ref_state["opt"].m.items():
        assert torch.equal(m, state["opt"].m[name]), name


def test_the_phases_are_ranges_of_a_running_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tr = Trainer(_tcfg(tmp_path, steps=1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert set(PHASES) | {"train.step", "train.wait"} <= names


class _FakeEvent:
    """A CUDA event on a card whose clock runs 1000 s apart from the host's."""

    syncs = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter() + 1000.0

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3

    def synchronize(self):
        _FakeEvent.syncs += 1


@pytest.fixture
def clock(monkeypatch):
    monkeypatch.setattr(spans, "_event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda index=None: None)
    _FakeEvent.syncs = 0
    return spans.CardClock(torch.device("cuda", 0))


def _step(obs, clock, n):
    with phase(obs, "train.step", clock, step=n):
        with phase(obs, "train.forward", clock, step=n, mb=0) as sp:
            time.sleep(0.002)
            sp.set(bytes=7)


def test_card_intervals_are_placed_on_the_host_clock(clock):
    assert phase(NULL_OBS, "train.forward", clock) is NULL_HANDLE
    obs = Obs()
    _step(obs, clock, 0)
    clock.synced()                 # the first anchor: nothing placed yet
    assert len(obs.tracer.spans) == 2 and len(clock._pending) == 2
    _step(obs, clock, 1)
    clock.synced()                 # placed by the last call's anchor
    clock.flush()                  # nothing waits: no synchronisation
    assert _FakeEvent.syncs == 0 and not clock._pending
    card = [s for s in obs.tracer.spans if s.attrs.get("lane") == "cuda:0"]
    assert len(card) == 4
    host = {s.span_id: s for s in obs.tracer.spans if "lane" not in s.attrs}
    for c in card:
        h = host[c.parent_id]
        assert c.name == h.name and c.attrs == {**h.attrs, "lane": "cuda:0"}
        assert h.t0 - 1e-3 <= c.t0 < c.t1 <= h.t1 + 1e-3
        assert c.t1 - c.t0 >= 0.002
    assert {c.attrs.get("bytes") for c in card if c.name == "train.forward"} == {7}
    rows = [e for e in chrome_trace(obs)["traceEvents"] if e["ph"] == "M"]
    assert [r["args"]["name"] for r in rows] == ["cuda:0"]

    _step(obs, clock, 2)           # a run that ends with no synchronisation after it
    clock.flush()
    assert _FakeEvent.syncs == 1 and not clock._pending
    assert len([s for s in obs.tracer.spans if s.attrs.get("lane")]) == 6
    clock.synced()                 # nothing waits: the anchor goes
    assert clock._anchor is None


def test_an_event_is_one_span_of_checkpoint_replan_and_restore(tmp_path, monkeypatch):
    monkeypatch.setattr(pplanner, "DEFAULT_MAX_CANDIDATES", 96)
    topo = pcore.hetero_cluster({"RTX4090D": 4, "V100": 4}, gpus_per_node=4)
    obs = Obs()
    tr = Trainer(_tcfg(tmp_path, steps=3), topo=topo,
                 events=[(2, pcore.NetworkEvent(0.0, "fail", device_id=7))],
                 plan=pcore.ParallelPlan(dp=2, tp=2, pp=2, microbatches=2), obs=obs)
    tr.run()
    (event,) = [s for s in obs.tracer.spans if s.name == "train.event"]
    assert event.parent_id is None and event.attrs == {"step": 2, "kind": "fail"}
    kids = [k.name for k in _children(obs, event)]
    assert kids[0] == "train.checkpoint" and kids[-1] == "train.restore"
    # the engine's replan span, and the planner's spans of the call it covers
    assert any(k.startswith("replan.") for k in kids)
    assert all(k.split(".")[0] in ("replan", "plan") for k in kids[1:-1])
    restore = _children(obs, event)[-1]
    assert restore.attrs == {"step": 2, **{k: tr.restores[0][k] for k in ("bytes", "seconds")}}
    assert obs.metrics.snapshot()[f"replan.action.{tr.adaptations[0].action}"] == 1
