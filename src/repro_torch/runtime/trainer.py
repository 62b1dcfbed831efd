"""Fault-tolerant training runtime (the reference's ``runtime/trainer.py``).

Drives the train step over the synthetic pipeline with:

  * periodic asynchronous checkpoints (``checkpoint.store``, the reference's
    on-disk format, the plan's JSON in the manifest),
  * the *event loop* of the paper's dynamic scenarios: injected
    :class:`NetworkEvent`\\ s (S1 bandwidth / S2 slowdown / S3 failure) are
    applied to the analytic :class:`ClusterTopology`, the
    :class:`DynamicOrchestrator` re-plans through the :class:`ReplanEngine`, and
    the trainer rebuilds its step and shardings and restores the state it
    checkpointed at the event onto them (an elastic reshard), then folds the
    measured restore into the engine's reconfiguration cost model
    (``calibrate_io``),
  * the same ``history`` records and ``adaptations`` / ``engine`` views,
  * spans of each step in the ``obs`` it is given (``runtime.spans``): ``train.step``
    holding ``train.data``, the step's ``train.forward`` / ``train.backward`` /
    ``train.optimizer`` (with the card's intervals on the host clock, on CUDA) and,
    on a logged step, ``train.wait``; ``train.checkpoint``; and per event
    ``train.event`` holding its checkpoint, the engine's ``replan.*`` spans and
    ``train.restore``.  ``obs`` may be assigned between two ``run`` calls.

With ``mesh`` (a ``DeviceMesh`` with axes ``("data", "model")`` or ``("pod",
"data", "model")``, ``launch.mesh``) the train state lives as DTensors under the
reference's axis rules: ``parallel.sharding.profile_for`` resolves them (ZeRO-3
shards the parameters' "fsdp" dims over "data" when ``zero3``; otherwise ZeRO-1
shards only the moments), the parameters, moments and batches are placed on
them, and the step runs under them.  Every rank runs the same program on the
same synthetic batches; rank 0 writes the checkpoints.  Without a mesh the
step runs on plain tensors of one device, which ``zero3`` does not change.
"""

from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import AsyncSaver, _items, restore
from repro_torch.core import (ClusterTopology, DynamicOrchestrator,
                              NetworkEvent, ParallelPlan, ReplanEngine,
                              StrategyCache)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import (export_jax_train_state,
                                        jax_train_state_like,
                                        load_jax_train_state)
from repro_torch.models.lm import LM
from repro_torch.obs import Obs, resolve_obs
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.axes import distribute, full
from repro_torch.parallel.trainstep import init_train_state, make_train_step
from repro_torch.runtime.spans import CardClock, phase

Pytree = Any


@dataclass
class TrainerConfig:
    arch: ArchConfig
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_dir: str = str(Path(tempfile.gettempdir()) / "repro_ckpt")
    ckpt_every: int = 20
    log_every: int = 10
    remat: str = "none"
    microbatches: int = 1
    zero3: bool = False
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    seed: int = 0
    device: str = "cuda"


class Trainer:
    def __init__(self, cfg: TrainerConfig, *,
                 mesh=None,
                 plan: ParallelPlan | None = None,
                 topo: ClusterTopology | None = None,
                 events: Sequence[tuple[int, NetworkEvent]] = (),
                 scenario: "str | object | None" = None,
                 obs: Obs | None = None):
        self.cfg = cfg
        self._obs = resolve_obs(obs)
        self.device = torch.device(cfg.device)
        self.model = LM(cfg.arch, device=self.device)
        self._clock = CardClock(self.device) if self.device.type == "cuda" else None
        self.plan = plan
        self.topo = topo
        self.trace = None
        events = list(events)
        if scenario is not None:
            # a catalog name or a repro_torch.scenarios.Trace: event times map
            # onto training steps via Trace.to_step_events, and a catalog
            # name also supplies the topology when none was given
            from repro_torch.scenarios import Trace, build_trace, get_scenario
            if isinstance(scenario, str):
                self.trace = build_trace(scenario, seed=cfg.seed)
                if topo is None:
                    topo = self.topo = get_scenario(scenario).make_topology()
            elif isinstance(scenario, Trace):
                if topo is None:
                    raise ValueError(
                        "an explicit Trace needs an explicit topo=")
                self.trace = scenario
            else:
                raise TypeError(f"scenario must be a catalog name or Trace, "
                                f"got {type(scenario).__name__}")
            events += self.trace.to_step_events(cfg.steps)
        if topo is not None:
            # fail fast on a trace/topology mismatch instead of KeyError-ing
            # mid-run (e.g. a 16-device catalog trace on an 8-device topo)
            missing = sorted({ev.device_id for _, ev in events
                              if ev.device_id is not None}
                             - set(topo.devices))
            if missing:
                raise ValueError(
                    f"events reference device ids {missing} not present "
                    f"in the topology ({sorted(topo.devices)})")
        self.events = sorted(events, key=lambda e: e[0])
        self.saver = AsyncSaver()
        self.history: list[dict] = []
        self.replans = 0
        # one record per elastic restore: the event's step, the seconds the
        # restore took and the bytes of the restored tree (what calibrate_io
        # is given)
        self.restores: list[dict] = []
        self._start_step = 0
        self._hist_mark = 0
        self._orch = None
        self._engine = None
        if topo is not None:
            desc = cfg.arch.to_model_desc()
            self._engine = ReplanEngine(
                desc, global_batch=cfg.global_batch, seq=cfg.seq_len,
                cache=StrategyCache(obs=self._obs), obs=self._obs)
            try:
                # cold plan up front: warms the strategy cache + candidate
                # portfolio so every later event takes a warm path
                self._engine.plan(topo)
            except RuntimeError:
                pass
            self._orch = DynamicOrchestrator(
                model=desc, global_batch=cfg.global_batch, seq=cfg.seq_len,
                engine=self._engine, obs=self._obs)
        self._build(mesh)

    @property
    def obs(self) -> Obs:
        """The telemetry bundle the run records into, and the re-planning parts
        with it."""
        return self._obs

    @obs.setter
    def obs(self, obs: Obs) -> None:
        self._obs = obs
        if self._engine is not None:
            self._engine.obs = self._engine.cache.obs = self._orch.obs = obs

    # -- public adaptation telemetry ------------------------------------------

    @property
    def adaptations(self) -> list:
        """Adaptation records (one per handled event) — the public view of
        the orchestrator history; empty when no topology was attached."""
        return list(self._orch.history) if self._orch is not None else []

    @property
    def engine(self):
        """The incremental ReplanEngine (None when no topology attached)."""
        return self._engine

    # -- (re)build against the current mesh/plan -----------------------------

    def _build(self, mesh) -> None:
        self.mesh = mesh
        self.prof = self.state_sh = None
        if mesh is not None:
            self.prof = shd.profile_for(self.cfg.arch, mesh, zero3=self.cfg.zero3)
            self.state_sh = {
                "params": shd.param_shardings(self.model, mesh, self.prof.rules),
                "opt": shd.opt_state_shardings(self.model, mesh, self.prof.opt_rules),
            }
        self._step = make_train_step(self.model, self.cfg.opt,
                                     microbatches=self.cfg.microbatches,
                                     remat=self.cfg.remat, mesh=mesh,
                                     rules=self.prof.rules if self.prof else None)
        a = self.cfg.arch
        self.data = SyntheticLM(DataConfig(
            vocab=a.vocab, seq_len=self.cfg.seq_len,
            global_batch=self.cfg.global_batch, seed=self.cfg.seed,
            audio_seq=a.audio_seq if a.encoder_layers else 0,
            vision_seq=a.vision_seq if a.cross_attn_every else 0,
            d_model=a.d_model))

    def init_state(self) -> Pytree:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        if self.mesh is None:
            return init_train_state(self.model, gen)
        # every rank draws the same full parameters, then keeps its shards
        self.model.init(gen)
        shd.distribute_params(self.model,
                              shd.module_shardings(self.model, self.state_sh["params"]))
        params = dict(self.model.named_parameters())
        opt_sh = shd.module_shardings(self.model, self.state_sh["opt"].m)
        return {"params": params, "opt": init_opt_state(params, opt_sh)}

    def _place(self, batch: dict) -> dict:
        out = {k: torch.from_numpy(v).to(self.device, non_blocking=True)
               for k, v in batch.items()}
        if self.mesh is None:
            return out
        sh = shd.batch_shardings(self.mesh, out, self.prof.rules)
        return distribute(out, sh)

    def _plan_json(self) -> str:
        return self.plan.to_json() if self.plan else ""

    def _save(self, path: Path, state: Pytree, step: int) -> None:
        """Queue a checkpoint of ``state``: on a mesh every rank gathers the
        shards (a collective) and rank 0 writes."""
        tree = export_jax_train_state(self.model, full(state))
        if self.mesh is None or dist.get_rank() == 0:
            self.saver.submit(path, tree, step=step, plan_json=self._plan_json())

    # -- event handling (paper §2.2: S1/S2/S3) --------------------------------

    def _handle_event(self, step: int, ev: NetworkEvent,
                      state: Pytree) -> Pytree:
        with phase(self.obs, "train.event", step=step, kind=ev.kind):
            assert self.topo is not None and self._orch is not None
            ck = Path(self.cfg.ckpt_dir) / f"step_{step}"
            with phase(self.obs, "train.checkpoint", step=step):
                self.saver.wait()
                self._save(ck, state, step)
                self.saver.wait()
                if self.mesh is not None:
                    dist.barrier()   # rank 0's checkpoint is on disk for all
            self.topo.apply_event(ev)
            if self._engine is not None and len(self.history) > self._hist_mark:
                # remaining-horizon budget for the engine's switch-cost
                # hysteresis: steps left x the measured mean step wall time.
                # Only entries logged by *this* run() invocation qualify: their
                # wall is measured from this run's t0 and covers the steps since
                # start_step (a previous run's entries would mix timebases)
                m = self.history[-1]
                done = max(m["step"] - self._start_step + 1, 1)
                self._engine.switch_horizon_s = \
                    (self.cfg.steps - step) * m["wall"] / done
            old_plan = self.plan or ParallelPlan()
            self.plan = self._orch.adapt(old_plan, self.topo, ev)
            self.replans += 1
            # rebuild the step and shardings against the new plan and reshard the
            # state checkpointed above onto them
            self._build(self.mesh)
            like = jax_train_state_like(self.model)
            with phase(self.obs, "train.restore", step=step) as span:
                t0 = time.perf_counter()
                tree, _ = restore(ck, like, shardings=self.state_sh)
                restored = load_jax_train_state(self.model, tree)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                restore_s = time.perf_counter() - t0
                # the restored tree's bytes (parameters in the model's dtype, fp32
                # moments, the int32 step), as the reference counts its leaves
                nbytes = sum(leaf.numel() * leaf.element_size()
                             for _, leaf in _items(tree))
                del tree              # the host copy, before the next step
                span.set(bytes=nbytes, seconds=restore_s)
            self.restores.append({"step": step, "seconds": restore_s, "bytes": nbytes})
            if self._engine is not None:
                # calibration hook: fold the measured checkpoint-restore path
                # into the reconfiguration cost model, so simulated switch
                # charges track what elastic restore costs on this deployment
                self._engine.reconfig.calibrate_io(restore_s, float(nbytes))
            return restored

    # -- main loop -------------------------------------------------------------

    def run(self, state: Pytree | None = None,
            start_step: int = 0) -> tuple[Pytree, list[dict]]:
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        self._start_step = start_step
        self._hist_mark = len(self.history)
        obs, clock = self.obs, self._clock
        ev_i = 0
        t0 = time.perf_counter()
        for step in range(start_step, cfg.steps):
            while ev_i < len(self.events) and self.events[ev_i][0] == step:
                _, ev = self.events[ev_i]
                state = self._handle_event(step, ev, state)
                ev_i += 1
            with phase(obs, "train.step", step=step,
                       tokens=cfg.global_batch * cfg.seq_len):
                with phase(obs, "train.data", clock, step=step) as span:
                    host = self.data.batch(step)
                    batch = self._place(host)
                    if obs.enabled:
                        span.set(bytes=sum(v.nbytes for v in host.values()))
                if obs.enabled:
                    state, metrics = self._step(state, batch, obs=obs, clock=clock,
                                                step=step)
                else:                 # the plain call: a step given as (state, batch)
                    state, metrics = self._step(state, batch)
                if step % cfg.log_every == 0 or step == cfg.steps - 1:
                    with phase(obs, "train.wait", step=step):
                        m = {k: float(v) for k, v in metrics.items()}
                        m.update(step=step, wall=time.perf_counter() - t0)
                        self.history.append(m)
                        tok_s = m["tokens"] * (step - start_step + 1) / m["wall"]
                        print(f"  step {step:4d} loss {m['loss']:.4f} "
                              f"gnorm {m['grad_norm']:.2f} lr {m['lr']:.2e} "
                              f"tok/s {tok_s:,.0f}", flush=True)
                    if clock is not None:
                        clock.synced()
                if cfg.ckpt_every and step and step % cfg.ckpt_every == 0:
                    with phase(obs, "train.checkpoint", step=step):
                        self._save(Path(cfg.ckpt_dir) / f"step_{step}", state, step)
        self.saver.wait()
        if clock is not None:
            clock.flush()
        return state, self.history
