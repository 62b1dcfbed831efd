"""Training runtime on one device: the planner-free half of the reference's
``runtime/trainer.py``.

Drives the train step over the synthetic pipeline with periodic asynchronous
checkpoints (``checkpoint.store``, the reference's on-disk format), and keeps the
same ``history`` records.  What the reference adds around that -- network events
(S1/S2/S3) applied to a cluster topology, the re-planning engine, the mesh and
sharding rebuild and the elastic restore -- needs the planner (``repro.core``)
and the parallel layer, which are not ported yet: passing ``topo``, ``events``,
``scenario``, ``plan`` or ``mesh`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

import torch

from repro_torch.checkpoint.store import AsyncSaver
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import export_jax_train_state
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.trainstep import init_train_state, make_train_step

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


def _waits_for(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"Trainer({what}=...) needs the {item}, which is not ported yet; the port "
        "trains on one device without it")


class Trainer:
    def __init__(self, cfg: TrainerConfig, *,
                 mesh=None, plan=None, topo=None,
                 events: Sequence = (), scenario=None):
        for what, value, item in (
                ("topo", topo, "planner (ROADMAP M14)"),
                ("events", list(events), "planner (ROADMAP M14)"),
                ("scenario", scenario, "planner and scenarios (ROADMAP M14)"),
                ("plan", plan, "planner (ROADMAP M14)"),
                ("mesh", mesh, "parallel layer (ROADMAP M11)")):
            if value is not None and value != []:
                raise _waits_for(what, item)
        if cfg.zero3:
            raise _waits_for("zero3", "parallel layer (ROADMAP M11)")
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.model = LM(cfg.arch, device=self.device)
        self.saver = AsyncSaver()
        self.history: list[dict] = []
        self._build()

    @property
    def adaptations(self) -> list:
        """Adaptation records: none without the planner."""
        return []

    @property
    def engine(self):
        """The re-planning engine: none without the planner."""
        return None

    def _build(self) -> None:
        self._step = make_train_step(self.model, self.cfg.opt,
                                     microbatches=self.cfg.microbatches,
                                     remat=self.cfg.remat)
        a = self.cfg.arch
        self.data = SyntheticLM(DataConfig(
            vocab=a.vocab, seq_len=self.cfg.seq_len,
            global_batch=self.cfg.global_batch, seed=self.cfg.seed,
            audio_seq=a.audio_seq if a.encoder_layers else 0,
            vision_seq=a.vision_seq if a.cross_attn_every else 0,
            d_model=a.d_model))

    def init_state(self) -> Pytree:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return init_train_state(self.model, gen)

    def _place(self, batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def run(self, state: Pytree | None = None,
            start_step: int = 0) -> tuple[Pytree, list[dict]]:
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        t0 = time.perf_counter()
        for step in range(start_step, cfg.steps):
            batch = self._place(self.data.batch(step))
            state, metrics = self._step(state, batch)
            if step % cfg.log_every == 0 or step == cfg.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, wall=time.perf_counter() - t0)
                self.history.append(m)
                tok_s = m["tokens"] * (step - start_step + 1) / m["wall"]
                print(f"  step {step:4d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.2f} lr {m['lr']:.2e} "
                      f"tok/s {tok_s:,.0f}", flush=True)
            if cfg.ckpt_every and step and step % cfg.ckpt_every == 0:
                self.saver.submit(Path(cfg.ckpt_dir) / f"step_{step}",
                                  export_jax_train_state(self.model, state), step=step)
        self.saver.wait()
        return state, self.history
