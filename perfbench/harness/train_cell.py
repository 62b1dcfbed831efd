"""One run of a training cell: set-up, the measured window, the traced steps with
``--trace 1``, then the check against the reference.

Set-up plans as ``repro_torch.launch.train --plan auto`` does (``plan_hybrid`` over
four H100s in one node, timed as ``plan_s``), builds the port's ``Trainer`` with the
cell's batch and length, sets its ``data`` to the benchmark's feed, writes the
seed's weights into the model's own parameters, and runs the first
``check_steps`` steps through ``Trainer.run``: they warm every shape the window
uses, and they are the steps the reference follows.  The window then drives
``Trainer.run(state, start_step=k)`` in short chunks until ``seconds`` have passed,
and ends at the synchronising ``float(loss)`` of its last step.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

from harness import compare, feed, reference, spec, weights
from harness import trace as tracing

#: the most steps one ``Trainer.run`` call of the window takes
CHUNK = 8

@dataclass
class Run:
    """What the metrics' readers read (``perfbench/metrics/<name>.py``)."""
    cfg: dict
    traffic: dict
    setup_s: float
    plan_s: float
    window_s: float
    step_s: list[float]
    tokens_per_step: int
    peak_bytes: int
    trace: tracing.Trace | None = None
    extra: dict = field(default_factory=dict)


def port_config(cfg: dict):
    """The port's ArchConfig for the configuration file, checked against the file
    by the configuration's reference module (``port_departures``): a program that
    departs from it raises."""
    from repro_torch.configs import get_config
    fields = {"n_layers": cfg["num_hidden_layers"], **cfg.get("port_overrides", {})}
    arch = dataclasses.replace(get_config(cfg["port_arch"]), **fields)
    wrong = spec.reference(cfg).port_departures(cfg, arch)
    if wrong:
        raise ValueError(f"the port's {cfg['port_arch']} departs from {cfg['name']}: "
                         f"{wrong} (file, port)")
    return arch


def build(arch, cfg: dict, traffic: dict, seed: int, device: str, ckpt_dir: str,
          plan=None, plant: Callable | None = None):
    """The port's Trainer for the cell (no checkpoints, no remat, a log line and a
    synchronising ``float(loss)`` every step), fed by the benchmark's feed, and its
    train state: the model's own parameters holding the seed's weights, and zeroed
    moments."""
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    opt = reference.AdamW()
    B, S = traffic["global_batch"], traffic["seq_len"]
    tcfg = TrainerConfig(
        arch=arch, steps=traffic["check_steps"], global_batch=B, seq_len=S,
        ckpt_dir=ckpt_dir, ckpt_every=0, log_every=1, remat="none", seed=seed,
        device=device, opt=AdamWConfig(**{f.name: getattr(opt, f.name)
                                          for f in dataclasses.fields(AdamWConfig)}))
    trainer = Trainer(tcfg, plan=plan)
    trainer.data = feed.Feed(seed, B, S, cfg["vocab_size"])
    if plant is not None:
        plant(trainer)
    params = dict(trainer.model.named_parameters())
    weights.fill(params, spec.reference(cfg).param_specs(cfg), seed)
    return trainer, {"params": params, "opt": init_opt_state(params)}


def program_readings(trainer, state, specs, seed, opt, check_steps):
    """Run the first ``check_steps`` steps through ``Trainer.run`` and take the
    program's side of the comparison: the loss of each step (the Trainer's
    history), each leaf's first gradient before clipping (from the moments after
    one step: m = (1 - b1) g scaled by the clip), its norm and its projection on
    the seed's fixed direction (``weights.project``), and each leaf's change
    (against the seed's values drawn again).  Returns (state, readings, seconds
    spent on the readings alone)."""
    import torch
    trainer.cfg.steps = 1
    state, hist = trainer.run(state, start_step=0)
    t0 = time.perf_counter()
    gnorm = hist[-1]["grad_norm"]
    clip = min(1.0, opt.clip_norm / max(gnorm, 1e-12))
    moments = state["opt"].m
    grad = {n: float(m.norm()) / (1 - opt.b1) / clip for n, m in moments.items()}
    proj = {n: p / (1 - opt.b1) / clip for n, p in weights.project(moments, seed).items()}
    spent = time.perf_counter() - t0
    trainer.cfg.steps = check_steps
    state, hist = trainer.run(state, start_step=1)
    t0 = time.perf_counter()
    params = state["params"]
    with torch.no_grad():
        change = {n: float((params[n].float() - p0.float()).norm())
                  for n, p0 in weights.draw(specs, seed, params[specs[0].name].dtype,
                                            params[specs[0].name].device)}
    losses = [h["loss"] for h in hist[:check_steps]]
    spent += time.perf_counter() - t0
    return state, reference.Readings(losses, grad, proj, change), spent


def run(cell: dict, cfg: dict, traffic: dict, limits: dict, metrics: dict,
        seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", plant: Callable | None = None,
        log=print) -> tuple[dict, Run]:
    """One run of the cell (``spec.resolve`` gives its pieces); returns the result
    line's object and what the metrics were read from.  ``t_start`` is the
    process's first host clock reading (set-up runs from it).  ``plant`` (tests
    only) is handed the Trainer before the first step, to break the timed path."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise spec.NoDevice(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                            f"this machine has {count}")
    if trace and not cuda:
        raise ValueError("--trace 1 reads the device's own trace: it needs the card")

    from repro_torch.core import hetero_cluster, plan_hybrid
    from repro_torch.kernels import ops

    B, S, V = traffic["global_batch"], traffic["seq_len"], cfg["vocab_size"]
    check_steps = traffic["check_steps"]
    ref_model = spec.reference(cfg)
    specs = ref_model.param_specs(cfg)
    arch = port_config(cfg)
    opt = reference.AdamW()

    t0 = time.perf_counter()
    topo = hetero_cluster({"H100": 4}, gpus_per_node=4)
    planned = plan_hybrid(topo, arch.to_model_desc(), global_batch=B, seq=S,
                          with_baseline=False)
    plan_s = time.perf_counter() - t0
    log(f"perfbench: plan {planned.plan.describe()} predicted step "
        f"{planned.predicted.step_time * 1e3:.3f} ms on 4 x H100 ({plan_s * 1e3:.3f} ms "
        "to plan)", flush=True)

    ckpt = tempfile.TemporaryDirectory(prefix="perfbench_ckpt_")
    trainer, state = build(arch, cfg, traffic, seed, device, ckpt.name, planned.plan,
                           plant)
    ops.reset_launch_counts()
    state, prog, check_s = program_readings(trainer, state, specs, seed, opt, check_steps)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start - check_s

    # the window
    stamps = trainer.data.stamps
    est = max(stamps[check_steps - 1] - stamps[check_steps - 2], 1e-3) \
        if check_steps > 1 else 0.1
    k = check_steps
    w0 = time.perf_counter()
    deadline = w0 + seconds
    while True:
        left = deadline - time.perf_counter()
        if left <= 0:
            break
        n = max(1, min(CHUNK, int(left / est)))
        trainer.cfg.steps = k + n
        state, _ = trainer.run(state, start_step=k)
        k += n
    w1 = time.perf_counter()
    window_steps = list(range(check_steps, k))
    ends = [stamps[s + 1] for s in window_steps[:-1]] + [w1]
    step_s = [e - stamps[s] for s, e in zip(window_steps, ends)]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = {h["step"]: h["loss"] for h in trainer.history}
    failed = sum(not math.isfinite(losses[s]) for s in window_steps)
    launches = {"by_kernel": ops.launch_counts(),
                "flash_forward_by_variant": ops.flash_launches_by_variant(),
                "flash_backward_by_variant": ops.flash_bwd_launches_by_variant(),
                "steps": k}

    traced = None
    if trace:
        # the device's own activity over whole steps, between two marker fills: little
        # cost on the host, so the idle share is the program's and not the tracer's
        n = traffic["trace_steps"]
        trainer.cfg.steps = k + n
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device=device)
            state, _ = trainer.run(state, start_step=k)
            torch.zeros(1, device=device)
            torch.cuda.synchronize()
        traced = tracing.read(prof, n)
        k += n
        # what the host was doing in each idle gap: host operators too, on a few more
        # steps (recording them slows the host, so these steps give the names only)
        n = traffic["trace_host_steps"]
        trainer.cfg.steps = k + n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(tracing.WINDOW):
                state, _ = trainer.run(state, start_step=k)
        traced.gaps = tracing.read(prof, n).gaps
        del prof

    log(f"perfbench: losses {[losses[s] for s in sorted(losses)]}", flush=True)
    log(f"perfbench: {len(step_s)} step times in the window of {w1 - w0:.6f} s; "
        f"launches {launches}", flush=True)
    result_run = Run(cfg=cfg, traffic=traffic, setup_s=setup_s, plan_s=plan_s,
                     window_s=w1 - w0, step_s=step_s, tokens_per_step=B * S,
                     peak_bytes=peak, trace=traced,
                     extra={"plan": planned.plan.to_json(),
                            "predicted_step_s": planned.predicted.step_time,
                            "launches": launches})

    # the program's state goes before the reference runs
    del state, trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ckpt.cleanup()

    params0 = weights.initial(cfg, specs, seed, device)
    batches = [feed.synthetic_batch(seed, s, B, S, V) for s in range(check_steps)]
    ref = ref_model.train(cfg, params0, batches, opt, seed)
    del params0
    numbers, where = compare.gaps(prog, ref)
    correct, checks = compare.verdict(numbers, limits)
    log(f"perfbench: reference losses {ref.losses}, program's {prog.losses}; every "
        f"number {numbers}, set at {where}", flush=True)

    values = {}
    for m in metrics[trace]:
        value = spec.reader(m["name"]).read(result_run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(window_steps), "failed": failed,
           "metrics": values, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        out["breakdown"] = {"device_ops": tracing.top((o[0], o[2]) for o in traced.ops),
                            "idle_gaps": tracing.top(traced.gaps)}
    out["checks"] = checks
    return out, result_run
