"""Dynamic-network scenarios S1/S2/S3 (paper Fig. 1) end to end, on the PyTorch
port (the twin of ``examples/dynamic_network.py``).

A training run over a temporal topology: bandwidth drop (S1), straggler
(S2), node failure (S3).  The timeline is expressed as a scenario *trace*
(repro_torch.scenarios): recorded to JSONL, loaded back, and handed to the
trainer, which maps event times onto training steps.  Each event flows
through the DynamicOrchestrator + ReplanEngine; the trainer checkpoints,
re-plans, rebuilds its step and restores the checkpoint.  The analytic cluster
is the reference example's; the model trains on one device whatever the plan.

PYTHONPATH=src python examples/dynamic_network_torch.py                # on the card
PYTHONPATH=src python examples/dynamic_network_torch.py --device cpu
"""

import argparse
import tempfile
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.core import NetworkEvent, ParallelPlan, hetero_cluster
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.scenarios import Trace

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (default; the kernels) or cpu (their plain versions)")
args = ap.parse_args()

topo = hetero_cluster({"RTX4090D": 4, "V100": 4}, gpus_per_node=4)
print(topo.describe())

STEPS = 24
with tempfile.TemporaryDirectory(prefix="repro_dyn_") as out:
    # hand-written timeline over a horizon of STEPS "seconds", one unit per
    # step: S1 at step 6, S2 at step 12, S3 at step 18
    trace = Trace.from_events(
        "s1s2s3_demo",
        [NetworkEvent(6.0, "bandwidth", factor=0.3, selector="ib"),   # S1
         NetworkEvent(12.0, "slowdown", device_id=2, factor=0.4),     # S2
         NetworkEvent(18.0, "fail", device_id=7)],                    # S3
        horizon=float(STEPS))
    path = trace.record(Path(out) / "s1s2s3_demo.trace.jsonl")
    trace = Trace.load(path)                     # JSONL round-trip
    print(trace.describe(), f"-> {path}")

    cfg = TrainerConfig(
        arch=get_config("qwen2_7b").reduced(n_layers=2, d_model=64, vocab=256,
                                            d_ff=128),
        steps=STEPS, global_batch=8, seq_len=64, ckpt_dir=out,
        ckpt_every=5, log_every=4, device=args.device,
        opt=AdamWConfig(peak_lr=2e-3, warmup_steps=3, total_steps=STEPS))

    trainer = Trainer(cfg, topo=topo, scenario=trace,
                      plan=ParallelPlan(dp=2, tp=2, pp=2, microbatches=2))
    state, hist = trainer.run()

print("\nadaptation history (paper §2.2 mechanisms):")
for rec in trainer.adaptations:
    print(f"  t={rec.time:5.1f} {rec.event.kind:9s} -> {rec.action:20s} "
          f"predicted step {rec.old_step_time*1e3:7.1f} -> "
          f"{rec.new_step_time*1e3:7.1f} ms")
print("\nincremental re-planning engine telemetry:")
print(trainer.engine.describe())
print("\nmodeled reconfiguration charges (repro_torch.core.reconfig, calibrated "
      "against the measured checkpoint-restore path):")
for r in trainer.engine.history:
    if not r.cold:
        verdict = "kept incumbent" if r.kept else "switched"
        print(f"  {r.path:22s} modeled switch cost {r.switch_cost:6.3f} s "
              f"-> {verdict}")
print(f"  calibrated store bandwidth "
      f"{trainer.engine.reconfig.io_bw / 1e9:.2f} GB/s")
print(f"\n{trainer.replans} re-plans; final loss {hist[-1]['loss']:.3f} "
      f"(training continued through all events)")
