"""Quickstart on the PyTorch port (the twin of ``examples/quickstart.py``): plan a
heterogeneous cluster, inspect the plan, train briefly.

PYTHONPATH=src python examples/quickstart_torch.py                # on the card
PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.core import hetero_cluster, plan_hybrid
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (default; the kernels) or cpu (their plain versions)")
args = ap.parse_args()

# 1. Describe the cluster with the multi-edge model (paper §3.1): four
#    current-gen consumer GPUs + four older V100s, PCIe vs NVLink edges.
topo = hetero_cluster({"RTX4090D": 4, "V100": 4}, gpus_per_node=4)
print(topo.describe())

# 2. Auto-plan (paper §3.3): enumerate + prune strategies, refine layer
#    assignment with branch-and-bound, score with the simulator.
cfg = get_config("qwen2_7b")
res = plan_hybrid(topo, cfg.to_model_desc(), global_batch=32, seq=1024)
print(f"\nbest plan       : {res.plan.describe()}")
print(f"predicted step  : {res.predicted.step_time*1e3:.0f} ms")
print(f"vs megatron-default: {res.speedup_vs_baseline:.2f}x "
      f"| vs tuned-uniform: {res.speedup_vs_tuned:.2f}x")
print(f"candidates: {res.candidates_evaluated} evaluated, "
      f"{res.candidates_pruned} pruned in {res.wall_time:.2f}s")

# 3. Execute a reduced config on this host with the plan's knobs.
print("\ntraining reduced config on", args.device)
with tempfile.TemporaryDirectory(prefix="repro_quickstart_") as ckpt:
    tcfg = TrainerConfig(arch=cfg.reduced(), steps=20, global_batch=8,
                         seq_len=128, ckpt_every=0, log_every=5, ckpt_dir=ckpt,
                         microbatches=res.plan.microbatches // res.plan.pp or 1,
                         opt=AdamWConfig(peak_lr=3e-3, warmup_steps=5,
                                         total_steps=20),
                         device=args.device)
    trainer = Trainer(tcfg, plan=res.plan)
    _, hist = trainer.run()
print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
