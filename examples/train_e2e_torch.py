"""End-to-end example of the PyTorch port: train an LM for a few hundred steps on
synthetic data, through the hand-written kernels on the card (the twin of
``examples/train_e2e.py``).

By default a ~100M dense decoder of the qwen2 family.  ``--arch`` trains one of
the ported architectures instead (dense, MoE, or cross-attention, whose batches
carry SyntheticLM's audio / vision embeddings): reduced with ``--small``, at its
published size otherwise.

PYTHONPATH=src python examples/train_e2e_torch.py --steps 300                # on the card
PYTHONPATH=src python examples/train_e2e_torch.py --steps 40 --small          # smoke, card
PYTHONPATH=src python examples/train_e2e_torch.py --steps 40 --small --device cpu
PYTHONPATH=src python examples/train_e2e_torch.py --steps 40 --small --arch whisper_medium
"""

import argparse
import dataclasses
import tempfile
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true",
                    help="10M-param config for quick verification")
    ap.add_argument("--arch", default="",
                    help="a ported architecture (its reduced config with --small)")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernels) or cpu (their plain versions)")
    ap.add_argument("--ckpt-dir", default=str(Path(tempfile.gettempdir()) / "repro_e2e_torch"))
    args = ap.parse_args()

    # ~100M dense decoder in the qwen2 family (GQA + swiglu).
    base = get_config("qwen2_7b")
    if args.arch:
        cfg = get_config(args.arch).reduced() if args.small else get_config(args.arch)
    elif args.small:
        cfg = base.reduced(n_layers=4, d_model=256, vocab=4096, d_ff=1024,
                           n_heads=4, n_kv_heads=2, head_dim=64)
    else:
        cfg = dataclasses.replace(
            base, name="qwen2-100m", n_layers=10, d_model=640, n_heads=10,
            n_kv_heads=2, head_dim=64, d_ff=2560, vocab=32768,
            dtype="float32", attn_q_chunk=256)
    n = LM(cfg, device="meta").n_params()
    print(f"model: {cfg.name}  params={n/1e6:.1f}M  device={args.device}  "
          f"steps={args.steps} batch={args.global_batch} seq={args.seq}")

    tcfg = TrainerConfig(
        arch=cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=100,
        log_every=10, device=args.device,
        opt=AdamWConfig(peak_lr=1e-3, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps, weight_decay=0.01))
    trainer = Trainer(tcfg)
    _, hist = trainer.run()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first - 0.3 else 'check hyperparams'})")


if __name__ == "__main__":
    main()
