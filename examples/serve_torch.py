"""Serving example of the PyTorch/CUDA port: batched prefill -> greedy decode.

The same loop as examples/serve.py: prefill a batch of requests, turn the
stacked prefill cache into the flat per-layer layout, right-size it, decode
token by token.  Runs on the GPU (the attention and RMSNorm kernels are built
at first use); pass --device cpu to run the plain versions instead.

Every --arch runs: the dense ones (qwen2_7b, gemma_7b, qwen3_32b, granite_34b),
the mixture-of-experts ones (qwen3_moe_30b_a3b, dbrx_132b), the cross-attention
ones (llama_3p2_vision_11b, whisper_medium), whose vision patches / audio
frames are random embeddings at 0.02 scale from a seeded generator (the
frontends are stubs, as in the reference), and the recurrent ones (zamba2_2p7b:
Mamba2 with a shared attention block; xlstm_125m: mLSTM and sLSTM).

PYTHONPATH=src python examples/serve_torch.py                    # reduced gemma-7b
PYTHONPATH=src python examples/serve_torch.py --arch qwen2_7b --full --seq 2048
PYTHONPATH=src python examples/serve_torch.py --arch whisper_medium --full --seq 448
PYTHONPATH=src python examples/serve_torch.py --arch zamba2_2p7b --full --seq 2048
PYTHONPATH=src python examples/serve_torch.py --arch llama_3p2_vision_11b --device cpu
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import modality_inputs
from repro_torch.kernels import ops
from repro_torch.models.lm import LM
from repro_torch.parallel.trainstep import make_prefill_step, make_serve_step

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="gemma_7b")
ap.add_argument("--full", action="store_true",
                help="published size in the config's dtype (default: reduced, fp32)")
ap.add_argument("--device", default="cuda")
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--seq", type=int, default=48)
ap.add_argument("--gen", type=int, default=16)
args = ap.parse_args()

dev = torch.device(args.device)
cfg = get_config(args.arch) if args.full else get_config(args.arch).reduced()
model = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
prefill, serve = make_prefill_step(model), make_serve_step(model)

B, S, GEN = args.batch, args.seq, args.gen
MAXLEN = S + GEN
requests = torch.randint(0, cfg.vocab, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
# the modality inputs a cross-attention model attends to (none for the others)
mods = modality_inputs(cfg, B, torch.Generator(device=dev).manual_seed(2), dev)


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()


# prefill: last-token logits + kv cache (stacked per pattern position)
t0 = time.perf_counter()
logits, stacked = prefill({"tokens": requests, **mods})
sync()
print(f"prefill  B={B} S={S}: {time.perf_counter() - t0:.3f}s "
      f"logits {tuple(logits.shape)}")

# convert to the flat per-layer serving layout and right-size to MAXLEN
cache = model.serving_cache(stacked, S, MAXLEN)
del stacked

tok = logits.argmax(-1, keepdim=True)
out = [tok]
sync()
t0 = time.perf_counter()
for t in range(GEN):
    # the cache is updated in place
    logits, cache = serve(cache, {"tokens": tok,
                                  "pos": torch.full((B,), S + t, device=dev), **mods})
    tok = logits.argmax(-1, keepdim=True)
    out.append(tok)
sync()
dt = time.perf_counter() - t0
gen = torch.cat(out, dim=1)
where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
print(f"decode   {GEN} steps x {B} seqs: {dt:.3f}s "
      f"({B * GEN / dt:.1f} tok/s on {where})")
print("kernel launches:", ops.launch_counts())
print("generated ids[0]:", gen[0].tolist())
assert bool(torch.isfinite(logits).all())
print("OK")
