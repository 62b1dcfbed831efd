#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # everything, as below
    python3 chip_smoke.py --layers 4      # cut qwen2-7b's served depth (never its width)
    python3 chip_smoke.py --skip-serve --skip-train   # build and check the kernels, run small
    python3 chip_smoke.py --skip-serve    # the kernels, small, the train phases and the rest
    python3 chip_smoke.py --out DIR       # also write report.json(l) and nvcc's log there
    python3 chip_smoke.py --bf16-seeds 6  # only the bf16 whole-model check, seeds 0..5

What it does, one JSON line per phase on standard output, each with the card's SM
and memory clocks, temperature and power draw (nvidia-smi) and the host's load
average taken at the phase's start and end (read only, never a check):

  device   the card's name and power limit (nvidia-smi), torch and CUDA versions;
  build    builds the kernels' shared library from src/repro_torch/kernels/csrc/
           with nvcc (first use of the library);
  kernels  holds each hand-written kernel against its plain PyTorch version on the
           card, at the reference's test cases and cases across the wgmma kernels'
           tile edges (fp32, bf16, fp16; at head_dim 80 ragged Sq and Skv, Sq < Skv,
           the window's edge, no mask with Sq > Skv and a softcap) and at the shapes
           the serving and training paths give it: the forwards, the attention
           forward's lse, and the two backwards (dq, dk, dv; dx, dw); records which
           flash variant each case launched, forward and backward (16-bit head_dim
           64/80/128/256 wgmma both ways, 16/32 mma.sync, fp32 scalar), shows that
           a call either wgmma kernel cannot take raises instead of running another
           variant or a plain version, and that a head_dim compiled into neither direction (96) is
           refused by the autograd wrapper, both launchers and both C entries and
           launches nothing, that two backward calls on the same inputs give dk,
           dv, dx and dw bit for bit at the training shapes of qwen2-7b, zamba2-2.7b
           and gemma-7b (dq within tolerance where its sum runs through TMA
           reduce-adds in no fixed order; recorded), and times kernel, plain
           version, one library call (a yardstick
           only; the port never calls it; for the RMSNorm backward three readings
           in turns with the kernel, and the names of the kernels it launches) and
           the card's bound, and the device time of each kernel an attention
           backward call launches; the RMSNorm forward in turns with F.rms_norm,
           three readings each, at every shape of every path, and both device-only,
           replayed from a CUDA graph; every flash and RMSNorm shape the family
           serves and the dense families qwen3-32b and granite-34b give the kernels
           at full width (causal self-attention, head_dim 256, one KV head,
           q/k-norm, cross-attention with more queries than keys at ragged key
           counts, the encoder, zamba2's shared attention at head_dim 80 with its
           4096-token window, and 6144 tokens where the window bites, the Mamba2
           gated norm over 5120), the flash forward, lse and backward held there
           and the forward timed beside SDPA (where the window bites SDPA is given
           it as a boolean mask); the backward timed beside SDPA's at the training
           shapes of qwen2-7b, zamba2-2.7b (head_dim 80) and gemma-7b (head_dim 256),
           all three on the wgmma kernel, and the mma.sync passes at head_dim 32 and
           16, which no main path runs; launch_train's shapes (zamba2-2.7b, 8 x 256
           tokens): the flash forward and backward held and timed beside SDPA's, the
           RMSNorm forward at 2560 and 5120 held and timed, its backward held there
           and at train_zamba's 2 x 4096 rows; launch_reduced's (the reduced float32
           qwen2-7b, 8 x 256 tokens): the scalar fp32 flash forward and backward held
           and timed beside SDPA's;
  small    reduced fp32 models on the card (through the kernels) against the same
           weights on the CPU (plain versions), one per family: qwen2-7b, gemma-7b,
           qwen3-32b, granite-34b, qwen3-moe, dbrx, llama-3.2-vision, whisper, zamba2,
           xlstm, and zamba2 again at its own head_dim 80, there on the scalar
           flash kernels; a 32-token prompt, longer
           than the vision and audio models' 16 patches / 24 frames, and twice
           zamba2's 16-token window, so its ring wraps:
           prefill + decode with exact launch counts, then three train steps (loss,
           grad norm, every parameter, exact launch counts per step) and, for
           qwen2-7b, qwen3-moe, whisper and zamba2, a checkpoint round trip of the
           card's train state, bit for bit; for qwen3-moe also whether two prefills
           on the same inputs give the same bits (recorded only); then the 16-bit
           flash kernels whole: one train step's loss and every gradient of reduced
           zamba2 at head_dim 80 and reduced gemma at head_dim 256 in bf16 (the
           wgmma kernels both ways) against the same weights in float32 on the card
           (BF16_MODELS; `--bf16-seeds N` runs only this check, at seeds 0..N-1);
  serve    qwen2-7b at full width and depth in bf16, random weights from a seed:
           4 requests of 2048 tokens through make_prefill_step, 16 greedy steps
           through make_serve_step, with the kernels' launch counts set to 0 just
           before and read just after (every prefill flash launch is the variant
           the split by shape names); then the prefill/decode agreement check;
  serve_moe, serve_vlm, serve_audio, serve_gemma, serve_zamba, serve_xlstm
           the same at full width and depth for qwen3-moe-30b-a3b (4 x 2048
           tokens), llama-3.2-vision-11b (4 x 2048 tokens against 1601 patch
           embeddings, so its cross-attention has more queries than keys),
           whisper-medium (1500 audio frames, 4 x 448 tokens), gemma-7b (4 x 2048
           tokens, head_dim 256), zamba2-2.7b (4 x 2048 tokens: Mamba2 and the shared
           attention at head_dim 80, every flash launch on the wgmma kernel) and
           xlstm-125m (4 x 2048 tokens: mLSTM and sLSTM, no attention), each model
           freed before the next;
           the agreement check for all but MoE (its capacity depends on how many
           tokens a call holds); for the recurrent ones 257 tokens take the
           sequential scans, 256 the chunkwise forms, and the check is held on a
           float32 copy of the served weights (FAMILY_SERVES says why), the bf16
           reading recorded beside it;
  train    (the serve model freed first) qwen2-7b at full width, 8 of 28 layers,
           bf16: the Trainer over SyntheticLM batches of 2 x 4096 tokens for 6
           steps, counts at 0 just before; exact launches of every kernel, forward
           and backward, per step, each flash launch the variant the split by shape
           names; finite losses, the step-0 loss where a random init puts it; ms
           per step, tokens/s, MFU and peak memory;
  train_mesh  the train phase's model, batches and seed again, on a one-rank NCCL
           process group (rendezvous on 127.0.0.1) and a (1, 1) ("data", "model")
           DeviceMesh on the card (launch.mesh.make_host_mesh), ZeRO-3 on: the
           Trainer's mesh path, its state and batches DTensors under the reference's
           axis rules, both kernels reached through local_map on the local shards;
           every step's loss within 5e-3 of train's (the wgmma backward's dq adds
           in no fixed order), exactly train's launches per step, all on wgmma; ms
           per step, tokens/s, MFU and peak memory beside train's (the gap is
           DTensor's host cost: read, not checked); the process group destroyed
           before the next phase;
  train_zamba  (the model before freed) the same for zamba2-2.7b at full width, 6 of
           54 layers (4 Mamba2, 2 occurrences of the shared attention block), 4
           steps: flash at head_dim 80 forward and backward, both on wgmma;
  train_zamba_mesh  train_zamba again through the Trainer's mesh path, as train_mesh
           is train's: the Mamba2 scans on the local shards through local_map, every
           step's loss within 5e-3 of train_zamba's;
  launch_train  the training launcher as a user runs it, in-process:
           `python -m repro_torch.launch.train --arch zamba2_2p7b --plan auto
           --steps 8 --global-batch 8 --seq 256`, zamba2-2.7b at full width and depth
           (54 layers, 1.74 G parameters): the planner (repro_torch.core) plans on the
           launcher's analytic cluster of H100s, then the Trainer runs 8 steps; the
           printed [plan] line and its predicted step checked against the planner
           run again, exact launches per step, every flash launch on wgmma both ways,
           finite losses, the step-0 loss; read beside the measured ms a step: the
           planner's predicted step for the same model on one H100;
  train_dynamic  the planner-driven Trainer through the reference example's three
           events (examples/dynamic_network.py: its cluster of 4 RTX4090D and 4 V100,
           plan dp=2 tp=2 pp=2 mb=2; S1 bandwidth x0.3 on "ib" at step 6, S2 device 2
           slowed x0.4 at step 12, S3 device 7 failed at step 18, as a recorded and
           reloaded trace) training train_zamba's model for 24 steps: each event
           checkpoints, re-plans, rebuilds the step and restores; 3 re-plans, each
           restore bit for bit the state saved at its event (a copy held on the
           card), exact launches, flash on wgmma; read: each restore's seconds and
           bytes, the calibrated store bandwidth, the engine's path and wall ms per
           event, ms a step before the first event and after the last.  The
           checkpoints live in a temporary directory, removed at the end;
  launch_reduced  the North star's own command, in-process: `python -m
           repro_torch.launch.train --arch qwen2_7b --reduced --plan auto --steps 8`
           (the reduced fp32 qwen2-7b, 8 x 256 tokens), the [plan] line checked as in
           launch_train, exact launches per step (its fp32 flash on the scalar
           kernel), finite losses;
  scenarios  host only: the port's ScenarioHarness over two seeds of one catalog
           scenario, sequentially and in 2 worker processes (equal timelines), and
           a PlannerService replay of a multi-tenant stream serially and with 4
           threads (equal plan digests); the walls printed;
  collectives  parallel.collectives.sync_grads on a one-rank NCCL group's "data" axis
           over a bf16 tree of train's parameter shapes (2.41 G entries, seeded on
           the card): "allreduce" and "rs_ag" give the tree back bit for bit, "int8"
           is within 1.25 of each leaf's scale in bf16 (within one in float32, on
           one layer's leaves) and its new_err is exactly g - deq; ms per
           schedule (a one-rank collective moves nothing: the int8 passes are the
           only device work);
  pipeline  parallel.pipeline.pipeline_forward on a one-rank "pipe" mesh: qwen2-7b's
           decoder layers at full width (4 stacked, bf16) through the functional
           attn_block / ffn_block, 4 microbatches of 1 x 2048 tokens, forward and
           backward, held against the same layers applied in sequence on the card
           (outputs and every gradient within TOL_BF16's dense tolerances) with the
           exact launches of both kernels both ways; ms beside the sequential
           stack's.  Uneven stages, the padding mask and send / recv need more than
           one rank and are held on gloo ranks by tests/test_torch_pipeline.py;
  roofline  launch.dryrun (the step on fake tensors, each rank's own flops, the
           collectives by kind, a tracked peak) for train's cell and launch_train's on
           a fake one-rank group's (1, 1) mesh, at one microbatch as measured: flops, the compute / memory / collective terms at
           the H100's datasheet peaks, the bottleneck and the tracked peak beside the
           measured ms a step and peak of those phases (measured / roofline and
           tracked / measured: readings, never gates); and, in a subprocess, the
           production cell qwen2-7b x train_4k on the (16, 16) mesh of 256 fake
           ranks: its fits, microbatches, terms and wall seconds;
  calibrate  tools/calibrate_fabric_torch.py's sweep on the card (pinned host<->card
           copies priced against the planner's H100 PCIe edge, one-rank NCCL
           all-reduces), fitted: alpha, beta, the copies' peak GB/s, the all-reduce's
           median latency (one rank moves no bytes: latency only) and the composite
           step's simulated against measured error (which prices latency, not
           bandwidth).

Then the card's name and power limit, a {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}.  Any failed check ends the run with a non-zero exit
code and without that last line.  Without a CUDA device the script exits at once:
it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
PEAK_BYTES_PER_S = 3.35e12
PEAK_TENSOR_16BIT_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

# The reference's kernel test cases: (B, Sq, Skv, H, KV, hd, causal, window)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 64, 256, 8, 8, 32, True, 0),       # queries aligned to the end of the keys
    (2, 128, 128, 4, 4, 64, True, 48),     # sliding window
    (1, 1, 128, 4, 2, 64, True, 0),        # single-token decode
    (2, 96, 96, 6, 2, 32, False, 0),       # bidirectional
    (1, 256, 256, 2, 1, 128, True, 0),     # MQA
    (1, 32, 32, 4, 4, 16, True, 8),        # tiny window
    (1, 100, 100, 2, 2, 256, True, 0),     # head_dim 256 (needs > 48 KB shared memory)
    (1, 70, 200, 4, 2, 64, False, 33),     # window without causal, ragged sizes
]
# Cases across the TMA + wgmma kernel's 128-row q tile and its kv tile edges (128
# keys at head_dim 64 and 128, 64 keys at head_dim 256: the shapes that kernel
# takes in 16 bits).
FLASH_TILE_EDGE_CASES = [
    (1, 129, 129, 4, 2, 128, True, 0),     # one row and one key past a tile
    (2, 255, 383, 28, 4, 128, True, 0),    # Sq < Skv, both ragged, qwen2-7b's heads
    (1, 300, 300, 4, 1, 64, True, 100),    # a window that spans tiles
    (2, 200, 200, 8, 8, 128, False, 0),    # bidirectional, ragged
    (1, 129, 129, 4, 4, 256, True, 0),     # head_dim 256: a row and a key past a tile
    (2, 191, 321, 8, 8, 256, True, 0),     # head_dim 256, Sq < Skv, both ragged
    (1, 130, 130, 4, 1, 256, False, 0),    # head_dim 256, bidirectional, one KV head
    (1, 300, 300, 2, 2, 256, True, 100),   # head_dim 256, a window over 64-key tiles
]
# Cases across the wgmma backward's tiles (128 keys; 64 query rows at head_dim 80 and
# 128, 128 at 64; at 256 64 keys and 64 rows): ragged GQA with Sq < Skv, a head_dim 64
# window spanning two key tiles; head_dim 256 with GQA, Sq and Skv ragged against its
# 64-key tiles, and a window across two of them; head_dim 80 with GQA and Sq < Skv
# across two 64-row query tiles and three 128-key tiles.
FLASH_BWD_EDGE_CASES = [
    (2, 191, 321, 28, 4, 128, True, 0),
    (2, 260, 260, 8, 2, 64, True, 150),
    (2, 150, 201, 8, 2, 256, True, 0),
    (1, 260, 260, 4, 2, 256, True, 90),
    (2, 100, 300, 8, 4, 80, True, 0),
]
# Head_dim 80 (zamba2's shared attention; both wgmma kernels' 64- and 16-column
# boxes): ragged Sq and Skv, Sq < Skv with GQA, the window's edge across the 128-key
# tiles, no mask with Sq > Skv.  Held forward, lse and backward in fp32, bf16 and fp16.
FLASH_HD80_CASES = [
    (1, 200, 200, 4, 4, 80, True, 0),
    (2, 191, 321, 8, 2, 80, True, 0),
    (1, 300, 300, 4, 4, 80, True, 100),
    (1, 200, 130, 4, 4, 80, False, 0),
]
# softcap 20 on scores scaled by 3 x 3, as the reference's test has it
FLASH_SOFTCAP_CASES = [(1, 64, 64, 2, 2, 32, True, 0), (1, 200, 200, 4, 2, 128, True, 0),
                       (1, 130, 130, 2, 2, 256, True, 0), (1, 200, 200, 4, 4, 80, True, 0)]
# Cross-attention: no mask, more queries than keys (key counts ragged against the
# 128-key tile), every query tile of the forward and of the wgmma backward past the
# last key tile.  Held in fp32, bf16 and fp16, forward, lse and backward.
FLASH_CROSS_CASES = [
    (1, 200, 70, 4, 2, 128, False, 0),
    (1, 200, 70, 4, 4, 64, False, 0),
    (2, 300, 129, 8, 2, 128, False, 0),
    (1, 33, 3, 2, 2, 16, False, 0),        # three keys; the mma.sync kernels (with one
                                           # key dq = dk = 0 exactly: nothing to hold)
]
# The families served at full size after qwen2-7b: (phase, architecture, prompt
# tokens, prefill/decode agreement check: in the served dtype, none, or on a
# float32 copy of the served weights).  The random recurrent models amplify bf16
# rounding far past the check's 8 % of the logits' spread, in the reference as in
# the port: at 12 of zamba2's layers (CPU, the reference's init) the reference's own
# bf16 prefill(257) and prefill(256) + decode disagree by 17.7 % of the spread and
# its bf16 prefill lies 30 % of the spread from its float32 one; random xlstm-125m's
# first mLSTM block grows the residual stream to ~1e7.  So their two paths are held
# to agree in float32 (the bf16 reading is recorded beside it).  The kernels phase
# also holds each kernel at every shape these paths give it (path_shapes below).
FAMILY_SERVES = (("serve_moe", "qwen3_moe_30b_a3b", 2048, False),
                 ("serve_vlm", "llama_3p2_vision_11b", 2048, True),
                 ("serve_audio", "whisper_medium", 448, True),
                 ("serve_gemma", "gemma_7b", 2048, True),
                 ("serve_zamba", "zamba2_2p7b", 2048, "float32"),
                 ("serve_xlstm", "xlstm_125m", 2048, "float32"))
# Dense families too large to serve on one card (qwen3-32b: 65.5 GB of bf16 weights,
# granite-34b: ~68 GB): their kernel shapes at full width (path_shapes) and their
# reduced models (the small phase) are held instead.
SHAPE_ONLY = (("qwen3_32b", 2048), ("granite_34b", 2048))
SMALL_ARCHS = ("qwen2_7b", "gemma_7b", "qwen3_32b", "granite_34b", "qwen3_moe_30b_a3b",
               "dbrx_132b", "llama_3p2_vision_11b", "whisper_medium", "zamba2_2p7b",
               "xlstm_125m")
# reduced models at another head_dim than reduced()'s 32: zamba2 at its own 80, so
# that the card-against-CPU steps run the head_dim-80 flash kernels too.  The small
# phase is float32, so these are the scalar kernels; the 16-bit ones are held whole by
# the bf16 check below (BF16_MODELS) and run in serve_zamba and train_zamba
SMALL_HEAD_DIMS = (("zamba2_2p7b", 80),)
# The bf16 whole-model check: reduced() widths at the architecture's own head_dim, one
# train step (loss and every gradient) of B_BF16 x S_BF16 tokens in bf16 on the card
# against the same bf16-rounded weights in float32 on the card.  S_BF16 spans four of
# the backward's 64-row query tiles and two 128-key tiles (four of 64 at head_dim 256),
# and is a multiple of the Mamba2 chunk (the chunkwise SSD under gradients).
BF16_MODELS = (("zamba2_2p7b", 80), ("gemma_7b", 256))
B_BF16, S_BF16 = 2, 256
# the small phase's checkpoint round trips: one of each kind of parameter tree
SMALL_CHECKPOINTS = ("qwen2_7b", "qwen3_moe_30b_a3b", "whisper_medium", "zamba2_2p7b")
SCENARIO = "fig6c_dynamic_bw"    # the scenarios phase's catalog scenario
SM90_HEAD_DIMS = (64, 80, 128, 256)   # 16-bit head_dims the forward runs on the wgmma kernel
SM90_BWD_HEAD_DIMS = (64, 80, 128, 256)   # ... and the backward
# the kernels line's entry of each flash variant, forward (every 16-bit head_dim a
# path has is a wgmma one; launch_reduced's float32 model runs the scalar kernel) and
# backward (likewise; the mma.sync passes, at head_dim 16 and 32, run on no main path)
FLASH_VARIANT_KERNELS = {"sm90_wgmma": "flash_attention", "scalar": "flash_attention_scalar"}
FLASH_BWD_VARIANT_KERNELS = {"sm90_wgmma": "flash_attention_bwd",
                             "mma_sync": "flash_attention_bwd_mma_sync",
                             "scalar": "flash_attention_bwd_scalar"}
UNCOMPILED_HEAD_DIM = 96          # compiled into neither direction: must be refused
RMSNORM_SHAPES = [(4, 37, 128), (1, 1, 256), (8, 512), (2, 3, 5, 64)]

# Tolerances (absolute and relative, as in the reference's tests), with reasons:
#  fp32: kernel and plain version both compute in fp32 but sum in another order
#        (per 32-key tile with a running maximum, against one softmax over the row);
#  softcap: tanh of scores scaled by 3 amplifies that difference;
#  16-bit: the kernel rounds the probabilities to the input type for the p*v
#        product and its output once at the end (one bf16 ulp at O(1) values is
#        0.008-0.016); it is held against the plain version run on the same values
#        in fp32.
TOL_FLASH_FP32, TOL_FLASH_SOFTCAP, TOL_16BIT, TOL_RMSNORM_FP32 = 2e-5, 1e-4, 2e-2, 1e-5
# The backwards and the forward's lse are held as a share of the reference's largest
# magnitude (a gradient's small entries are differences of large terms):
#  fp32: 1e-4 for attention -- sums over up to 4,096 keys in another order and
#        expf / tanhf against torch's; 1e-5 for RMSNorm (sums over one row, and dw
#        over the rows in a fixed other order);
#  16-bit: 2e-2 -- the kernels round p and ds to the input type for the products
#        and D is taken from the 16-bit output, against the plain version run in fp32
#        on the same values;
#  lse: 1e-4 in fp32 and 1e-3 in 16 bits (the wgmma kernel's exponentials are the
#        approximate ex2 instruction).
TOL_BWD_FP32, TOL_RMSNORM_BWD_FP32, TOL_LSE_FP32, TOL_LSE_16BIT = 1e-4, 1e-5, 1e-4, 1e-3
# train_mesh against train (train_zamba_mesh against train_zamba), per step's loss,
# absolute: the same bf16 step on the
# same card, but the wgmma backward's dq is summed by TMA reduce-adds in no fixed
# order, so two runs part by rounding that the steps carry forward
TOL_MESH_LOSS = 5e-3
# The bf16 whole-model check (BF16_MODELS): a reduced model's loss in bf16 against
# float32, absolute, and each gradient's largest difference as a share of its largest
# magnitude and its difference's L2 norm as a share of its norm, by architecture.
# bf16 rounds every activation, product and weight gradient to 8 bits (2^-9 relative)
# at each layer; zamba2's Mamba2 recurrences amplify that far more than gemma's
# attention and FFN layers do (the plain versions on the CPU, bf16 against float32,
# seed 0: zamba2's embedding gradient 45 % of its largest magnitude, its shared
# attention's 9-16 %; gemma's worst 1.5 %), so at zamba2 only the loss is a tight
# check.  Measured on the card over seeds 0-5 (--bf16-seeds 6): zamba2's loss within
# 5.2e-4, gradients 0.94 and 0.54; gemma's 5.1e-5, 0.0173 and 0.0140.  The
# tolerances are about twice the worst.
TOL_BF16 = {"zamba2_2p7b": (1e-3, 2.0, 1.1),    # (loss, largest entry, L2 norm)
            "gemma_7b": (1e-4, 0.035, 0.03)}
# int8 gradient compression (collectives phase), the reference's formula in the
# leaf's dtype: in float32 round(x / scale) is within half a step of x / scale and
# q * scale exact to 2^-24, so g is within one scale (the reference test's bound).  In
# bf16, x / scale is itself rounded to bf16 (a spacing of 0.5 between 64 and 128: a
# quarter step more) and so is q * scale (half an ulp of up to 127 scales: about half a
# step more): 0.5 + 0.25 + 0.5 = 1.25 scales.
INT8_BF16_SCALES = 1.25

FAILURES: list[str] = []


#: where emit() also appends its lines (--out): the end of a long standard output
#: may be all a caller gets back
REPORT_LINES: list[Path] = []


def emit(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    for path in REPORT_LINES:
        with path.open("a") as f:
            f.write(line + "\n")


def probe() -> dict:
    """The card's SM and memory clocks, temperature and power draw (nvidia-smi) and
    the host's load average: read only, taken at each phase's start and end so that
    a swing between runs can be traced to the card or the host; no check reads it."""
    out: dict = {"loadavg": [round(x, 2) for x in os.getloadavg()]}
    names = ("sm_clock_mhz", "mem_clock_mhz", "temp_c", "power_w")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,power.draw",
             "--format=csv,noheader,nounits"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, timeout=30)
        values = smi.stdout.strip().splitlines()[0].split(",")
    except (OSError, subprocess.SubprocessError, IndexError):
        return {**out, "nvidia_smi": "unreadable"}
    for name, value in zip(names, values):
        try:
            out[name] = float(value)
        except ValueError:
            out[name] = value.strip()
    return out


def with_clocks(obj: dict, start: dict) -> dict:
    """obj with the probe taken at its phase's start and one taken now."""
    obj["clocks"] = {"start": start, "end": probe()}
    return obj


def fail(msg: str) -> None:
    FAILURES.append(msg)
    print("FAIL: " + msg, file=sys.stderr, flush=True)


def stop_if_failed(phase: str) -> None:
    if FAILURES:
        print(f"chip_smoke: phase {phase!r} failed: {len(FAILURES)} check(s)",
              file=sys.stderr)
        sys.exit(1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut qwen2-7b's served depth to this many layers")
    ap.add_argument("--skip-serve", action="store_true", help="skip every serve phase")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16-seeds", type=int, default=0,
                    help="run only the bf16 whole-model check, at seeds 0..N-1 (exit 4)")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit("chip_smoke: src/repro_torch is not beside this script")
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script measures on the "
                 "card only")
    sys.path.insert(0, str(ROOT / "src"))
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        REPORT_LINES.append(Path(args.out) / "report.jsonl")
        REPORT_LINES[0].write_text("")
    run(args, torch)


def run(args, torch) -> None:
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import rmsnorm as rms_mod
    from repro_torch.checkpoint.store import restore as restore_state
    from repro_torch.checkpoint.store import save as save_state
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, modality_inputs
    from repro_torch.models.convert import (export_jax_train_state,
                                            jax_train_state_like, load_jax_train_state)
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.trainstep import (init_train_state, make_prefill_step,
                                                make_serve_step, make_train_step)
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 checks need fp32
    report: dict = {}
    start = probe()

    # ------------------------------------------------------------- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave nothing"
    report["device"] = {
        "phase": "device", "nvidia_smi": smi_line,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(with_clocks(report["device"], start))

    # -------------------------------------------------------------- build
    start = probe()
    t0 = time.perf_counter()
    _build.load()
    report["build"] = {
        "phase": "build", "built": _build.build_info["built"],
        "nvcc_seconds": round(_build.build_info["seconds"], 2),
        "seconds": round(time.perf_counter() - t0, 2),
        "sources": [str(s.relative_to(ROOT)) for s in _build.sources()]}
    emit(with_clocks(report["build"], start))
    if args.out:
        (Path(args.out) / "nvcc.log").write_text(_build.build_info["log"])

    # ------------------------------------------------------------ helpers
    def time_ms(fn, iters: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def graph_ms(fn, calls: int, replays: int = 10) -> float:
        """Per-call time of `calls` calls of fn captured in one CUDA graph."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * calls)

    def compare_share(name: str, got, want, tol: float) -> float:
        """Max abs error as a share of want's largest magnitude; a failure above tol."""
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"{name}: bad shape {tuple(g.shape)} or non-finite values")
            return float("inf")
        share = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if not share <= tol:
            fail(f"{name}: max abs err {share:.3e} of the largest magnitude exceeds {tol:g}")
        return share

    def compare(name: str, got, want, tol: float) -> float:
        """Max abs error; records a failure unless |got-want| <= tol + tol*|want|."""
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"{name}: bad shape {tuple(g.shape)} or non-finite values")
            return float("inf")
        err = (g - w).abs()
        excess = float((err - (tol + tol * w.abs())).max())
        worst = float(err.max())
        if excess > 0:
            fail(f"{name}: max abs err {worst:.3e} exceeds tolerance {tol:g}")
        return worst

    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def bf16_model_check(arch: str, head_dim: int, seed: int) -> dict:
        """One train step's loss and gradients of reduced `arch` at its own `head_dim`
        in bf16 on the card (the 16-bit flash kernels, wgmma both ways) against the
        same bf16-rounded weights in float32 on the card (the scalar kernels): the
        losses' absolute difference and, for every parameter, the largest gradient
        difference as a share of the float32 gradient's largest magnitude and the
        difference's L2 norm as a share of the float32 gradient's."""
        base = get_config(arch).reduced(head_dim=head_dim)
        models = {"bfloat16": LM(dataclasses.replace(base, dtype="bfloat16"), device=dev).init(
            torch.Generator(device=dev).manual_seed(seed))}
        models["float32"] = LM(base, device=dev)
        models["float32"].load_state_dict(models["bfloat16"].state_dict())
        data = SyntheticLM(DataConfig(vocab=base.vocab, seq_len=S_BF16, global_batch=B_BF16,
                                      seed=seed, d_model=base.d_model))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
        losses, grads, variants = {}, {}, {}
        for name, model in models.items():
            params = dict(model.named_parameters())
            ops.reset_launch_counts()
            loss = model.loss(batch["tokens"], batch["labels"])
            grads[name] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            torch.cuda.synchronize()
            losses[name] = float(loss)
            variants[name] = {"forward": ops.flash_launches_by_variant(),
                              "backward": ops.flash_bwd_launches_by_variant()}
            want = "scalar" if name == "float32" else "sm90_wgmma"
            for way, by in variants[name].items():
                if not by[want] or any(n for kind, n in by.items() if kind != want):
                    fail(f"bf16 check {arch}@{head_dim} {name}: flash {way} launches {by}, "
                         f"expected all {want!r}")
        shares = {n: float((grads["bfloat16"][n].float() - g).abs().max())
                  / max(float(g.abs().max()), 1e-30) for n, g in grads["float32"].items()}
        rel_l2 = {n: float((grads["bfloat16"][n].float() - g).norm())
                  / max(float(g.norm()), 1e-30) for n, g in grads["float32"].items()}
        worst = sorted(shares, key=shares.get, reverse=True)[:3]
        worst_l2 = sorted(rel_l2, key=rel_l2.get, reverse=True)[:3]
        del models, grads
        torch.cuda.empty_cache()
        return {"config": base.name, "head_dim": head_dim, "seed": seed,
                "tokens": [B_BF16, S_BF16], "losses": losses,
                "loss_abs_diff": abs(losses["bfloat16"] - losses["float32"]),
                "grad_max_err_share": shares[worst[0]], "grad_rel_l2": rel_l2[worst_l2[0]],
                "worst_params": {n: shares[n] for n in worst},
                "worst_params_rel_l2": {n: rel_l2[n] for n in worst_l2},
                "flash_launches": variants}

    if args.bf16_seeds:
        start = probe()
        runs = [bf16_model_check(arch, head_dim, seed) for seed in range(args.bf16_seeds)
                for arch, head_dim in BF16_MODELS]
        emit(with_clocks({"phase": "bf16_seeds", "runs": runs, "worst": {
            f"{arch}@{head_dim}": {
                key: max(r[key] for r in runs if r["head_dim"] == head_dim)
                for key in ("loss_abs_diff", "grad_max_err_share", "grad_rel_l2")}
            for arch, head_dim in BF16_MODELS}}, start))
        sys.exit(1 if FAILURES else 4)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    # ------------------------------------------------------------ kernels
    start = probe()

    def flash_inputs(case, dtype, scale=1.0):
        B, Sq, Skv, H, KV, hd, _, _ = case
        return (randn((B, Sq, H, hd), dtype, scale),
                randn((B, Skv, KV, hd), dtype, scale),
                randn((B, Skv, KV, hd), dtype))

    def truth(q, k, v, **kw):
        """The plain version on the same values held in fp32: a 16-bit plain
        version rounds its scores to 16 bits, which is its error, not the kernel's."""
        return ops.mha_reference(q.float(), k.float(), v.float(), **kw)

    def expected_variant(dtype, hd, backward: bool = False) -> str:
        if dtype == torch.float32:
            return "scalar"
        wgmma = SM90_BWD_HEAD_DIMS if backward else SM90_HEAD_DIMS
        return "sm90_wgmma" if hd in wgmma else "mma_sync"

    def flash_case(case, dtype, tol, scale=1.0, softcap=0.0) -> dict:
        """One checked call; records the variant it launched and fails if that is
        not the one the split by shape names."""
        q, k, v = flash_inputs(case, dtype, scale)
        kw = dict(causal=case[6], window=case[7], softcap=softcap)
        before = ops.flash_launches_by_variant()
        got = ops.flash_attention(q, k, v, **kw)
        after = ops.flash_launches_by_variant()
        ran = [key for key in after if after[key] != before[key]]
        want_variant = expected_variant(dtype, case[5])
        if ran != [want_variant] or flash_mod.variant(dtype, case[5]) != want_variant:
            fail(f"flash {case} {dtype}: launched {ran}, expected [{want_variant!r}]")
        name = f"flash {case} {dtype}" + (f" softcap {softcap:g}" if softcap else "")
        err = compare(name, got, truth(q, k, v, **kw), tol)
        return {"case": list(case) + ([f"softcap {softcap:g}"] if softcap else []),
                "dtype": str(dtype), "variant": ran[0] if len(ran) == 1 else ran,
                "max_abs_err": err, "tol": tol}

    flash_cases = []
    for dtype, tol in ((torch.float32, TOL_FLASH_FP32),
                       (torch.bfloat16, TOL_16BIT), (torch.float16, TOL_16BIT)):
        for case in FLASH_CASES + FLASH_TILE_EDGE_CASES + FLASH_CROSS_CASES + FLASH_HD80_CASES:
            flash_cases.append(flash_case(case, dtype, tol))
        stol = TOL_FLASH_SOFTCAP if dtype == torch.float32 else TOL_16BIT
        for case in FLASH_SOFTCAP_CASES:
            flash_cases.append(flash_case(case, dtype, stol, scale=3.0, softcap=20.0))

    # Backward kernels, and the forward's lse, against the plain versions held in fp32
    def flash_bwd_case(case, dtype, scale=1.0, softcap=0.0) -> dict:
        fp32 = dtype == torch.float32
        tol, lse_tol = (TOL_BWD_FP32, TOL_LSE_FP32) if fp32 else (TOL_16BIT, TOL_LSE_16BIT)
        q, k, v = flash_inputs(case, dtype, scale)
        do = randn(q.shape, dtype)
        causal, window = case[6], case[7]
        o, lse = flash_mod.launch_forward(q, k, v, causal, window, softcap, with_lse=True)
        before = ops.flash_bwd_launches_by_variant()
        grads = flash_mod.launch_backward(q, k, v, o, lse, do, causal, window, softcap)
        after = ops.flash_bwd_launches_by_variant()
        ran = [key for key in after if after[key] != before[key]]
        want_variant = expected_variant(dtype, case[5], backward=True)
        if ran != [want_variant] or flash_mod.bwd_variant(dtype, case[5]) != want_variant:
            fail(f"flash backward {case} {dtype}: launched {ran}, expected [{want_variant!r}]")
        kw = dict(causal=causal, window=window, softcap=softcap)
        qf, kf, vf = q.float(), k.float(), v.float()
        o_ref = ops.mha_reference(qf, kf, vf, **kw)
        lse_ref = ops.flash_attention_lse_reference(qf, kf, **kw)
        want = ops.flash_attention_bwd_reference(qf, kf, vf, o_ref, lse_ref, do.float(), **kw)
        name = f"flash backward {case} {dtype}" + (f" softcap {softcap:g}" if softcap else "")
        errs = {"lse": compare_share(name + " lse", lse, lse_ref, lse_tol)}
        for gname, got, ref_ in zip(("dq", "dk", "dv"), grads, want):
            errs[gname] = compare_share(f"{name} {gname}", got, ref_, tol)
        worst = max(float((got.float() - ref_).abs().max()) for got, ref_ in zip(grads, want))
        del q, k, v, do, o, lse, grads, want, o_ref, lse_ref
        return {"case": list(case) + ([f"softcap {softcap:g}"] if softcap else []),
                "dtype": str(dtype), "variant": ran[0] if len(ran) == 1 else ran,
                "max_err_share": errs, "max_abs_err": worst, "tol": tol, "lse_tol": lse_tol}

    flash_bwd_cases = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for case in (FLASH_CASES + FLASH_TILE_EDGE_CASES + FLASH_BWD_EDGE_CASES
                     + FLASH_CROSS_CASES + FLASH_HD80_CASES):
            flash_bwd_cases.append(flash_bwd_case(case, dtype))
        for case in FLASH_SOFTCAP_CASES:
            flash_bwd_cases.append(flash_bwd_case(case, dtype, scale=3.0, softcap=20.0))

    # A call the wgmma kernel cannot take must raise, never run another variant:
    # q one element past a 16-byte boundary (the wrapper refuses it first, so the
    # C launcher is called directly) cannot be described by a tensor map.  Held at
    # head_dim 128, 256 and 80.
    lib = _build.load()

    def misaligned_q(case):
        q, k, v = flash_inputs(case, torch.bfloat16)
        q_off = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
        q_off.copy_(q)
        return q, k, v, q_off

    refusal = []
    for case in (FLASH_TILE_EDGE_CASES[0], FLASH_TILE_EDGE_CASES[4], FLASH_HD80_CASES[0]):
        q, k, v, q_off = misaligned_q(case)
        o = torch.full_like(q, float("nan"))
        torch.cuda.synchronize()
        code = lib.repro_flash_attention_fwd(
            q_off.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, case[0],
            case[1], case[2], case[3], case[4], case[5], *q_off.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], 1, 0, 0.0,
            _build.DTYPE_CODES[torch.bfloat16], 0, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        try:
            _build.check(code, "flash_attention")
            raised = ""
        except RuntimeError as exc:
            raised = str(exc)
        if code != -3 or not raised or not bool(torch.isnan(o).all()):
            fail(f"misaligned q {case}: launcher returned {code} (want -3, a refusal), "
                 f"raised {raised!r}, output touched: {not bool(torch.isnan(o).all())}")
        refusal.append({"case": list(case), "dtype": "torch.bfloat16", "q_offset_bytes": 2,
                        "code": code, "raised": raised})
        del q, k, v, q_off, o
    case = FLASH_TILE_EDGE_CASES[0]
    q, k, v, q_off = misaligned_q(case)

    # the same for the backward's wgmma kernel: its launcher refuses before it
    # launches anything, and dq, dk, dv stay untouched
    o, lse = flash_mod.launch_forward(q, k, v, True, 0, 0.0, with_lse=True)
    do = randn(q.shape, torch.bfloat16)
    grads = [torch.full_like(t, float("nan")) for t in (q, k, v)]
    delta, dq_acc = flash_mod._bwd_scratch("sm90_wgmma", q)
    call = _build.FlashBwdCall(
        q=q_off.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        dout=do.data_ptr(), lse=lse.data_ptr(), delta=delta.data_ptr(),
        dq_acc=dq_acc.data_ptr(), dq=grads[0].data_ptr(), dk=grads[1].data_ptr(),
        dv=grads[2].data_ptr(), stream=torch.cuda.current_stream().cuda_stream,
        B=case[0], Sq=case[1], Skv=case[2], H=case[3], KV=case[4], hd=case[5], causal=1,
        window=0, softcap=0.0, dtype=_build.DTYPE_CODES[torch.bfloat16], device=0)
    for name, t in zip(_build.FLASH_BWD_TENSORS, (q_off, k, v, o, do, *grads)):
        for i, part in enumerate(("sb", "ss", "sh")):
            setattr(call, f"{name}_{part}", t.stride(i))
    torch.cuda.synchronize()
    code = lib.repro_flash_attention_bwd(ctypes.addressof(call))
    torch.cuda.synchronize()
    try:
        _build.check(code, "flash_attention backward")
        raised = ""
    except RuntimeError as exc:
        raised = str(exc)
    untouched = all(bool(torch.isnan(t).all()) for t in grads)
    if code != -3 or not raised or not untouched:
        fail(f"misaligned q, backward: launcher returned {code} (want -3, a refusal), "
             f"raised {raised!r}, gradients untouched: {untouched}")
    bwd_refusal = {"case": list(case), "dtype": "torch.bfloat16", "q_offset_bytes": 2,
                   "code": code, "raised": raised}
    del q, k, v, q_off, o, lse, do, grads, delta, dq_acc

    rms_cases = []
    for dtype, tol in ((torch.float32, TOL_RMSNORM_FP32),
                       (torch.bfloat16, TOL_16BIT), (torch.float16, TOL_16BIT)):
        # past the row pipeline's edges: 1024 (the last row a lane group takes), 1032
        # and 1027 (the pipeline; 1027 no whole 16-byte packs, the scalar kernels),
        # 3072 / 6144 (gemma's, granite's), 16392 (past the pipeline's reach); lane
        # groups of 4..32 lanes with 1..8 packs a lane (8, 200, 520), odd row counts
        for shape in RMSNORM_SHAPES + [(3, 3584), (5, 7, 100), (2, 1027), (2, 1024),
                                       (3, 1032), (5, 3072), (3, 6144), (2, 16392),
                                       (9, 200), (3, 520), (5, 8), (7, 128)]:
            for wdtype in {dtype, torch.float32}:
                x = randn(shape, dtype)
                w = randn(shape[-1:], wdtype, 0.1) + 1
                err = compare(f"rmsnorm {shape} {dtype} w {wdtype}", ops.rmsnorm(x, w),
                              ops.rmsnorm_reference(x, w), tol)
                rms_cases.append({"shape": list(shape), "dtype": str(dtype),
                                  "w_dtype": str(wdtype), "max_abs_err": err,
                                  "tol": tol})

    rms_bwd_cases = []
    for dtype, tol in ((torch.float32, TOL_RMSNORM_BWD_FP32),
                       (torch.bfloat16, TOL_16BIT), (torch.float16, TOL_16BIT)):
        # (2, 1027): the row pipeline at 4 packs a thread; (2, 2051): past its reach,
        # the block-per-row kernel
        for shape in RMSNORM_SHAPES + [(3, 3584), (5, 7, 100), (2, 1027), (2, 2051),
                                       (8192, 3584)]:
            for wdtype in {dtype, torch.float32}:
                x = randn(shape, dtype)
                w = randn(shape[-1:], wdtype, 0.1) + 1
                dy = randn(shape, dtype)
                dx, dw = rms_mod.launch_backward(
                    x, w, dy, 1e-6, 0, _build.DTYPE_CODES[dtype], _build.DTYPE_CODES[wdtype])
                dx_ref, dw_ref = ops.rmsnorm_bwd_reference(x.float(), w.float(), dy.float())
                name = f"rmsnorm backward {shape} {dtype} w {wdtype}"
                rms_bwd_cases.append({
                    "shape": list(shape), "dtype": str(dtype), "w_dtype": str(wdtype),
                    "max_err_share": {"dx": compare_share(name + " dx", dx, dx_ref, tol),
                                      "dw": compare_share(name + " dw", dw, dw_ref, tol)},
                    "max_abs_err": max(float((dx.float() - dx_ref).abs().max()),
                                       float((dw.float() - dw_ref).abs().max())),
                    "tol": tol})
                del x, w, dy, dx, dw, dx_ref, dw_ref

    # the serving path's own shapes, bf16
    cfg = get_config("qwen2_7b")
    B_REQ, S_REQ, GEN_STEPS, CACHE_EXTRA = 4, 2048, 16, 32
    B_TRAIN, S_TRAIN = 2, 4096   # TRAIN_4K's length; its global batch of 256 cut to 2
    TRAIN_LAYERS = 8
    ZAMBA_TRAIN_LAYERS = 6   # two of zamba2's (mamba, mamba, shared_attn) cycles
    DYNAMIC_STEPS = 24       # train_dynamic: events at steps 6, 12 and 18
    # launch_train: the launcher's own command line, zamba2-2.7b at full width and depth
    B_LAUNCH, S_LAUNCH, LAUNCH_STEPS = 8, 256, 8
    LAUNCH_ARGV = ["--arch", "zamba2_2p7b", "--plan", "auto", "--steps", str(LAUNCH_STEPS),
                   "--global-batch", str(B_LAUNCH), "--seq", str(S_LAUNCH)]
    # launch_reduced: the North star's command as ROADMAP gives it (the launcher's
    # default global batch and sequence, B_LAUNCH x S_LAUNCH)
    REDUCED_ARGV = ["--arch", "qwen2_7b", "--reduced", "--plan", "auto", "--steps",
                    str(LAUNCH_STEPS)]
    # pipeline: qwen2-7b's decoder layers at full width, PIPE_LAYERS of them, through
    # pipeline_forward on a one-rank "pipe" mesh, PIPE_M microbatches of 1 x PIPE_SEQ
    PIPE_LAYERS, PIPE_M, PIPE_SEQ = 4, 4, 2048
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    bf16 = torch.bfloat16

    def visible_pairs(Sq, Skv, causal, window):
        qpos = np.arange(Sq)[:, None] + (Skv - Sq)
        kpos = np.arange(Skv)[None, :]
        m = np.ones((Sq, Skv), bool)
        if causal:
            m &= qpos >= kpos
        if window:
            m &= qpos - kpos < window
        return int(m.sum())

    def window_mask(Sq, Skv, window):
        """The causal mask with a window as the boolean (Sq, Skv) mask SDPA takes."""
        qpos = torch.arange(Sq, device=dev)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=dev)[None, :]
        return (qpos >= kpos) & (qpos - kpos < window)

    def sdpa(q, k, v, causal, mask=None):
        """One library call computing the same attention (a yardstick only): causal
        or not, or under an explicit boolean mask where a window bites (SDPA takes
        no window of its own)."""
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kw = dict(is_causal=causal) if mask is None else dict(attn_mask=mask)
        try:
            call = lambda: F.scaled_dot_product_attention(   # noqa: E731
                qt, kt, vt, enable_gqa=True, **kw)
            call()
        except TypeError:   # an older torch without enable_gqa: repeat k/v beforehand
            g = q.shape[2] // k.shape[2]
            kr, vr = (t.repeat_interleave(g, dim=1) for t in (kt, vt))
            call = lambda: F.scaled_dot_product_attention(qt, kr, vr, **kw)  # noqa: E731
        return call

    def timed_flash(case, entry, dtype=None) -> dict:
        """The forward at one case (bf16 unless given): ms, the plain version's,
        SDPA's and the bound.  Where the window bites (a query would see a key
        outside it), SDPA is given the window as an explicit boolean mask
        (`library_call` says which)."""
        B_, Sq_, Skv_, H_, KV_, hd_, causal_, window_ = case
        dtype = dtype or bf16
        q, k, v = flash_inputs(case, dtype)
        kw = dict(causal=causal_, window=window_)
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw), 20)
        plain_ms = time_ms(lambda: ops.mha_reference(q, k, v, **kw), 3, 1)
        same = visible_pairs(Sq_, Skv_, causal_, window_) == visible_pairs(Sq_, Skv_, causal_, 0)
        mask = None if same else window_mask(Sq_, Skv_, window_)
        library_ms = time_ms(sdpa(q, k, v, causal_, mask), 20)
        flops = 4.0 * hd_ * visible_pairs(Sq_, Skv_, causal_, window_) * B_ * H_
        peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_TENSOR_16BIT_FLOPS
        bounds = {"operations": flops / peak * 1e3,
                  "bytes": q.element_size() * (2 * q.numel() + k.numel() + v.numel())
                  / PEAK_BYTES_PER_S * 1e3}
        del q, k, v, mask
        return {"case": list(case), "variant": entry["variant"],
                "max_abs_err": entry["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "library_call": "sdpa" if same else "sdpa_bool_mask",
                "bound_ms": max(bounds.values()),
                "bound_by": max(bounds, key=bounds.get),
                "tflops": flops / (ms * 1e-3) / 1e12}

    main_case = (B_REQ, S_REQ, S_REQ, H, KV, hd, cfg.causal, 0)
    main_entry = flash_case(main_case, bf16, TOL_16BIT)
    main_timed = timed_flash(main_case, main_entry)
    ragged = (1, S_REQ + 1, S_REQ + 1, H, KV, hd, cfg.causal, 0)
    flash_cases += [main_entry, flash_case(ragged, bf16, TOL_16BIT)]

    def path_shapes(c, prompt: int) -> tuple[list, list]:
        """The flash cases and RMSNorm (rows, width) shapes that serving config c
        gives the kernels in a prefill of B_REQ x prompt tokens and a decode step:
        causal self-attention (windowed in zamba2's shared block); the block norms;
        q/k-norm per head; Mamba2's gated norm over its expanded width;
        cross-attention to the memory (no mask) at prefill and decode; the
        encoder's attention and norms over the audio frames."""
        H_, KV_, hd_, d_ = c.n_heads, c.n_kv_heads, c.hd, c.d_model
        flash = []
        if {"attn", "cross_attn"} & set(c.pattern):
            flash.append((B_REQ, prompt, prompt, H_, KV_, hd_, c.causal, 0))
        if "shared_attn" in c.pattern:
            flash.append((B_REQ, prompt, prompt, H_, KV_, hd_, True, c.attn_window))
        rms = [(B_REQ * prompt, d_), (B_REQ, d_)]
        if "mamba" in c.pattern:
            e = c.ssm_expand * d_
            rms += [(B_REQ * prompt, e), (B_REQ, e)]
        if c.qk_norm:
            rms += [(rows * heads, hd_) for rows in (B_REQ * prompt, B_REQ)
                    for heads in (H_, KV_)]
        if c.encoder_layers or c.cross_attn_every:
            mem = c.audio_seq if c.encoder_layers else c.vision_seq
            flash += [(B_REQ, sq, mem, H_, KV_, hd_, False, 0) for sq in (prompt, 1)]
        if c.encoder_layers:
            flash.append((B_REQ, c.audio_seq, c.audio_seq, H_, KV_, hd_, False, 0))
            rms.append((B_REQ * c.audio_seq, d_))
        return flash, rms

    def timed_rmsnorm(shape, eps, name: str) -> dict:
        """The bf16 forward at one (rows, d) shape, checked, then timed in turns with
        F.rms_norm, three readings each (one reading of each, ~1 us apart, could not
        tell them apart), beside the plain version's time and the bound; then both
        device-only, replayed from a CUDA graph (a call of a few rows is bound by the
        host's launch path, which the graph leaves out)."""
        rows_, d_ = shape
        x = randn(shape, bf16)
        w = randn((d_,), bf16, 0.1) + 1
        err = compare(name, ops.rmsnorm(x, w, eps=eps), ops.rmsnorm_reference(x, w, eps),
                      TOL_16BIT)
        rms_cases.append({"shape": list(shape), "dtype": str(bf16), "w_dtype": str(bf16),
                          "max_abs_err": err, "tol": TOL_16BIT})
        iters = 50 if rows_ > 100 else 200
        bounds = {"bytes": 2.0 * (2 * x.numel() + w.numel()) / PEAK_BYTES_PER_S * 1e3,
                  "operations": 4.0 * x.numel() / PEAK_FP32_FLOPS * 1e3}
        ms_readings, lib_readings = [], []
        for _ in range(3):
            ms_readings.append(time_ms(lambda: ops.rmsnorm(x, w, eps=eps), iters))
            lib_readings.append(time_ms(lambda: F.rms_norm(x, (d_,), w, eps), iters))
        out = {"shape": [rows_, d_], "max_abs_err": err,
               "ms": float(np.median(ms_readings)), "ms_readings": ms_readings,
               "plain_ms": time_ms(lambda: ops.rmsnorm_reference(x, w, eps), iters),
               "library_ms": float(np.median(lib_readings)),
               "library_ms_readings": lib_readings,
               "bound_ms": max(bounds.values()), "bound_by": max(bounds, key=bounds.get)}
        calls = 20 if x.numel() > 1 << 22 else 200
        out["graph_ms"] = graph_ms(lambda: ops.rmsnorm(x, w, eps=eps), calls)
        out["library_graph_ms"] = graph_ms(lambda: F.rms_norm(x, (d_,), w, eps), calls)
        out["no_slower_than_library"] = {"events": out["ms"] <= out["library_ms"],
                                         "graph": out["graph_ms"] <= out["library_graph_ms"]}
        del x, w
        torch.cuda.empty_cache()
        return out

    # every shape the families' serving paths give the kernels at full width, and
    # those of the dense families not served here, bf16: the flash forward, lse and
    # backward checked (with the variant each launched), the forward timed beside
    # SDPA; the RMSNorm forward checked and timed beside F.rms_norm
    path_timed: dict = {}
    path_rms_timed: dict = {}
    path_archs = [(phase, arch, prompt) for phase, arch, prompt, _ in FAMILY_SERVES]
    path_archs += [(arch, arch, prompt) for arch, prompt in SHAPE_ONLY]
    for phase, arch, prompt in path_archs:
        pcfg = get_config(arch)
        p_flash, p_rms = path_shapes(pcfg, prompt)
        for case in p_flash:
            entry = {"path": phase, **flash_case(case, bf16, TOL_16BIT)}
            flash_cases.append(entry)
            flash_bwd_cases.append({"path": phase, **flash_bwd_case(case, bf16)})
            torch.cuda.empty_cache()
            path_timed.setdefault(phase, []).append(timed_flash(case, entry))
        for shape in p_rms:
            path_rms_timed.setdefault(phase, []).append(
                timed_rmsnorm(shape, pcfg.norm_eps, f"rmsnorm {shape} bf16 ({phase})"))
        torch.cuda.empty_cache()

    # zamba2's shared attention where its window bites (6144 tokens, a 4096-token
    # window), bf16, held against the plain version and timed beside SDPA given the
    # window as a boolean mask
    zcfg = get_config("zamba2_2p7b")
    window_case = (1, 6144, 6144, zcfg.n_heads, zcfg.n_kv_heads, zcfg.hd, True,
                   zcfg.attn_window)
    window_entry = {"path": "serve_zamba", **flash_case(window_case, bf16, TOL_16BIT)}
    flash_cases.append(window_entry)
    window_timed = timed_flash(window_case, window_entry)
    torch.cuda.empty_cache()

    # A head_dim compiled into neither direction is refused everywhere, and nothing
    # runs: the autograd wrapper, the Python launchers of both directions, and the C
    # entries (code -1, outputs left as they were).
    xcase = (1, 128, 128, 4, 4, UNCOMPILED_HEAD_DIM, True, 0)
    q, k, v = flash_inputs(xcase, bf16)
    x_out = [torch.full_like(q, float("nan")) for _ in range(4)]   # o, then dq, dk, dv
    x_lse = torch.zeros((1, 4, 128), dtype=torch.float32, device=dev)
    x_scratch = torch.zeros((1, 4, 128), dtype=torch.float32, device=dev)
    x_codes = {}

    def c_forward():
        x_codes["c_forward"] = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), x_out[0].data_ptr(), None, *xcase[:6],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *x_out[0].stride()[:3], 1, 0,
            0.0, _build.DTYPE_CODES[bf16], 0, torch.cuda.current_stream().cuda_stream)
        _build.check(x_codes["c_forward"], "flash_attention")

    def c_backward():
        call = _build.FlashBwdCall(
            q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=q.data_ptr(),
            dout=q.data_ptr(), lse=x_lse.data_ptr(), delta=x_scratch.data_ptr(),
            dq_acc=None, dq=x_out[1].data_ptr(), dk=x_out[2].data_ptr(),
            dv=x_out[3].data_ptr(), stream=torch.cuda.current_stream().cuda_stream,
            B=1, Sq=128, Skv=128, H=4, KV=4, hd=UNCOMPILED_HEAD_DIM, causal=1, window=0,
            softcap=0.0, dtype=_build.DTYPE_CODES[bf16], device=0)
        for name, t_ in zip(_build.FLASH_BWD_TENSORS, (q, k, v, q, q, *x_out[1:])):
            for i, part in enumerate(("sb", "ss", "sh")):
                setattr(call, f"{name}_{part}", t_.stride(i))
        x_codes["c_backward"] = lib.repro_flash_attention_bwd(ctypes.addressof(call))
        _build.check(x_codes["c_backward"], "flash_attention backward")

    before = (ops.flash_launches_by_variant(), ops.flash_bwd_launches_by_variant())
    raised = {}
    for how, call in (
            ("autograd", lambda: ops.flash_attention(q.detach().requires_grad_(), k, v,
                                                     causal=True)),
            ("forward_launcher", lambda: flash_mod.launch_forward(
                q, k, v, True, 0, 0.0, with_lse=True)),
            ("backward_launcher", lambda: flash_mod.launch_backward(
                q, k, v, q, x_lse, q, True, 0, 0.0)),
            ("c_forward", c_forward), ("c_backward", c_backward)):
        try:
            call()
            raised[how] = ""
        except (ValueError, RuntimeError) as exc:
            raised[how] = str(exc)
    torch.cuda.synchronize()
    after = (ops.flash_launches_by_variant(), ops.flash_bwd_launches_by_variant())
    untouched = all(bool(torch.isnan(t_).all()) for t_ in x_out)
    if (not all(raised.values()) or after != before or not untouched
            or set(x_codes.values()) != {-1}):
        fail(f"flash at head_dim {UNCOMPILED_HEAD_DIM}: raised {raised}, C codes {x_codes} "
             f"(want -1), launches {before} -> {after}, outputs untouched {untouched}")
    uncompiled = {"head_dim": UNCOMPILED_HEAD_DIM, "dtype": str(bf16), "raised": raised,
                  "c_codes": x_codes, "outputs_untouched": untouched}
    del q, k, v, x_out, x_lse, x_scratch

    def timed_backward(case, dtype=None) -> dict:
        """The backward at one training case (bf16 unless given): held against the
        plain version (flash_bwd_case), then timed beside the plain version, the
        backward of SDPA (given the window as a boolean mask where it bites) and the
        bound."""
        B_, Sq_, Skv_, H_, KV_, hd_, causal_, window_ = case
        dtype = dtype or bf16
        entry = flash_bwd_case(case, dtype)
        flash_bwd_cases.append(entry)
        torch.cuda.empty_cache()
        q, k, v = flash_inputs(case, dtype)
        do = randn(q.shape, dtype)
        o, lse = flash_mod.launch_forward(q, k, v, causal_, window_, 0.0, with_lse=True)
        ms = time_ms(lambda: flash_mod.launch_backward(
            q, k, v, o, lse, do, causal_, window_, 0.0), 10)
        plain_ms = time_ms(lambda: ops.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=causal_, window=window_), 2, 1)
        torch.cuda.empty_cache()
        pairs = visible_pairs(Sq_, Skv_, causal_, window_)
        same = pairs == visible_pairs(Sq_, Skv_, causal_, 0)
        kw = dict(is_causal=causal_) if same else dict(attn_mask=window_mask(Sq_, Skv_,
                                                                              window_))
        leaves = [t_.transpose(1, 2).detach().requires_grad_() for t_ in (q, k, v)]
        try:
            out = F.scaled_dot_product_attention(*leaves, enable_gqa=True, **kw)
        except TypeError:   # an older torch without enable_gqa
            out = F.scaled_dot_product_attention(
                leaves[0], *(t_.repeat_interleave(H_ // KV_, dim=1) for t_ in leaves[1:]),
                **kw)
        dot = do.transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(out, leaves, dot,
                                                         retain_graph=True), 10)
        flops = 10.0 * hd_ * pairs * B_ * H_
        nbytes = q.element_size() * (3 * q.numel() + 2 * (k.numel() + v.numel())
                                     + 2 * o.numel()) + 4.0 * lse.numel()
        peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_TENSOR_16BIT_FLOPS
        bounds = {"operations": flops / peak * 1e3,
                  "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
        del q, k, v, do, o, lse, leaves, out, dot, kw
        torch.cuda.empty_cache()
        return {"case": list(case), "variant": entry["variant"],
                "max_abs_err": entry["max_abs_err"], "max_err_share": entry["max_err_share"],
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "library_call": "sdpa_backward" if same else "sdpa_bool_mask_backward",
                "bound_ms": max(bounds.values()), "bound_by": max(bounds, key=bounds.get),
                "share_of_bound": max(bounds.values()) / ms,
                "tflops": flops / (ms * 1e-3) / 1e12}

    from torch.profiler import ProfilerActivity, profile

    def repeat_and_kernels(case) -> tuple[dict, dict]:
        """Two backward calls on the same bf16 inputs: dk and dv bit for bit (summed
        in registers in a fixed order), dq within tolerance (where the wgmma kernel
        adds it up with TMA reduce-adds, in no fixed order); then the device time of
        each kernel one call launches."""
        causal_, window_ = case[6], case[7]
        q, k, v = flash_inputs(case, bf16)
        do = randn(q.shape, bf16)
        o, lse = flash_mod.launch_forward(q, k, v, causal_, window_, 0.0, with_lse=True)
        first = flash_mod.launch_backward(q, k, v, o, lse, do, causal_, window_, 0.0)
        again = flash_mod.launch_backward(q, k, v, o, lse, do, causal_, window_, 0.0)
        repeat = {"case": list(case), "dk_bit_exact": bool(torch.equal(first[1], again[1])),
                  "dv_bit_exact": bool(torch.equal(first[2], again[2])),
                  "dq_bit_exact": bool(torch.equal(first[0], again[0])),
                  "dq_max_err_share": compare_share(f"flash backward repeat {case} dq",
                                                    again[0], first[0], TOL_16BIT)}
        if not (repeat["dk_bit_exact"] and repeat["dv_bit_exact"]):
            fail(f"flash backward repeat at {case}: {repeat}")
        del first, again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_mod.launch_backward(q, k, v, o, lse, do, causal_, window_, 0.0)
            torch.cuda.synchronize()
        kernel_ms: dict = {}
        for e in prof.events():
            name = re.search(r"flash_bwd\w*", e.name)
            if e.device_type == torch.autograd.DeviceType.CUDA and name:
                kernel_ms[name.group()] = (kernel_ms.get(name.group(), 0.0)
                                           + e.time_range.elapsed_us() / 1e3)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
        return repeat, kernel_ms

    # the training path's attention shape, bf16: the backward checked and timed beside
    # SDPA's, then the forward timed with and without lse, two backward calls
    # compared, and the device time of each kernel a backward call launches
    train_case = (B_TRAIN, S_TRAIN, S_TRAIN, H, KV, hd, cfg.causal, 0)
    train_bwd = timed_backward(train_case)
    q, k, v = flash_inputs(train_case, bf16)
    do = randn(q.shape, bf16)
    o, lse = flash_mod.launch_forward(q, k, v, cfg.causal, 0, 0.0, with_lse=True)
    fwd_train = {
        "ms_with_lse": time_ms(lambda: flash_mod.launch_forward(
            q, k, v, cfg.causal, 0, 0.0, with_lse=True), 20),
        "ms_without_lse": time_ms(lambda: flash_mod.launch_forward(
            q, k, v, cfg.causal, 0, 0.0, with_lse=False), 20)}
    fwd_train["bound_ms"] = max(
        4.0 * hd * visible_pairs(S_TRAIN, S_TRAIN, cfg.causal, 0) * B_TRAIN * H
        / PEAK_TENSOR_16BIT_FLOPS * 1e3,
        (2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4.0 * lse.numel())
        / PEAK_BYTES_PER_S * 1e3)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    bwd_repeat, bwd_kernel_ms = repeat_and_kernels(train_case)

    # the backward at zamba2's training shape (head_dim 80, its window not biting at
    # 4096 tokens), which train_zamba runs, and at gemma's (head_dim 256), which no main
    # path trains, both on the wgmma kernel: held, timed, repeated
    zamba_train_case = (B_TRAIN, S_TRAIN, S_TRAIN, zcfg.n_heads, zcfg.n_kv_heads, zcfg.hd,
                        True, zcfg.attn_window)
    gcfg = get_config("gemma_7b")
    gemma_train_case = (B_TRAIN, S_TRAIN, S_TRAIN, gcfg.n_heads, gcfg.n_kv_heads, gcfg.hd,
                        True, 0)
    bwd_timed = {}
    for key, case in (("head_dim_80", zamba_train_case), ("head_dim_256", gemma_train_case)):
        bwd_timed[key] = timed_backward(case)
        bwd_timed[key]["repeat"], bwd_timed[key]["kernel_ms"] = repeat_and_kernels(case)
    # the mma.sync passes, at the head_dims they keep (no main path runs them): 2 x
    # 2048 tokens, 16 heads
    bwd_mma = {f"head_dim_{hd_}": timed_backward((B_TRAIN, 2048, 2048, 16, 16, hd_, True, 0))
               for hd_ in (32, 16)}

    # the launcher's training path (launch_train: zamba2-2.7b at full depth, B_LAUNCH x
    # S_LAUNCH tokens, its 4096-token window not biting), bf16: the flash forward held
    # and timed beside SDPA, the backward held and timed beside SDPA's, the RMSNorm
    # forward at its widths (d_model, Mamba2's gated norm) held and timed
    launch_case = (B_LAUNCH, S_LAUNCH, S_LAUNCH, zcfg.n_heads, zcfg.n_kv_heads, zcfg.hd,
                   True, zcfg.attn_window)
    launch_entry = {"path": "launch_train", **flash_case(launch_case, bf16, TOL_16BIT)}
    flash_cases.append(launch_entry)
    path_timed["launch_train"] = [timed_flash(launch_case, launch_entry)]
    launch_bwd = {"path": "launch_train", **timed_backward(launch_case)}
    # launch_reduced's shape (the reduced float32 qwen2-7b, B_LAUNCH x S_LAUNCH): the
    # scalar fp32 kernels, forward and backward
    rcfg = get_config("qwen2_7b").reduced()
    reduced_case = (B_LAUNCH, S_LAUNCH, S_LAUNCH, rcfg.n_heads, rcfg.n_kv_heads, rcfg.hd,
                    rcfg.causal, 0)
    reduced_entry = {"path": "launch_reduced",
                     **flash_case(reduced_case, torch.float32, TOL_FLASH_FP32)}
    flash_cases.append(reduced_entry)
    reduced_fwd = timed_flash(reduced_case, reduced_entry, torch.float32)
    reduced_bwd = {"path": "launch_reduced", **timed_backward(reduced_case, torch.float32)}
    # the pipeline phase's shapes (qwen2-7b's layers, microbatches of 1 x PIPE_SEQ),
    # bf16: the flash forward held, its backward held and timed, the RMSNorm forward
    # held and timed and its backward held
    pipe_case = (1, PIPE_SEQ, PIPE_SEQ, H, KV, hd, cfg.causal, 0)
    flash_cases.append({"path": "pipeline", **flash_case(pipe_case, bf16, TOL_16BIT)})
    pipe_bwd = {"path": "pipeline", **timed_backward(pipe_case)}
    path_rms_timed["pipeline"] = [timed_rmsnorm((PIPE_SEQ, d), cfg.norm_eps,
                                                f"rmsnorm ({PIPE_SEQ},{d}) bf16 (pipeline)")]
    zamba_widths = (zcfg.d_model, zcfg.ssm_expand * zcfg.d_model)
    path_rms_timed["launch_train"] = [
        timed_rmsnorm((B_LAUNCH * S_LAUNCH, w_), zcfg.norm_eps,
                      f"rmsnorm ({B_LAUNCH * S_LAUNCH},{w_}) bf16 (launch_train)")
        for w_ in zamba_widths]
    # the RMSNorm backward at zamba2's widths on its training paths, bf16:
    # launch_train's B_LAUNCH x S_LAUNCH rows and train_zamba's / train_dynamic's
    # B_TRAIN x S_TRAIN; and the pipeline phase's PIPE_SEQ rows of qwen2-7b's d_model
    rms_bwd_path_cases = [(r_, w_, zcfg.norm_eps, "zamba2 training")
                          for r_ in (B_LAUNCH * S_LAUNCH, B_TRAIN * S_TRAIN)
                          for w_ in zamba_widths]
    rms_bwd_path_cases.append((PIPE_SEQ, d, cfg.norm_eps, "pipeline"))
    for rows_, w_, eps_, label in rms_bwd_path_cases:
        x, dy = randn((rows_, w_), bf16), randn((rows_, w_), bf16)
        w = randn((w_,), bf16, 0.1) + 1
        dx, dw = rms_mod.launch_backward(x, w, dy, eps_, 0,
                                         _build.DTYPE_CODES[bf16], _build.DTYPE_CODES[bf16])
        dx_ref, dw_ref = ops.rmsnorm_bwd_reference(x.float(), w.float(), dy.float(), eps_)
        name = f"rmsnorm backward ({rows_}, {w_}) bf16 ({label})"
        rms_bwd_cases.append({
            "shape": [rows_, w_], "dtype": str(bf16), "w_dtype": str(bf16),
            "max_err_share": {"dx": compare_share(name + " dx", dx, dx_ref, TOL_16BIT),
                              "dw": compare_share(name + " dw", dw, dw_ref, TOL_16BIT)},
            "max_abs_err": max(float((dx.float() - dx_ref).abs().max()),
                               float((dw.float() - dw_ref).abs().max())),
            "tol": TOL_16BIT})
        del x, dy, w, dx, dw, dx_ref, dw_ref
    torch.cuda.empty_cache()

    # the serving path's two shapes (prefill, decode step)
    rms_shapes = {rows: timed_rmsnorm((rows, d), cfg.norm_eps, f"rmsnorm ({rows},{d}) bf16")
                  for rows in (B_REQ * S_REQ, B_REQ)}

    # RMSNorm backward at the training path's shape (2 x 4096 rows of d_model), bf16
    rows = B_TRAIN * S_TRAIN
    x, dy = randn((rows, d), bf16), randn((rows, d), bf16)
    w = randn((d,), bf16, 0.1) + 1
    bcodes = (0, _build.DTYPE_CODES[bf16], _build.DTYPE_CODES[bf16])
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    y_lib = F.rms_norm(xr, (d,), wr, cfg.norm_eps)
    rms_bwd_bounds = {"bytes": 2.0 * (3 * x.numel() + 2 * w.numel()) / PEAK_BYTES_PER_S * 1e3,
                      "operations": 10.0 * x.numel() / PEAK_FP32_FLOPS * 1e3}
    # the kernel and its library yardstick (autograd of F.rms_norm) in turns, three
    # readings each: the yardstick read 0.134 ms in one run and 0.41-0.45 in others
    rms_bwd_ms, rms_bwd_lib_ms = [], []
    for _ in range(3):
        rms_bwd_ms.append(time_ms(lambda: rms_mod.launch_backward(
            x, w, dy, cfg.norm_eps, *bcodes), 50))
        rms_bwd_lib_ms.append(time_ms(lambda: torch.autograd.grad(
            y_lib, (xr, wr), dy, retain_graph=True), 50))
    # which kernels the yardstick launches (one profiled call)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(y_lib, (xr, wr), dy, retain_graph=True)
        torch.cuda.synchronize()
    lib_kernels = sorted({e.name for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA})
    rms_bwd_entry = {
        "shape": [rows, d],
        "ms": float(np.median(rms_bwd_ms)), "ms_readings": rms_bwd_ms,
        "plain_ms": time_ms(lambda: ops.rmsnorm_bwd_reference(x, w, dy, cfg.norm_eps), 20),
        "library_ms": float(np.median(rms_bwd_lib_ms)),
        "library_ms_readings": rms_bwd_lib_ms, "library_kernels": lib_kernels,
        "bound_ms": max(rms_bwd_bounds.values()),
        "bound_by": max(rms_bwd_bounds, key=rms_bwd_bounds.get)}
    first = rms_mod.launch_backward(x, w, dy, cfg.norm_eps, *bcodes)
    again = rms_mod.launch_backward(x, w, dy, cfg.norm_eps, *bcodes)
    rms_bwd_entry["repeat_bit_exact"] = {"dx": bool(torch.equal(first[0], again[0])),
                                         "dw": bool(torch.equal(first[1], again[1]))}
    if not all(rms_bwd_entry["repeat_bit_exact"].values()):
        fail(f"rmsnorm backward repeat: {rms_bwd_entry['repeat_bit_exact']}")
    del first, again
    main_rms_bwd = next(
        c for c in rms_bwd_cases
        if c["shape"] == [rows, d] and c["dtype"] == str(bf16) and c["w_dtype"] == str(bf16))
    rms_bwd_entry["max_abs_err"] = main_rms_bwd["max_abs_err"]
    rms_bwd_entry["max_err_share"] = main_rms_bwd["max_err_share"]
    del x, dy, w, xr, wr, y_lib
    torch.cuda.empty_cache()

    kernels = {
        "rmsnorm": {
            "name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:38",
            "launches": 0, "dtype": "bfloat16",
            **rms_shapes[B_REQ * S_REQ],
            "tol": TOL_16BIT,
            "worst_err_all_cases": max(c["max_abs_err"] for c in rms_cases),
            "decode_shape": rms_shapes[B_REQ], "path_shapes": path_rms_timed},
        "flash_attention": {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:155",
            "launches": 0, "dtype": "bfloat16",
            "shape": {"q": [B_REQ, S_REQ, H, hd], "kv": [B_REQ, S_REQ, KV, hd],
                      "causal": cfg.causal},
            "tol": TOL_16BIT,
            **{key: main_timed[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "tflops")},
            "variant": main_entry["variant"], "launches_by_variant": {},
            "worst_err_all_cases": max(c["max_abs_err"] for c in flash_cases),
            "train_shape": {"q": [B_TRAIN, S_TRAIN, H, hd], **fwd_train},
            # gemma-7b's prefill shape: the wgmma kernel's head_dim-256 layout
            "head_dim_256": path_timed["serve_gemma"][0],
            # zamba2-2.7b's: its 64- and 16-column boxes, and where its window bites
            "head_dim_80": {**path_timed["serve_zamba"][0], "window_bites": window_timed},
            "path_shapes": path_timed},
        "rmsnorm_bwd": {
            "name": "rmsnorm_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:38",
            "launches": 0, "dtype": "bfloat16", **rms_bwd_entry,
            "tol": TOL_16BIT, "err_is": "share of the largest magnitude (dx, dw)",
            "worst_err_all_cases": max(max(c["max_err_share"].values())
                                       for c in rms_bwd_cases)},
        "flash_attention_bwd": {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:102",
            "launches": 0, "dtype": "bfloat16",
            "shape": {"q": [B_TRAIN, S_TRAIN, H, hd], "kv": [B_TRAIN, S_TRAIN, KV, hd],
                      "causal": cfg.causal},
            "tol": TOL_16BIT, "err_is": "share of the largest magnitude (lse, dq, dk, dv)",
            **{key: train_bwd[key]
               for key in ("max_abs_err", "max_err_share", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms", "tflops", "variant")},
            "share_of_bound": train_bwd["share_of_bound"],
            "launches_by_variant": {},
            "repeat": bwd_repeat, "kernel_ms": bwd_kernel_ms,
            # zamba2-2.7b's training shape (train_zamba) and gemma-7b's, each with its
            # repeat check and kernel times
            "head_dim_80": bwd_timed["head_dim_80"], "head_dim_256": bwd_timed["head_dim_256"],
            "path_shapes": {"launch_train": launch_bwd, "pipeline": pipe_bwd},
            "worst_err_all_cases": max(max(c["max_err_share"].values())
                                       for c in flash_bwd_cases)},
        # the mma.sync backward passes, at the 16-bit head_dims 32 and 16 they keep;
        # no main path launches them
        "flash_attention_bwd_mma_sync": {
            "name": "flash_attention_bwd_mma_sync", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:102",
            "launches": 0, "dtype": "bfloat16",
            "shape": {"q": [B_TRAIN, 2048, 16, 32], "kv": [B_TRAIN, 2048, 16, 32],
                      "causal": True},
            "tol": TOL_16BIT, "err_is": "share of the largest magnitude (lse, dq, dk, dv)",
            **{key: bwd_mma["head_dim_32"][key]
               for key in ("max_abs_err", "max_err_share", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms", "tflops", "variant")},
            "launches_by_variant": {}, "head_dim_16": bwd_mma["head_dim_16"]},
        # the scalar fp32 kernels, at launch_reduced's shape (its only main path)
        "flash_attention_scalar": {
            "name": "flash_attention_scalar", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:155",
            "launches": 0, "dtype": "float32",
            "shape": {"q": [B_LAUNCH, S_LAUNCH, rcfg.n_heads, rcfg.hd],
                      "kv": [B_LAUNCH, S_LAUNCH, rcfg.n_kv_heads, rcfg.hd],
                      "causal": rcfg.causal},
            "tol": TOL_FLASH_FP32,
            **{key: reduced_fwd[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "tflops",
                                                 "variant")},
            "launches_by_variant": {}},
        "flash_attention_bwd_scalar": {
            "name": "flash_attention_bwd_scalar", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:102",
            "launches": 0, "dtype": "float32",
            "shape": {"q": [B_LAUNCH, S_LAUNCH, rcfg.n_heads, rcfg.hd],
                      "kv": [B_LAUNCH, S_LAUNCH, rcfg.n_kv_heads, rcfg.hd],
                      "causal": rcfg.causal},
            "tol": TOL_BWD_FP32, "err_is": "share of the largest magnitude (lse, dq, dk, dv)",
            **{key: reduced_bwd[key]
               for key in ("max_abs_err", "max_err_share", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms", "tflops", "variant")},
            "launches_by_variant": {}},
    }
    report["kernels_checked"] = {
        "phase": "kernels", "ok": not FAILURES,
        "tolerances": {"flash_fp32": TOL_FLASH_FP32, "flash_softcap_fp32": TOL_FLASH_SOFTCAP,
                       "rmsnorm_fp32": TOL_RMSNORM_FP32, "16bit": TOL_16BIT,
                       "bwd_fp32_share": TOL_BWD_FP32,
                       "rmsnorm_bwd_fp32_share": TOL_RMSNORM_BWD_FP32,
                       "lse_fp32_share": TOL_LSE_FP32, "lse_16bit_share": TOL_LSE_16BIT},
        "flash_cases": flash_cases, "flash_refusal": refusal,
        "flash_bwd_refusal": bwd_refusal, "flash_uncompiled_head_dim": uncompiled,
        "rmsnorm_cases": rms_cases,
        "flash_bwd_cases": flash_bwd_cases, "rmsnorm_bwd_cases": rms_bwd_cases,
        "kernels": list(kernels.values())}
    emit(with_clocks(report["kernels_checked"], start))
    stop_if_failed("kernels")

    # ------------------------------------------------------------ launches
    # per block kind, from the reference's block code: (RMSNorms, self-attention
    # flash calls, cross-attention flash calls) of one forward.  Self-attention
    # norms its input and, before the FFN, the residual (q/k-norm adds two);
    # cross-attention its own input too; Mamba2 its input and its gated output
    # (gn); mLSTM its input; sLSTM its input and its recurrence's output (gn).
    KIND_LAUNCHES = {"attn": (2, 1, 0), "cross_attn": (3, 1, 1), "shared_attn": (2, 1, 0),
                     "mamba": (2, 0, 0), "mlstm": (1, 0, 0), "slstm": (2, 0, 0)}

    def forward_launches(c) -> dict:
        """Kernel launches of one forward (prefill) of config c: each block's by
        KIND_LAUNCHES, q-norm and k-norm per attention (qk_norm), the final norm,
        and the encoder's two norms and one flash call per layer and enc_norm."""
        kinds = [c.block_kind(i) for i in range(c.n_layers)]
        rms = sum(KIND_LAUNCHES[k][0] + 2 * c.qk_norm * KIND_LAUNCHES[k][1]
                  for k in kinds) + 1
        flash = sum(KIND_LAUNCHES[k][1] + KIND_LAUNCHES[k][2] for k in kinds)
        if c.encoder_layers:
            rms += 2 * c.encoder_layers + 1
            flash += c.encoder_layers
        return {"rmsnorm": rms, "flash_attention": flash,
                "rmsnorm_bwd": 0, "flash_attention_bwd": 0}

    def decode_launches(c) -> dict:
        """One decode step: the same norms (whisper re-encodes every step, as the
        reference does); self-attention over the cache (a ring in zamba2's shared
        block) is plain tensor code, so the flash calls are the cross-attention's
        and the encoder's."""
        out = forward_launches(c)
        out["flash_attention"] -= sum(KIND_LAUNCHES[c.block_kind(i)][1]
                                      for i in range(c.n_layers))
        return out

    def by_kernel(want: dict, kind: str, bwd_kind: str = "") -> dict:
        """Launch counts keyed by the kernels line's entries: the flash forward's
        under the entry of `kind`, the variant that runs it on the path, and the
        flash backward's under that of `bwd_kind`."""
        out = {k: n for k, n in want.items()
               if k not in ("flash_attention", "flash_attention_bwd")}
        out.update({name: want["flash_attention"] if variant == kind else 0
                    for variant, name in FLASH_VARIANT_KERNELS.items()})
        out.update({name: want["flash_attention_bwd"] if variant == bwd_kind else 0
                    for variant, name in FLASH_BWD_VARIANT_KERNELS.items()})
        return out

    def train_launches(c) -> dict:
        """One train step without remat: each forward launch has its backward."""
        fwd = forward_launches(c)
        return {"rmsnorm": fwd["rmsnorm"], "rmsnorm_bwd": fwd["rmsnorm"],
                "flash_attention": fwd["flash_attention"],
                "flash_attention_bwd": fwd["flash_attention"]}

    def open_gates(model) -> None:
        """The reference initialises the cross-attention gates at zero, which makes
        cross-attention add nothing; at 0.5 it counts in every check."""
        with torch.no_grad():
            for blk in model.blocks:
                if hasattr(blk, "cross"):
                    blk.cross["gate"].fill_(0.5)

    # -------------------------------------------------------------- small
    # A reduced fp32 model of each family, same weights on the card (kernels) and on
    # the CPU (plain versions): prefill logits and decode steps agree, then three
    # train steps, with exact launch counts.
    def small_phase(arch: str, checkpoint: bool, head_dim: int = 0) -> dict:
        small_cfg = get_config(arch).reduced(**({"head_dim": head_dim} if head_dim else {}))
        cpu_model = LM(small_cfg, device="cpu").init(torch.Generator().manual_seed(args.seed))
        open_gates(cpu_model)
        gpu_model = LM(small_cfg, device=dev)
        gpu_model.load_state_dict(cpu_model.state_dict())
        toks = torch.randint(0, small_cfg.vocab, (2, 40),
                             generator=torch.Generator().manual_seed(args.seed + 1))
        mods = modality_inputs(small_cfg, 2, torch.Generator().manual_seed(args.seed + 2), "cpu")
        ops.reset_launch_counts()
        outs = {}
        for name, model, tk in (("cpu", cpu_model, toks), ("gpu", gpu_model, toks.to(dev))):
            md = {k: v.to(tk.device) for k, v in mods.items()}
            logits, stacked = model.prefill(tk[:, :32], **md)
            cache = model.serving_cache(stacked, 32, 40)
            steps = [logits]
            for t in range(32, 40):
                lg, cache = model.decode_step(
                    cache, tk[:, t:t + 1], torch.full((2,), t, device=tk.device), **md)
                steps.append(lg)
            outs[name] = torch.stack(steps).float().cpu()
        small_err = compare(f"small {arch}: card (kernels) vs CPU (plain)",
                            outs["gpu"], outs["cpu"], 1e-3)
        small_counts = ops.launch_counts()
        want = {k: n + 8 * decode_launches(small_cfg)[k]
                for k, n in forward_launches(small_cfg).items()}
        if small_counts != want:
            fail(f"small {arch}: launched {small_counts}, expected {want}")
        moe_repeat = None
        if small_cfg.n_experts:
            # two prefills on the card on the same inputs: the combine's index_add
            # sums in no fixed order there, so the bits may differ (recorded only)
            md = {k: v.to(dev) for k, v in mods.items()}
            first, _ = gpu_model.prefill(toks[:, :32].to(dev), **md)
            again, _ = gpu_model.prefill(toks[:, :32].to(dev), **md)
            moe_repeat = {"logits_bit_exact": bool(torch.equal(first, again)),
                          "max_abs_diff": float((first - again).abs().max())}
            del first, again, md
        del cpu_model, gpu_model

        # Three train steps on the card (kernels, forward and backward) against the
        # CPU (plain versions), from the same weights and SyntheticLM batches: loss,
        # grad_norm and every new parameter within 1e-3.  A peak lr of 1e-4: AdamW's
        # first steps move a parameter by up to lr whatever the size of its gradient,
        # so a gradient entry at rounding level may move it by lr on one device and
        # not the other; 3 steps at <= 1e-4 stay inside the tolerance.
        cpu_model = LM(small_cfg, device="cpu")
        cpu_state = init_train_state(cpu_model, torch.Generator().manual_seed(args.seed))
        open_gates(cpu_model)
        gpu_model = LM(small_cfg, device=dev)
        gpu_state = load_jax_train_state(gpu_model,
                                         export_jax_train_state(cpu_model, cpu_state))
        small_opt = AdamWConfig(peak_lr=1e-4, warmup_steps=2, total_steps=10)
        data = SyntheticLM(DataConfig(
            vocab=small_cfg.vocab, seq_len=64, global_batch=4, seed=args.seed,
            audio_seq=small_cfg.audio_seq if small_cfg.encoder_layers else 0,
            vision_seq=small_cfg.vision_seq if small_cfg.cross_attn_every else 0,
            d_model=small_cfg.d_model))
        steps = {"cpu": make_train_step(cpu_model, small_opt, remat="none"),
                 "gpu": make_train_step(gpu_model, small_opt, remat="none")}
        per_step = train_launches(small_cfg)
        train_metrics = {"cpu": [], "gpu": []}
        for i in range(3):
            batch = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
            cpu_state, m_cpu = steps["cpu"](cpu_state, batch)
            ops.reset_launch_counts()
            gpu_state, m_gpu = steps["gpu"](gpu_state, {k: v.to(dev) for k, v in batch.items()})
            torch.cuda.synchronize()
            moved = ops.launch_counts()
            if moved != per_step or ops.flash_bwd_launches_by_variant()["scalar"] != \
                    per_step["flash_attention_bwd"]:
                fail(f"small {arch} train step {i}: launched {moved} "
                     f"(backward by variant {ops.flash_bwd_launches_by_variant()}), "
                     f"expected {per_step}, every backward on the scalar kernel")
            for name, m in (("cpu", m_cpu), ("gpu", m_gpu)):
                train_metrics[name].append({k: float(v) for k, v in m.items()})
        for key in ("loss", "grad_norm"):
            compare(f"small {arch} train: {key} card vs CPU",
                    torch.tensor([m[key] for m in train_metrics["gpu"]]),
                    torch.tensor([m[key] for m in train_metrics["cpu"]]), 1e-3)
        param_err = max(compare(f"small {arch} train: parameter {name} card vs CPU",
                                gpu_state["params"][name].detach().cpu(), p.detach(), 1e-3)
                        for name, p in cpu_state["params"].items())
        out = {"config": small_cfg.name, "head_dim": small_cfg.hd, "dtype": "float32",
               "prompt_tokens": 32,
               "max_abs_err": small_err, "tol": 1e-3, "launches": small_counts,
               **({"moe_prefill_repeat": moe_repeat} if moe_repeat else {}),
               "train": {"steps": 3, "batch": [4, 64], "metrics": train_metrics,
                         "max_abs_err_params": param_err, "tol": 1e-3,
                         "launches_per_step": per_step}}
        if checkpoint:
            # the card's train state through a checkpoint and back, bit for bit
            with tempfile.TemporaryDirectory() as tmp:
                save_state(tmp, export_jax_train_state(gpu_model, gpu_state), step=3)
                again = LM(small_cfg, device=dev)
                tree, manifest = restore_state(tmp, jax_train_state_like(again))
                restored = load_jax_train_state(again, tree)
            same = (manifest["step"] == 3
                    and torch.equal(restored["opt"].step, gpu_state["opt"].step)
                    and all(torch.equal(restored["params"][name], gpu_state["params"][name])
                            for name in gpu_state["params"])
                    and all(torch.equal(getattr(restored["opt"], mom)[name],
                                        getattr(gpu_state["opt"], mom)[name])
                            for mom in ("m", "v") for name in gpu_state["params"]))
            if not same:
                fail(f"small {arch} train: the card's train state did not come back from "
                     "a checkpoint bit for bit")
            out["train"]["checkpoint_round_trip_bit_exact"] = same
        return out

    start = probe()
    report["small"] = {"phase": "small", "models": {
        arch: small_phase(arch, checkpoint=arch in SMALL_CHECKPOINTS)
        for arch in SMALL_ARCHS}}
    for arch, head_dim in SMALL_HEAD_DIMS:
        report["small"]["models"][f"{arch}@head_dim{head_dim}"] = small_phase(
            arch, checkpoint=False, head_dim=head_dim)
    report["small"]["bf16"] = {}
    for arch, head_dim in BF16_MODELS:
        entry = bf16_model_check(arch, head_dim, args.seed)
        entry["tol"] = dict(zip(("loss_abs_diff", "grad_max_err_share", "grad_rel_l2"),
                                TOL_BF16[arch]))
        if not all(entry[key] <= tol for key, tol in entry["tol"].items()):
            fail(f"bf16 check {arch}@{head_dim}: loss off by {entry['loss_abs_diff']:.3e}, "
                 f"gradients by {entry['grad_max_err_share']:.3e} of their largest "
                 f"magnitude and {entry['grad_rel_l2']:.3e} of their norm, against "
                 f"{entry['tol']}: {entry['worst_params']} {entry['worst_params_rel_l2']}")
        report["small"]["bf16"][f"{arch}@head_dim{head_dim}"] = entry
    emit(with_clocks(report["small"], start))
    stop_if_failed("small")

    # launches of each main path, counted from 0 just before it and read just after,
    # and the counts the path's code gives
    path_counts: dict = {}
    path_want: dict = {}
    path_variants: dict = {}
    path_bwd_variants: dict = {}

    # -------------------------------------------------------------- serve
    # One served model at full width: random weights from the seed, B_REQ requests
    # of `prompt` tokens through make_prefill_step, GEN_STEPS greedy steps through
    # make_serve_step, the counts at 0 just before and read just after; every
    # prefill flash launch must be the variant the split by shape names for the
    # model's type and head_dim.  `agree`: then the prefill/decode agreement check,
    # in the served dtype (True) or on a float32 copy of the weights ("float32").
    def serve_phase(phase: str, scfg, prompt: int, agree: bool) -> dict:
        L_ = scfg.n_layers
        start = probe()
        t0 = time.perf_counter()
        model = LM(scfg, device=dev).init(torch.Generator(device=dev).manual_seed(args.seed))
        open_gates(model)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prefill_step, serve_step = make_prefill_step(model), make_serve_step(model)
        requests = torch.randint(0, scfg.vocab, (B_REQ, prompt), generator=gen, device=dev)
        mods = modality_inputs(scfg, B_REQ, gen, dev)

        # warm-up (cuBLAS handles and work space), not counted
        warm_logits, stacked = prefill_step({"tokens": requests, **mods})
        cache = model.serving_cache(stacked, prompt, prompt + CACHE_EXTRA)
        serve_step(cache, {"tokens": requests[:, :1],
                           "pos": torch.full((B_REQ,), prompt, device=dev), **mods})
        del stacked, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # the main path, with the counts at 0
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, stacked = prefill_step({"tokens": requests, **mods})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        counts_prefill = ops.launch_counts()
        variants_prefill = ops.flash_launches_by_variant()
        want_prefill = forward_launches(scfg)
        n_flash = want_prefill["flash_attention"]
        if counts_prefill != want_prefill:
            fail(f"{phase}: prefill launched {counts_prefill}, expected {want_prefill}")
        want_kind = expected_variant(scfg.torch_dtype, scfg.hd)
        want_variants = {kind: n_flash if kind == want_kind else 0 for kind in variants_prefill}
        if variants_prefill != want_variants:
            fail(f"{phase}: prefill flash launches by variant {variants_prefill}, "
                 f"expected {want_variants}")
        if tuple(logits.shape) != (B_REQ, scfg.vocab) or not bool(torch.isfinite(logits).all()):
            fail(f"{phase}: prefill logits have the wrong shape or are not finite")
        # the warm-up and this prefill took the same requests: the same bits or not
        # (MoE's combine sums through atomics; recorded only)
        repeat = {"logits_bit_exact": bool(torch.equal(warm_logits, logits)),
                  "max_abs_diff": float((warm_logits.float() - logits.float()).abs().max())}
        del warm_logits
        cache = model.serving_cache(stacked, prompt, prompt + CACHE_EXTRA)
        del stacked
        tok = logits.argmax(-1, keepdim=True)
        generated = [tok]
        want_step = decode_launches(scfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(GEN_STEPS):
            before = ops.launch_counts()
            logits, cache = serve_step(
                cache, {"tokens": tok, "pos": torch.full((B_REQ,), prompt + t, device=dev),
                        **mods})
            after = ops.launch_counts()
            moved = {key: after[key] - before[key] for key in after}
            if moved != want_step:
                fail(f"{phase}: decode step {t} launched {moved}, expected {want_step}")
            tok = logits.argmax(-1, keepdim=True)
            generated.append(tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / GEN_STEPS
        counts = ops.launch_counts()
        path_counts[phase] = counts
        want_total = {k: n + GEN_STEPS * want_step[k] for k, n in want_prefill.items()}
        path_want[phase] = by_kernel(want_total, want_kind)
        path_variants[phase] = ops.flash_launches_by_variant()
        peak_bytes = torch.cuda.max_memory_allocated()
        if not bool(torch.isfinite(logits).all()):
            fail(f"{phase}: decode logits are not finite")
        for name in ("rmsnorm", "flash_attention"):
            if want_total[name] and counts[name] == 0:
                fail(f"{phase}: kernel {name} was not launched on the serving path")
        ids = torch.cat(generated, dim=1)
        del cache, logits
        out = {"phase": phase, "config": scfg.name, "dtype": scfg.dtype, "layers": L_,
               "layers_published": get_config(scfg.name).n_layers,
               "d_model": scfg.d_model, "n_params": model.n_params(),
               "requests": B_REQ, "prompt_tokens": prompt, "decode_steps": GEN_STEPS,
               "memory": {k: list(v.shape) for k, v in mods.items()},
               "init_s": round(init_s, 2), "prefill_ms": prefill_ms,
               "prefill_tokens_per_s": B_REQ * prompt / (prefill_ms * 1e-3),
               "decode_ms_per_step": decode_ms,
               "decode_tokens_per_s": B_REQ / (decode_ms * 1e-3),
               "peak_memory_bytes": peak_bytes,
               "launches_prefill": counts_prefill,
               "flash_launches_prefill_by_variant": variants_prefill,
               "launches_per_decode_step": want_step, "launches_total": counts,
               "prefill_repeat": repeat,
               "generated_ids_request0": ids[0].tolist()}
        def disagreement(amodel) -> tuple[float, float]:
            """Prefill/decode agreement through the kernels: the last position of a
            257-token prefill (flash kernel; the recurrences' sequential scans)
            against a 256-token prefill (their chunkwise forms) plus one decode step
            over the cache (plain attention with per-row positions): (max |diff|,
            the logits' spread)."""
            n = 257
            a_prefill, a_serve = make_prefill_step(amodel), make_serve_step(amodel)
            full_logits, _ = a_prefill({"tokens": requests[:, :n], **mods})
            _, stacked = a_prefill({"tokens": requests[:, :n - 1], **mods})
            cache = amodel.serving_cache(stacked, n - 1, n + 7)
            step_logits, _ = a_serve(
                cache, {"tokens": requests[:, n - 1:n],
                        "pos": torch.full((B_REQ,), n - 1, device=dev), **mods})
            torch.cuda.synchronize()
            return (float((full_logits.float() - step_logits.float()).abs().max()),
                    float(full_logits.float().std()))

        if agree:
            diff, spread = disagreement(model)
            out["agreement"] = {"tokens": 257, "dtype": scfg.dtype, "max_abs_diff": diff,
                                "logit_std": spread}
            if agree == "float32":
                # Held on a float32 copy of the served weights (module docstring).
                fp32 = LM(dataclasses.replace(scfg, dtype="float32"), device=dev)
                fp32.load_state_dict(model.state_dict())
                diff, spread = disagreement(fp32)
                # float32 keeps 24 bits; the two paths differ in algorithm and
                # summation order (the reference's own paths agree within 0.1 % of
                # the spread at 12 of zamba2's layers on a CPU)
                agree_tol = 0.01 * spread
                out["agreement"] = {"tokens": 257, "dtype": "float32", "max_abs_diff": diff,
                                    "logit_std": spread, "tol": agree_tol,
                                    "served_dtype_not_gated": out["agreement"]}
                del fp32
            else:
                # bf16 keeps 8 bits: each of the 2 * depth residual updates is rounded
                # at ~0.4 % and the two paths use different matrix-product shapes, so
                # the logits may differ by a few percent of their spread, not more.
                agree_tol = 0.08 * spread
                out["agreement"]["tol"] = agree_tol
            if not diff <= agree_tol:
                fail(f"{phase}: prefill/decode disagree: max |diff| {diff:.4f} > "
                     f"{agree_tol:.4f}")
        emit(with_clocks(out, start))
        stop_if_failed(phase)
        del model, prefill_step, serve_step, requests, mods
        torch.cuda.empty_cache()
        return out

    if not args.skip_serve:
        report["serve"] = serve_phase(
            "serve", dataclasses.replace(cfg, n_layers=args.layers) if args.layers else cfg,
            S_REQ, agree=True)

    # -------------------------------------------------------------- train
    # A training path just driven, with the counts at 0 just before: exact launches
    # of every kernel, forward and backward, `steps` steps' worth; every flash launch
    # the variant the split by shape names, both directions; finite losses at the
    # logged steps, the step-0 loss where a random init puts it; ms a step between
    # the first and last logged steps (with `event_steps`, the mean of the steps that
    # handled no event), tokens/s, MFU and peak memory.
    def train_reading(phase: str, tcfg, model, hist, steps: int, batch: int,
                      seq: int, logged: list, event_steps: tuple = ()) -> dict:
        L_ = tcfg.n_layers
        counts = ops.launch_counts()
        path_counts[phase] = counts
        path_variants[phase] = ops.flash_launches_by_variant()
        path_bwd_variants[phase] = ops.flash_bwd_launches_by_variant()
        peak_bytes = torch.cuda.max_memory_allocated()
        n_params = model.n_params()
        # parameters whose products run in a step: zamba2's shared block is held
        # once and runs at each of its occurrences
        n_shared = sum(tcfg.block_kind(i) == "shared_attn" for i in range(L_))
        flop_params = n_params
        if n_shared > 1:
            flop_params += (n_shared - 1) * sum(p.numel() for p in model.shared.parameters())
        per_step = train_launches(tcfg)
        want = {k: steps * n for k, n in per_step.items()}
        fwd_kind = expected_variant(tcfg.torch_dtype, tcfg.hd)
        bwd_kind = expected_variant(tcfg.torch_dtype, tcfg.hd, backward=True)
        path_want[phase] = by_kernel(want, fwd_kind, bwd_kind)
        if counts != want:
            fail(f"{phase}: {steps} steps launched {counts}, expected {want}")
        for name, got, kind, n in (
                ("forward", path_variants[phase], fwd_kind, want["flash_attention"]),
                ("backward", path_bwd_variants[phase], bwd_kind, want["flash_attention_bwd"])):
            if got != {v: n if v == kind else 0 for v in got}:
                fail(f"{phase}: flash {name} launches by variant {got}: all {n} must be "
                     f"{kind!r}")
        losses = [h["loss"] for h in hist]
        if [h["step"] for h in hist] != logged or not all(
                math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
            fail(f"{phase}: losses or grad norms missing or not finite: {hist}")
        # at init the logits of the random tied unembedding (N(0, 0.02^2) entries)
        # against RMS-normalised hidden states (the final norm's weight at 1) are
        # ~N(0, d * 0.02^2), so the log-sum-exp over the vocabulary, and the loss,
        # sit at ln V + d * 0.02^2 / 2
        loss0_expected = math.log(tcfg.vocab) + tcfg.d_model * 0.02 ** 2 / 2
        if not abs(losses[0] - loss0_expected) <= 0.5:
            fail(f"{phase}: step-0 loss {losses[0]:.4f} is not within 0.5 of "
                 f"{loss0_expected:.4f}")
        walls = [h["wall"] for h in hist]
        step_ms = (walls[-1] - walls[0]) * 1e3 / (logged[-1] - logged[0])
        if event_steps:   # every step logged: the steps that handled no event
            step_ms = float(np.mean([(walls[i] - walls[i - 1]) * 1e3
                                     for i in range(1, len(walls))
                                     if logged[i] not in event_steps]))
        tokens = batch * seq
        # 6 operations per parameter and token at each occurrence, and attention's
        # 12 * hd per visible (query, key) pair (forward 4, backward 8) at each
        # attention occurrence; the chunkwise SSD's products with no parameter in them
        # are left out
        n_attn = sum(tcfg.block_kind(i) in ("attn", "shared_attn") for i in range(L_))
        attn_flops = 12.0 * tcfg.hd * visible_pairs(
            seq, seq, tcfg.causal, tcfg.attn_window) * batch * tcfg.n_heads * n_attn
        model_flops = 6.0 * flop_params * tokens + attn_flops
        return {
            "phase": phase, "config": tcfg.name, "dtype": tcfg.dtype,
            "layers": L_,
            # a reduced config is named after its arch with a "-smoke" suffix
            "layers_published": get_config(tcfg.name.removesuffix("-smoke")).n_layers,
            "d_model": tcfg.d_model, "head_dim": tcfg.hd, "n_params": n_params,
            "flop_params": flop_params, "global_batch": batch, "seq_len": seq,
            "steps": steps, "remat": "none",
            "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
            "lrs": [h["lr"] for h in hist],
            "step0_loss_expected": loss0_expected, "ln_vocab": math.log(tcfg.vocab),
            "step_walls_s": walls,
            "ms_per_step": step_ms, "tokens_per_s": tokens / (step_ms * 1e-3),
            "model_flops_per_step": model_flops,
            "mfu": model_flops / (step_ms * 1e-3) / PEAK_TENSOR_16BIT_FLOPS,
            "peak_memory_bytes": peak_bytes,
            "launches": counts, "launches_per_step": per_step,
            "flash_launches_by_variant": path_variants[phase],
            "flash_bwd_launches_by_variant": path_bwd_variants[phase]}

    # A one-rank NCCL group on the card (127.0.0.1 rendezvous), destroyed after the phase
    # that asked for it (train_mesh, collectives, pipeline).
    @contextlib.contextmanager
    def nccl_one_rank():
        import torch.distributed as dist
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0, device_id=dev)
        try:
            yield
        finally:
            dist.destroy_process_group()
            torch.cuda.empty_cache()

    # One model trained at full width, cut in depth: the Trainer over SyntheticLM
    # batches of B_TRAIN x S_TRAIN tokens, remat none, every step logged.  With
    # `ref` (the train phase's reading) the same run on a one-rank NCCL group and a
    # (1, 1) mesh with ZeRO-3: the Trainer's mesh path, held to ref's losses.
    def train_phase(phase: str, tcfg, steps: int, ref: dict | None = None) -> dict:
        if ref is not None:
            from repro_torch.launch.mesh import make_host_mesh
            with nccl_one_rank():
                return _train_phase(phase, tcfg, steps, ref, make_host_mesh())
        return _train_phase(phase, tcfg, steps, ref, None)

    def _train_phase(phase: str, tcfg, steps: int, ref, mesh) -> dict:
        start = probe()
        t0 = time.perf_counter()
        trainer = Trainer(TrainerConfig(
            arch=tcfg, steps=steps, global_batch=B_TRAIN, seq_len=S_TRAIN,
            ckpt_every=0, log_every=1, remat="none", seed=args.seed, device="cuda",
            zero3=mesh is not None), mesh=mesh)
        state = trainer.init_state()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        # the main path, with the counts at 0
        ops.reset_launch_counts()
        state, hist = trainer.run(state)
        torch.cuda.synchronize()
        out = train_reading(phase, tcfg, trainer.model, hist, steps, B_TRAIN, S_TRAIN,
                            list(range(steps)))
        out["init_s"] = round(init_s, 2)
        if mesh is not None:
            out.update(mesh_reading(trainer, state, ref, out))
        emit(with_clocks(out, start))
        stop_if_failed(phase)
        del trainer, state
        torch.cuda.empty_cache()
        return out

    def mesh_reading(trainer, state, ref: dict, out: dict) -> dict:
        """train_mesh beside train (train_zamba_mesh beside train_zamba): every step's
        loss within TOL_MESH_LOSS of the reference phase's,
        the state DTensors in the placements the rules give; the step time, MFU and
        peak memory of both (their difference is DTensor's host cost: a reading)."""
        from torch.distributed.tensor import DTensor
        from repro_torch.parallel.sharding import module_shardings
        want = module_shardings(trainer.model, trainer.state_sh["params"])
        placed = all(isinstance(t, DTensor) and tuple(t.placements) == want[n].placements
                     for n, t in state["params"].items())
        moments = all(isinstance(t, DTensor) for t in state["opt"].m.values())
        gaps = [abs(a - b) for a, b in zip(out["losses"], ref["losses"])]
        if not placed or not moments or len(gaps) != len(ref["losses"]) \
                or not max(gaps) <= TOL_MESH_LOSS:
            fail(f"{out['phase']}: state placed {placed}, moments DTensors {moments}, "
                 f"loss gaps to {ref['phase']} {gaps} (tolerance {TOL_MESH_LOSS})")
        print(f"  {out['phase']}: {out['ms_per_step']:.1f} ms a step ({ref['phase']} "
              f"{ref['ms_per_step']:.1f}), {out['tokens_per_s']:,.0f} tokens/s "
              f"({ref['tokens_per_s']:,.0f}), MFU {100 * out['mfu']:.2f} % "
              f"({100 * ref['mfu']:.2f}), peak {out['peak_memory_bytes'] / 1e9:.2f} GB "
              f"({ref['peak_memory_bytes'] / 1e9:.2f}); loss gaps to {ref['phase']} <= "
              f"{max(gaps):.2e}", flush=True)
        return {"mesh": dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape)),
                "backend": "nccl", "zero3": True, "profile_notes": list(trainer.prof.notes),
                "loss_gaps_to_train": gaps, "loss_tol": TOL_MESH_LOSS,
                "train_ms_per_step": ref["ms_per_step"],
                "train_tokens_per_s": ref["tokens_per_s"], "train_mfu": ref["mfu"],
                "train_peak_memory_bytes": ref["peak_memory_bytes"],
                "ms_over_train": out["ms_per_step"] / ref["ms_per_step"],
                "host_ms_over_train": out["ms_per_step"] - ref["ms_per_step"]}

    class Tee(io.TextIOBase):
        """Standard output, also kept in a buffer (a phase reads what its entry
        point printed)."""

        def __init__(self, out):
            self.out, self.buf = out, io.StringIO()

        def write(self, s):
            self.buf.write(s)
            return self.out.write(s)

        def flush(self):
            self.out.flush()

    # The training launcher as a user runs it, at zamba2-2.7b's full width and
    # depth: planning on the launcher's analytic cluster of H100s (--plan auto),
    # then the Trainer; the counts at 0 just before main() and read just after.
    # Beside the measured step, the planner's prediction for the same model on one
    # H100 (a reading, never a check).
    def launch_train_phase(phase: str, lcfg, argv: list) -> dict:
        from repro_torch.core import (ParallelPlan, hetero_cluster, plan_hybrid,
                                      simulate_training_step)
        from repro_torch.launch import train as launch_train
        start = probe()
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_launch_")
        try:
            torch.cuda.reset_peak_memory_stats()
            tee = Tee(sys.stdout)
            # the main path, with the counts at 0
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                trainer = launch_train.main(argv + ["--ckpt-dir", ckpt_dir])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            out = train_reading(phase, lcfg, trainer.model, trainer.history, LAUNCH_STEPS,
                                B_LAUNCH, S_LAUNCH, [0, LAUNCH_STEPS - 1])
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        printed = re.findall(r"^\[plan\] (.*) \(predicted step ([0-9.]+) ms\)$",
                             tee.buf.getvalue(), re.M)
        # the launcher's planning step again (deterministic), for its unrounded
        # prediction, and the prediction for the same model on one H100
        desc = lcfg.to_model_desc()
        res = plan_hybrid(hetero_cluster({"H100": max(torch.cuda.device_count(), 4)},
                                         gpus_per_node=4),
                          desc, global_batch=B_LAUNCH, seq=S_LAUNCH, with_baseline=False)
        one = simulate_training_step(ParallelPlan(), desc, hetero_cluster({"H100": 1}),
                                     global_batch=B_LAUNCH, seq=S_LAUNCH)
        if (trainer.plan is None or len(printed) != 1
                or printed[0][0] != trainer.plan.describe()
                or trainer.plan.to_json() != res.plan.to_json()
                or printed[0][1] != f"{res.predicted.step_time * 1e3:.1f}"
                or not 0 < res.predicted.step_time < math.inf):
            fail(f"{phase}: the [plan] line {printed} does not name the launcher's plan "
                 f"{res.plan.describe()} and its predicted step "
                 f"{res.predicted.step_time * 1e3:.1f} ms")
        out.update({
            "argv": argv, "main_wall_s": wall_s,
            "plan": trainer.plan.to_json() if trainer.plan else None,
            "plan_line": printed,
            "planned_on": f"hetero_cluster({{'H100': {max(torch.cuda.device_count(), 4)}}})",
            "predicted_ms_planned_cluster": res.predicted.step_time * 1e3,
            "predicted_ms_one_h100": one.step_time * 1e3,
            "predicted_one_h100_breakdown_ms": {
                "compute": one.compute_time * 1e3, "bubble": one.bubble_time * 1e3},
            "measured_over_predicted_one_h100": out["ms_per_step"] / (one.step_time * 1e3)})
        emit(with_clocks(out, start))
        stop_if_failed(phase)
        del trainer
        torch.cuda.empty_cache()
        return out

    # The planner-driven Trainer through the reference example's three events on its
    # analytic cluster, training train_zamba's model: each event checkpoints, applies
    # the event, re-plans, rebuilds the step and restores; the subclass holds a copy
    # of the state on the card across each event to show the restore gives it back
    # bit for bit, and removes the checkpoint once read.  All checkpoints live under
    # one temporary directory, removed at the end, pass or fail.
    def train_dynamic_phase() -> dict:
        from repro_torch.core import NetworkEvent, ParallelPlan, hetero_cluster
        from repro_torch.scenarios import Trace
        phase = "train_dynamic"
        start = probe()
        dcfg = dataclasses.replace(get_config("zamba2_2p7b"), n_layers=ZAMBA_TRAIN_LAYERS)
        steps = DYNAMIC_STEPS
        held: list = []

        class HeldTrainer(Trainer):
            def _handle_event(self, step, ev, state):
                opt = state["opt"]
                saved = ({n: t.detach().clone() for n, t in state["params"].items()},
                         {n: t.clone() for n, t in opt.m.items()},
                         {n: t.clone() for n, t in opt.v.items()}, opt.step.clone())
                t0 = time.perf_counter()
                restored = super()._handle_event(step, ev, state)
                torch.cuda.synchronize()
                event_s = time.perf_counter() - t0
                ropt = restored["opt"]
                same = (all(torch.equal(saved[0][n], t) for n, t in restored["params"].items())
                        and all(torch.equal(saved[1][n], t) for n, t in ropt.m.items())
                        and all(torch.equal(saved[2][n], t) for n, t in ropt.v.items())
                        and saved[0].keys() == restored["params"].keys()
                        and saved[1].keys() == ropt.m.keys() == ropt.v.keys()
                        and torch.equal(saved[3], ropt.step))
                ck = Path(self.cfg.ckpt_dir) / f"step_{step}"
                # the restore's first half again: the checkpoint read into host
                # memory (store.restore), the rest being the copies onto the card
                t0 = time.perf_counter()
                tree, _ = restore_state(ck, jax_train_state_like(self.model))
                read_s = time.perf_counter() - t0
                del tree
                held.append({"step": step, "kind": ev.kind, "bit_exact": same,
                             "event_s": event_s, "read_again_s": read_s,
                             "checkpoint_file_bytes": (ck / "arrays.npz").stat().st_size})
                shutil.rmtree(ck)
                del saved
                return restored

        tmp = tempfile.mkdtemp(prefix="chip_smoke_dynamic_")
        try:
            topo = hetero_cluster({"RTX4090D": 4, "V100": 4}, gpus_per_node=4)
            trace = Trace.from_events(
                "s1s2s3", [NetworkEvent(6.0, "bandwidth", factor=0.3, selector="ib"),
                           NetworkEvent(12.0, "slowdown", device_id=2, factor=0.4),
                           NetworkEvent(18.0, "fail", device_id=7)], horizon=float(steps))
            trace = Trace.load(trace.record(Path(tmp) / "s1s2s3.trace.jsonl"))
            cluster = topo.describe().splitlines()
            t0 = time.perf_counter()
            trainer = HeldTrainer(
                TrainerConfig(arch=dcfg, steps=steps, global_batch=B_TRAIN, seq_len=S_TRAIN,
                              ckpt_dir=str(Path(tmp) / "ckpt"), ckpt_every=0, log_every=1,
                              remat="none", seed=args.seed, device="cuda"),
                topo=topo, scenario=trace,
                plan=ParallelPlan(dp=2, tp=2, pp=2, microbatches=2))
            state = trainer.init_state()
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            # the main path, with the counts at 0
            ops.reset_launch_counts()
            state, hist = trainer.run(state)
            torch.cuda.synchronize()
            out = train_reading(phase, dcfg, trainer.model, hist, steps, B_TRAIN, S_TRAIN,
                                list(range(steps)), tuple(s for s, _ in trainer.events))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        event_steps = [s for s, _ in trainer.events]
        records = trainer.adaptations
        if (trainer.replans != 3 or len(records) != 3 or event_steps != [6, 12, 18]
                or [r["step"] for r in held] != event_steps
                or not all(r["bit_exact"] for r in held)):
            fail(f"{phase}: {trainer.replans} replans at {event_steps}, adaptations "
                 f"{[(r.event.kind, r.action) for r in records]}, restores {held}: want 3 "
                 "replans at steps 6, 12, 18, each restore bit for bit")
        walls = out["step_walls_s"]
        first, last = event_steps[0], event_steps[-1]
        before_ms = (walls[first - 1] - walls[0]) * 1e3 / (first - 1)
        after_ms = (walls[-1] - walls[last]) * 1e3 / (steps - 1 - last)
        eng = trainer.engine
        out.update({
            "init_s": round(init_s, 2), "cluster": cluster,
            "plan_start": "dp=2 tp=2 pp=2 mb=2",
            "replans": trainer.replans,
            "adaptations": [{"time": r.time, "kind": r.event.kind, "action": r.action,
                             "predicted_ms_old": r.old_step_time * 1e3,
                             "predicted_ms_new": r.new_step_time * 1e3,
                             "switch_cost_s": r.switch_cost} for r in records],
            "plan_end": trainer.plan.to_json(),
            "restores": [{**r, **h} for r, h in zip(trainer.restores, held)],
            "calibrated_store_bytes_per_s": eng.reconfig.io_bw,
            "engine": [{"path": r.path, "wall_ms": r.wall_time * 1e3, "cold": r.cold,
                        "kept": r.kept, "switch_cost_s": r.switch_cost,
                        "predicted_ms": r.predicted.step_time * 1e3} for r in eng.history],
            "ms_per_step_with_events": (walls[-1] - walls[0]) * 1e3 / (steps - 1),
            "ms_per_step_before_first_event": before_ms,
            "ms_per_step_after_last_event": after_ms,
            "after_over_before": after_ms / before_ms})
        for r in records:
            print(f"  {phase}: t={r.time:4.1f} {r.event.kind:9s} -> {r.action}", flush=True)
        emit(with_clocks(out, start))
        stop_if_failed(phase)
        del trainer, state
        torch.cuda.empty_cache()
        return out

    # The port's scenario harness and planner service, host only: a catalog
    # scenario's two seeds replayed sequentially and in 2 worker processes (spawned:
    # they import neither torch nor JAX), and a multi-tenant stream through the
    # planner service serially and threaded.
    def scenarios_phase() -> dict:
        from repro_torch.core import ModelDesc
        from repro_torch.scenarios import ScenarioHarness, build_tenant, to_job_specs
        from repro_torch.service import PlannerService
        phase = "scenarios"
        start = probe()
        harness = ScenarioHarness(
            ModelDesc("tiny", n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
                      vocab=32000), global_batch=32, seq=512, max_candidates=24)
        items = [(SCENARIO, 0), (SCENARIO, 1)]
        walls, reports = {}, {}
        for how, kw in (("sequential", {"parallel": False}),
                        ("processes_2", {"parallel": True, "max_workers": 2})):
            t0 = time.perf_counter()
            reports[how] = harness.run_many(items, **kw)
            walls[how] = time.perf_counter() - t0
        same = all(a.adapted.timeline == b.adapted.timeline
                   and a.static.timeline == b.static.timeline and a.replans == b.replans
                   for a, b in zip(reports["sequential"], reports["processes_2"]))
        digests = {}
        for workers in (1, 4):
            topo, arrivals, trace = build_tenant("multi_tenant_small", seed=0)
            svc = PlannerService(topo, workers=workers, max_candidates=48)
            t0 = time.perf_counter()
            rep_ = svc.replay(to_job_specs(arrivals, gpus_per_node=4), list(trace.to_events()))
            walls[f"service_workers_{workers}"] = time.perf_counter() - t0
            digests[workers] = rep_
        svc_same = digests[1].plan_digests == digests[4].plan_digests and \
            digests[1].replans == digests[4].replans > 0
        if not same or not svc_same or len(reports["sequential"]) != 2:
            fail(f"{phase}: harness timelines equal {same}; service digests equal and "
                 f"re-planned {svc_same}")
        out = {"phase": phase, "scenario": SCENARIO, "seeds": [0, 1],
               "timelines_equal": same, "service_digests_equal": svc_same,
               "replans": [r.replans for r in reports["sequential"]],
               "service": {"admitted": digests[1].admitted,
                           "cold_searches": digests[1].cold_searches,
                           "cache_hits": digests[1].cache_hits,
                           "replans": digests[1].replans},
               "walls_s": walls}
        print(f"  {phase}: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()),
              flush=True)
        emit(with_clocks(out, start))
        stop_if_failed(phase)
        return out

    def elapsed_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # sync_grads' three schedules on a bf16 tree of train's parameter shapes (2.41 G
    # entries), drawn from a seeded generator on the card, over a one-rank NCCL
    # group's "data" axis: "allreduce" and "rs_ag" give the tree back bit for bit (a
    # one-rank sum, divided by 1); "int8" stays within INT8_BF16_SCALES of each leaf's
    # scale and its new_err is exactly g - deq (deq being what a one-rank sum
    # returns); one layer's leaves in float32 within one scale.  ms per schedule: a
    # one-rank collective moves nothing, so the int8 passes are the only real device
    # work.
    def int8_worst(tree, synced) -> float:
        """The largest |synced - g| over the leaves, in units of each leaf's scale."""
        from repro_torch.parallel.collectives import _quantize_int8
        return max(float((synced[n].float() - t.float()).abs().max())
                   / float(_quantize_int8(t)[1].float()) for n, t in tree.items())

    def collectives_phase(tcfg) -> dict:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.collectives import sync_grads
        phase = "collectives"
        start = probe()
        g = torch.Generator(device=dev).manual_seed(args.seed)
        shapes = {n: tuple(p.shape) for n, p in LM(tcfg, device="meta").named_parameters()}
        tree = {n: torch.randn(sh, generator=g, device=dev, dtype=torch.float32).to(bf16)
                for n, sh in shapes.items()}
        n_el = sum(t.numel() for t in tree.values())
        out = {"phase": phase, "config": tcfg.name, "layers": tcfg.n_layers,
               "leaves": len(tree), "entries": n_el, "bytes": 2 * n_el, "dtype": "bfloat16",
               "ranks": 1, "backend": "nccl", "ms": {}}
        with nccl_one_rank():
            mesh = make_mesh((1,), ("data",))
            for schedule in ("allreduce", "rs_ag", "int8"):
                res = {}
                ms = [elapsed_ms(lambda: res.update(r=sync_grads(tree, mesh, "data",
                                                                 schedule=schedule)))
                      for _ in range(3)]
                synced, new_err = res.pop("r")
                out["ms"][schedule] = ms
                if schedule != "int8":
                    exact = all(torch.equal(synced[n], tree[n]) for n in tree)
                    out[f"{schedule}_bit_for_bit"] = exact
                    if not exact or new_err is not None:
                        fail(f"{phase}: {schedule} did not give the tree back bit for bit")
                else:
                    worst = int8_worst(tree, synced)
                    err_exact = all(torch.equal(new_err[n], tree[n] - synced[n])
                                    for n in tree)
                    out["int8_worst_err_in_scales"] = worst
                    out["int8_new_err_exact"] = err_exact
                    if not worst <= INT8_BF16_SCALES or not err_exact:
                        fail(f"{phase}: int8 error {worst:.3f} scales (limit "
                             f"{INT8_BF16_SCALES}), new_err exactly g - deq {err_exact}")
                del synced, new_err
                torch.cuda.empty_cache()
            # the reference test's dtype: one layer's leaves in float32
            layer0 = {n: t.float() for n, t in tree.items() if n.startswith("blocks.0.")}
            synced, _ = sync_grads(layer0, mesh, "data", schedule="int8")
            out["int8_float32_worst_err_in_scales"] = int8_worst(layer0, synced)
            if not out["int8_float32_worst_err_in_scales"] <= 1.0:
                fail(f"{phase}: int8 in float32: error "
                     f"{out['int8_float32_worst_err_in_scales']:.3f} scales (limit 1)")
            del layer0, synced
        print(f"  {phase}: " + ", ".join(f"{k} {float(np.median(v)):.1f} ms"
                                         for k, v in out["ms"].items()), flush=True)
        del tree
        torch.cuda.empty_cache()
        emit(with_clocks(out, start))
        stop_if_failed(phase)
        return out

    # pipeline_forward on a one-rank "pipe" mesh: qwen2-7b's decoder layers at full
    # width, PIPE_LAYERS stacked (pad_stages, one stage), bf16, through the port's
    # functional attn_block / ffn_block (their RMSNorm and flash kernels), PIPE_M
    # microbatches of 1 x PIPE_SEQ; against the same layers applied in sequence on
    # the card: the outputs and every stage parameter's gradient of mean(out^2)
    # within TOL_BF16's dense tolerances (the largest difference and the L2 norm of
    # the difference, each as a share of the sequential one's), and the exact
    # launches of both kernels, forward and backward.  Uneven stages, the padding
    # mask and the send / recv between stages need more than one rank: one card
    # cannot drive them (tests/test_torch_pipeline.py holds them on gloo ranks).
    def pipeline_phase() -> dict:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import layers as L
        from repro_torch.parallel.pipeline import pad_stages, pipeline_forward
        phase = "pipeline"
        start = probe()
        defs = {"attn": L.attn_defs(cfg), "ffn": L.ffn_defs(cfg)}
        g = torch.Generator(device=dev).manual_seed(args.seed)
        stacked = {}
        for path, pd in L.flatten_defs(defs):
            shape_ = (PIPE_LAYERS, *pd.shape)
            if pd.init == "ones":
                stacked[path] = torch.ones(shape_, device=dev, dtype=bf16)
            elif pd.init == "zeros":
                stacked[path] = torch.zeros(shape_, device=dev, dtype=bf16)
            else:
                scale = pd.scale if pd.scale is not None else 1.0 / math.sqrt(pd.shape[0])
                stacked[path] = (torch.randn(shape_, generator=g, device=dev) * scale).to(bf16)
        sp, mask = pad_stages(stacked, [PIPE_LAYERS])
        sp = {k: v.detach().requires_grad_() for k, v in sp.items()}
        x = (torch.randn((PIPE_M, 1, PIPE_SEQ, d), generator=g, device=dev)).to(bf16)
        positions = torch.arange(PIPE_SEQ, device=dev)[None]

        def layer_fn(p, h):
            nest = {"attn": {}, "ffn": {}}
            for path, t in p.items():
                block, name = path.split(".")
                nest[block][name] = t
            return L.ffn_block(nest["ffn"], cfg, L.attn_block(nest["attn"], cfg, h, positions))

        def sequential():
            # the stage taken once and each layer indexed from it, as the pipeline
            # does (each index's backward writes a zeroed gradient of what it indexes)
            stage = {k: v[0] for k, v in sp.items()}
            outs = []
            for m in range(PIPE_M):
                h = x[m]
                for i in range(PIPE_LAYERS):
                    h = layer_fn({k: v[i] for k, v in stage.items()}, h)
                outs.append(h)
            return torch.stack(outs)

        def step(fn):
            out_ = fn()
            loss = out_.float().pow(2).mean()
            grads_ = torch.autograd.grad(loss, list(sp.values()))
            return out_.detach(), dict(zip(sp, grads_))

        with nccl_one_rank():
            mesh = make_mesh((1,), ("pipe",))
            pipe = lambda: pipeline_forward(layer_fn, sp, mask, x, mesh=mesh)   # noqa: E731
            step(pipe)                      # warm-up, outside the counts
            torch.cuda.synchronize()
            # the main path, with the counts at 0
            ops.reset_launch_counts()
            res = {}
            pipe_ms = elapsed_ms(lambda: res.update(r=step(pipe)))
            counts = ops.launch_counts()
            variants = {"forward": ops.flash_launches_by_variant(),
                        "backward": ops.flash_bwd_launches_by_variant()}
            out_p, grads_p = res.pop("r")
            path_counts[phase] = counts
            path_variants[phase] = variants["forward"]
            path_bwd_variants[phase] = variants["backward"]
            out_s, grads_s = step(sequential)
            seq_ms = elapsed_ms(lambda: step(sequential))
            pipe_ms2 = elapsed_ms(lambda: step(pipe))
        per_layer = {"rmsnorm": 2, "flash_attention": 1, "rmsnorm_bwd": 2,
                     "flash_attention_bwd": 1}
        want = {k: n * PIPE_LAYERS * PIPE_M for k, n in per_layer.items()}
        fwd_kind = expected_variant(bf16, hd)
        bwd_kind = expected_variant(bf16, hd, backward=True)
        path_want[phase] = by_kernel(want, fwd_kind, bwd_kind)
        if counts != want:
            fail(f"{phase}: launched {counts}, expected {want}")
        for way, kind, n in (("forward", fwd_kind, want["flash_attention"]),
                             ("backward", bwd_kind, want["flash_attention_bwd"])):
            if variants[way] != {v: n if v == kind else 0 for v in variants[way]}:
                fail(f"{phase}: flash {way} launches by variant {variants[way]}: all {n} "
                     f"must be {kind!r}")
        _, tol_max, tol_l2 = TOL_BF16["gemma_7b"]

        def shares(a, b):
            a, b = a.float(), b.float()
            return (float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30),
                    float((a - b).norm()) / max(float(b.norm()), 1e-30))

        agree = {"out": shares(out_p, out_s)}
        agree.update({f"grad {k}": shares(grads_p[k], grads_s[k]) for k in sp})
        worst = max(v[0] for v in agree.values()), max(v[1] for v in agree.values())
        if not (worst[0] <= tol_max and worst[1] <= tol_l2) or \
                not bool(torch.isfinite(out_p.float()).all()):
            fail(f"{phase}: pipeline against sequential: worst share {worst[0]:.3e} "
                 f"(limit {tol_max}), L2 {worst[1]:.3e} (limit {tol_l2})")
        out = {"phase": phase, "config": cfg.name, "layers": PIPE_LAYERS, "stages": 1,
               "microbatches": PIPE_M, "tokens": [1, PIPE_SEQ], "dtype": "bfloat16",
               "ranks": 1, "backend": "nccl",
               "not_driven": "uneven stages, the padding mask and send / recv need more "
                             "than one rank (held on gloo ranks by "
                             "tests/test_torch_pipeline.py)",
               "launches": counts, "launches_expected": want,
               "flash_launches_by_variant": variants,
               "ms_fwd_bwd": [pipe_ms, pipe_ms2], "sequential_ms_fwd_bwd": seq_ms,
               "worst_share": worst[0], "worst_rel_l2": worst[1],
               "tol": {"largest_entry": tol_max, "l2": tol_l2},
               "agreement": {k: {"max_share": v[0], "rel_l2": v[1]}
                             for k, v in agree.items()}}
        print(f"  {phase}: {pipe_ms:.1f} / {pipe_ms2:.1f} ms forward + backward against "
              f"the sequential stack's {seq_ms:.1f}; worst share {worst[0]:.2e}, L2 "
              f"{worst[1]:.2e}", flush=True)
        del sp, stacked, x, out_p, grads_p, out_s, grads_s
        torch.cuda.empty_cache()
        emit(with_clocks(out, start))
        stop_if_failed(phase)
        return out

    # The port's dry run (launch.dryrun: the step on fake tensors, counted) for train's
    # cell and launch_train's, each on a fake one-rank group and a (1, 1) mesh,
    # beside what the card measured for the same step: measured / roofline (the
    # largest of the three terms) and the tracked / measured peak.  Readings, never
    # gates.  Meanwhile a production cell (qwen2-7b x train_4k on the (16, 16) mesh
    # of 256 fake ranks) runs in a subprocess, away from this process's NCCL groups:
    # its fits, microbatches, terms and wall seconds.
    def roofline_phase(train_cfg) -> dict:
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.config import ShapeSpec
        phase = "roofline"
        start = probe()
        prod_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
        t0 = time.perf_counter()
        prod = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2_7b",
             "--shape", "train_4k", "--mesh", "single", "--out", prod_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        try:
            cells = {}
            for name, ccfg, shape, measured in (
                    ("train", train_cfg, ShapeSpec("train", S_TRAIN, B_TRAIN, "train"),
                     report["train"]),
                    ("launch_train", get_config("zamba2_2p7b"),
                     ShapeSpec("launch_train", S_LAUNCH, B_LAUNCH, "train"),
                     report["launch_train"])):
                c0 = time.perf_counter()
                with dr.fake_group(1):
                    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
                    r = dr.dry_run(ccfg, shape, mesh, mesh_name="1x1", arch=name,
                                   microbatches=1, remat="none")
                roof_s = max(r["t_compute"], r["t_memory"], r["t_collective"])
                cells[name] = {
                    "config": ccfg.name, "layers": ccfg.n_layers,
                    "tokens": [B_TRAIN if name == "train" else B_LAUNCH, shape.seq_len],
                    **{k: r[k] for k in ("flops", "bytes", "t_compute", "t_memory",
                                         "t_collective", "bottleneck", "model_flops",
                                         "peak_bytes", "peak_detail", "zero3", "fits")},
                    "measured_ms_per_step": measured["ms_per_step"],
                    "measured_peak_bytes": measured["peak_memory_bytes"],
                    "measured_over_roofline": measured["ms_per_step"] * 1e-3 / roof_s,
                    "tracked_over_measured_peak": r["peak_bytes"]
                    / measured["peak_memory_bytes"],
                    "dry_run_s": time.perf_counter() - c0}
                if not (r["flops"] > 0 and r["peak_bytes"] > 0):
                    fail(f"{phase}: {name}'s dry run counted no flops or no memory: {r}")
                if r["microbatches"] != 1:   # the measured phase's step is one batch
                    fail(f"{phase}: {name}'s dry run escalated to {r['microbatches']} "
                         f"microbatches (tracked peak {r['peak_bytes']:.4g} B)")
            log, _ = prod.communicate(timeout=900)
        finally:
            if prod.poll() is None:
                prod.kill()
                prod.communicate()
        prod_wall = time.perf_counter() - t0
        prod_path = Path(prod_dir) / "qwen2_7b.train_4k.single.json"
        if prod.returncode != 0 or not prod_path.is_file():
            fail(f"{phase}: the production dry run exited {prod.returncode}: {log[-3000:]}")
            stop_if_failed(phase)
        rep = json.loads(prod_path.read_text())
        shutil.rmtree(prod_dir, ignore_errors=True)
        production = {"cell": "qwen2_7b x train_4k x single (16, 16), 256 fake ranks",
                      **{k: rep.get(k) for k in (
                          "status", "fits", "microbatches", "zero3", "flops", "t_compute",
                          "t_memory", "t_collective", "bottleneck", "useful_ratio",
                          "peak_bytes", "coll_counts", "coll_bytes", "t_step_s",
                          "wall_s")},
                      "subprocess_wall_s": prod_wall}
        if rep.get("status") != "ok":
            fail(f"{phase}: the production cell's status is {rep.get('status')}")
        out = {"phase": phase, "constants": {"peak_flops": dr.rl.PEAK_FLOPS,
                                             "hbm_bw": dr.rl.HBM_BW,
                                             "hbm_bytes": dr.rl.HBM_BYTES,
                                             "source": "H100 SXM5 datasheet"},
               "cells": cells, "production": production}
        for name, c in cells.items():
            print(f"  {phase} {name}: flops {c['flops']:.3e}, compute "
                  f"{c['t_compute'] * 1e3:.1f} ms, memory {c['t_memory'] * 1e3:.1f} ms, "
                  f"{c['bottleneck']}-bound; measured {c['measured_ms_per_step']:.1f} ms "
                  f"= {c['measured_over_roofline']:.2f}x; tracked peak "
                  f"{c['peak_bytes'] / 1e9:.1f} GB = {c['tracked_over_measured_peak']:.2f}x "
                  f"the measured", flush=True)
        print(f"  {phase} production: fits {production['fits']}, M "
              f"{production['microbatches']}, compute {production['t_compute']:.3f} s, "
              f"memory {production['t_memory']:.3f} s, collective "
              f"{production['t_collective']:.3f} s; {prod_wall:.1f} s", flush=True)
        emit(with_clocks(out, start))
        stop_if_failed(phase)
        return out

    # tools/calibrate_fabric_torch.py's sweep on the card: pinned host<->card copies
    # (class "pcie", against the planner's H100 PCIe edge) and one-rank NCCL
    # all-reduces (class "nccl"), fitted; the fitted alpha and beta, the per-class peak
    # GB/s and the composite step's simulated against measured error.
    def calibrate_phase() -> dict:
        import importlib.util
        phase = "calibrate"
        start = probe()
        spec = importlib.util.spec_from_file_location(
            "calibrate_fabric_torch", ROOT / "tools" / "calibrate_fabric_torch.py")
        cal = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cal)
        t0 = time.perf_counter()
        samples, measured = cal.run_card_sweep()
        rep = cal.fit_report(samples, measured_step=measured)
        if not (measured > 0 and all(s_["t"] > 0 for s_ in samples)
                and {s_["cls"] for s_ in samples} == {"pcie", "nccl"}):
            fail(f"{phase}: a sample or the composite step was not measured")
        # a one-rank all-reduce moves no bytes: its class prices latency alone
        latency = cal.latency_only(samples)
        out = {"phase": phase, "alpha": rep["alpha"], "beta": rep["beta"],
               "n_samples": rep["n_samples"], "median_residual": rep["median_residual"],
               "classes_peak_gb_s": {c: row["peak_bw"] / 1e9
                                     for c, row in rep["classes"].items()
                                     if c not in latency},
               "classes_bw_eff": {c: row["bw_eff"] for c, row in rep["classes"].items()
                                  if c not in latency},
               "latency_only_us": {c: t * 1e6 for c, t in latency.items()},
               "step": rep["step"], "step_error_is": "latency pricing: the composite "
               "step's all-reduce moves no bytes on one rank, so its error is no "
               "bandwidth reading", "sweep_s": time.perf_counter() - t0,
               "samples": samples}
        print(f"  {phase}: alpha {rep['alpha']:.4g}, beta {rep['beta']:.4g}; "
              + ", ".join(f"{c} {v:.2f} GB/s" for c, v in out["classes_peak_gb_s"].items())
              + "".join(f", {c} latency only {v:.1f} us"
                        for c, v in out["latency_only_us"].items())
              + f"; step {rep['step']['measured_s'] * 1e3:.2f} ms measured, "
              f"{rep['step']['simulated_s'] * 1e3:.2f} simulated "
              f"({rep['step']['rel_error']:.1%}, latency pricing, not bandwidth)",
              flush=True)
        emit(with_clocks(out, start))
        stop_if_failed(phase)
        return out

    if not args.skip_train:
        # qwen2-7b at 8 of 28 layers: at 12 bytes a parameter (bf16 parameters and
        # gradients, fp32 moments) the full depth's 7.07 G would need 85 GB
        train_cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
        report["train"] = train_phase("train", train_cfg, steps=6)
        # the same run through the Trainer's mesh path (DTensor, ZeRO-3)
        report["train_mesh"] = train_phase("train_mesh", train_cfg, steps=6,
                                           ref=report["train"])
        # zamba2-2.7b at 6 of 54 layers, two cycles of (mamba, mamba, shared_attn): 4
        # Mamba2 layers and 2 occurrences of the shared block, whose attention is
        # head_dim 80 on both flash directions
        zamba_cfg = dataclasses.replace(get_config("zamba2_2p7b"),
                                        n_layers=ZAMBA_TRAIN_LAYERS)
        report["train_zamba"] = train_phase("train_zamba", zamba_cfg, steps=4)
        # the same through the Trainer's mesh path: the Mamba2 scan on DTensors
        report["train_zamba_mesh"] = train_phase("train_zamba_mesh", zamba_cfg, steps=4,
                                                 ref=report["train_zamba"])
        # zamba2-2.7b at full width and depth through the launcher (1.74 G parameters,
        # ~21 GB with AdamW), then the planner-driven Trainer at train_zamba's size
        report["launch_train"] = launch_train_phase("launch_train", get_config("zamba2_2p7b"),
                                                    LAUNCH_ARGV)
        report["train_dynamic"] = train_dynamic_phase()
        report["launch_reduced"] = launch_train_phase(
            "launch_reduced", get_config("qwen2_7b").reduced(), REDUCED_ARGV)
        report["scenarios"] = scenarios_phase()
        report["collectives"] = collectives_phase(train_cfg)
        report["pipeline"] = pipeline_phase()
        report["roofline"] = roofline_phase(train_cfg)
        report["calibrate"] = calibrate_phase()

    # ------------------------------- serve_moe, serve_vlm, serve_audio, serve_gemma
    # The other families at full width and depth, each freed before the next
    # (qwen3-moe alone holds 60.4 GB).  No prefill/decode agreement for MoE: the
    # capacity C depends on how many tokens a call holds, so a decode step of
    # B_REQ tokens (C = 1) drops pairs that the prefill kept (the reference's own
    # test_decode_consistent_with_forward leaves the MoE architectures out); MoE is
    # held by the card-vs-CPU check of the small phase and the CPU tests against JAX.
    if not args.skip_serve:
        for phase, arch, prompt, agree in FAMILY_SERVES:
            report[phase] = serve_phase(phase, get_config(arch), prompt, agree)

    # ------------------------------------------------------------- verdict
    if args.skip_serve or args.skip_train:
        print("chip_smoke: --skip-serve / --skip-train: a main path was not driven, so "
              "no result is printed", file=sys.stderr)
        sys.exit(4)
    # a flash entry's launches are those of its variant, forward or backward (a serve
    # path runs no backward)
    variant_of = {name: (kind, path_variants) for kind, name in FLASH_VARIANT_KERNELS.items()}
    variant_of.update({name: (kind, path_bwd_variants)
                       for kind, name in FLASH_BWD_VARIANT_KERNELS.items()})
    for name, kern in kernels.items():
        kind, by_path = variant_of.get(name, (None, None))
        kern["launches_by_path"] = {
            path: (by_path[path][kind] if path in by_path else 0) if kind else c[name]
            for path, c in path_counts.items()}
        kern["launches"] = sum(kern["launches_by_path"].values())
        for path, want in path_want.items():   # the kernels each path's code runs
            if want[name] and kern["launches_by_path"][path] == 0:
                fail(f"kernel {name} was not launched on the {path} path")
        if kind:
            kern["launches_by_variant"] = dict(by_path)
    stop_if_failed("verdict")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "dtype", "tol")
    keys += ("variant", "launches_by_path", "launches_by_variant", "head_dim_256",
             "head_dim_80", "head_dim_16")
    kernels_line = {"kernels": [{key: kern[key] for key in keys if key in kern}
                                for kern in kernels.values()]}
    final = {"ok": True, "device": {"platform": "gpu",
                                    "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}}
    if args.out:
        report["kernels"] = kernels_line["kernels"]
        (Path(args.out) / "report.json").write_text(json.dumps(report, indent=1))
    print(smi_line, flush=True)
    emit(kernels_line)
    emit(final)


if __name__ == "__main__":
    main()
