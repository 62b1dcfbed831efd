"""Roofline terms of one step on an H100 (the reference's ``launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds:

  compute    = per-device flops / PEAK_FLOPS      (counted by ``launch.dryrun``)
  memory     = per-device HBM bytes / HBM_BW      (analytic, fused-kernel view)
  collective = per-device collective bytes / link bandwidth (analytic)

The port has no compiled module to read.  Its dry-run runs the real step on
fake tensors and counts each rank's own operations (``launch.dryrun``), and the
collectives DTensor issued, by kind, per execution (DTensor's
``CommDebugMode``), which the report keeps in ``coll_counts`` / ``coll_bytes``
beside the analytic volume the collective term prices.  The analytic terms
(:func:`analytic_hbm_bytes`, :func:`analytic_collectives`,
:func:`recurrent_correction`, :func:`model_flops_estimate`,
:func:`combine_probe_costs`) are the reference's arithmetic.  The constants are
an H100 SXM5's and the collective term prices NVLink within a node and
InfiniBand across nodes (:func:`collective_seconds`), where the reference prices
a TPU v5e's torus.
"""

from __future__ import annotations

import functools
import math
from dataclasses import asdict, dataclass, field

from torch.utils._pytree import tree_leaves

from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.models.lm import LM

# NVIDIA H100 SXM5, datasheet figures (not readings of a card).
PEAK_FLOPS = 989e12          # dense 16-bit tensor-core operations/s
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # device memory
NVLINK_BW = 450e9            # bytes/s each way, a GPU within its 8-GPU node
IB_BW = 50e9                 # bytes/s a GPU across nodes (InfiniBand NDR, 400 Gb/s)
NODE_GPUS = 8


@functools.lru_cache(maxsize=8)
def meta_lm(cfg: ArchConfig) -> LM:
    """``cfg``'s model on the meta device: shapes, no storage."""
    return LM(cfg, device="meta")


# ---------------------------------------------------------------------------
# Analytic HBM traffic (fused-kernel view)
#
# ``attn_fused=False`` charges the S x S score round trips of an unfused
# attention, the traffic the flash kernel eliminates; the port's step runs the
# flash kernel, so its dry-run passes ``attn_fused=True``.
# ---------------------------------------------------------------------------


def analytic_hbm_bytes(cfg: ArchConfig, shape: ShapeSpec,
                       mesh_shape: dict[str, int], *, zero3: bool,
                       microbatches: int, remat: str = "full",
                       attn_fused: bool = False) -> dict[str, float]:
    model = mesh_shape.get("model", 1)
    data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    db = 2
    B, S = shape.global_batch, shape.seq_len
    Sq = 1 if shape.kind == "decode" else S
    L, d = cfg.n_layers, cfg.d_model
    M = microbatches
    train = shape.kind == "train"

    lm = meta_lm(cfg)
    n = lm.n_params()
    p_shards = model * (data if zero3 else 1)
    p_loc = n * db / p_shards
    tok_loc = max(B // data, 1) * Sq              # per device per step
    # heads replicated over "model" when not divisible (fallback rule)
    H_loc = cfg.n_heads // model if cfg.n_heads % model == 0 else cfg.n_heads

    out: dict[str, float] = {}
    # parameters: fwd read xM (+ bwd re-read, + remat re-read), optimizer r/w
    if train:
        reads = M * (2 + (1 if remat == "full" else 0))
        out["params_io"] = p_loc * reads
        n_opt_loc = n / (model * data)            # zero1: moments over data
        out["optimizer_io"] = n_opt_loc * (4 * 4 + 2 * db) + p_loc * 2
    else:
        out["params_io"] = p_loc
    # activations: residual stream + block internals, fwd (+bwd ~2x, remat +1)
    act_mult = (4.0 if remat == "full" else 3.0) if train else 1.0
    d_ff_eff = cfg.top_k * cfg.d_ff if cfg.n_experts else cfg.d_ff
    act_total = 0.0
    for i in range(L):
        kind = cfg.block_kind(i)
        if kind == "mamba":
            inner = 6 * cfg.ssm_expand * d          # z/x/conv/gate streams
        elif kind in ("mlstm", "slstm"):
            inner = 10 * d                          # qkv/gates at e~2d
        else:
            inner = 4 * max(d_ff_eff, 2 * d)
        act_total += tok_loc * (8 * d + inner) * db
    out["activations_io"] = act_mult * act_total
    # unfused attention scores (the flash-kernel target)
    n_attn = sum(1 for i in range(L) if cfg.block_kind(i) in
                 ("attn", "cross_attn", "shared_attn"))
    if not attn_fused and n_attn:
        kv_avg = min(cfg.attn_window or S, S) if shape.kind != "decode" \
            else min(cfg.attn_window or S, S)
        causal_frac = 0.5 if (shape.kind != "decode"
                              and not cfg.attn_window) else 1.0
        B_loc = max(B // data, 1)
        score_rw = 3 * 4                           # write+read f32, + softmax
        out["attn_scores_io"] = (act_mult if train else 1.0) * n_attn * \
            B_loc * H_loc * Sq * kv_avg * causal_frac * score_rw
    # kv cache / recurrent state io (serving: the cache read dominates)
    if shape.kind == "decode":
        cache = lm.init_cache(B, S, device="meta")
        total = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
        out["cache_io"] = total / (data * model) * 2   # read + write
    # lm head + embed
    V_loc = cfg.vocab / model if cfg.vocab % model == 0 else cfg.vocab
    if train:
        out["lm_head_io"] = tok_loc * V_loc * (db + 4) + \
            M * (cfg.vocab * d * db / p_shards) * 3
    else:
        out["lm_head_io"] = max(B // data, 1) * V_loc * 4
    return out


def _ring_ag_bytes(size_global: float, n: int) -> float:
    """Per-device wire bytes for a ring all-gather of a tensor whose global
    (gathered) size is ``size_global``, over ``n`` participants."""
    if n <= 1:
        return 0.0
    return (n - 1) / n * size_global


def analytic_collectives(cfg: ArchConfig, shape: ShapeSpec, mesh_shape:
                         dict[str, int], *, zero3: bool, zero1: bool,
                         microbatches: int = 1) -> dict[str, float]:
    """Per-device, per-step collective wire bytes by class.

    Classes map to mesh axes (multi-edge: different axes = different physical
    links, so only same-axis traffic serializes):
      * tp_*:   activation collectives on the "model" axis
      * dp_*:   gradient sync on "data" (+ "pod"): AR, or RS+AG (ZeRO-1),
                plus FSDP param all-gathers when zero3
      * ep_*:   MoE all-to-all on "model"
    """
    model = mesh_shape.get("model", 1)
    data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    db = 2  # bf16
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        S = 1
    L = cfg.n_layers
    d = cfg.d_model
    act_global = B * S * d * db            # one residual-stream tensor
    params_bytes = meta_lm(cfg).n_params() * db

    out: dict[str, float] = {}
    heads_shardable = cfg.n_heads % model == 0
    # TP activation collectives per layer (fwd; bwd doubles; train = 3x fwd
    # cost in flops but 2 passes of collectives).
    passes = 2.0 if shape.kind == "train" else 1.0
    n_attn = sum(1 for i in range(L)
                 if cfg.block_kind(i) in ("attn", "cross_attn", "shared_attn"))
    n_ffn = sum(1 for i in range(L) if cfg.block_kind(i) == "attn"
                and not cfg.n_experts) \
        + sum(1 for i in range(L) if cfg.block_kind(i) in
              ("cross_attn", "shared_attn"))
    if model > 1 and heads_shardable:
        # Megatron TP: each attn/ffn output row-parallel matmul ends in an
        # all-reduce of the activation (2 per transformer layer).
        n_coll = n_attn + n_ffn
        out["tp_allreduce_model"] = passes * n_coll * 2 * _ring_ag_bytes(
            act_global / max(data, 1), model)
    if cfg.n_experts and model > 1:
        # EP: dispatch+combine all-to-alls of the routed activations.
        moe_layers = sum(1 for i in range(L) if cfg.block_kind(i) == "attn")
        routed = act_global / max(data, 1) * cfg.top_k
        out["ep_alltoall_model"] = passes * moe_layers * 2 * routed / model
    if shape.kind == "train" and data > 1:
        if zero1 or zero3:
            out["dp_reduce_scatter_data"] = _ring_ag_bytes(params_bytes, data)
            out["dp_all_gather_data"] = _ring_ag_bytes(params_bytes, data)
        else:
            out["dp_allreduce_data"] = 2 * _ring_ag_bytes(params_bytes, data)
        if zero3:
            # params re-gathered each microbatch fwd+bwd.  Expert weights
            # use 2-D TP on the data axis instead of FSDP (layers.moe_defs),
            # so only the dense remainder is gathered.
            expert_bytes = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model \
                * cfg.d_ff * db if cfg.n_experts else 0.0
            out["fsdp_all_gather_data"] = 2 * microbatches * _ring_ag_bytes(
                max(params_bytes - expert_bytes, 0.0), data)
    return out


def link_bw(axis: str, mesh_shape: dict[str, int]) -> float:
    """Bytes/s a GPU moves on ``axis``: NVLink when the axis lies within one
    8-GPU node -- it is the mesh's innermost axis and its extent is at most
    ``NODE_GPUS`` -- else InfiniBand (the "pod" axis, and "model" at 16)."""
    axes = list(mesh_shape)
    inner = axes and axes[-1] == axis and mesh_shape[axis] <= NODE_GPUS
    return NVLINK_BW if inner else IB_BW


def collective_seconds(vol: dict[str, float],
                       mesh_shape: dict[str, int]) -> float:
    """Serialize same-axis traffic; different axes ride different links
    (multi-edge) -- the slower of the axis queues bounds the term when overlap
    is perfect.  The conservative no-overlap sum within an axis and the max
    across axes, as in the reference; each axis at :func:`link_bw`."""
    per_axis: dict[str, float] = {}
    for k, v in vol.items():
        axis = k.rsplit("_", 1)[-1]
        per_axis[axis] = per_axis.get(axis, 0.0) + v / link_bw(axis, mesh_shape)
    return max(per_axis.values()) if per_axis else 0.0


# ---------------------------------------------------------------------------
# Probe-based cost scaling (the reference's; kept as its function)
#
# XLA's cost analysis counts a loop body once, so the reference lowers 1- and
# 2-cycle probes and scales the delta.  The port's model loops in Python over
# its layers and time chunks, so its dry-run counts every operation and needs
# no probe; the function stays, with the reference's arithmetic.
# ---------------------------------------------------------------------------


def combine_probe_costs(*, f1: dict[str, float], f2: dict[str, float],
                        n_cycles: int, microbatches: int,
                        f_enc1: dict[str, float] | None = None,
                        n_enc: int = 0) -> dict[str, float]:
    """Extrapolate per-device (flops, bytes) from 1-/2-cycle probes."""
    out = {}
    for k in ("flops", "bytes"):
        d_cyc = max(f2[k] - f1[k], 0.0)
        base = max(f1[k] - d_cyc, 0.0)
        if f_enc1 is not None and n_enc > 0:
            d_enc = max(f_enc1[k] - f1[k], 0.0)   # probe3: one extra enc layer
            base_total = base + d_cyc * n_cycles + d_enc * (n_enc - 1)
        else:
            base_total = base + d_cyc * n_cycles
        out[k] = base_total * microbatches
        out[f"{k}_per_cycle"] = d_cyc
        out[f"{k}_base"] = base
    return out


def recurrent_correction(cfg: ArchConfig, shape: ShapeSpec,
                         mesh_shape: dict[str, int]) -> dict[str, float]:
    """Analytic per-device flops/bytes of the sequential time scans that the
    reference's probes count once instead of S times (decode: S=1, nothing to
    fix).  The port's dry-run counts them itself; its memory term adds the
    bytes, as the reference's does."""
    if shape.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    B = shape.global_batch
    S = shape.seq_len
    B_loc = max(B // data, 1)
    mult = 3.0 if shape.kind == "train" else 1.0      # bwd re-runs the scan
    d = cfg.d_model
    flops = byts = 0.0
    for kind in cfg.pattern:          # one occurrence per cycle per position
        n_occ = cfg.n_cycles
        if kind == "mamba":
            # chunkwise-parallel SSD: the big intra-chunk einsums sit
            # OUTSIDE the chunk loop and the boundary step unrolls in the
            # probes, so probe costs are already exact -- no correction.
            continue
        elif kind == "mlstm":
            H = cfg.n_heads
            hd = 2 * d // H
            chunked = S % 64 == 0 and S > 64
            if chunked and S // 64 <= 128:
                continue      # probes unroll the chunk loop: counted exactly
            if chunked:
                # chunkwise analytic: intra matmuls + per-chunk state io
                c = 64
                flops += n_occ * B_loc * H * (4 * S * c * hd + 8 * (S // c)
                                              * hd * hd)
                byts += n_occ * (S // c) * B_loc * 2 * H * hd * hd * 4
            else:
                st = H * hd * hd
                flops += n_occ * S * B_loc * 8 * st
                byts += n_occ * S * B_loc * 2 * st * 4
        elif kind == "slstm":
            H = cfg.n_heads
            hd = d // H
            rec = H * hd * 4 * hd
            flops += n_occ * S * B_loc * 2 * rec
            byts += n_occ * S * (rec * 2 + B_loc * 8 * H * hd * 4)
    return {"flops": flops * mult, "bytes": byts * mult}


# ---------------------------------------------------------------------------
# Cell report
# ---------------------------------------------------------------------------


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per device: flops counted over one step (each rank's own operations),
    # bytes analytic
    flops: float
    bytes: float
    collective_bytes: float
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    # memory fit: rank 0's tracked peak over the step, state included
    peak_bytes: float
    fits: bool
    # collectives DTensor issued in the step, per execution, by kind
    coll_counts: dict[str, int] = field(default_factory=dict)
    coll_bytes: dict[str, float] = field(default_factory=dict)
    peak_detail: dict[str, float] = field(default_factory=dict)
    analytic_detail: dict[str, float] = field(default_factory=dict)
    note: str = ""

    def to_dict(self) -> dict:
        return asdict(self)


def model_flops_estimate(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (train), 2*N*D (prefill/decode); N = active."""
    n = meta_lm(cfg).n_params()
    if cfg.n_experts:
        dense_ffn = cfg.n_layers * cfg.n_experts * (
            3 * cfg.d_model * cfg.d_ff)
        active_ffn = cfg.n_layers * cfg.top_k * (3 * cfg.d_model * cfg.d_ff)
        n = n - dense_ffn + active_ffn
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def build_report(*, arch: str, shape: ShapeSpec, mesh_name: str,
                 mesh_shape: dict[str, int], cfg: ArchConfig, flops: float,
                 peak_bytes: float, zero3: bool, zero1: bool, microbatches: int,
                 coll_counts: dict[str, int] | None = None,
                 coll_bytes: dict[str, float] | None = None,
                 peak_detail: dict[str, float] | None = None,
                 remat_policy: str = "full", note: str = "") -> RooflineReport:
    """The cell's report from the dry-run's counts (``flops``: one rank's own
    operations over the step; ``peak_bytes``: rank 0's tracked peak).  The memory
    term charges no score matrix: the port's step runs the flash kernel
    (``attn_fused=True``, where the reference's dry run left it off)."""
    chips = math.prod(mesh_shape.values())
    corr = recurrent_correction(cfg, shape, mesh_shape)
    hbm = analytic_hbm_bytes(cfg, shape, mesh_shape, zero3=zero3,
                             microbatches=microbatches, remat=remat_policy,
                             attn_fused=True)
    byts = sum(hbm.values()) + corr["bytes"]
    vol = analytic_collectives(cfg, shape, mesh_shape, zero3=zero3,
                               zero1=zero1, microbatches=microbatches)
    t_comp = flops / PEAK_FLOPS
    t_mem = byts / HBM_BW
    t_coll = collective_seconds(vol, mesh_shape)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops_estimate(cfg, shape)
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops=flops, bytes=byts, collective_bytes=sum(vol.values()),
        t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
        bottleneck=bottleneck, model_flops=mf,
        useful_ratio=(mf / (flops * chips)) if flops else 0.0,
        peak_bytes=peak_bytes, fits=peak_bytes <= HBM_BYTES,
        coll_counts=dict(coll_counts or {}), coll_bytes=dict(coll_bytes or {}),
        peak_detail=dict(peak_detail or {}),
        analytic_detail={**vol, **{f"hbm_{k}": v for k, v in hbm.items()}},
        note=note)
