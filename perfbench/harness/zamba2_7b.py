"""The plain reference of Zamba2-7B (``configs/zamba2_7b_l18.json``): its loss, its
gradients and AdamW's update, in float32 plain PyTorch with TF32 off.

It imports nothing of the program, and shares no code with the program's scans.
It follows the configuration file (Zyphra's Zamba2 as published, arXiv:2411.15242):

* every layer is a Mamba2 layer ``x + mamba(norm(x + t))``, where ``t`` is zero but
  at the layers of ``hybrid_layer_ids``; there ``t`` is the output of one of
  ``num_mem_blocks`` shared blocks, taken in turn by use, through the use's own
  d x d ``linear``.  A shared block, on ``concat(x, e0)`` (``e0`` the embedding's
  output, 2 d wide): RMSNorm; attention with rope over the whole head, causal,
  softmax scale ``(head_dim / 2) ** -0.5``, into d; RMSNorm; a GeGLU MLP with exact
  (erf) GELU whose gate and up products each take the use's rank-``adapter_rank``
  adapter.  No residual inside the block, no linear biases;
* Mamba2: projections z, x, B, C (``mamba_ngroups`` groups of ``mamba_d_state``) and
  dt; a causal depthwise convolution of width ``mamba_d_conv`` with bias over x, B
  and C together, then SiLU; ``dt = softplus(dt + dt_bias)`` with no clamp; the SSD
  in its quadratic form, head h reading group ``h // (heads / groups)``:
  ``y = (L o C B^T) (dt x) + D x`` with ``L[t, s] = exp(sum_{s<r<=t} A dt_r)`` for
  s <= t, ``A = -exp(A_log)``; then the gated RMSNorm ``norm(y * silu(z))`` taken
  over each group's slice of the inner width; the out projection;

then a final RMSNorm and the tied head, with the mean cross-entropy over every
label.  The sizes it derives (the inner width ``mamba_expand * hidden_size``, the
heads ``inner / mamba_headdim``, the block's 2 * ``hidden_size`` input) come from
those keys; the file's derived keys (``attention_hidden_size``, ``n_mamba_heads``,
``kv_channels``...) repeat the source and are not read.  Parameters are named as the
program names its own.  Memory: each layer, each block of query rows of the SSD and
of attention, and each block of rows of the loss is recomputed in the backward
(``torch.utils.checkpoint``).

The contract of a reference module (``perfbench/README.md``): :func:`param_specs`,
:func:`params_run`, :func:`loss`, :func:`train`, :func:`attention_calls`,
:func:`other_flops`, :func:`port_departures`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from harness import reference as R
from harness.reference import EXACT, ParamSpec, Precision

#: query rows a block of the SSD's quadratic form and of attention
SSD_ROWS = 256
ATTN_ROWS = 256
#: the source's ``chunk_size``: the SSD's work is counted as its chunked algorithm
#: does it at this chunk (``other_flops``)
SOURCE_CHUNK = 256
#: ``A_log``'s initial standard deviation (``weights.draw`` draws normal, ones or
#: zeros; ``assumed`` in the configuration file says why)
A_LOG_SCALE = 2.0
#: ``w_B`` and ``w_C`` drawn at this share of 1/sqrt(fan_in): with dt the softplus of
#: a zero-mean draw (~0.7, where the published initialisation gives 1e-3 to 0.1), the
#: SSD's dt (C.B) is then about the published model's, and the state carried over
#: long spans does not swamp D x (``assumed`` in the configuration file)
BC_SCALE = 0.1


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------


def kinds(cfg: dict) -> list[str]:
    """Each layer's kind: ``hybrid`` (a shared block, then Mamba2) or ``mamba``."""
    ids = set(cfg["hybrid_layer_ids"])
    if any(i >= cfg["num_hidden_layers"] for i in ids):
        raise ValueError(f"{cfg['name']}: a hybrid layer id past the last layer")
    return ["hybrid" if i in ids else "mamba" for i in range(cfg["num_hidden_layers"])]


def _dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    e = cfg["mamba_expand"] * d
    G, N = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    return {"d": d, "e": e, "P": cfg["mamba_headdim"], "nh": e // cfg["mamba_headdim"],
            "G": G, "N": N, "W": cfg["mamba_d_conv"], "ch": e + 2 * G * N,
            "f": cfg["intermediate_size"], "r": cfg["adapter_rank"],
            "H": cfg["num_attention_heads"], "KV": cfg["num_key_value_heads"],
            "hd": cfg["head_dim"]}


# ---------------------------------------------------------------------------
# the parameters
# ---------------------------------------------------------------------------


def _normal(name, shape, scale=None):
    return ParamSpec(name, tuple(shape), "normal",
                     scale if scale is not None else 1.0 / math.sqrt(shape[0]))


def _mamba_specs(p: str, m: dict) -> list[ParamSpec]:
    d, e, G, N, nh = m["d"], m["e"], m["G"], m["N"], m["nh"]
    return [ParamSpec(p + "ln", (d,), "ones"), _normal(p + "w_z", (d, e)),
            _normal(p + "w_x", (d, e)), _normal(p + "w_B", (d, G * N), BC_SCALE / math.sqrt(d)),
            _normal(p + "w_C", (d, G * N), BC_SCALE / math.sqrt(d)), _normal(p + "w_dt", (d, nh)),
            _normal(p + "conv_w", (m["W"], m["ch"]), 0.5),
            ParamSpec(p + "conv_b", (m["ch"],), "zeros"),
            _normal(p + "A_log", (nh,), A_LOG_SCALE), ParamSpec(p + "D", (nh,), "ones"),
            ParamSpec(p + "dt_bias", (nh,), "zeros"), ParamSpec(p + "gn", (e,), "ones"),
            _normal(p + "w_out", (e, d))]


def _use_specs(p: str, m: dict) -> list[ParamSpec]:
    d, r, f = m["d"], m["r"], m["f"]
    return [_normal(p + "a_in", (d, r)), _normal(p + "a_gate", (r, f)),
            _normal(p + "a_up", (r, f)), _normal(p + "linear", (d, d))]


def _block_specs(p: str, m: dict) -> list[ParamSpec]:
    d, w, f, H, KV, hd = m["d"], 2 * m["d"], m["f"], m["H"], m["KV"], m["hd"]
    return [ParamSpec(p + "attn.ln", (w,), "ones"), _normal(p + "attn.wq", (w, H, hd)),
            _normal(p + "attn.wk", (w, KV, hd)), _normal(p + "attn.wv", (w, KV, hd)),
            _normal(p + "attn.wo", (H, hd, d)), ParamSpec(p + "ffn.ln", (d,), "ones"),
            _normal(p + "ffn.w_up", (d, f)), _normal(p + "ffn.w_gate", (d, f)),
            _normal(p + "ffn.w_down", (f, d))]


def param_specs(cfg: dict) -> list[ParamSpec]:
    """Every parameter: its name (the program's), shape and initialisation."""
    m = _dims(cfg)
    if not cfg["tie_word_embeddings"]:
        raise ValueError("the reference ties the head to the embedding")
    specs = [_normal("embed.tok", (cfg["vocab_size"], m["d"]), 0.02),
             ParamSpec("final_norm", (m["d"],), "ones")]
    for i, kind in enumerate(kinds(cfg)):
        specs += _mamba_specs(f"blocks.{i}.mamba.", m)
        if kind == "hybrid":
            specs += _use_specs(f"blocks.{i}.use.", m)
    if "hybrid" in kinds(cfg):
        for b in range(cfg["num_mem_blocks"]):
            specs += _block_specs(f"mem.{b}.", m)
    return specs


def params_run(cfg: dict) -> int:
    """Parameters whose products run in a step: every parameter once, and each
    shared block's once more for each use after its first."""
    held = sum(math.prod(s.shape) for s in param_specs(cfg))
    uses = kinds(cfg).count("hybrid")
    block = sum(math.prod(s.shape) for s in _block_specs("", _dims(cfg)))
    return held + (uses - min(uses, cfg["num_mem_blocks"])) * block


# ---------------------------------------------------------------------------
# the work of a step, beyond 6 operations a parameter and token
# ---------------------------------------------------------------------------


def attention_calls(cfg: dict, traffic: dict) -> list[dict]:
    """One causal attention call at each use of a shared block."""
    m = _dims(cfg)
    return [{"B": traffic["global_batch"], "S": traffic["seq_len"], "H": m["H"],
             "KV": m["KV"], "hd": m["hd"], "window": 0,
             "calls": kinds(cfg).count("hybrid")}]


def other_flops(cfg: dict, traffic: dict) -> float:
    """The SSD's and the convolution's operations in a step, forward and backward
    (3 x the forward), at every Mamba2 layer, counted as the chunked SSD algorithm
    does them at the source's ``chunk_size`` Q.  For a sequence of S tokens, with
    P = ``mamba_headdim``, N = ``mamba_d_state``, G groups, nh heads, W the
    convolution's width and ch its channels, the forward takes

        2 S Q N G       the intra-chunk C B^T of every group
      + 2 S Q P nh      its masked product with dt x
      + 2 S N P nh      the chunk states
      + 2 (S/Q) N P nh  the states passed from chunk to chunk
      + 2 S N P nh      the states' part of y
      + 2 S W ch        the convolution

    times ``global_batch`` sequences and the layers.  Elementwise work (the decay
    ratios, the gates, softplus) is not counted."""
    m = _dims(cfg)
    S, Q = traffic["seq_len"], SOURCE_CHUNK
    N, P, nh, G = m["N"], m["P"], m["nh"], m["G"]
    fwd = (2 * S * Q * N * G + 2 * S * Q * P * nh + 2 * S * N * P * nh
           + 2 * (S // Q) * N * P * nh + 2 * S * N * P * nh + 2 * S * m["W"] * m["ch"])
    return 3.0 * fwd * traffic["global_batch"] * cfg["num_hidden_layers"]


# ---------------------------------------------------------------------------
# the port's configuration against the file
# ---------------------------------------------------------------------------

# the configuration file's keys, and the port's ArchConfig fields that state them
PORT_FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "hd", "intermediate_size": "d_ff", "vocab_size": "vocab",
    "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
    "tie_word_embeddings": "tie_embeddings", "torch_dtype": "dtype",
    "attention_window": "attn_window", "mamba_d_state": "ssm_state",
    "mamba_expand": "ssm_expand", "mamba_headdim": "ssm_head_dim",
    "mamba_d_conv": "ssm_conv_width", "mamba_ngroups": "ssm_groups",
    "use_conv_bias": "ssm_conv_bias", "num_mem_blocks": "n_shared_blocks",
    "adapter_rank": "adapter_rank",
}
# what the port must do and what it must not, as this reference models it: the
# convolution over x, B and C, exact GELU in a GeGLU MLP, the halved scale, causal
# attention, and nothing the reference does not model
PORT_SET = {"ssm_conv_xbc": True, "ffn_kind": "geglu", "gelu_approximate": "none",
            "attn_scale_div": 2.0, "causal": True, "qkv_bias": False, "qk_norm": False,
            "n_experts": 0, "logit_softcap": 0.0, "scale_embed": False,
            "encoder_layers": 0, "cross_attn_every": 0}


def port_departures(cfg: dict, arch) -> dict:
    """Where the port's ArchConfig ``arch`` departs from the file or does what this
    reference does not model: ``{key: (file's, port's)}``."""
    wrong = {}
    for key, attr in PORT_FIELDS.items():
        if getattr(arch, attr) != cfg[key]:
            wrong[key] = (cfg[key], getattr(arch, attr))
    for attr, value in PORT_SET.items():
        if getattr(arch, attr) != value:
            wrong[attr] = (value, getattr(arch, attr))
    if cfg["hidden_act"] != "gelu":
        wrong["hidden_act"] = (cfg["hidden_act"], "gelu")
    if list(arch.pattern) != kinds(cfg):
        wrong["hybrid_layer_ids"] = (cfg["hybrid_layer_ids"],
                                     [i for i, k in enumerate(arch.pattern) if k == "hybrid"])
    if list(cfg["layers_block_type"]) != kinds(cfg):
        wrong["layers_block_type"] = (cfg["layers_block_type"], kinds(cfg))
    return wrong


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------


def _ssd_rows(x, u, dt_a, Bg, Cg, lo, pr):
    """Rows ``lo..lo+R`` of one group's quadratic SSD: x and u = dt x (B,S,h,P),
    dt_a the running sum of A dt (B,S,h, float64), Bg and Cg (B,S,N).
    y[t] = sum_{s<=t} exp(cs_t - cs_s) (C_t . B_s) u_s, the sums taken relative to
    the block's first row so that near pairs keep their digits."""
    hi = lo + Cg.shape[1]
    cs = (dt_a[:, :hi] - dt_a[:, lo:lo + 1]).float()           # (B,hi,h)
    t = torch.arange(lo, hi, device=x.device)[:, None]
    s = torch.arange(hi, device=x.device)[None, :]
    seen = (s <= t)[None, :, :, None]
    ratio = cs[:, lo:hi, None, :] - cs[:, None, :, :]           # (B,R,hi,h)
    L = pr.w(torch.where(seen, torch.exp(torch.where(seen, ratio, 0.0)), 0.0))
    cb = pr.w(Cg @ Bg[:, :hi].transpose(1, 2))                  # (B,R,hi)
    return torch.einsum("btsh,bshp->bthp", L * cb[..., None], u[:, :hi])


def ssd(x, dt, A, Bm, Cm, D, pr=EXACT):
    """The SSD's quadratic form: x (B,S,nh,P), dt (B,S,nh), A (nh,) negative, Bm
    and Cm (B,S,G,N), D (nh,); float32.  Group by group, blocks of SSD_ROWS query
    rows recomputed in the backward."""
    Bsz, S, nh, P = x.shape
    G = Bm.shape[2]
    per = nh // G
    u = pr.w(dt[..., None] * x)
    dt_a = torch.cumsum((A * dt).double(), dim=1)               # (B,S,nh)
    ys = []
    for g in range(G):
        h = slice(g * per, (g + 1) * per)
        rows = [checkpoint(_ssd_rows, x[:, :, h], u[:, :, h], dt_a[:, :, h], Bm[:, :, g],
                           Cm[:, lo:lo + SSD_ROWS, g], lo, pr, use_reentrant=False)
                for lo in range(0, S, SSD_ROWS)]
        ys.append(torch.cat(rows, dim=1))
    return torch.cat(ys, dim=2) + D[:, None] * x


def _conv(xbc, w, b):
    """Causal depthwise convolution over the sequence with bias: (B,S,ch), w
    (W,ch), b (ch,)."""
    W = w.shape[0]
    out = F.conv1d(xbc.transpose(1, 2), w.t()[:, None, :], b, padding=W - 1,
                   groups=xbc.shape[-1])
    return out[..., :xbc.shape[1]].transpose(1, 2)


def mamba(P_, p, cfg, x, t, pr):
    """``x + mamba(norm(x + t))`` (t None: ``x + mamba(norm(x))``)."""
    m = _dims(cfg)
    eps, r, mm = cfg["rms_norm_eps"], pr.r, pr.mm
    Bsz, S, d = x.shape
    e, G, N, nh, Pd = m["e"], m["G"], m["N"], m["nh"], m["P"]
    h = R.rms_norm(x if t is None else r(x + t), P_[p + "ln"], eps, pr)
    z = mm(h, P_[p + "w_z"])
    xbc = torch.cat([mm(h, P_[p + "w_x"]), mm(h, P_[p + "w_B"]), mm(h, P_[p + "w_C"])], -1)
    xbc = r(F.silu(r(_conv(xbc, P_[p + "conv_w"], P_[p + "conv_b"]))))
    xs, Bm, Cm = xbc.split([e, G * N, G * N], dim=-1)
    dt = r(F.softplus(r(mm(h, P_[p + "w_dt"]) + P_[p + "dt_bias"])))
    A = -torch.exp(P_[p + "A_log"])
    y = r(ssd(xs.reshape(Bsz, S, nh, Pd), dt, A, Bm.reshape(Bsz, S, G, N),
              Cm.reshape(Bsz, S, G, N), P_[p + "D"], pr))
    y = r(y.reshape(Bsz, S, e) * r(F.silu(z)))
    yg = y.reshape(Bsz, S, G, e // G)
    inv = pr.w(torch.rsqrt(pr.w(yg.square().mean(-1, keepdim=True)) + eps))
    y = r((yg * inv).reshape(Bsz, S, e) * P_[p + "gn"])
    return r(x + mm(y, P_[p + "w_out"]))


def _attn_rows(q, k, v, lo, scale, pr):
    """Causal attention of query rows ``lo..lo+R`` (q (B,H,R,hd)) over keys 0..lo+R."""
    hi = lo + q.shape[2]
    s = pr.w(q @ k[:, :, :hi].transpose(-1, -2)) * scale
    seen = torch.arange(hi, device=q.device)[None, :] <= \
        torch.arange(lo, hi, device=q.device)[:, None]
    s = s.masked_fill(~seen, float("-inf"))
    return pr.mm(pr.w(torch.softmax(s, dim=-1)), v[:, :, :hi])


def shared_block(P_, b, u, cfg, x, e0, rope, pr):
    """Shared block ``b`` (prefix ``mem.b.``) at the use whose parameters are under
    ``u`` (``blocks.i.use.``): the block's output through the use's linear."""
    m = _dims(cfg)
    eps, r, mm = cfg["rms_norm_eps"], pr.r, pr.mm
    Bsz, S, d = x.shape
    H, KV, hd, w = m["H"], m["KV"], m["hd"], 2 * d
    h = R.rms_norm(torch.cat([x, e0], dim=-1), P_[b + "attn.ln"], eps, pr)
    q = mm(h, P_[b + "attn.wq"].reshape(w, H * hd)).reshape(Bsz, S, H, hd)
    k = mm(h, P_[b + "attn.wk"].reshape(w, KV * hd)).reshape(Bsz, S, KV, hd)
    v = mm(h, P_[b + "attn.wv"].reshape(w, KV * hd)).reshape(Bsz, S, KV, hd)
    rope = tuple(pr.w(t) for t in rope)
    q, k = r(R._rope(q, *rope)), r(R._rope(k, *rope))
    G_ = H // KV
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(G_, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(G_, dim=2).transpose(1, 2)
    scale = (hd / 2) ** -0.5
    o = torch.cat([checkpoint(_attn_rows, qh[:, :, lo:lo + ATTN_ROWS], kh, vh, lo, scale,
                              pr, use_reentrant=False)
                   for lo in range(0, S, ATTN_ROWS)], dim=2)
    o = mm(o.transpose(1, 2).reshape(Bsz, S, H * hd), P_[b + "attn.wo"].reshape(H * hd, d))
    h = R.rms_norm(o, P_[b + "ffn.ln"], eps, pr)
    lo_ = mm(h, P_[u + "a_in"])
    gate = r(mm(h, P_[b + "ffn.w_gate"]) + mm(lo_, P_[u + "a_gate"]))
    up = r(mm(h, P_[b + "ffn.w_up"]) + mm(lo_, P_[u + "a_up"]))
    y = mm(r(r(F.gelu(gate)) * up), P_[b + "ffn.w_down"])
    return mm(y, P_[u + "linear"])


def loss(P_: dict, cfg: dict, tokens: torch.Tensor, labels: torch.Tensor,
         pr: Precision = EXACT) -> torch.Tensor:
    """Mean next-token cross-entropy over every label."""
    B, S = tokens.shape
    x = pr.r(P_["embed.tok"][tokens.long()])
    e0 = x
    rope = R.rope_tables(S, cfg["head_dim"], cfg["rope_theta"], x.device)
    use = 0
    for i, kind in enumerate(kinds(cfg)):
        t = None
        if kind == "hybrid":
            b = f"mem.{use % cfg['num_mem_blocks']}."
            t = checkpoint(shared_block, P_, b, f"blocks.{i}.use.", cfg, x, e0, rope, pr,
                           use_reentrant=False)
            use += 1
        x = checkpoint(mamba, P_, f"blocks.{i}.mamba.", cfg, x, t, pr, use_reentrant=False)
    x = R.rms_norm(x, P_["final_norm"], cfg["rms_norm_eps"], pr).reshape(B * S, -1)
    labels = labels.reshape(B * S).long()
    total = sum(checkpoint(R._loss_rows, x[lo:lo + R.LOSS_ROWS], P_["embed.tok"],
                           labels[lo:lo + R.LOSS_ROWS], pr, use_reentrant=False)
                for lo in range(0, B * S, R.LOSS_ROWS))
    return total / (B * S)


# ---------------------------------------------------------------------------
# training: the steps the reference follows
# ---------------------------------------------------------------------------


def train(cfg: dict, params0: dict, batches: list[dict], opt: R.AdamW, seed: int,
          pr: Precision = EXACT, rows: slice = slice(None),
          double: str | None = None) -> R.Readings:
    """:func:`reference.adamw_train` on this module's :func:`loss`."""
    return R.adamw_train(cfg, params0, batches, opt, seed, loss_fn=loss, pr=pr, rows=rows,
                         double=double)
