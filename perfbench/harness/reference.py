"""The plain reference of the benchmark's language models: their loss, its
gradients and AdamW's update, in float32 plain PyTorch with TF32 off.

It imports nothing of the program.  It follows the configuration file
(``perfbench/configs/<name>.json``): a decoder over a cycle of block kinds, of
which it has one,

* ``attn``: RMSNorm, grouped-query attention with rope (half-split, angles in
  float32), optional q/k/v bias, causal, optional window; then RMSNorm and SwiGLU;

then a final RMSNorm and the tied head, with the mean cross-entropy over every
label.  The parameters are named as the program names its own, so that the harness
can give both sides the same values.  Memory: every layer, every block of query
rows of attention and every block of rows of the loss is recomputed in the backward
(``torch.utils.checkpoint``), so the full-width model fits beside its float32
AdamW state on one card.

A :class:`Precision` is where the control enters: the same model with every tensor
that the program holds in bfloat16 rounded to float8 instead (``FLOAT8``), the
precision below the configuration's.  ``BF16`` rounds them to bfloat16, as the
program does: a second witness of what that rounding alone gives.

This module is also the contract of a configuration's reference module
(``harness/<cfg["reference"]>.py``), which gives everything that depends on the
model: :func:`param_specs`, :func:`params_run`, :func:`loss`, :func:`train` (one call
into the shared :func:`adamw_train`), :func:`attention_calls`, :func:`other_flops`
and :func:`port_departures`.  What every model shares stays here: :class:`AdamW`,
:class:`Precision`, :class:`Readings`, :func:`float32_exact` and the AdamW loop.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: query rows a block of attention, and rows a block of the loss
ATTN_ROWS = 512
LOSS_ROWS = 1024

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclass(frozen=True)
class ParamSpec:
    name: str
    shape: tuple[int, ...]
    init: str            # normal | zeros | ones
    scale: float = 0.0   # normal only: the standard deviation


@dataclass(frozen=True)
class AdamW:
    """The optimizer the configuration trains with (the port's AdamWConfig)."""
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 0
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def lr(self, step: int) -> float:
        """Linear warm-up, then cosine decay to ``min_lr_frac`` of the peak."""
        if step < self.warmup_steps:
            return self.peak_lr * step / max(self.warmup_steps, 1)
        prog = min(max((step - self.warmup_steps)
                       / max(self.total_steps - self.warmup_steps, 1), 0.0), 1.0)
        return self.min_lr_frac * self.peak_lr + (1 - self.min_lr_frac) * \
            self.peak_lr * 0.5 * (1 + math.cos(math.pi * prog))


# ---------------------------------------------------------------------------
# the parameters
# ---------------------------------------------------------------------------


def kinds(cfg: dict) -> list[str]:
    pattern = cfg["layer_pattern"]
    if cfg["num_hidden_layers"] % len(pattern):
        raise ValueError(f"{cfg['name']}: {cfg['num_hidden_layers']} layers do not "
                         f"hold whole periods of {pattern}")
    return [pattern[i % len(pattern)] for i in range(cfg["num_hidden_layers"])]


def _normal(name, shape, scale=None):
    return ParamSpec(name, tuple(shape), "normal",
                     scale if scale is not None else 1.0 / math.sqrt(shape[0]))


def _attn_specs(p: str, cfg: dict) -> list[ParamSpec]:
    d, H, KV, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    out = [ParamSpec(p + "ln", (d,), "ones"), _normal(p + "wq", (d, H, hd)),
           _normal(p + "wk", (d, KV, hd)), _normal(p + "wv", (d, KV, hd)),
           _normal(p + "wo", (H, hd, d))]
    if cfg["qkv_bias"]:
        out += [ParamSpec(p + "bq", (H, hd), "zeros"), ParamSpec(p + "bk", (KV, hd), "zeros"),
                ParamSpec(p + "bv", (KV, hd), "zeros")]
    return out


def _ffn_specs(p: str, cfg: dict) -> list[ParamSpec]:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return [ParamSpec(p + "ln", (d,), "ones"), _normal(p + "w_up", (d, f)),
            _normal(p + "w_gate", (d, f)), _normal(p + "w_down", (f, d))]


def param_specs(cfg: dict) -> list[ParamSpec]:
    """Every parameter: its name (the program's), shape and initialisation."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    if not cfg["tie_word_embeddings"]:
        raise ValueError("the reference ties the head to the embedding")
    specs = [_normal("embed.tok", (V, d), 0.02), ParamSpec("final_norm", (d,), "ones")]
    for i, kind in enumerate(kinds(cfg)):
        p = f"blocks.{i}."
        if kind == "attn":
            specs += _attn_specs(p + "attn.", cfg) + _ffn_specs(p + "ffn.", cfg)
        else:
            raise ValueError(f"the reference has no block kind {kind!r}")
    return specs


def params_run(cfg: dict) -> int:
    """Parameters whose products run in a step."""
    return sum(math.prod(s.shape) for s in param_specs(cfg))


# ---------------------------------------------------------------------------
# the work of a step, beyond 6 operations a parameter and token
# ---------------------------------------------------------------------------


def attention_calls(cfg: dict, traffic: dict) -> list[dict]:
    """One entry for each kind of attention call in a step: batch ``B``, length
    ``S``, heads ``H``, key heads ``KV``, head size ``hd``, ``window`` (0: none), and
    the ``calls`` a forward pass makes.  Every call is causal."""
    return [{"B": traffic["global_batch"], "S": traffic["seq_len"],
             "H": cfg["num_attention_heads"], "KV": cfg["num_key_value_heads"],
             "hd": cfg["head_dim"], "window": cfg["attention_window"],
             "calls": kinds(cfg).count("attn")}]


def other_flops(cfg: dict, traffic: dict) -> float:
    """A step's model operations counted neither as 6 a parameter and token nor as
    attention's visible pairs: none in the dense decoder."""
    return 0.0


# ---------------------------------------------------------------------------
# the port's configuration against the file
# ---------------------------------------------------------------------------

# the configuration file's keys, and the port's ArchConfig fields that state them
PORT_FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "hd", "intermediate_size": "d_ff", "vocab_size": "vocab",
    "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta", "qkv_bias": "qkv_bias",
    "tie_word_embeddings": "tie_embeddings", "torch_dtype": "dtype",
    "attention_window": "attn_window",
}
# what the reference does not model, and the port must therefore not do
PORT_OFF = {"qk_norm": False, "n_experts": 0, "logit_softcap": 0.0, "scale_embed": False,
            "causal": True, "encoder_layers": 0, "cross_attn_every": 0,
            "ffn_kind": "swiglu"}


def port_departures(cfg: dict, arch) -> dict:
    """Where the port's ArchConfig ``arch`` departs from the file or does what this
    reference does not model: ``{key: (file's, port's)}``, empty when it runs the
    configuration as stated."""
    wrong = {}
    for key, attr in PORT_FIELDS.items():
        if key in cfg and getattr(arch, attr) != cfg[key]:
            wrong[key] = (cfg[key], getattr(arch, attr))
    for attr, value in PORT_OFF.items():
        if getattr(arch, attr) != value:
            wrong[attr] = (value, getattr(arch, attr))
    if tuple(arch.pattern) != tuple(cfg["layer_pattern"]):
        wrong["layer_pattern"] = (cfg["layer_pattern"], arch.pattern)
    return wrong


# ---------------------------------------------------------------------------
# precision: float32, or every stored tensor rounded (the control, the witness)
# ---------------------------------------------------------------------------


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to float32.  A float8 type takes one scale
    for the whole tensor, mapping its largest magnitude to the type's largest."""
    if dtype.itemsize >= 2:
        return x.to(dtype).to(x.dtype)
    fmax = torch.finfo(dtype).max
    scale = fmax / x.detach().abs().amax().float().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


class Precision:
    """What the reference holds in which type.  Two classes of tensor: those the
    program holds in its 16-bit type (every product's inputs and output, every
    norm's, activation's, residual sum's and projection's output, the logits),
    rounded by :meth:`r`; and those the configuration keeps in float32 (attention's
    scores and softmax, a norm's statistics, the rope angles, the loss's
    log-sum-exp, AdamW's moments), rounded by :meth:`w`.  Each rounds forward and its gradient backward.

    ``EXACT`` keeps both in float32.  ``BF16`` rounds the first class to bfloat16 as
    the program does: a second witness of what that rounding alone gives.
    ``FLOAT8``, the control, takes each stated precision one step down: the 16-bit
    class to float8 (e4m3 forward, e5m2 backward), the float32 class to bfloat16."""

    def __init__(self, name: str, fwd: torch.dtype | None, bwd: torch.dtype | None,
                 wide: torch.dtype | None = None):
        self.name, self.fwd, self.bwd, self.wide = name, fwd, bwd, wide

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.fwd is None else _Rounded.apply(x, self.fwd, self.bwd)

    def w(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.wide is None else _Rounded.apply(x, self.wide, self.wide)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(self.r(a) @ self.r(b))


EXACT = Precision("float32", None, None)
BF16 = Precision("bfloat16", torch.bfloat16, torch.bfloat16)
FLOAT8 = Precision("float8", torch.float8_e4m3fn, torch.float8_e5m2, torch.bfloat16)


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps, pr=EXACT):
    inv = pr.w(torch.rsqrt(pr.w(x.square().mean(-1, keepdim=True)) + eps))
    return pr.r(x * inv * w)


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_tables(S: int, hd: int, theta: float, device):
    half = hd // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float64, device=device)
                      * (math.log(theta) / half))
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * freqs
    return (torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :])


def _attn_rows(q, k, v, lo, window, pr):
    """Attention of the query rows ``lo..lo+R`` (q (B,H,R,hd)) over keys 0..lo+R."""
    R = q.shape[2]
    hi = lo + R
    k, v = k[:, :, :hi], v[:, :, :hi]
    s = pr.w(q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    qpos = torch.arange(lo, hi, device=q.device)[:, None]
    kpos = torch.arange(hi, device=q.device)[None, :]
    seen = kpos <= qpos
    if window:
        seen = seen & (qpos - kpos < window)
    s = s.masked_fill(~seen, float("-inf"))
    return pr.mm(pr.w(torch.softmax(s, dim=-1)), v)


def attention(q, k, v, window, pr):
    """Causal grouped-query attention; q (B,S,H,hd), k and v (B,S,KV,hd); query
    head h reads key head h // (H / KV)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    outs = [checkpoint(_attn_rows, q[:, :, lo:lo + ATTN_ROWS], k, v, lo, window, pr,
                       use_reentrant=False) for lo in range(0, S, ATTN_ROWS)]
    return torch.cat(outs, dim=2).transpose(1, 2)


def attn_ffn(P, p, cfg, x, rope, pr):
    """``x + attn(norm(x)) + ffn(...)`` with the attention's and FFN's parameters
    under the prefix ``p`` (``blocks.i.``)."""
    B, S, d = x.shape
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, r, mm = cfg["rms_norm_eps"], pr.r, pr.mm
    h = rms_norm(x, P[p + "attn.ln"], eps, pr)
    q = mm(h, P[p + "attn.wq"].reshape(d, H * hd)).reshape(B, S, H, hd)
    k = mm(h, P[p + "attn.wk"].reshape(d, KV * hd)).reshape(B, S, KV, hd)
    v = mm(h, P[p + "attn.wv"].reshape(d, KV * hd)).reshape(B, S, KV, hd)
    if cfg["qkv_bias"]:
        q = r(q + P[p + "attn.bq"])
        k = r(k + P[p + "attn.bk"])
        v = r(v + P[p + "attn.bv"])
    rope = tuple(pr.w(t) for t in rope)
    q, k = r(_rope(q, *rope)), r(_rope(k, *rope))
    o = attention(q, k, v, cfg["attention_window"], pr).reshape(B, S, H * hd)
    x = r(x + mm(o, P[p + "attn.wo"].reshape(H * hd, d)))
    h = rms_norm(x, P[p + "ffn.ln"], eps, pr)
    up = r(mm(h, P[p + "ffn.w_up"]) * r(F.silu(mm(h, P[p + "ffn.w_gate"]))))
    return r(x + mm(up, P[p + "ffn.w_down"]))


def _loss_rows(x, emb, labels, pr):
    logits = pr.mm(x, emb.t())
    lse = pr.w(torch.logsumexp(logits, -1))
    return (lse - logits.gather(-1, labels[:, None])[:, 0]).sum()


def loss(P: dict, cfg: dict, tokens: torch.Tensor, labels: torch.Tensor,
         pr: Precision = EXACT) -> torch.Tensor:
    """Mean next-token cross-entropy over every label."""
    B, S = tokens.shape
    x = pr.r(P["embed.tok"][tokens.long()])
    rope = rope_tables(S, cfg["head_dim"], cfg["rope_theta"], x.device)
    for i in range(len(kinds(cfg))):
        x = checkpoint(attn_ffn, P, f"blocks.{i}.", cfg, x, rope, pr, use_reentrant=False)
    x = rms_norm(x, P["final_norm"], cfg["rms_norm_eps"], pr).reshape(B * S, -1)
    labels = labels.reshape(B * S).long()
    total = sum(checkpoint(_loss_rows, x[lo:lo + LOSS_ROWS], P["embed.tok"],
                           labels[lo:lo + LOSS_ROWS], pr, use_reentrant=False)
                for lo in range(0, B * S, LOSS_ROWS))
    return total / (B * S)


# ---------------------------------------------------------------------------
# training: the steps the reference follows
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def float32_exact():
    """Float32 products as float32 (TF32 off), restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


@dataclass
class Readings:
    """What a training run gives the comparison: the loss of each step, the norm
    of each parameter's first gradient before clipping, its projection on the
    parameter's fixed random direction (``weights.project``), and the norm of each
    parameter's change over the steps."""
    losses: list[float]
    grad_norms: dict[str, float]
    grad_proj: dict[str, float]
    change_norms: dict[str, float]


def train(cfg: dict, params0: dict, batches: list[dict], opt: AdamW, seed: int,
          pr: Precision = EXACT, rows: slice = slice(None),
          double: str | None = None) -> Readings:
    """:func:`adamw_train` on this module's :func:`loss`."""
    return adamw_train(cfg, params0, batches, opt, seed, loss_fn=loss, pr=pr, rows=rows,
                       double=double)


def adamw_train(cfg: dict, params0: dict, batches: list[dict], opt: AdamW, seed: int, *,
                loss_fn, pr: Precision = EXACT, rows: slice = slice(None),
                double: str | None = None) -> Readings:
    """Follow ``len(batches)`` AdamW steps of ``loss_fn(P, cfg, tokens, labels, pr)``
    from ``params0`` (name -> tensor in the parameter type, on the device the
    reference runs on).  The update is float32 and each parameter is stored back in
    the configuration's ``param_dtype`` after it, as the configuration states.
    ``seed`` draws the directions the first gradient is projected on.  ``pr``
    rounds what the program would hold in its 16-bit type (the control, the
    witness).  Planted faults, for the control's tests: ``rows`` keeps a share of
    each batch's rows (the rest left out), ``double`` names a parameter whose update
    is applied twice."""
    from harness.weights import project     # weights imports this module
    store = DTYPES[cfg["param_dtype"]]
    dev = next(iter(params0.values())).device
    names = list(params0)
    P = {n: params0[n].to(torch.float32, copy=True).requires_grad_() for n in names}
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    losses, grad_norms, grad_proj = [], {}, {}
    with float32_exact():
        for t, batch in enumerate(batches, start=1):
            tok = torch.as_tensor(np.ascontiguousarray(batch["tokens"][rows]), device=dev)
            lab = torch.as_tensor(np.ascontiguousarray(batch["labels"][rows]), device=dev)
            value = loss_fn(P, cfg, tok, lab, pr)
            grads = torch.autograd.grad(value, [P[n] for n in names])
            losses.append(float(value.detach()))
            del value
            norms = [g.norm() for g in grads]
            if t == 1:
                grad_norms = {n: float(g) for n, g in zip(names, norms)}
                grad_proj = project(dict(zip(names, grads)), seed)
            gnorm = torch.stack(norms).norm()
            scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            lr = opt.lr(t)
            with torch.no_grad():
                for n, g in zip(names, grads):
                    g = g * scale
                    m[n].mul_(opt.b1).add_(g, alpha=1 - opt.b1)
                    v[n].mul_(opt.b2).addcmul_(g, g, value=1 - opt.b2)
                    if pr.wide is not None:       # the control's moments
                        m[n].copy_(m[n].to(pr.wide))
                        v[n].copy_(v[n].to(pr.wide))
                    step = (m[n] / (1 - opt.b1 ** t)) / \
                        ((v[n] / (1 - opt.b2 ** t)).sqrt() + opt.eps)
                    step.add_(P[n], alpha=opt.weight_decay)
                    P[n].sub_(step, alpha=lr * (2 if n == double else 1))
                    P[n].copy_(P[n].to(store).float())
            del grads
    with torch.no_grad():
        change = {n: float((P[n] - params0[n].float()).norm()) for n in names}
    return Readings(losses, grad_norms, grad_proj, change)
