"""Zamba2-7B on the port (``configs/zamba2_7b.py``): the model against the plain
float32 Zamba2 of ``tests/plain_zamba2.py`` on seeded weights at reduced widths, the
published Mamba2's grouped SSD in both of the port's forms against the quadratic
form, the softmax scale of the plain attention versions, the cut to 18 layers, the
registry, the planner's description, spans and counters; and, on the card (marker
``cuda``), flash attention at head_dim 224.

At reduced widths the whole 18-layer cut runs (shared blocks 0, 1, 0 at layers 6, 11
and 17), over 512 tokens, so the SSD takes its chunkwise form (4 chunks of 128).
A_log and dt_bias are drawn as published Mamba2 draws them (A from 1 to 16, dt
log-uniform in [1e-3, 0.1]), so some heads carry their state across chunks.
"""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

import plain_zamba2 as plain
from repro_torch.configs import (ALIASES, ARCH_IDS, EXTRA_ARCH_IDS, all_configs,
                                 get_config)
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.lm import LM
from repro_torch.obs import Obs

#: the ten architectures the JAX package mirrors
TEN = ("gemma_7b", "qwen2_7b", "qwen3_32b", "granite_34b", "qwen3_moe_30b_a3b",
       "dbrx_132b", "whisper_medium", "zamba2_2p7b", "llama_3p2_vision_11b", "xlstm_125m")
S = 512
#: float32 on both sides: the port sums the SSD by chunks (or steps) and the plain form
#: by query rows, in other orders, so the two differ by rounding alone.  Read here: the
#: loss the same to its last bit, the worst leaf 3.4e-5 of its largest gradient entry
#: (a dt_bias, whose gradient sums terms that mostly cancel); a port without the state
#: passed from chunk to chunk reads 1.8.  The limits leave ~3x room for other libraries'
#: summation orders and stay four decades under that fault.
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes side by side, and
    threads beyond a process's share of the cores make these small products crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sizes(cfg) -> dict:
    """The plain model's sizes for an ArchConfig."""
    return {"d": cfg.d_model, "layers": cfg.n_layers,
            "hybrid": [i for i, k in enumerate(cfg.pattern) if k == "hybrid"],
            "blocks": cfg.n_shared_blocks, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.hd, "ffn": cfg.d_ff, "adapter": cfg.adapter_rank,
            "expand": cfg.ssm_expand, "ssm_head_dim": cfg.ssm_head_dim,
            "state": cfg.ssm_state, "groups": cfg.ssm_groups, "conv": cfg.ssm_conv_width,
            "eps": cfg.norm_eps, "theta": cfg.rope_theta}


def published_ssd_init(model: LM, gen: torch.Generator) -> None:
    """A_log = log(A), A uniform in [1, 16]; dt_bias the inverse softplus of dt drawn
    log-uniform in [1e-3, 0.1] (Mamba2's initialisation)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("A_log"):
                p.copy_(torch.log(1 + 15 * torch.rand(p.shape, generator=gen)))
            elif name.endswith("dt_bias"):
                lo, hi = math.log(1e-3), math.log(0.1)
                dt = torch.exp(lo + (hi - lo) * torch.rand(p.shape, generator=gen))
                p.copy_(dt + torch.log(-torch.expm1(-dt)))


@pytest.fixture(scope="module")
def pair():
    """The reduced model (one sequence; blocks 2 x 64 wide, 16 SSD heads of 8 in two
    groups) with Mamba2's published initialisation, and the plain model's loss and
    gradients on the same weights."""
    cfg = get_config("zamba2_7b").reduced(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                                         ssm_head_dim=8)
    gen = torch.Generator().manual_seed(7)
    model = LM(cfg, device="cpu").init(gen)
    published_ssd_init(model, gen)
    tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen)
    labels = torch.randint(0, cfg.vocab, (1, S), generator=gen)
    params = dict(model.named_parameters())
    P = {n: p.detach().clone().requires_grad_() for n, p in params.items()}
    want = plain.loss(P, sizes(cfg), tokens, labels)
    want_grads = dict(zip(P, torch.autograd.grad(want, list(P.values()))))
    return cfg, model, tokens, labels, float(want), want_grads


def port(model, tokens, labels):
    params = dict(model.named_parameters())
    got = model.loss(tokens, labels)
    return float(got), dict(zip(params, torch.autograd.grad(got, list(params.values()))))


def worst_gap(got: dict, want: dict) -> tuple[float, str]:
    """The worst leaf's largest entry gap over its largest reference entry."""
    return max((float((got[n] - want[n]).abs().max() / want[n].abs().max()), n)
               for n in want)


def test_the_cut_runs_the_chunkwise_ssd(pair):
    cfg = pair[0]
    assert cfg.n_layers == 18 and cfg.ssm_groups == 2 and S % L.MAMBA_CHUNK == 0
    assert S > L.MAMBA_CHUNK
    assert cfg.shared_uses() == {6: (0, 0), 11: (1, 1), 17: (2, 0)}


def test_loss_and_every_gradient_match_the_plain_model(pair):
    cfg, model, tokens, labels, want, want_grads = pair
    obs = Obs()
    with L.recording(obs.span, obs.inc):
        got, got_grads = port(model, tokens, labels)
    # every group in one call
    assert obs.metrics.counters_with_prefix("model.ssd.") == {"model.ssd.chunked": 18}
    assert got == pytest.approx(want, rel=LOSS_TOL)
    assert got_grads.keys() == want_grads.keys()
    gap, where = worst_gap(got_grads, want_grads)
    assert gap <= GRAD_TOL, where


def dropped_chunk_to_chunk(x, B_in, C_in, dt, A_log, D, hd, h0, chunk):
    """The chunkwise SSD with no state passed from chunk to chunk: each chunk as a
    sequence of its own (a planted fault)."""
    Bb, S_, nh, _ = x.shape
    n = S_ // chunk

    def split(t):
        return t.reshape(Bb * n, chunk, *t.shape[2:])

    y, _ = ORIGINAL(split(x), split(B_in), split(C_in), split(dt), A_log, D, hd, None, chunk)
    return y.reshape(x.shape), torch.zeros((Bb, nh, hd, B_in.shape[-1]))


ORIGINAL = L._ssd_chunked_groups


def test_dropping_the_chunk_to_chunk_term_fails_by_far(pair, monkeypatch):
    # the comparison above sees the state carried between chunks: without it the
    # gap is over ten times its tolerance
    _, model, tokens, labels, _, want_grads = pair
    monkeypatch.setattr(L, "_ssd_chunked_groups", dropped_chunk_to_chunk)
    _, got_grads = port(model, tokens, labels)
    gap, where = worst_gap(got_grads, want_grads)
    assert gap > 10 * GRAD_TOL, where


def ssd_inputs(Bsz, S_, nh, P, G, N, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(Bsz, S_, nh, P, generator=gen)
    Bm = torch.randn(Bsz, S_, G, N, generator=gen) * 0.3
    Cm = torch.randn(Bsz, S_, G, N, generator=gen) * 0.3
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(Bsz, S_, nh, generator=gen))
    A_log = torch.log(1 + 15 * torch.rand(nh, generator=gen))
    D = torch.randn(nh, generator=gen)
    return x, Bm, Cm, dt, A_log, D


@pytest.mark.parametrize("S_, form", [(384, "chunked"), (200, "sequential")])
def test_both_ssd_forms_match_the_quadratic_form_at_two_groups(S_, form):
    # 384 = 3 chunks (the chunkwise form); 200 is no multiple of the chunk (the
    # sequential form); head h reads group h // 4
    x, Bm, Cm, dt, A_log, D = (t.requires_grad_() for t in ssd_inputs(1, S_, 8, 8, 2, 8, 3))
    obs = Obs()
    with L.recording(obs.span, obs.inc):
        y, _ = L._mamba_scan(x, Bm, Cm, dt, A_log, D, 8)
    calls = {"chunked": 1, "sequential": 2}[form]                     # a group each
    assert obs.metrics.counters_with_prefix("model.ssd.") == {f"model.ssd.{form}": calls}
    want = plain.ssd(x, dt, -torch.exp(A_log), Bm, Cm, D)
    assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(4))
    got_g = torch.autograd.grad(y, (x, Bm, Cm, dt, A_log, D), g)
    want_g = torch.autograd.grad(want, (x, Bm, Cm, dt, A_log, D), g)
    for name, a, b in zip(("x", "B", "C", "dt", "A_log", "D"), got_g, want_g):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name


def test_the_group_split_is_by_head_blocks():
    # group g's B and C reach heads g*4 .. g*4+3 only
    x, Bm, Cm, dt, A_log, D = ssd_inputs(1, 256, 8, 16, 2, 8, 5)
    y0, _ = L._mamba_scan(x, Bm, Cm, dt, A_log, D, 16)
    Bm2 = Bm.clone()
    Bm2[:, :, 1] += 1.0
    y1, _ = L._mamba_scan(x, Bm2, Cm, dt, A_log, D, 16)
    assert torch.equal(y0[:, :, :4], y1[:, :, :4])
    assert not torch.allclose(y0[:, :, 4:], y1[:, :, 4:])


@pytest.mark.parametrize("scale", [None, 112 ** -0.5, 0.9])
def test_plain_flash_versions_take_a_scale(scale):
    gen = torch.Generator().manual_seed(11)
    q, k, v, do = (torch.randn(2, 40, 4, 16, generator=gen) for _ in range(4))
    k, v = k[:, :, :2], v[:, :, :2]
    s = 1 / math.sqrt(16) if scale is None else scale
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    scores = torch.einsum("bqhd,bshd->bhqs", qr, kr.repeat_interleave(2, dim=2)) * s
    scores = scores.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(), float("-inf"))
    want = torch.einsum("bhqs,bshd->bqhd", torch.softmax(scores, -1),
                        vr.repeat_interleave(2, dim=2))
    got = ref.mha_reference(q, k, v, causal=True, scale=scale)
    assert torch.allclose(got, want, atol=1e-6)
    lse = ref.flash_attention_lse_reference(q, k, causal=True, scale=scale)
    assert torch.allclose(lse, torch.logsumexp(scores, -1), atol=1e-5)
    grads = ref.flash_attention_bwd_reference(q, k, v, got, lse, do, causal=True, scale=scale)
    for a, b in zip(grads, torch.autograd.grad(want, (qr, kr, vr), do)):
        assert torch.allclose(a, b, atol=1e-5)
    # and the differentiable entry point on the CPU
    out = ops.flash_attention(qr, kr, vr, causal=True, scale=scale)
    assert torch.allclose(out, want, atol=1e-6)


def test_the_cut_at_full_width():
    cfg = get_config("zamba2_7b")
    assert cfg.n_layers == 81 and cfg.pattern.count("hybrid") == 13
    cut = dataclasses.replace(cfg, n_layers=18)
    assert cut.pattern == tuple("hybrid" if i in (6, 11, 17) else "mamba" for i in range(18))
    assert [b for _, b in sorted(cut.shared_uses().values())] == [0, 1, 0]
    assert cut.softmax_scale == pytest.approx(112 ** -0.5)
    model = LM(cut, device="meta")
    assert model.n_params() == 2_245_451_680
    assert sum(p.numel() for p in model.parameters()) == 2_245_451_680


def test_the_ten_architectures_stay_the_jax_packages():
    assert ARCH_IDS == TEN
    assert sorted(all_configs()) == sorted(TEN)
    assert EXTRA_ARCH_IDS == ("zamba2_7b",) and not set(EXTRA_ARCH_IDS) & set(ARCH_IDS)
    assert get_config("zamba2-7b") is get_config("zamba2_7b") and ALIASES["zamba2-7b"]
    for arch in TEN:     # the new fields' defaults, read off the ten
        cfg = get_config(arch)
        assert (cfg.ssm_groups, cfg.ssm_conv_xbc, cfg.layer_kinds, cfg.attn_scale_div) == \
            (1, False, (), 1.0)
        assert cfg.softmax_scale == pytest.approx(1 / math.sqrt(cfg.hd))


def test_the_launcher_plans_and_trains_the_new_arch(tmp_path):
    # launch.train --arch zamba2_7b: the planner plans the HybridDesc, the Trainer trains
    from repro_torch.launch import train as launch_train
    trainer = launch_train.main(["--arch", "zamba2_7b", "--reduced", "--steps", "1",
                                 "--global-batch", "2", "--seq", "64", "--device", "cpu",
                                 "--ckpt-dir", str(tmp_path)])
    assert trainer.cfg.arch.name == "zamba2-7b-smoke" and trainer.plan is not None
    assert math.isfinite(trainer.history[-1]["loss"])


def test_the_planner_describes_what_runs():
    # each use of a shared block an "attn" layer of 2d-wide inputs ahead of its
    # Mamba2 layer; the planner holds a block's weights at each use (it has no shared
    # weights) and counts no norm of a shared block nor the final norm
    cut = dataclasses.replace(get_config("zamba2_7b"), n_layers=18)
    desc = cut.to_model_desc()
    assert desc.n_layers == 21 and desc.block_pattern.count("attn") == 3
    assert desc.layer_params(6) == 3 * 7168 * 7168 + 7168 * 3584 + 3 * 3584 * 14336 \
        + 3584 * 128 + 2 * 128 * 14336 + 3584 * 3584
    held = LM(cut, device="meta").n_params()
    block = sum(math.prod(d.shape) for _, d in L.flatten_defs(L.shared_block_defs(cut)))
    norms = 7168 + 3584
    assert desc.total_params() - held == block - 3 * norms - 3584


def test_spans_and_counters(tmp_path):
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = get_config("zamba2_7b").reduced(n_layers=12, d_model=64, n_heads=4,
                                         n_kv_heads=4, d_ff=128)   # blocks at 6 and 11
    obs = Obs()
    trainer = Trainer(TrainerConfig(arch=cfg, steps=1, global_batch=1, seq_len=256,
                                    ckpt_dir=str(tmp_path), ckpt_every=0, log_every=1,
                                    device="cpu"), obs=obs)
    trainer.run()
    spans = obs.tracer.span_dicts()
    assert [s["name"] for s in spans].count("model.ssd") == 12
    shared = [s["attrs"] for s in spans if s["name"] == "model.shared_block"]
    assert [(a["block"], a["use"]) for a in shared] == [(0, 0), (1, 1)]
    assert obs.metrics.counters_with_prefix("model.ssd.") == {"model.ssd.chunked": 12}
    ops.reset_launch_counts()
    assert ops.flash_launches_by_head_dim() == {"forward": {}, "backward": {}}


@pytest.mark.cuda
def test_flash_at_head_dim_224_on_the_card():
    # zamba2-7b's training shape, causal, scale (224/2)^-0.5, against the float32
    # plain versions: within the 16-bit tolerance the kernel tests use (2e-2 of the
    # largest entry), on the sm90_wgmma kernels both ways
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    scale = 112 ** -0.5
    q, k, v, do = (torch.randn(2, 4096, 32, 224, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ops.reset_launch_counts()
    o = ops.flash_attention(qr, kr, vr, causal=True, scale=scale)
    grads = torch.autograd.grad(o, (qr, kr, vr), do)
    assert ops.flash_launches_by_head_dim() == {"forward": {"224/sm90_wgmma": 1},
                                                "backward": {"224/sm90_wgmma": 1}}
    qf, kf, vf = (t.float() for t in (q, k, v))
    o_ref = ref.mha_reference(qf, kf, vf, causal=True, scale=scale)
    lse = ref.flash_attention_lse_reference(qf, kf, causal=True, scale=scale)
    want = ref.flash_attention_bwd_reference(qf, kf, vf, o_ref, lse, do.float(), causal=True,
                                             scale=scale)
    assert float((o.float() - o_ref).abs().max()) <= 2e-2 * float(o_ref.abs().max())
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert float((a.float() - b).abs().max()) <= 2e-2 * float(b.abs().max()), name
