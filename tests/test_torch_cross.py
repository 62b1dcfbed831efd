"""Cross-attention and its encoder in the port against the JAX package: the
attention kernel's plain version with more queries than keys (no mask) against
the Pallas kernel in interpret mode, ``cross_attn_block``, whisper's ``encode``,
and llama-3.2-vision and whisper at reduced size as whole models (forward,
prefill, caches, decode, loss, gradients, a train step, checkpoints, the
trainer), float32 on the CPU, weights from the JAX package's ``LM.init`` handed
to both sides as numpy; the modality inputs are seeded numpy embeddings at
0.02 scale, as ``SyntheticLM`` makes them.

Every model case runs at S = 8 and at S = 32, longer than the reduced configs'
16 vision patches and 24 audio frames, so cross-attention at prefill has more
queries than keys.  Tolerances are those of ``test_torch_lm.py``, the absolute
part scaled by the compared array's largest magnitude when that is above 1
(:func:`_close`).

Gradients and the train step are held with the port in float64 against the JAX
package in float64.  Neither side is float64 throughout: both take attention
scores and the cross-entropy's logits in float32 (and the port's plain attention
backward runs in float32), and at S = 32 through ten layers that rounding moves a
gradient by up to ~2e-3 of its largest magnitude (JAX's own float32 gradient
strays up to ~4e-3 from its float64 one).  So each leaf is held to be no farther
from JAX's float64 result than JAX's own float32 result is, and never farther
than 1e-4 where that is closer (:func:`_no_farther`).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel.trainstep import make_train_step as jax_train_step  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, layers  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.trainstep import (_split_mods,  # noqa: E402
                                            make_prefill_step, make_serve_step,
                                            make_train_step)
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

CROSS = ["llama_3p2_vision_11b", "whisper_medium"]
B = 2


def _numpy_tree(tree, rng):
    """jax tree -> nested dicts of float32 numpy; constant leaves (norms at one,
    the cross-attention gates at zero) are perturbed so that a mixed-up one
    shows and the gates let the memory through."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if np.ptp(a) == 0:
        a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    return a


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _close(got, want, tol, err_msg=""):
    """|got - want| <= tol * max(1, max|want|) + tol * |want|, elementwise."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol, err_msg=err_msg)


def _no_farther(got, want, jax32, tol, err_msg=""):
    """max|got - want| <= max(tol, max|jax32 - want|), both as shares of
    max(1, max|want|): the port no farther from the float64 reference than the
    reference's own float32 run."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    floor = float(np.abs(np.asarray(jax32) - want).max()) / scale
    assert err <= max(tol, floor), f"{err_msg}: {err:.3e} > max({tol:g}, {floor:.3e})"


def _mods(cfg, rng, batch=B):
    """The modality inputs a config needs, as numpy float32 at 0.02 scale."""
    out = {}
    if cfg.encoder_layers:
        out["audio_embed"] = (rng.standard_normal((batch, cfg.audio_seq, cfg.d_model))
                              * 0.02).astype(np.float32)
    if cfg.cross_attn_every:
        out["vision_embed"] = (rng.standard_normal((batch, cfg.vision_seq, cfg.d_model))
                               * 0.02).astype(np.float32)
    return out


def _f64(cfg):
    return dataclasses.replace(cfg, dtype="float64")


# ------------------------------------------------------------ the kernel's contract

# (B, Sq, Skv, H, KV, hd): more queries than keys, nothing masked.  Multiples of the
# Pallas test's 32-row block for the interpret-mode kernel (it halves its block
# until it divides S); ragged ones against the jnp oracle.
MORE_Q_CASES = [(1, 96, 64, 4, 2, 32), (2, 128, 32, 4, 4, 64), (1, 64, 32, 2, 1, 128)]
MORE_Q_RAGGED = [(1, 70, 24, 4, 2, 32), (2, 200, 70, 4, 2, 128), (1, 33, 1, 2, 2, 16)]


def _qkv(case, seed):
    Bq, Sq, Skv, H, KV, hd = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((Bq, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((Bq, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32))


@pytest.mark.parametrize("case", MORE_Q_CASES, ids=str)
def test_flash_attention_more_queries_than_keys_matches_pallas(case):
    """``ops.flash_attention(causal=False)`` with Sq > Skv against the Pallas
    kernel in interpret mode, forward and through its VJP (the reference's custom
    VJP differentiates its ``mha_reference``)."""
    q, k, v, do = _qkv(case, 1)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=False, block_q=32,
                                                  block_kv=32, interpret=True), jq, jk, jv)
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=False)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("case", MORE_Q_RAGGED, ids=str)
def test_flash_attention_more_queries_than_keys_matches_oracle(case):
    q, k, v, do = _qkv(case, 2)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want, vjp = jax.vjp(lambda a, b, c: jref.mha_reference(a, b, c, causal=False), jq, jk, jv)
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=False)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as lying on CUDA device 0, so that the
    wrapper's CUDA-path checks run here (only refusals: an accepted call would
    go on to build the kernels)."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)

    def get_device(self):
        return 0


MASKED = [(True, 0), (False, 4), (True, 4)]
REFUSALS = [(c, w, dev) for c, w in MASKED for dev in ("cpu", "cuda")]


@pytest.mark.parametrize("causal,window,device", REFUSALS,
                         ids=[f"causal{c}-window{w}-{d}" for c, w, d in REFUSALS])
def test_masked_attention_with_more_queries_than_keys_raises(causal, window, device):
    q, k, v, _ = (torch.from_numpy(a).bfloat16() for a in _qkv((1, 8, 4, 2, 2, 16), 3))
    if device == "cuda":
        q, k, v = (t.as_subclass(_FakeCuda) for t in (q, k, v))
    with pytest.raises(ValueError, match="Sq"):
        ops.flash_attention(q, k, v, causal=causal, window=window)


# ------------------------------------------------------------ cross-attention block


def _cross_inputs(arch, seed, S, M):
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    rng = np.random.default_rng(seed)
    pnp = _numpy_tree(jlayers.materialize(jlayers.cross_attn_defs(jcfg),
                                          jax.random.PRNGKey(seed), jnp.float32), rng)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mem = (rng.standard_normal((B, M, cfg.d_model)) * 0.5).astype(np.float32)
    return cfg, jcfg, pnp, x, mem


CROSS_BLOCK = [(a, S) for a in CROSS for S in (8, 40)]


@pytest.mark.parametrize("arch,S", CROSS_BLOCK, ids=[f"{a}-S{S}" for a, S in CROSS_BLOCK])
def test_cross_attn_block_matches_reference(arch, S):
    cfg, jcfg, pnp, x, mem = _cross_inputs(arch, 1, S, 16)
    want = np.asarray(jlayers.cross_attn_block({k: jnp.asarray(v) for k, v in pnp.items()},
                                               jcfg, jnp.asarray(x), jnp.asarray(mem)))
    got = layers.cross_attn_block({k: torch.tensor(v) for k, v in pnp.items()}, cfg,
                                  torch.from_numpy(x), torch.from_numpy(mem))
    _close(got.numpy(), want, 1e-5)
    assert float(np.abs(want - x).max()) > 1e-3     # the gate lets the memory through


@pytest.mark.parametrize("arch,S", CROSS_BLOCK, ids=[f"{a}-S{S}" for a, S in CROSS_BLOCK])
def test_cross_attn_block_gradients_match_reference(arch, S):
    """Gradients of every weight, the gate, x and the memory, float64 on both sides."""
    cfg, jcfg, pnp, x, mem = _cross_inputs(arch, 2, S, 16)
    dy = np.random.default_rng(3).standard_normal(x.shape)
    with jax.enable_x64(True):
        jp = {k: jnp.asarray(v, jnp.float64) for k, v in pnp.items()}
        _, vjp = jax.vjp(lambda p, a, m: jlayers.cross_attn_block(p, _f64(jcfg), a, m), jp,
                         jnp.asarray(x, jnp.float64), jnp.asarray(mem, jnp.float64))
        jgp, jgx, jgm = jax.tree.map(np.asarray, vjp(jnp.asarray(dy)))
    tp = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True) for k, v in pnp.items()}
    tx = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    tm = torch.tensor(mem, dtype=torch.float64, requires_grad=True)
    grads = torch.autograd.grad(layers.cross_attn_block(tp, _f64(cfg), tx, tm),
                                [tx, tm, *tp.values()], torch.from_numpy(dy))
    _close(grads[0].numpy(), jgx, 1e-6, "x")
    _close(grads[1].numpy(), jgm, 1e-6, "memory")
    for name, g in zip(tp, grads[2:]):
        _close(g.numpy(), jgp[name], 1e-6, err_msg=name)


def test_cross_attn_defs_match_reference():
    cfg, jcfg = get_config("whisper_medium").reduced(), jax_config("whisper_medium").reduced()
    tdefs, jdefs = layers.cross_attn_defs(cfg), jlayers.cross_attn_defs(jcfg)
    assert list(tdefs) == list(jdefs)
    for k in jdefs:
        assert (tdefs[k].shape, tdefs[k].scale, tdefs[k].init) == \
            (jdefs[k].shape, jdefs[k].scale, jdefs[k].init)


# ------------------------------------------------------------ whole models

MODEL_CASES = [(a, S) for a in CROSS for S in (8, 32)]


@pytest.fixture(scope="module", params=MODEL_CASES, ids=[f"{a}-S{S}" for a, S in MODEL_CASES])
def pair(request):
    """Both models on the same weights, tokens and modality inputs, with every
    result the tests compare computed once."""
    arch, S = request.param
    jcfg = jax_config(arch).reduced()
    jm = JaxLM(jcfg)
    rng = np.random.default_rng(MODEL_CASES.index(request.param))
    pnp = _numpy_tree(jm.init(jax.random.PRNGKey(1)), rng)
    jparams = jax.tree.map(jnp.asarray, pnp)
    tokens = rng.integers(0, jcfg.vocab, (B, S + 1), dtype=np.int32)
    mods = _mods(jcfg, rng)
    jmods = {k: jnp.asarray(v) for k, v in mods.items()}
    jt = jnp.asarray(tokens)

    jx = jax.jit(jm.forward)(jparams, jt[:, :S], **jmods)
    jlogits, jstacked = jax.jit(jm.prefill)(jparams, jt[:, :S], **jmods)
    jflat = jm.unstack_cache(jstacked)
    jstep = jax.jit(jm.decode_step)
    jcache = jm.init_cache(B, S + 2)
    jchain = []
    for t in range(S + 1):
        lg, jcache = jstep(jparams, jcache, jt[:, t:t + 1], jnp.full((B,), t, jnp.int32),
                           **jmods)
        jchain.append(np.asarray(lg))
    jmemory = (np.asarray(jax.jit(jm.encode)(jparams, jmods["audio_embed"]))
               if jcfg.encoder_layers else None)

    tm = convert.load_jax_params(LM(get_config(arch).reduced(), device="cpu"), pnp)
    tt = torch.from_numpy(tokens)
    tmods = {k: torch.from_numpy(v) for k, v in mods.items()}
    with torch.no_grad():
        tx = tm.forward(tt[:, :S], **tmods)
        tmemory = tm.encode(tmods["audio_embed"]).numpy() if jcfg.encoder_layers else None
    tlogits, tstacked = make_prefill_step(tm)({"tokens": tt[:, :S], **tmods})
    serve = make_serve_step(tm)
    tcache = tm.init_cache(B, S + 2, device="cpu")
    tchain = []
    for t in range(S + 1):
        lg, tcache = serve(tcache, {"tokens": tt[:, t:t + 1],
                                    "pos": torch.full((B,), t, dtype=torch.int32), **tmods})
        tchain.append(lg.numpy().copy())
    return dict(arch=arch, S=S, jm=jm, tm=tm, pnp=pnp, jcfg=jcfg, mods=mods,
                jx=np.asarray(jx), tx=tx.numpy(), jmemory=jmemory, tmemory=tmemory,
                jlogits=np.asarray(jlogits), tlogits=tlogits.numpy(),
                jflat=jflat, tstacked=tstacked, jstacked=jstacked,
                jchain=jchain, tchain=tchain, jcache=jcache, tcache=tcache)


def test_blocks_hold_cross_attention_where_the_pattern_says(pair):
    tm, cfg = pair["tm"], pair["tm"].cfg
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    assert [hasattr(b, "cross") for b in tm.blocks] == [k == "cross_attn" for k in kinds]
    assert "cross_attn" in kinds
    assert hasattr(tm, "encoder") == bool(cfg.encoder_layers)
    if cfg.cross_attn_every:     # the prompt is longer than the memory at S = 32
        assert (pair["S"] > cfg.vision_seq) == (pair["S"] == 32)
    else:
        assert (pair["S"] > cfg.audio_seq) == (pair["S"] == 32)


def test_encode(pair):
    if pair["jmemory"] is None:
        assert pair["tmemory"] is None
        return
    assert pair["tmemory"].shape == (B, pair["jcfg"].audio_seq, pair["jcfg"].d_model)
    _close(pair["tmemory"], pair["jmemory"], 1e-4)


def test_forward_hidden(pair):
    _close(pair["tx"], pair["jx"], 1e-4)


def test_prefill_logits(pair):
    assert pair["tlogits"].shape == (B, pair["jcfg"].vocab)
    _close(pair["tlogits"], pair["jlogits"], 1e-4)


def test_prefill_cache_stacked_layout(pair):
    jcfg, S = pair["jcfg"], pair["S"]
    assert len(pair["tstacked"]) == jcfg.cycle_len == len(pair["jstacked"])
    for tpos, jpos in zip(pair["tstacked"], pair["jstacked"]):
        assert set(tpos) == {"k", "v"}
        for name in ("k", "v"):
            assert tuple(tpos[name].shape) == jpos[name].shape == (
                jcfg.n_cycles, B, S, jcfg.n_kv_heads, jcfg.hd)


def test_prefill_cache_every_leaf_after_unstack(pair):
    tflat = pair["tm"].unstack_cache(pair["tstacked"])
    assert len(tflat) == len(pair["jflat"]) == pair["jcfg"].n_layers
    for tl, jl in zip(tflat, pair["jflat"]):
        for name in ("k", "v"):
            _close(tl[name].numpy(), np.asarray(jl[name]), 1e-4)


def test_decode_chain_teacher_forced(pair):
    for t, (tl, jl) in enumerate(zip(pair["tchain"], pair["jchain"])):
        _close(tl, jl, 2e-3, err_msg=f"step {t}")
    for tc, jc in zip(pair["tcache"], pair["jcache"]):
        for name in ("k", "v"):
            _close(tc[name].numpy(), np.asarray(jc[name]), 2e-3)


def test_decode_agrees_with_prefill(pair):
    """Step S-1 of the chain has seen tokens 0..S-1: the prefill's logits."""
    S = pair["S"]
    _close(pair["tchain"][S - 1], pair["tlogits"], 2e-3)


def test_memory_matters(pair):
    """Another memory changes the output: cross-attention reads it (the
    batch's two memories swapped, at 50 times the 0.02 scale so that the change
    shows far above rounding)."""
    tm, S = pair["tm"], pair["S"]
    mods = {k: torch.from_numpy(v * 50) for k, v in pair["mods"].items()}
    other = {k: v.flip(0) for k, v in mods.items()}
    tokens = torch.zeros((B, S), dtype=torch.int64)
    base, _ = tm.prefill(tokens, **mods)
    swapped, _ = tm.prefill(tokens, **other)
    assert float((base[0] - swapped[1]).abs().max()) < 1e-4 < \
        float((base[0] - swapped[0]).abs().max())


def test_missing_modality_input_raises(pair):
    with pytest.raises(ValueError, match="needs"):
        pair["tm"].prefill(torch.zeros((1, 4), dtype=torch.int64))


def test_n_params(pair):
    assert pair["tm"].n_params() == pair["jm"].n_params()
    assert pair["tm"].n_params() == sum(p.numel() for p in pair["tm"].parameters())


def test_export_gives_back_what_was_loaded(pair):
    got, want = _flat(convert.export_jax_params(pair["tm"])), _flat(pair["pnp"])
    assert sorted(got) == sorted(want)
    assert any(".cross." in path for path in got)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_init_fills_every_parameter(pair):
    cfg = pair["tm"].cfg
    m = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    assert all(bool(torch.isfinite(p).all()) for p in m.parameters())
    assert torch.all(m.final_norm == 1)
    gates = [b.cross["gate"] for b in m.blocks if hasattr(b, "cross")]
    assert gates and all(torch.all(g == 0) for g in gates)    # zeros, as the reference
    if cfg.encoder_layers:
        assert torch.all(m.enc_norm == 1) and len(m.encoder) == cfg.encoder_layers
    rng = np.random.default_rng(0)
    logits, _ = m.prefill(torch.zeros((1, 4), dtype=torch.int64),
                          **{k: torch.from_numpy(v) for k, v in _mods(cfg, rng, 1).items()})
    assert bool(torch.isfinite(logits).all())


# ------------------------------------------------------------ training


@pytest.fixture(scope="module", params=CROSS)
def grads_pair(request):
    arch = request.param
    jcfg = jax_config(arch).reduced()
    jm = JaxLM(jcfg)
    rng = np.random.default_rng(20 + CROSS.index(arch))
    pnp = _numpy_tree(jm.init(jax.random.PRNGKey(2)), rng)
    S = 32
    tokens = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    labels = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    labels[0, :3] = -100
    mods = _mods(jcfg, rng)
    jl32, jg32 = jax.jit(jax.value_and_grad(lambda p, t, lb: jm.loss(
        p, t, lb, **{k: jnp.asarray(v) for k, v in mods.items()})))(
            jax.tree.map(jnp.asarray, pnp), jnp.asarray(tokens), jnp.asarray(labels))
    jl32, jg32 = float(jl32), jax.tree.map(np.asarray, jg32)
    with jax.enable_x64(True):
        jm64 = JaxLM(_f64(jcfg))
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), pnp)
        m64 = {k: jnp.asarray(v, jnp.float64) for k, v in mods.items()}
        jl, jg = jax.jit(jax.value_and_grad(lambda p, t, lb: jm64.loss(p, t, lb, **m64)))(
            p64, jnp.asarray(tokens), jnp.asarray(labels))
        jl, jg = float(jl), jax.tree.map(np.asarray, jg)
    tmods = {k: torch.from_numpy(v) for k, v in mods.items()}
    tm32 = convert.load_jax_params(LM(get_config(arch).reduced(), device="cpu"), pnp)
    loss32 = float(tm32.loss(torch.from_numpy(tokens), torch.from_numpy(labels), **tmods))
    tm = convert.load_jax_params(LM(_f64(get_config(arch).reduced()), device="cpu"), pnp)
    tmods64 = {k: v.double() for k, v in tmods.items()}
    loss = tm.loss(torch.from_numpy(tokens), torch.from_numpy(labels), **tmods64)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    return dict(arch=arch, jcfg=jcfg, pnp=pnp, tokens=tokens, labels=labels, mods=mods,
                tm=tm, tmods64=tmods64, jloss=jl, jloss32=jl32, jgrads=jg, jgrads32=jg32,
                loss=float(loss), loss32=loss32, grads=dict(zip(names, grads)))


def test_loss_matches_reference(grads_pair):
    for want in (grads_pair["jloss"], grads_pair["jloss32"]):
        np.testing.assert_allclose(grads_pair["loss32"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads_pair["loss"], grads_pair["jloss"], rtol=1e-6)


def test_every_gradient_matches_reference(grads_pair):
    got = convert.export_jax_tree(grads_pair["tm"], grads_pair["grads"])
    flat, want, want32 = _flat(got), _flat(grads_pair["jgrads"]), _flat(grads_pair["jgrads32"])
    assert sorted(flat) == sorted(want)
    for path in want:
        _no_farther(flat[path], want[path], want32[path], 1e-4, err_msg=path)
    gates = [path for path in flat if path.endswith("cross.gate")]
    assert gates and all(float(np.abs(flat[p]).max()) > 0 for p in gates)
    if grads_pair["jcfg"].encoder_layers:     # the loss reaches the encoder through the memory
        assert float(np.abs(flat["encoder.attn.wq"]).max()) > 0


def test_train_step_matches_reference(grads_pair):
    """One AdamW step with the modality input in the batch, the port in float64
    against JAX in float64, no farther from it than JAX's float32 step (eps 1e-3,
    as in ``test_torch_train.py``)."""
    pnp, jcfg = grads_pair["pnp"], grads_pair["jcfg"]
    cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-3)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    batch = {"tokens": grads_pair["tokens"], "labels": grads_pair["labels"],
             **grads_pair["mods"]}
    jparams32 = jax.tree.map(jnp.asarray, pnp)
    j32, jmet32 = jax.jit(jax_train_step(JaxLM(jcfg), jopt, remat="none"))(
        {"params": jparams32, "opt": jadamw.init_opt_state(jparams32)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    j32, jmet32 = jax.tree.map(np.asarray, (j32, jmet32))
    with jax.enable_x64(True):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), pnp)
        jstate = {"params": jparams, "opt": jadamw.init_opt_state(jparams)}
        jnew, jmet = jax.jit(jax_train_step(JaxLM(_f64(jcfg)), jopt, remat="none"))(
            jstate, {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else None)
                     for k, v in batch.items()})
        jnew, jmet = jax.tree.map(np.asarray, (jnew, jmet))
        start = jax.tree.map(np.asarray, jstate)
    tm = LM(_f64(get_config(grads_pair["arch"]).reduced()), device="cpu")
    state = convert.load_jax_train_state(tm, start)
    # the embeddings go in as float32: the step casts them to the model's dtype
    new, met = make_train_step(tm, cfg, remat="none")(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key, tol in (("loss", 1e-6), ("grad_norm", 1e-5), ("lr", 1e-6)):
        _no_farther(float(met[key]) / float(jmet[key]), 1.0,
                    float(jmet32[key]) / float(jmet[key]), tol, err_msg=key)
    out = convert.export_jax_train_state(tm, new)
    for part, got, want, want32 in (("params", out["params"], jnew["params"], j32["params"]),
                                    ("m", out["opt"].m, jnew["opt"].m, j32["opt"].m)):
        got, want, want32 = _flat(got), _flat(want), _flat(want32)
        assert sorted(got) == sorted(want)
        for path in want:
            _no_farther(got[path], want[path], want32[path], 1e-5, err_msg=f"{part} {path}")


@pytest.mark.parametrize("remat", ["selective", "full"])
def test_remat_changes_nothing(grads_pair, remat):
    tm = grads_pair["tm"]
    loss = tm.loss(torch.from_numpy(grads_pair["tokens"]),
                   torch.from_numpy(grads_pair["labels"]), remat=remat,
                   **grads_pair["tmods64"])
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    assert float(loss) == grads_pair["loss"]
    for (name, _), g in zip(tm.named_parameters(), grads):
        torch.testing.assert_close(g, grads_pair["grads"][name], rtol=0, atol=1e-12, msg=name)


# ------------------------------------------------------------ checkpoints and trainer


def _jax_state(arch, dtype, seed):
    jm = JaxLM(jax_config(arch).reduced(dtype=dtype))
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    noise = lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)  # noqa: E731
    return {"params": params,
            "opt": jadamw.OptState(jax.tree.map(noise, params),
                                   jax.tree.map(lambda p: jnp.abs(noise(p)), params),
                                   jnp.asarray(3, jnp.int32))}


CKPT_CASES = [(a, dt) for a in CROSS for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", CKPT_CASES, ids=[f"{a}-{d}" for a, d in CKPT_CASES])
def test_checkpoints_cross_both_ways(tmp_path, arch, dtype):
    jst = _jax_state(arch, dtype, 0)
    jstore.save(tmp_path / "jax", jst, step=3)
    model = LM(get_config(arch).reduced(dtype=dtype), device="cpu")
    tree, manifest = store.restore(tmp_path / "jax", convert.jax_train_state_like(model))
    state = convert.load_jax_train_state(model, tree)
    assert manifest["step"] == 3 and int(state["opt"].step) == 3
    store.save(tmp_path / "port", convert.export_jax_train_state(model, state), step=4)
    back, manifest = jstore.restore(tmp_path / "port", _jax_state(arch, dtype, 9))
    assert manifest["step"] == 4
    for part in ("params", "m", "v"):
        a = jst["params"] if part == "params" else getattr(jst["opt"], part)
        b = back["params"] if part == "params" else getattr(back["opt"], part)
        want, got = _flat(jax.tree.map(np.asarray, a)), _flat(b)
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg=f"{part} {path}")
    if arch == "whisper_medium":
        assert {"encoder.attn.wq", "enc_norm", "pos0.cross.gate"} <= set(want)


@pytest.mark.parametrize("arch", CROSS)
def test_trainer_feeds_the_modality_input(tmp_path, arch):
    """The trainer's batches carry the pipeline's float32 embedding to the device;
    the step casts it, so it reaches a bf16 model in bf16, and the steps run."""
    cfg = get_config(arch).reduced(n_layers=get_config(arch).reduced().cycle_len,
                                   dtype="bfloat16")
    trainer = Trainer(TrainerConfig(arch=cfg, steps=2, global_batch=2, seq_len=32,
                                    ckpt_dir=str(tmp_path), ckpt_every=0, log_every=1,
                                    device="cpu"))
    batch = trainer._place(trainer.data.batch(0))
    key = "audio_embed" if cfg.encoder_layers else "vision_embed"
    assert batch[key].dtype == torch.float32 and batch["tokens"].dtype == torch.int32
    assert _split_mods(trainer.model, batch)[1][key].dtype == torch.bfloat16
    _, hist = trainer.run()
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("arch", CROSS + ["qwen2_7b", "qwen3_moe_30b_a3b"])
def test_modality_inputs_follow_the_input_specs(arch):
    """The random modality inputs the entry points make have the keys, shapes and
    dtype of the config's input specs (none for a model without cross-attention),
    at 0.02 scale, and the same seed gives the same inputs."""
    from repro_torch.data.pipeline import modality_inputs
    from repro_torch.models.config import ShapeSpec

    cfg = get_config(arch).reduced(dtype="bfloat16")
    specs = cfg.input_specs(ShapeSpec("p", 8, 3, "prefill"))
    got = modality_inputs(cfg, 3, torch.Generator().manual_seed(5), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
        {k: spec for k, spec in specs.items() if k.endswith("_embed")}
    again = modality_inputs(cfg, 3, torch.Generator().manual_seed(5), "cpu")
    for key, t in got.items():
        assert torch.equal(t, again[key])
        assert 0.015 < float(t.float().std()) < 0.025
