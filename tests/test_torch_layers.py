"""Layer functions of the port against their twins in the JAX package, in
float32 on the CPU, on weights made by the JAX package's own init (biases and
norm weights, which it makes constant, are perturbed with numpy so that a
swapped or dropped one shows)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _weights(defs_fn, arch, seed=0, **overrides):
    """(jax cfg, torch cfg, jax params, torch params) for one def-tree."""
    jcfg = jax_config(arch).reduced(**overrides)
    tcfg = get_config(arch).reduced(**overrides)
    params = JL.materialize(defs_fn(jcfg), jax.random.PRNGKey(seed),
                            jnp.float32)
    rng = np.random.default_rng(seed)
    pnp = {}
    for k, v in params.items():
        a = np.asarray(v, np.float32)
        if np.ptp(a) == 0:          # ones / zeros
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        pnp[k] = a
    jp = {k: jnp.asarray(v) for k, v in pnp.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in pnp.items()}
    return jcfg, tcfg, jp, tp


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("gemma_style", [False, True])
def test_rms_norm(gemma_style):
    x, w = _x((2, 5, 96)), _x((96,), 2) * 0.1 + 1
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                      gemma_style=gemma_style)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5,
                       gemma_style=gemma_style)
    _close(got, want)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    x = _x((2, 7, 3, 32))
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [90, 91, 92, 2000, 2001, 5, 6]],
                   np.int32)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_act(kind):
    x = _x((4, 33)) * 3
    _close(TL._act(kind, torch.from_numpy(x)), JL._act(kind, jnp.asarray(x)))


@pytest.mark.parametrize("arch", ["qwen2_7b", "qwen3_32b", "granite_34b"])
def test_qkv(arch):
    """qkv bias (qwen2), qk-norm (qwen3), MQA (granite); head order kept."""
    jcfg, tcfg, jp, tp = _weights(JL.attn_defs, arch)
    x = _x((2, 6, jcfg.d_model))
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    got = TL._qkv(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    want = JL._qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def _attn_inputs(B=2, Sq=12, Skv=12, KV=2, G=3, hd=16, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=5),
    dict(causal=False, window=5), dict(causal=True, softcap=20.0),
    dict(causal=True, q_chunk=5)],
    ids=["causal", "full", "window", "window-full", "softcap", "chunked"])
def test_mha_default_positions(kw):
    q, k, v = _attn_inputs()
    got = TL.mha(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    want = JL.mha(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    _close(got, want)


def test_mha_queries_aligned_to_end_of_keys():
    q, k, v = _attn_inputs(Sq=4, Skv=12)
    got = TL.mha(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    want = JL.mha(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 4])
def test_mha_explicit_positions(window):
    q, k, v = _attn_inputs(Sq=3, Skv=10)
    qpos = np.array([[4, 5, 6], [7, 8, 9]], np.int32)
    kvpos = np.stack([np.arange(10), np.arange(10)[::-1]]).astype(np.int32)
    got = TL.mha(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                 q_positions=torch.from_numpy(qpos),
                 kv_positions=torch.from_numpy(kvpos.copy()), window=window,
                 q_chunk=2)
    want = JL.mha(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                  q_positions=jnp.asarray(qpos),
                  kv_positions=jnp.asarray(kvpos), window=window, q_chunk=1)
    _close(got, want)


@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma_7b"])
def test_attn_block(arch):
    jcfg, tcfg, jp, tp = _weights(JL.attn_defs, arch)
    x = _x((2, 9, jcfg.d_model))
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    got = TL.attn_block(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    want = JL.attn_block(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    _close(got, want)
    got = TL.attn_block(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                        window=4, causal=False)
    want = JL.attn_block(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                         window=4, causal=False)
    _close(got, want)


@pytest.mark.parametrize("window,pos", [(0, [3, 7]), (0, [0, 9]),
                                        (6, [2, 4]), (6, [13, 29])],
                         ids=["plain", "plain-edges", "ring-unwrapped",
                              "ring-wrapped"])
def test_attn_decode(window, pos):
    """A different position per row; with a window the cache is a ring of S
    slots and positions beyond S wrap."""
    jcfg, tcfg, jp, tp = _weights(JL.attn_defs, "qwen2_7b")
    B, S = 2, (6 if window else 10)
    x = _x((B, 1, jcfg.d_model))
    ck = _x((B, S, jcfg.n_kv_heads, jcfg.hd), 4)
    cv = _x((B, S, jcfg.n_kv_heads, jcfg.hd), 5)
    pos = np.asarray(pos, np.int32)
    assert window or (pos < S).all()          # the caller's contract
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out, nk, nv = TL.attn_decode(tp, tcfg, torch.from_numpy(x), tk, tv,
                                 torch.from_numpy(pos), window=window)
    assert nk is tk and nv is tv              # written in place
    wout, wk, wv = JL.attn_decode(jp, jcfg, jnp.asarray(x), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.asarray(pos),
                                  window=window)
    _close(out, wout)
    _close(nk, wk)
    _close(nv, wv)
    assert not np.array_equal(tk.numpy(), ck)  # the write happened


@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma_7b", "whisper_medium"],
                         ids=["swiglu", "geglu", "gelu"])
def test_ffn_block(arch):
    jcfg, tcfg, jp, tp = _weights(JL.ffn_defs, arch)
    assert ("w_gate" in tp) == (jcfg.ffn_kind != "gelu")
    x = _x((2, 5, jcfg.d_model))
    _close(TL.ffn_block(tp, tcfg, torch.from_numpy(x)),
           JL.ffn_block(jp, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma_7b"])
def test_embed_and_logits(arch):
    """gemma scales the embedding by sqrt(d) and softcaps the logits."""
    jcfg, tcfg, jp, tp = _weights(JL.embed_defs, arch)
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 7),
                                               dtype=np.int32)
    got = TL.embed(tp, tcfg, torch.from_numpy(tokens))
    want = JL.embed(jp, jcfg, jnp.asarray(tokens))
    _close(got, want)
    x = _x((2, 3, jcfg.d_model)) * (40.0 if jcfg.logit_softcap else 1.0)
    got = TL.logits_chunked(torch.from_numpy(x), tp["tok"], tcfg)
    want = JL.logits_chunked(jnp.asarray(x), jp["tok"], jcfg)
    _close(got, want)


def test_defs_match_reference_shapes_and_init_rule():
    for arch in ("qwen2_7b", "gemma_7b", "qwen3_32b", "granite_34b"):
        jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
        for jf, tf in ((JL.attn_defs, TL.attn_defs), (JL.ffn_defs, TL.ffn_defs),
                       (JL.embed_defs, TL.embed_defs)):
            jd, td = jf(jcfg), tf(tcfg)
            assert list(jd) == list(td)
            for name in jd:
                assert jd[name].shape == td[name].shape
                assert jd[name].scale == td[name].scale
                assert jd[name].init == td[name].init


def test_init_params_follows_the_scale_rule():
    tcfg = get_config("qwen2_7b").reduced()
    defs = TL.attn_defs(tcfg)
    params = TL.materialize(defs, torch.float32, "cpu")
    TL.init_params(params, defs, torch.Generator().manual_seed(0))
    assert torch.all(params["ln"] == 1) and torch.all(params["bq"] == 0)
    std = float(params["wq"].detach().std())
    assert abs(std - 1 / np.sqrt(tcfg.d_model)) < 0.1 / np.sqrt(tcfg.d_model)
    emb = TL.materialize(TL.embed_defs(tcfg), torch.float32, "cpu")
    TL.init_params(emb, TL.embed_defs(tcfg), torch.Generator().manual_seed(0))
    assert abs(float(emb["tok"].detach().std()) - 0.02) < 0.002
