"""The Mamba2 slice of the port against the JAX package: the chunked time scan, the
sequential and chunkwise SSD recurrences, ``mamba_block`` (prefill and a decode
step), and zamba2 at reduced size as a whole model (Mamba2 blocks and one shared
attention + FFN block every third layer: forward, prefill caches leaf for leaf, the
decode step, loss, gradients, a train step, the converter and checkpoints), float32
on the CPU, weights from the JAX package's ``LM.init`` handed to both sides as numpy.

The reduced zamba2's shared attention has a window of W = 16, so its decode cache is
a ring of 16 slots.  Its prefill cache is held at S = 12 (< W), 32 (= 2W) and 21
(= W + 5).  At 21 the reference's layout (the last W tokens at slots 0..W-1) is not
the one its decode step reads (token p at slot p % W); the port copies the layout,
and the two are held to agree with each other, not with a longer forward.

Tolerances, with their reasons:

* layer functions: 1e-5 of the largest magnitude (:func:`_close`), as
  ``test_torch_moe.py``;
* whole model, float32: 1e-3 (:data:`WHOLE`).  The SSM's decays are exponentials of
  sums, which the two frameworks take in another order, and the shared attention's
  ``x @ in_proj`` cancels ~10x; over six seeds the port's forward, prefill logits and
  caches and decode step after it lay up to 3.4e-4 of the largest magnitude from
  JAX's (most at ~1e-5), and at S = 256 (the chunkwise SSD) JAX's own float32 prefill
  lies up to ~1.5e-4 from its float64 one.  There the port's float32 prefill is held
  against JAX's float64 one.  The teacher-forced decode chains: 2e-3, as
  ``test_torch_lm.py`` (six seeds: up to 3.3e-4);
* gradients of one Mamba2 block: the port in float64 against JAX in float64, no
  farther than JAX's own float32 result, or 1e-4;
* the whole model's gradients and train step (:data:`GRAD_TOL`, :data:`STEP_TOL`):
  the port in float64 against JAX in float64, each leaf no farther than JAX's own
  float32 result or than the stated tolerance.  Both "float64" models run the SSM in
  float32, as the reference casts it, so their gradients differ by the SSM's float32
  rounding, which JAX's float32 run (the same SSM arithmetic in the same order) does
  not show; over six seeds at S = 256 the port lay from JAX's float64 result by
  gradients 5.3e-4 to 3.2e-3, new parameters up to 1.9e-5, first moments up to
  2.6e-5 of the largest magnitude, and the grad norm by up to 6.1e-4 of itself.
  JAX's float64 model runs only the chunkwise SSD: the sequential scan's float32
  initial state meets a float64 update in its ``lax.scan`` carry, which JAX refuses,
  so the float64 cases take S = 256.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel.trainstep import make_train_step as jax_train_step  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert, layers  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.trainstep import (make_prefill_step,  # noqa: E402
                                            make_serve_step, make_train_step)

ARCH = "zamba2_2p7b"
B = 2
RING_CASES = [12, 32, 21]     # S < W, S = 2W, S = W + 5 (W = 16)
LONG = 256                    # two 128-token chunks of the chunkwise SSD
MAX_LEN = 36                  # the decode caches' length (a ring of min(16, 36) slots)
WHOLE = 1e-3                  # whole-model float32 tolerance (module docstring)


def _numpy_tree(tree, rng):
    """jax tree -> nested dicts of float32 numpy; constant leaves (norms, D at one,
    A_log and dt_bias at zero) are perturbed so that a mixed-up one shows."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if np.ptp(a) == 0:
        a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    return a


def _flat(tree, prefix=""):
    """Nested dicts and tuples -> {dotted path: float32 numpy}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree, np.float32)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _close(got, want, tol, err_msg=""):
    """|got - want| <= tol * max(1, max|want|) + tol * |want|, elementwise."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale, rtol=tol,
                               err_msg=err_msg)


def _no_farther(got, want, jax32, tol, err_msg=""):
    """max|got - want| <= max(tol, max|jax32 - want|), both as shares of
    max(1, max|want|): the port no farther from the float64 reference than the
    reference's own float32 run."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    floor = float(np.abs(np.asarray(jax32) - want).max()) / scale
    assert err <= max(tol, floor), f"{err_msg}: {err:.3e} > max({tol:g}, {floor:.3e})"


def _f64(cfg):
    return dataclasses.replace(cfg, dtype="float64")


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ------------------------------------------------------------ the time scan


def _jax_step(carry, x):
    h, s = carry
    h = jnp.tanh(0.9 * h + x[0])
    return (h, s + h * x[1]), 2.0 * h


def _torch_step(carry, x):
    h, s = carry
    h = torch.tanh(0.9 * h + x[0])
    return (h, s + h * x[1]), 2.0 * h


@pytest.mark.parametrize("S", [7, 256, 512])
def test_chunked_time_scan_matches_reference(S):
    """Carry, ys and their gradients against the reference's ``chunked_time_scan``;
    at S = 512 (two 256-step chunks) each chunk is recomputed in the backward, so
    the step runs twice per position, else once."""
    rng = np.random.default_rng(S)
    xs = (rng.standard_normal((S, 3, 5)) * 0.5).astype(np.float32), \
        (rng.standard_normal((S, 3, 5)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((3, 5)).astype(np.float32), np.zeros((3, 5), np.float32))

    def jloss(c, x):
        (h, s), ys = jlayers.chunked_time_scan(_jax_step, c, x)
        return jnp.sum(ys * ys) + jnp.sum(s), (h, s, ys)

    (_, (jh, js, jys)), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        tuple(map(jnp.asarray, c0)), tuple(map(jnp.asarray, xs)))
    calls = []

    def step(carry, x):
        calls.append(1)
        return _torch_step(carry, x)

    tc = tuple(torch.from_numpy(a).requires_grad_() for a in c0)
    tx = tuple(torch.from_numpy(a).requires_grad_() for a in xs)
    (th, ts), tys = layers.chunked_time_scan(step, tc, tx)
    assert len(calls) == S
    grads = torch.autograd.grad((tys * tys).sum() + ts.sum(), [*tc, *tx])
    assert len(calls) == (2 * S if S == 512 else S)
    for got, want in ((th, jh), (ts, js), (tys, jys)):
        _close(got.detach().numpy(), want, 1e-6)
    for got, want in zip(grads, jax.tree.leaves(jg)):
        _close(got.numpy(), want, 1e-5)


# ------------------------------------------------------------ the SSD recurrences


def _ssd_inputs(seed, S, with_h0):
    cfg = get_config(ARCH).reduced()
    e = cfg.ssm_expand * cfg.d_model
    hd, N = cfg.ssm_head_dim, cfg.ssm_state
    nh = e // hd
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = dict(x=f(B, S, nh, hd), B_in=f(B, S, N), C_in=f(B, S, N),
                dt=np.log1p(np.exp(f(B, S, nh))).astype(np.float32),
                A_log=0.3 * f(nh), D=1 + 0.1 * f(nh))
    h0 = f(B, nh, hd, N) if with_h0 else None
    return args, h0, hd


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_mamba_scan_seq_matches_reference(with_h0):
    args, h0, hd = _ssd_inputs(1, 21, with_h0)
    jy, jh = jlayers._mamba_scan_seq(*_j(args).values(), hd,
                                     h0=None if h0 is None else jnp.asarray(h0))
    ty, th = layers._mamba_scan_seq(*_t(args).values(), hd,
                                    h0=None if h0 is None else torch.from_numpy(h0))
    _close(ty.numpy(), jy, 1e-5)
    _close(th.numpy(), jh, 1e-5)


SSD_CASES = [(c, h) for c in (32, 64, 128) for h in (False, True)]


@pytest.mark.parametrize("chunk,with_h0", SSD_CASES,
                         ids=[f"chunk{c}-{'h0' if h else 'zeros'}" for c, h in SSD_CASES])
def test_mamba_scan_chunkwise_matches_reference(chunk, with_h0):
    """The chunkwise SSD at S = 256 against the reference's at the same chunk; and
    against the port's own sequential form, looser (another algorithm: the chunk's
    decays exponentiate differences of cumulative sums)."""
    args, h0, hd = _ssd_inputs(2, LONG, with_h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    jy, jh = jlayers._mamba_scan(*_j(args).values(), hd,
                                 h0=None if h0 is None else jnp.asarray(h0), chunk=chunk)
    ty, th = layers._mamba_scan(*_t(args).values(), hd, h0=th0, chunk=chunk)
    _close(ty.numpy(), jy, 1e-5)
    _close(th.numpy(), jh, 1e-5)
    sy, sh = layers._mamba_scan_seq(*_t(args).values(), hd, h0=th0)
    _close(ty.numpy(), sy.numpy(), 1e-4)
    _close(th.numpy(), sh.numpy(), 1e-4)


def _block_params(seed):
    jcfg = jax_config(ARCH).reduced()
    rng = np.random.default_rng(seed)
    pnp = _numpy_tree(jlayers.materialize(jlayers.mamba_defs(jcfg), jax.random.PRNGKey(seed),
                                          jnp.float32), rng)
    return get_config(ARCH).reduced(), jcfg, pnp, rng


@pytest.mark.parametrize("S", [21, LONG])
def test_mamba_block_prefill_matches_reference(S):
    cfg, jcfg, pnp, rng = _block_params(3)
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    jout, jh, jconv = jlayers.mamba_block(_j(pnp), jcfg, jnp.asarray(x), return_state=True)
    tout, th, tconv = layers.mamba_block(_t(pnp), cfg, torch.from_numpy(x))
    assert tuple(tconv.shape) == (B, cfg.ssm_conv_width - 1, cfg.ssm_expand * cfg.d_model)
    for got, want in ((tout, jout), (th, jh), (tconv, jconv)):
        _close(got.numpy(), want, 1e-5)


def test_mamba_block_decode_step_matches_reference():
    """One token through the decode path (``state`` and ``conv_state`` from a
    21-token prefill) against the reference, and against the prefill of all 22."""
    cfg, jcfg, pnp, rng = _block_params(4)
    x = (rng.standard_normal((B, 22, cfg.d_model)) * 0.5).astype(np.float32)
    _, jh, jconv = jlayers.mamba_block(_j(pnp), jcfg, jnp.asarray(x[:, :21]), return_state=True)
    jout, jh2, jconv2 = jlayers.mamba_block(_j(pnp), jcfg, jnp.asarray(x[:, 21:]), state=jh,
                                            conv_state=jconv, return_state=True)
    tout, th2, tconv2 = layers.mamba_block(_t(pnp), cfg, torch.from_numpy(x[:, 21:]),
                                           state=torch.from_numpy(np.array(jh)),
                                           conv_state=torch.from_numpy(np.array(jconv)))
    for got, want in ((tout, jout), (th2, jh2), (tconv2, jconv2)):
        _close(got.numpy(), want, 1e-5)
    full, hf, convf = layers.mamba_block(_t(pnp), cfg, torch.from_numpy(x))
    _close(tout.numpy(), full[:, -1:].numpy(), 1e-5)
    _close(th2.numpy(), hf.numpy(), 1e-5)
    _close(tconv2.numpy(), convf.numpy(), 1e-5)


def test_mamba_block_gradients_match_reference():
    """Gradients of every Mamba2 weight and the input at S = 256 (the chunkwise SSD:
    the reference's float64 run takes no other), both sides in float64, against JAX's
    float64 gradients no farther than JAX's float32 ones, or 1e-4 (the SSM runs in
    float32 on both sides: A_log's gradient sums 256 positions of it)."""
    cfg, jcfg, pnp, rng = _block_params(5)
    x = (rng.standard_normal((B, LONG, cfg.d_model)) * 0.5).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)

    def jvjp(dtype, c):
        def grads(p, xx, g):
            return jax.vjp(lambda pp, xs: jlayers.mamba_block(pp, c, xs), p, xx)[1](g)
        p = {k: jnp.asarray(v, dtype) for k, v in pnp.items()}
        out = jax.jit(grads)(p, jnp.asarray(x, dtype), jnp.asarray(dy, dtype))
        return jax.tree.map(np.asarray, out)

    jgp32, jgx32 = jvjp(jnp.float32, jcfg)
    with jax.enable_x64(True):
        jgp, jgx = jvjp(jnp.float64, _f64(jcfg))
    tp = {k: torch.from_numpy(v).double().requires_grad_() for k, v in pnp.items()}
    tx = torch.from_numpy(x).double().requires_grad_()
    out = layers.mamba_block(tp, _f64(cfg), tx)[0]
    grads = torch.autograd.grad(out, [tx, *tp.values()], torch.from_numpy(dy).double())
    _no_farther(grads[0].numpy(), jgx, jgx32, 1e-4, err_msg="x")
    for name, g in zip(tp, grads[1:]):
        _no_farther(g.numpy(), jgp[name], jgp32[name], 1e-4, err_msg=name)


def test_mamba_defs_match_reference():
    cfg, jcfg = get_config(ARCH).reduced(), jax_config(ARCH).reduced()
    tdefs, jdefs = layers.mamba_defs(cfg), jlayers.mamba_defs(jcfg)
    assert list(tdefs) == list(jdefs)
    for k in jdefs:
        assert (tdefs[k].shape, tdefs[k].scale, tdefs[k].init) == \
            (jdefs[k].shape, jdefs[k].scale, jdefs[k].init), k


# ------------------------------------------------------------ the whole model


def _jax_right_size(jm, jflat, max_len):
    """The reference's right-sizing of a prefill cache (``examples/serve.py``)."""
    return jax.tree.map(
        lambda dst, src: dst.at[tuple(slice(0, s) for s in src.shape)].set(src)
        if dst.shape != src.shape else src, jm.init_cache(B, max_len), jflat)


@pytest.fixture(scope="module")
def pair():
    """Both models on the same weights and tokens, with every result the tests
    compare computed once."""
    jcfg = jax_config(ARCH).reduced()
    jm = JaxLM(jcfg)
    rng = np.random.default_rng(7)
    pnp = _numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(1)), rng)
    jparams = jax.tree.map(jnp.asarray, pnp)
    tokens = rng.integers(0, jcfg.vocab, (B, LONG), dtype=np.int32)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)
    tm = convert.load_jax_params(LM(get_config(ARCH).reduced(), device="cpu"), pnp)
    prefill, serve = make_prefill_step(tm), make_serve_step(tm)
    jprefill, jstep = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    out = dict(jm=jm, tm=tm, pnp=pnp, jcfg=jcfg, tokens=tokens, prefill={}, after={})
    with torch.no_grad():
        out["tx"] = tm.forward(tt[:, :21]).numpy()
    out["jx"] = np.asarray(jax.jit(jm.forward)(jparams, jt[:, :21]))
    for S in RING_CASES + [LONG]:
        jl, jst = jprefill(jparams, jt[:, :S])
        tl, tst = prefill({"tokens": tt[:, :S]})
        out["prefill"][S] = dict(jlogits=np.asarray(jl), jstacked=jst, tlogits=tl.numpy(),
                                 tstacked=tst)
        if S == LONG:
            continue
        # one decode step after the prefill, each side right-sizing by its rule
        pos = jnp.full((B,), S, jnp.int32)
        jlg, jcache = jstep(jparams, _jax_right_size(jm, jm.unstack_cache(jst), MAX_LEN),
                            jt[:, S:S + 1], pos)
        tcache = tm.serving_cache(tst, S, MAX_LEN)
        tlg, tcache2 = serve(tcache, {"tokens": tt[:, S:S + 1],
                                      "pos": torch.full((B,), S, dtype=torch.int32)})
        assert tcache2 is tcache
        out["after"][S] = dict(jlogits=np.asarray(jlg), jcache=jcache, tlogits=tlg.numpy(),
                               tcache=tcache)
    with jax.enable_x64(True):
        jm64 = JaxLM(_f64(jcfg))
        jl64, jst64 = jax.jit(jm64.prefill)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), pnp), jt)
        out["prefill64"] = dict(jlogits=np.asarray(jl64), jstacked=jax.tree.map(np.asarray, jst64))
    # teacher-forced decode from an empty cache: the ring wraps after 16 tokens
    jcache, tcache = jm.init_cache(B, MAX_LEN), tm.init_cache(B, MAX_LEN, device="cpu")
    out["chain"] = []
    for t in range(33):
        pos = np.full((B,), t, np.int32)
        jlg, jcache = jstep(jparams, jcache, jt[:, t:t + 1], jnp.asarray(pos))
        tlg, tcache = serve(tcache, {"tokens": tt[:, t:t + 1], "pos": torch.from_numpy(pos)})
        out["chain"].append((tlg.numpy().copy(), np.asarray(jlg)))
    out["chain_caches"] = (tcache, jcache)
    return out


def test_blocks_hold_their_kinds(pair):
    tm, cfg = pair["tm"], pair["tm"].cfg
    assert cfg.pattern == ("mamba", "mamba", "shared_attn")
    for i, blk in enumerate(tm.blocks):
        kind = cfg.block_kind(i)
        assert hasattr(blk, "mamba") == (kind == "mamba")
        assert (kind == "shared_attn") == hasattr(blk, "in_proj")
    # one shared weight set, held once, not per occurrence
    assert {n.split(".")[0] for n, _ in tm.named_parameters()} == \
        {"embed", "final_norm", "blocks", "shared"}
    assert not any(".attn." in n for n, _ in tm.blocks.named_parameters())


def test_forward_hidden(pair):
    _close(pair["tx"], pair["jx"], WHOLE)


@pytest.mark.parametrize("S", RING_CASES)
def test_prefill_logits(pair, S):
    got = pair["prefill"][S]
    assert got["tlogits"].shape == (B, pair["jcfg"].vocab)
    _close(got["tlogits"], got["jlogits"], WHOLE)


@pytest.mark.parametrize("S", RING_CASES)
def test_prefill_cache_every_leaf(pair, S):
    """Stacked per pattern position (the ring of W slots, ``ssm`` fp32, ``conv``),
    then leaf for leaf after unstacking: the reference's ring layout included."""
    jcfg, tm = pair["jcfg"], pair["tm"]
    got = pair["prefill"][S]
    W, C = jcfg.attn_window, jcfg.n_cycles
    e = jcfg.ssm_expand * jcfg.d_model
    for p, kind in enumerate(jcfg.pattern):
        shapes = {k: tuple(v.shape) for k, v in got["tstacked"][p].items()}
        if kind == "mamba":
            assert shapes == {"ssm": (C, B, e // jcfg.ssm_head_dim, jcfg.ssm_head_dim,
                                      jcfg.ssm_state),
                              "conv": (C, B, jcfg.ssm_conv_width - 1, e)}
            assert got["tstacked"][p]["ssm"].dtype == torch.float32
        else:
            assert shapes == {n: (C, B, W, jcfg.n_kv_heads, jcfg.hd) for n in ("k", "v")}
    tflat = _flat(tm.unstack_cache(got["tstacked"]))
    jflat = _flat(pair["jm"].unstack_cache(got["jstacked"]))
    assert sorted(tflat) == sorted(jflat)
    for path in jflat:
        _close(tflat[path], jflat[path], WHOLE, err_msg=path)


def test_prefill_and_cache_at_the_chunkwise_length(pair):
    """S = 256: the chunkwise SSD in every Mamba2 layer; held against JAX's float64
    prefill (module docstring)."""
    got, want = pair["prefill"][LONG], pair["prefill64"]
    _close(got["tlogits"], want["jlogits"], WHOLE, "logits")
    tflat, jflat = _flat(got["tstacked"]), _flat(want["jstacked"])
    assert sorted(tflat) == sorted(jflat)
    for path in jflat:
        _close(tflat[path], jflat[path], WHOLE, path)


@pytest.mark.parametrize("S", RING_CASES)
def test_decode_step_after_prefill(pair, S):
    """``serving_cache`` (the reference's right-sizing rule) and one decode step at
    position S, against the reference's own."""
    got = pair["after"][S]
    _close(got["tlogits"], got["jlogits"], WHOLE)
    tflat, jflat = _flat(got["tcache"]), _flat(got["jcache"])
    assert sorted(tflat) == sorted(jflat)
    for path in jflat:
        _close(tflat[path], jflat[path], WHOLE, err_msg=path)


def test_decode_chain_teacher_forced(pair):
    for t, (tl, jl) in enumerate(pair["chain"]):
        _close(tl, jl, 2e-3, err_msg=f"step {t}")
    tc, jc = pair["chain_caches"]
    tflat, jflat = _flat(tc), _flat(jc)
    for path in jflat:
        _close(tflat[path], jflat[path], 2e-3, err_msg=path)


def test_decode_agrees_with_prefill_inside_the_window(pair):
    """Within the window (and at 2W, where the ring's layouts agree) step t of the
    chain has seen tokens 0..t: the prefill of t + 1 tokens."""
    for S in (12, 32):
        _close(pair["chain"][S - 1][0], pair["prefill"][S]["tlogits"], 2e-3, err_msg=str(S))


def test_serving_cache_rule(pair):
    """A leaf of the prefill's shape is taken whole, a sequence leaf its first
    ``filled`` positions; prefill positions that do not fit raise."""
    tm = pair["tm"]
    stacked = pair["prefill"][12]["tstacked"]
    flat = tm.unstack_cache(stacked)
    cache = tm.serving_cache(stacked, 12, 14)    # ring of min(16, 14) = 14 slots
    assert tuple(cache[2]["k"].shape) == (B, 14, 2, 32)
    assert torch.equal(cache[2]["k"][:, :12], flat[2]["k"][:, :12])
    assert not bool(cache[2]["k"][:, 12:].any())
    assert torch.equal(cache[0]["ssm"], flat[0]["ssm"]) and \
        torch.equal(cache[0]["conv"], flat[0]["conv"])
    with pytest.raises(ValueError, match="do not fit"):
        tm.serving_cache(stacked, 12, 10)


def test_n_params(pair):
    assert pair["tm"].n_params() == pair["jm"].n_params()
    assert pair["tm"].n_params() == sum(p.numel() for p in pair["tm"].parameters())
    full = LM(get_config(ARCH), device="meta")
    assert full.n_params() == JaxLM(jax_config(ARCH)).n_params() == 1_740_519_360


def test_export_gives_back_what_was_loaded(pair):
    got, want = _flat(convert.export_jax_params(pair["tm"])), _flat(pair["pnp"])
    assert sorted(got) == sorted(want)
    assert {"pos2.in_proj", "shared.attn.wq", "shared.ffn.w_gate", "pos0.mamba.A_log",
            "pos1.mamba.conv_w"} <= set(got)
    assert got["pos2.in_proj"].shape[0] == pair["jcfg"].n_cycles
    assert got["shared.attn.wq"].shape == want["shared.attn.wq"].shape
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_init_fills_every_parameter(pair):
    cfg = pair["tm"].cfg
    m = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    assert all(bool(torch.isfinite(p).all()) for p in m.parameters())
    mb = m.blocks[0].mamba
    assert bool((mb["A_log"] == 0).all()) and bool((mb["D"] == 1).all())
    assert bool((mb["dt_bias"] == 0).all()) and bool((mb["gn"] == 1).all())
    assert abs(float(mb["conv_w"].std()) - 0.5) < 0.1
    assert abs(float(m.blocks[2].in_proj.std()) - 0.02) < 0.005
    logits, _ = m.prefill(torch.zeros((1, 4), dtype=torch.int64))
    assert bool(torch.isfinite(logits).all())


# ------------------------------------------------------------ training


OPT = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-3)
# whole-model tolerances (module docstring): ~3x the six seeds' worst
GRAD_TOL = 1e-2
STEP_TOL = {"loss": 1e-6, "grad_norm": 5e-3, "lr": 1e-6, "params": 1e-4, "m": 1e-4}


def _jax_loss_grads_and_step(jcfg, pnp, batch, dtype):
    """The reference's loss and gradients, and one step of its ``make_train_step``
    (AdamW eps 1e-3, as in ``test_torch_train.py``), from one compiled program:
    (loss, grads, start state, new state, metrics) as numpy."""
    jm = JaxLM(jcfg)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), pnp)
    state = {"params": params, "opt": jadamw.init_opt_state(params)}
    step = jax_train_step(jm, jadamw.AdamWConfig(**dataclasses.asdict(OPT)), remat="none")

    def both(st, b):
        return (jax.value_and_grad(jm.loss)(st["params"], b["tokens"], b["labels"]),
                step(st, b))

    (loss, grads), (new, met) = jax.jit(both)(state, {k: jnp.asarray(v)
                                                      for k, v in batch.items()})
    return (float(loss), *jax.tree.map(np.asarray, (grads, state, new, met)))


@functools.lru_cache(maxsize=None)
def _grads_pair(head_dim: int = 0):
    """Both models on the same weights and batch, the reduced config at its own
    head_dim (0) or at ``head_dim``: JAX's loss, gradients and train step in float32
    and float64, and the port's float64 loss and gradients."""
    over = {"head_dim": head_dim} if head_dim else {}
    jcfg = jax_config(ARCH).reduced(**over)
    rng = np.random.default_rng(11)
    pnp = _numpy_tree(jax.jit(JaxLM(jcfg).init)(jax.random.PRNGKey(2)), rng)
    tokens = rng.integers(0, jcfg.vocab, (B, LONG), dtype=np.int32)
    labels = rng.integers(0, jcfg.vocab, (B, LONG), dtype=np.int32)
    labels[0, :3] = -100
    batch = {"tokens": tokens, "labels": labels}
    jl32, jg32, _, j32, jmet32 = _jax_loss_grads_and_step(jcfg, pnp, batch, jnp.float32)
    with jax.enable_x64(True):
        jl, jg, start, jnew, jmet = _jax_loss_grads_and_step(_f64(jcfg), pnp, batch,
                                                             jnp.float64)
    tm32 = convert.load_jax_params(LM(get_config(ARCH).reduced(**over), device="cpu"), pnp)
    with torch.no_grad():
        loss32 = float(tm32.loss(torch.from_numpy(tokens), torch.from_numpy(labels)))
    tm = convert.load_jax_params(LM(_f64(get_config(ARCH).reduced(**over)), device="cpu"),
                                 pnp)
    loss = tm.loss(torch.from_numpy(tokens), torch.from_numpy(labels))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    return dict(jcfg=jcfg, pnp=pnp, batch=batch, tm=tm, jloss=jl, jloss32=jl32, jgrads=jg,
                jgrads32=jg32, start=start, jnew=jnew, jmet=jmet, j32=j32, jmet32=jmet32,
                loss=float(loss), loss32=loss32, grads=dict(zip(names, grads)))


@pytest.fixture(scope="module")
def grads_pair():
    return _grads_pair()


def test_loss_matches_reference(grads_pair):
    for want in (grads_pair["jloss"], grads_pair["jloss32"]):
        np.testing.assert_allclose(grads_pair["loss32"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads_pair["loss"], grads_pair["jloss"], rtol=1e-6)


def test_every_gradient_matches_reference(grads_pair):
    got = _flat(convert.export_jax_tree(grads_pair["tm"], grads_pair["grads"]))
    want, want32 = _flat(grads_pair["jgrads"]), _flat(grads_pair["jgrads32"])
    assert sorted(got) == sorted(want)
    for path in want:
        _no_farther(got[path], want[path], want32[path], GRAD_TOL, err_msg=path)
    for path in ("pos0.mamba.A_log", "pos2.in_proj", "shared.attn.wq"):
        assert float(np.abs(got[path]).max()) > 0, path


@pytest.mark.parametrize("head_dim", [0, 80], ids=["reduced", "head_dim80"])
def test_train_step_matches_reference(head_dim):
    """One AdamW step, the port in float64 against JAX in float64, no farther from
    it than JAX's float32 step or :data:`STEP_TOL` (eps 1e-3, as in
    ``test_torch_train.py``): the reduced config as it is, and at zamba2's own
    head_dim 80 (its shared attention's width on the card)."""
    g = _grads_pair(head_dim)
    tm = LM(_f64(get_config(ARCH).reduced(**({"head_dim": head_dim} if head_dim else {}))),
            device="cpu")
    state = convert.load_jax_train_state(tm, g["start"])
    new, met = make_train_step(tm, OPT, remat="none")(
        state, {k: torch.from_numpy(v) for k, v in g["batch"].items()})
    for key in ("loss", "grad_norm", "lr"):
        _no_farther(float(met[key]) / float(g["jmet"][key]), 1.0,
                    float(g["jmet32"][key]) / float(g["jmet"][key]), STEP_TOL[key], err_msg=key)
    out = convert.export_jax_train_state(tm, new)
    for part, got, want, want32 in (
            ("params", out["params"], g["jnew"]["params"], g["j32"]["params"]),
            ("m", out["opt"].m, g["jnew"]["opt"].m, g["j32"]["opt"].m)):
        got, want, want32 = _flat(got), _flat(want), _flat(want32)
        assert sorted(got) == sorted(want)
        for path in want:
            _no_farther(got[path], want[path], want32[path], STEP_TOL[part],
                        err_msg=f"{part} {path}")


@pytest.mark.parametrize("remat", ["selective", "full"])
def test_remat_changes_nothing(grads_pair, remat):
    tm = grads_pair["tm"]
    loss = tm.loss(torch.from_numpy(grads_pair["batch"]["tokens"]),
                   torch.from_numpy(grads_pair["batch"]["labels"]), remat=remat)
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    assert float(loss) == grads_pair["loss"]
    for (name, _), g in zip(tm.named_parameters(), grads):
        torch.testing.assert_close(g, grads_pair["grads"][name], rtol=0, atol=1e-12, msg=name)


# ------------------------------------------------------------ checkpoints


def _jax_state(dtype, seed):
    jm = JaxLM(jax_config(ARCH).reduced(dtype=dtype))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    noise = lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)  # noqa: E731
    return {"params": params,
            "opt": jadamw.OptState(jax.tree.map(noise, params),
                                   jax.tree.map(lambda p: jnp.abs(noise(p)), params),
                                   jnp.asarray(3, jnp.int32))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_both_ways(tmp_path, dtype):
    """A zamba2 train state written by the JAX package, read by the port, written
    again and read back by the JAX package: bit for bit, the unstacked ``shared``
    group and the stacked ``in_proj`` among the leaves."""
    jst = _jax_state(dtype, 0)
    jstore.save(tmp_path / "jax", jst, step=3)
    model = LM(get_config(ARCH).reduced(dtype=dtype), device="cpu")
    tree, manifest = store.restore(tmp_path / "jax", convert.jax_train_state_like(model))
    state = convert.load_jax_train_state(model, tree)
    assert manifest["step"] == 3 and int(state["opt"].step) == 3
    store.save(tmp_path / "port", convert.export_jax_train_state(model, state), step=4)
    back, manifest = jstore.restore(tmp_path / "port", jst)   # jst: the structure
    assert manifest["step"] == 4
    for part in ("params", "m", "v"):
        a = jst["params"] if part == "params" else getattr(jst["opt"], part)
        b = back["params"] if part == "params" else getattr(back["opt"], part)
        want, got = _flat(jax.tree.map(np.asarray, a)), _flat(b)
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg=f"{part} {path}")
    assert {"shared.attn.wq", "pos2.in_proj", "pos0.mamba.conv_w"} <= set(want)
