"""The xLSTM slice of the port against the JAX package: the chunkwise mLSTM,
``mlstm_block`` (chunkwise and sequential, prefill and a decode step),
``slstm_block``, and xlstm-125m at reduced size as a whole model (alternating mLSTM
and sLSTM blocks: forward, prefill caches leaf for leaf, the decode step, loss,
gradients, a train step, the converter and checkpoints), float32 on the CPU, weights
from the JAX package's ``LM.init`` handed to both sides as numpy.

``mlstm_block`` takes the chunkwise form when ``S % 64 == 0 and S > 64`` (here
S = 128: two chunks) and the sequential step otherwise (S = 12, 21, 64, and every
decode step); ``slstm_block`` is always sequential.

Tolerances, with their reasons:

* layer functions: 1e-5 of the largest magnitude (:func:`_close`), as
  ``test_torch_moe.py``;
* whole model: 2e-3 (:data:`WHOLE`).  The reduced model on the reference's init is
  badly conditioned: its residual stream reaches ~1e5 in the first mLSTM block, and
  the second mLSTM block moves its output by 3.6e-5 of the largest magnitude for a
  1e-6 relative change of its input (measured in float64).  So float32 rounding
  alone reaches ~1e-3 after four layers: over six seeds at S = 21, JAX's own float32
  forward lies 1e-5 to 2.1e-3 of the largest magnitude from its float64 one, the
  port's 2.8e-5 to 3.1e-4, and the port's prefill caches and decode steps lie up to
  6.3e-4 from JAX's float32 ones.  At S = 128 (the chunkwise mLSTM) the port's
  float32 prefill is held against JAX's float64 one;
* gradients of one block: the port in float64 against JAX in float64, no farther
  than JAX's own float32 result, or 1e-4;
* the whole model's gradients and train step (:data:`GRAD_TOL`, :data:`STEP_TOL`):
  the port in float64 against JAX in float64, each leaf no farther than JAX's own
  float32 result or than the stated tolerance.  Both "float64" models keep the
  recurrent states and gates in float32, as the reference casts them, so their
  gradients differ by that float32 rounding, which JAX's float32 run (the same
  arithmetic in the same order) does not show; over six seeds at S = 128 the port
  lay from JAX's float64 result by gradients 4.3e-5 to 2.7e-3, new parameters up to
  1.6e-5, first moments up to 3.3e-5 of the largest magnitude, and the grad norm by
  up to 1.5e-3 of itself.
"""

import dataclasses

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

ARCH = "xlstm_125m"
B = 2
SEQ_CASES = [12, 21]          # the sequential mLSTM
LONG = 128                    # two 64-token chunks of the chunkwise mLSTM
MAX_LEN = 24
WHOLE = 2e-3                  # whole-model float32 tolerance (module docstring)


def _numpy_tree(tree, rng):
    """jax tree -> nested dicts of float32 numpy; constant leaves (the norms at one)
    are perturbed so that a mixed-up one shows."""
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
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _state_t(state):
    return tuple(torch.from_numpy(np.array(s)) for s in state)


# ------------------------------------------------------------ the layers


def _block_params(kind, seed):
    jcfg = jax_config(ARCH).reduced()
    defs = getattr(jlayers, f"{kind}_defs")(jcfg)
    rng = np.random.default_rng(seed)
    pnp = _numpy_tree(jlayers.materialize(defs, jax.random.PRNGKey(seed), jnp.float32), rng)
    return get_config(ARCH).reduced(), jcfg, pnp, rng


def _x(rng, S, cfg):
    return (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)


MLSTM_CHUNK_CASES = [(c, s) for c in (32, 64) for s in (False, True)]


@pytest.mark.parametrize("chunk,with_state", MLSTM_CHUNK_CASES,
                         ids=[f"chunk{c}-{'state' if s else 'fresh'}"
                              for c, s in MLSTM_CHUNK_CASES])
def test_mlstm_chunkwise_matches_reference(chunk, with_state):
    """``_mlstm_chunkwise`` at S = 128 against the reference's at the same chunk,
    from a fresh state (m at -1e30) or a carried one."""
    cfg = get_config(ARCH).reduced()
    H, hd = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
    rng = np.random.default_rng(chunk + with_state)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(B, LONG, H, hd), f(B, LONG, H, hd) / np.sqrt(hd), f(B, LONG, H, hd)
    it, ft = f(B, LONG, H), 2.0 + f(B, LONG, H)
    if with_state:
        state = (f(B, H, hd, hd), np.abs(f(B, H, hd)), f(B, H))
    else:
        state = (np.zeros((B, H, hd, hd), np.float32), np.zeros((B, H, hd), np.float32),
                 np.full((B, H), -1e30, np.float32))
    jy, jst = jlayers._mlstm_chunkwise(*map(jnp.asarray, (q, k, v, it, ft)),
                                       tuple(map(jnp.asarray, state)), chunk=chunk)
    ty, tst = layers._mlstm_chunkwise(*map(torch.from_numpy, (q, k, v, it, ft)),
                                      _state_t(state), chunk=chunk)
    _close(ty.numpy(), jy, 1e-5)
    for name, got, want in zip(("C", "n", "m"), tst, jst):
        _close(got.numpy(), want, 1e-5, err_msg=name)


@pytest.mark.parametrize("S", [21, 64, LONG])
def test_mlstm_block_matches_reference(S):
    """Sequential at 21 and 64 (64 is not > 64), chunkwise at 128."""
    cfg, jcfg, pnp, rng = _block_params("mlstm", 1)
    x = _x(rng, S, cfg)
    jout, jst = jlayers.mlstm_block(_j(pnp), jcfg, jnp.asarray(x), return_state=True)
    tout, tst = layers.mlstm_block(_t(pnp), cfg, torch.from_numpy(x))
    _close(tout.numpy(), jout, 1e-5)
    for name, got, want in zip(("C", "n", "m"), tst, jst):
        _close(got.numpy(), want, 1e-5, err_msg=name)


def test_mlstm_chunkwise_agrees_with_the_sequential_step():
    """The port's two algorithms: 128 tokens at once (chunkwise) against two blocks
    of 64 (sequential), the second from the first one's state."""
    cfg, _, pnp, rng = _block_params("mlstm", 2)
    x = torch.from_numpy(_x(rng, LONG, cfg))
    p = _t(pnp)
    whole, st = layers.mlstm_block(p, cfg, x)
    first, st1 = layers.mlstm_block(p, cfg, x[:, :64])
    second, st2 = layers.mlstm_block(p, cfg, x[:, 64:], state=st1)
    _close(torch.cat([first, second], 1).numpy(), whole.numpy(), 1e-5)
    for got, want in zip(st2, st):
        _close(got.numpy(), want.numpy(), 1e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_step_matches_reference(kind):
    """One token with the state of a 21-token prefill, against the reference."""
    cfg, jcfg, pnp, rng = _block_params(kind, 3)
    x = _x(rng, 22, cfg)
    jblock, tblock = getattr(jlayers, f"{kind}_block"), getattr(layers, f"{kind}_block")
    _, jst = jblock(_j(pnp), jcfg, jnp.asarray(x[:, :21]), return_state=True)
    jout, jst2 = jblock(_j(pnp), jcfg, jnp.asarray(x[:, 21:]), state=jst, return_state=True)
    tout, tst2 = tblock(_t(pnp), cfg, torch.from_numpy(x[:, 21:]), state=_state_t(jst))
    _close(tout.numpy(), jout, 1e-5)
    for got, want in zip(tst2, jst2):
        _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("S", [21, LONG])
def test_slstm_block_matches_reference(S):
    cfg, jcfg, pnp, rng = _block_params("slstm", 4)
    x = _x(rng, S, cfg)
    jout, jst = jlayers.slstm_block(_j(pnp), jcfg, jnp.asarray(x), return_state=True)
    tout, tst = layers.slstm_block(_t(pnp), cfg, torch.from_numpy(x))
    assert tst[2].dtype == torch.float32 and tst[0].dtype == torch.float32
    _close(tout.numpy(), jout, 1e-5)
    for name, got, want in zip(("c", "n", "h", "m"), tst, jst):
        _close(got.numpy(), want, 1e-5, err_msg=name)


def test_slstm_keeps_h_in_the_input_dtype():
    """The carried h is x's dtype (bf16 here), c, n and m float32, as the
    reference carries them."""
    cfg, _, pnp, rng = _block_params("slstm", 5)
    x = torch.from_numpy(_x(rng, 5, cfg)).bfloat16()
    _, (c, n, h, m) = layers.slstm_block({k: v.bfloat16() for k, v in _t(pnp).items()},
                                         dataclasses.replace(cfg, dtype="bfloat16"), x)
    assert h.dtype == torch.bfloat16
    assert c.dtype == n.dtype == m.dtype == torch.float32


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_gradients_match_reference(kind):
    """Gradients of every weight and the input at S = 128 (the chunkwise mLSTM),
    both sides in float64, against JAX's float64 gradients no farther than its
    float32 ones, or 1e-4."""
    cfg, jcfg, pnp, rng = _block_params(kind, 6)
    x = _x(rng, LONG, cfg)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jblock = getattr(jlayers, f"{kind}_block")

    def jvjp(dtype, c):
        def grads(p, xx, g):
            return jax.vjp(lambda pp, xs: jblock(pp, c, xs), p, xx)[1](g)
        p = {k: jnp.asarray(v, dtype) for k, v in pnp.items()}
        out = jax.jit(grads)(p, jnp.asarray(x, dtype), jnp.asarray(dy, dtype))
        return jax.tree.map(np.asarray, out)

    jgp32, jgx32 = jvjp(jnp.float32, jcfg)
    with jax.enable_x64(True):
        jgp, jgx = jvjp(jnp.float64, _f64(jcfg))
    tp = {k: torch.from_numpy(v).double().requires_grad_() for k, v in pnp.items()}
    tx = torch.from_numpy(x).double().requires_grad_()
    out = getattr(layers, f"{kind}_block")(tp, _f64(cfg), tx)[0]
    grads = torch.autograd.grad(out, [tx, *tp.values()], torch.from_numpy(dy).double())
    _no_farther(grads[0].numpy(), jgx, jgx32, 1e-4, err_msg="x")
    for name, g in zip(tp, grads[1:]):
        _no_farther(g.numpy(), jgp[name], jgp32[name], 1e-4, err_msg=name)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_defs_match_reference(kind):
    tdefs = getattr(layers, f"{kind}_defs")(get_config(ARCH))
    jdefs = getattr(jlayers, f"{kind}_defs")(jax_config(ARCH))
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
    rng = np.random.default_rng(8)
    pnp = _numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(1)), rng)
    jparams = jax.tree.map(jnp.asarray, pnp)
    tokens = rng.integers(0, jcfg.vocab, (B, LONG), dtype=np.int32)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)
    tm = convert.load_jax_params(LM(get_config(ARCH).reduced(), device="cpu"), pnp)
    prefill, serve = make_prefill_step(tm), make_serve_step(tm)
    jprefill, jstep = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    out = dict(jm=jm, tm=tm, pnp=pnp, jcfg=jcfg, prefill={}, after={})
    with torch.no_grad():
        out["tx"] = tm.forward(tt[:, :21]).numpy()
    out["jx"] = np.asarray(jax.jit(jm.forward)(jparams, jt[:, :21]))
    for S in SEQ_CASES + [LONG]:
        jl, jst = jprefill(jparams, jt[:, :S])
        tl, tst = prefill({"tokens": tt[:, :S]})
        out["prefill"][S] = dict(jlogits=np.asarray(jl), jstacked=jst, tlogits=tl.numpy(),
                                 tstacked=tst)
        if S == LONG:
            continue
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
    jcache, tcache = jm.init_cache(B, MAX_LEN), tm.init_cache(B, MAX_LEN, device="cpu")
    out["chain"] = []
    for t in range(13):
        pos = np.full((B,), t, np.int32)
        jlg, jcache = jstep(jparams, jcache, jt[:, t:t + 1], jnp.asarray(pos))
        tlg, tcache = serve(tcache, {"tokens": tt[:, t:t + 1], "pos": torch.from_numpy(pos)})
        out["chain"].append((tlg.numpy().copy(), np.asarray(jlg)))
    out["chain_caches"] = (tcache, jcache)
    return out


def test_blocks_hold_their_kinds(pair):
    tm, cfg = pair["tm"], pair["tm"].cfg
    assert cfg.pattern == ("mlstm", "slstm")
    for i, blk in enumerate(tm.blocks):
        kind = cfg.block_kind(i)
        assert {n for n, _ in blk.named_children()} == {kind}
    assert not hasattr(tm, "shared")


def test_forward_hidden(pair):
    _close(pair["tx"], pair["jx"], WHOLE)


@pytest.mark.parametrize("S", SEQ_CASES)
def test_prefill_logits(pair, S):
    got = pair["prefill"][S]
    assert got["tlogits"].shape == (B, pair["jcfg"].vocab)
    _close(got["tlogits"], got["jlogits"], WHOLE)


@pytest.mark.parametrize("S", SEQ_CASES)
def test_prefill_cache_every_leaf(pair, S):
    """Stacked per pattern position ((C, n, m) and (c, n, h, m), each with a leading
    n_cycles dim), then leaf for leaf after unstacking."""
    jcfg, tm = pair["jcfg"], pair["tm"]
    got = pair["prefill"][S]
    Cy, H, d = jcfg.n_cycles, jcfg.n_heads, jcfg.d_model
    hm, hs = 2 * d // H, d // H
    shapes = [tuple(tuple(t.shape) for t in entry["state"]) for entry in got["tstacked"]]
    assert shapes == [((Cy, B, H, hm, hm), (Cy, B, H, hm), (Cy, B, H)),
                      ((Cy, B, H, hs), (Cy, B, H, hs), (Cy, B, H, hs), (Cy, B, H))]
    tflat = _flat(tm.unstack_cache(got["tstacked"]))
    jflat = _flat(pair["jm"].unstack_cache(got["jstacked"]))
    assert sorted(tflat) == sorted(jflat)
    for path in jflat:
        _close(tflat[path], jflat[path], WHOLE, err_msg=path)


def test_prefill_and_cache_at_the_chunkwise_length(pair):
    """S = 128: the chunkwise mLSTM; held against JAX's float64 prefill (module
    docstring)."""
    got, want = pair["prefill"][LONG], pair["prefill64"]
    _close(got["tlogits"], want["jlogits"], WHOLE, "logits")
    tflat, jflat = _flat(got["tstacked"]), _flat(want["jstacked"])
    assert sorted(tflat) == sorted(jflat)
    for path in jflat:
        _close(tflat[path], jflat[path], WHOLE, path)


@pytest.mark.parametrize("S", SEQ_CASES)
def test_decode_step_after_prefill(pair, S):
    """``serving_cache`` (the states taken whole) and one decode step at position S,
    against the reference's own."""
    got = pair["after"][S]
    _close(got["tlogits"], got["jlogits"], WHOLE)
    tflat, jflat = _flat(got["tcache"]), _flat(got["jcache"])
    assert sorted(tflat) == sorted(jflat)
    for path in jflat:
        _close(tflat[path], jflat[path], WHOLE, err_msg=path)


def test_decode_chain_teacher_forced(pair):
    for t, (tl, jl) in enumerate(pair["chain"]):
        _close(tl, jl, WHOLE, err_msg=f"step {t}")
    tc, jc = pair["chain_caches"]
    tflat, jflat = _flat(tc), _flat(jc)
    for path in jflat:
        _close(tflat[path], jflat[path], WHOLE, err_msg=path)


def test_decode_agrees_with_prefill(pair):
    """Step 11 of the chain has seen tokens 0..11: the 12-token prefill."""
    _close(pair["chain"][11][0], pair["prefill"][12]["tlogits"], WHOLE)


def test_init_cache_starts_the_stabilisers_low(pair):
    cache = pair["tm"].init_cache(B, 4, device="cpu")
    (C, n, m), (c, ns, h, ms) = cache[0]["state"], cache[1]["state"]
    assert bool((m == -1e30).all()) and bool((ms == -1e30).all())
    assert not any(bool(t.any()) for t in (C, n, c, ns, h))
    assert h.dtype == pair["tm"].cfg.torch_dtype and C.dtype == torch.float32


def test_n_params(pair):
    assert pair["tm"].n_params() == pair["jm"].n_params()
    assert pair["tm"].n_params() == sum(p.numel() for p in pair["tm"].parameters())
    full = LM(get_config(ARCH), device="meta")
    assert full.n_params() == JaxLM(jax_config(ARCH)).n_params() == 141_351_168


def test_export_gives_back_what_was_loaded(pair):
    got, want = _flat(convert.export_jax_params(pair["tm"])), _flat(pair["pnp"])
    assert sorted(got) == sorted(want)
    assert {"pos0.mlstm.w_i", "pos0.mlstm.wq", "pos1.slstm.r_zifo",
            "pos1.slstm.w_down"} <= set(got)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_init_fills_every_parameter(pair):
    cfg = pair["tm"].cfg
    m = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    assert all(bool(torch.isfinite(p).all()) for p in m.parameters())
    r = m.blocks[1].slstm["r_zifo"].detach()
    assert abs(float(r.std()) - 0.1) < 0.02
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


@pytest.fixture(scope="module")
def grads_pair():
    jcfg = jax_config(ARCH).reduced()
    rng = np.random.default_rng(12)
    pnp = _numpy_tree(jax.jit(JaxLM(jcfg).init)(jax.random.PRNGKey(2)), rng)
    tokens = rng.integers(0, jcfg.vocab, (B, LONG), dtype=np.int32)
    labels = rng.integers(0, jcfg.vocab, (B, LONG), dtype=np.int32)
    labels[0, :3] = -100
    batch = {"tokens": tokens, "labels": labels}
    jl32, jg32, _, j32, jmet32 = _jax_loss_grads_and_step(jcfg, pnp, batch, jnp.float32)
    with jax.enable_x64(True):
        jl, jg, start, jnew, jmet = _jax_loss_grads_and_step(_f64(jcfg), pnp, batch,
                                                             jnp.float64)
    tm32 = convert.load_jax_params(LM(get_config(ARCH).reduced(), device="cpu"), pnp)
    with torch.no_grad():
        loss32 = float(tm32.loss(torch.from_numpy(tokens), torch.from_numpy(labels)))
    tm = convert.load_jax_params(LM(_f64(get_config(ARCH).reduced()), device="cpu"), pnp)
    loss = tm.loss(torch.from_numpy(tokens), torch.from_numpy(labels))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    return dict(jcfg=jcfg, pnp=pnp, batch=batch, tm=tm, jloss=jl, jloss32=jl32, jgrads=jg,
                jgrads32=jg32, start=start, jnew=jnew, jmet=jmet, j32=j32, jmet32=jmet32,
                loss=float(loss), loss32=loss32, grads=dict(zip(names, grads)))


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
    for path in ("pos0.mlstm.w_f", "pos1.slstm.r_zifo"):
        assert float(np.abs(got[path]).max()) > 0, path


def test_train_step_matches_reference(grads_pair):
    """One AdamW step, the port in float64 against JAX in float64, no farther from
    it than JAX's float32 step or :data:`STEP_TOL` (eps 1e-3, as in
    ``test_torch_train.py``)."""
    g = grads_pair
    tm = LM(_f64(get_config(ARCH).reduced()), device="cpu")
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


def test_remat_around_the_chunked_time_scan(grads_pair, monkeypatch):
    """With the time scan cut into chunks of 32 (its own per-chunk recomputation
    inside each block's), ``remat="full"`` still gives the same loss and gradients."""
    monkeypatch.setattr(layers, "TIME_SCAN_CHUNK", 32)
    tm = grads_pair["tm"]
    loss = tm.loss(torch.from_numpy(grads_pair["batch"]["tokens"]),
                   torch.from_numpy(grads_pair["batch"]["labels"]), remat="full")
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    np.testing.assert_allclose(float(loss), grads_pair["loss"], rtol=1e-12)
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
    assert {"pos0.mlstm.wq", "pos1.slstm.r_zifo"} <= set(want)
