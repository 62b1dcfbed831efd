"""The mixture-of-experts slice of the port against the JAX package: routing, the
MoE block, and qwen3-moe and dbrx at reduced size as whole models (forward,
prefill, caches, decode, loss, gradients, a train step, checkpoints), float32 on
the CPU, weights from the JAX package's ``LM.init`` handed to both sides as numpy.

The routing is held first and exactly (experts, tokens, slots, the drop bin), so
a dispatch fault shows as one and not as a tolerance miss.  The prefill/decode
agreement that the dense and cross-attention models are held to does not apply:
the capacity depends on how many tokens a call holds, so a decode step of B
tokens drops pairs that the prefill kept (the reference's own
``test_decode_consistent_with_forward`` leaves the MoE architectures out).
Gradients and the train step are held against the JAX package run in float64
with the port run in float64 too: at these inputs dbrx's float32 gradients stray
~5e-4 (JAX's) and ~8e-4 (the port's) of their largest magnitude from the float64
ones, so a float32 run cannot tell a fault from rounding at 1e-4.  The loss is
held in float32 as well.

Tolerances are those of ``test_torch_lm.py`` and ``test_torch_train.py``, with
the absolute part scaled by the compared array's largest magnitude when that is
above 1 (:func:`_close`): the reference's init rule draws an expert stack at
``1 / sqrt(n_experts)`` (its first dim), so a random MoE block's output, and the
residual stream after it, run to ~1e2, where float32 rounding alone is ~1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

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

MOE = ["qwen3_moe_30b_a3b", "dbrx_132b"]
B, S = 2, 8


def _numpy_tree(tree, rng):
    """jax tree -> nested dicts of float32 numpy; constant leaves (norms at one)
    are perturbed so that a mixed-up one shows."""
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


def _assert_trees_close(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path in want:
        _close(got[path], want[path], tol, err_msg=path)


# ------------------------------------------------------------ routing and block


def _jax_route(p, cfg, h):
    """The reference's ``moe_block`` from its normed input up to the slots, step
    for step (``src/repro/models/layers.py``): (G, C, se, stok, slot, sg)."""
    Bh, Sh, d = h.shape
    E, K = cfg.n_experts, cfg.top_k
    t = Bh * Sh
    G = max(cfg.moe_groups, 1)
    if t % G:
        G = 1
    tg = t // G
    ht = h.reshape(G, tg, d)
    logits = jnp.einsum("gtd,de->gte", ht, p["router"]).astype(jnp.float32)
    gate, idx = lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    gate = (gate / jnp.sum(gate, -1, keepdims=True)).astype(h.dtype)
    C = min(max(int(K * tg * cfg.moe_capacity_factor / E), 1), tg)
    flat_e = idx.reshape(G, tg * K)
    flat_tok = jnp.broadcast_to(jnp.repeat(jnp.arange(tg), K)[None], (G, tg * K))
    order = jnp.argsort(flat_e, axis=1, stable=True)
    se = jnp.take_along_axis(flat_e, order, axis=1)
    stok = jnp.take_along_axis(flat_tok, order, axis=1)
    sg = jnp.take_along_axis(gate.reshape(G, tg * K), order, axis=1)
    first = jax.vmap(lambda s: jnp.searchsorted(s, jnp.arange(E)))(se)
    rank = jnp.arange(tg * K)[None] - jnp.take_along_axis(first, se, axis=1)
    slot = jnp.where(rank < C, se * C + rank, E * C)
    return G, C, se, stok, slot, sg


def _block_inputs(arch, groups, seed, shape=(4, 16), **over):
    cfg = dataclasses.replace(get_config(arch).reduced(), moe_groups=groups, **over)
    jcfg = dataclasses.replace(jax_config(arch).reduced(), moe_groups=groups, **over)
    rng = np.random.default_rng(seed)
    pnp = _numpy_tree(jlayers.materialize(jlayers.moe_defs(jcfg), jax.random.PRNGKey(seed),
                                          jnp.float32), rng)
    x = (rng.standard_normal((*shape, cfg.d_model)) * 0.5).astype(np.float32)
    tp = {k: torch.tensor(v) for k, v in pnp.items()}
    jp = {k: jnp.asarray(v) for k, v in pnp.items()}
    return cfg, jcfg, tp, jp, x


# groups: 1; 4 (divides the 64 tokens); 7 (does not: falls back to 1)
ROUTE_CASES = [(a, g) for a in MOE for g in (1, 4, 7)]


@pytest.mark.parametrize("arch,groups", ROUTE_CASES, ids=[f"{a}-G{g}" for a, g in ROUTE_CASES])
def test_moe_route_matches_reference(arch, groups):
    cfg, jcfg, tp, jp, x = _block_inputs(arch, groups, 1)
    h = np.asarray(jlayers.rms_norm(jnp.asarray(x), jp["ln"], jcfg.norm_eps))
    want = _jax_route(jp, jcfg, jnp.asarray(h))
    got = layers.moe_route(tp, cfg, torch.from_numpy(h))
    assert (got.groups, got.capacity) == want[:2] == ((4 if groups == 4 else 1), got.capacity)
    for name, g, w in zip(("expert", "token", "slot"), got[2:5], want[2:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got.gate.numpy(), np.asarray(want[5]), atol=1e-6, rtol=1e-6)
    # at the default capacity factor some pairs overflow into the drop bin
    E, C = cfg.n_experts, got.capacity
    dropped = got.slot == E * C
    assert 0 < int(dropped.sum()) < got.slot.numel()
    for row, drop in zip(got.slot, dropped):     # a kept slot is its pair's own in its group
        kept = row[~drop]
        assert len(set(kept.tolist())) == kept.numel()


@pytest.mark.parametrize("arch,groups", ROUTE_CASES, ids=[f"{a}-G{g}" for a, g in ROUTE_CASES])
def test_moe_block_matches_reference(arch, groups):
    cfg, jcfg, tp, jp, x = _block_inputs(arch, groups, 2)
    want = np.asarray(jlayers.moe_block(jp, jcfg, jnp.asarray(x)))
    got = layers.moe_block(tp, cfg, torch.from_numpy(x)).numpy()
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_block_gradients_match_reference(arch):
    """Gradients of every expert weight, the router and the input, against JAX
    in float64."""
    cfg, jcfg, tp, jp, x = _block_inputs(arch, 4, 3)
    dy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    with jax.enable_x64(True):
        jp64 = {k: jnp.asarray(v, jnp.float64) for k, v in jp.items()}
        jcfg64 = dataclasses.replace(jcfg, dtype="float64")
        _, vjp = jax.vjp(lambda p, xx: jlayers.moe_block(p, jcfg64, xx), jp64,
                         jnp.asarray(x, jnp.float64))
        jgp, jgx = jax.tree.map(np.asarray, vjp(jnp.asarray(dy, jnp.float64)))
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    grads = torch.autograd.grad(layers.moe_block(tp, cfg, tx), [tx, *tp.values()],
                                torch.from_numpy(dy))
    _close(grads[0].numpy(), jgx, 1e-4)
    for name, g in zip(tp, grads[1:]):
        _close(g.numpy(), jgp[name], 1e-4, err_msg=name)


def test_moe_groups_change_nothing_without_drops():
    """With ample capacity (no drops) group-local dispatch equals one group: the
    port's twin of the reference's ``test_moe_grouped_dispatch_matches_single_group``."""
    outs = []
    for groups in (1, 4):
        cfg, _, tp, _, x = _block_inputs("qwen3_moe_30b_a3b", groups, 5,
                                         moe_capacity_factor=8.0)
        assert int((layers.moe_route(tp, cfg, torch.from_numpy(x)).slot
                    == cfg.n_experts * layers.moe_route(tp, cfg, torch.from_numpy(x)).capacity)
                   .sum()) == 0
        outs.append(layers.moe_block(tp, cfg, torch.from_numpy(x)))
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)


def test_moe_defs_match_reference():
    cfg, jcfg = get_config("dbrx_132b").reduced(), jax_config("dbrx_132b").reduced()
    tdefs, jdefs = layers.moe_defs(cfg), jlayers.moe_defs(jcfg)
    assert list(tdefs) == list(jdefs)
    for k in jdefs:
        assert (tdefs[k].shape, tdefs[k].scale, tdefs[k].init) == \
            (jdefs[k].shape, jdefs[k].scale, jdefs[k].init)


# ------------------------------------------------------------ whole models


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    """Both models on the same weights and tokens, with every result the tests
    compare computed once."""
    arch = request.param
    jcfg = jax_config(arch).reduced()
    jm = JaxLM(jcfg)
    rng = np.random.default_rng(MOE.index(arch))
    pnp = _numpy_tree(jm.init(jax.random.PRNGKey(1)), rng)
    jparams = jax.tree.map(jnp.asarray, pnp)
    tokens = rng.integers(0, jcfg.vocab, (B, S + 1), dtype=np.int32)
    jt = jnp.asarray(tokens)

    jx = jax.jit(jm.forward)(jparams, jt[:, :S])
    jlogits, jstacked = jax.jit(jm.prefill)(jparams, jt[:, :S])
    jflat = jm.unstack_cache(jstacked)
    jstep = jax.jit(jm.decode_step)
    jcache = jm.init_cache(B, S + 2)
    jchain = []
    for t in range(S + 1):
        lg, jcache = jstep(jparams, jcache, jt[:, t:t + 1], jnp.full((B,), t, jnp.int32))
        jchain.append(np.asarray(lg))

    tm = convert.load_jax_params(LM(get_config(arch).reduced(), device="cpu"), pnp)
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        tx = tm.forward(tt[:, :S])
    tlogits, tstacked = make_prefill_step(tm)({"tokens": tt[:, :S]})
    serve = make_serve_step(tm)
    tcache = tm.init_cache(B, S + 2, device="cpu")
    tchain = []
    for t in range(S + 1):
        lg, tcache = serve(tcache, {"tokens": tt[:, t:t + 1],
                                    "pos": torch.full((B,), t, dtype=torch.int32)})
        tchain.append(lg.numpy().copy())
    return dict(arch=arch, jm=jm, tm=tm, pnp=pnp, jcfg=jcfg,
                jx=np.asarray(jx), tx=tx.numpy(),
                jlogits=np.asarray(jlogits), tlogits=tlogits.numpy(),
                jflat=jflat, tstacked=tstacked, jstacked=jstacked,
                jchain=jchain, tchain=tchain, jcache=jcache, tcache=tcache)


def test_blocks_hold_experts(pair):
    tm, cfg = pair["tm"], pair["tm"].cfg
    assert cfg.n_experts and all(hasattr(b, "moe") and not hasattr(b, "ffn")
                                 for b in tm.blocks)
    assert tuple(tm.blocks[0].moe["w_down"].shape) == (cfg.n_experts, cfg.d_ff, cfg.d_model)


def test_forward_hidden(pair):
    _close(pair["tx"], pair["jx"], 1e-4)


def test_prefill_logits(pair):
    assert pair["tlogits"].shape == (B, pair["jcfg"].vocab)
    _close(pair["tlogits"], pair["jlogits"], 1e-4)


def test_prefill_cache_stacked_layout(pair):
    jcfg = pair["jcfg"]
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


def test_n_params(pair):
    assert pair["tm"].n_params() == pair["jm"].n_params()
    assert pair["tm"].n_params() == sum(p.numel() for p in pair["tm"].parameters())


def test_export_gives_back_what_was_loaded(pair):
    out = convert.export_jax_params(pair["tm"])
    got, want = _flat(out), _flat(pair["pnp"])
    assert sorted(got) == sorted(want)
    assert {"pos0.moe.router", "pos0.moe.w_gate", "pos0.moe.w_up",
            "pos0.moe.w_down", "pos0.moe.ln"} <= set(got)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_init_fills_every_parameter(pair):
    cfg = pair["tm"].cfg
    m = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    assert all(bool(torch.isfinite(p).all()) for p in m.parameters())
    logits, _ = m.prefill(torch.zeros((1, 4), dtype=torch.int64))
    assert bool(torch.isfinite(logits).all())
    w = m.blocks[0].moe["w_gate"]
    # the scale rule on the stacked (E, d, f) leaf: 1 / sqrt(E), as the reference
    assert abs(float(w.std()) - 1 / np.sqrt(cfg.n_experts)) < 0.1 / np.sqrt(cfg.n_experts)


# ------------------------------------------------------------ training


@pytest.fixture(scope="module", params=MOE)
def grads_pair(request):
    arch = request.param
    jcfg = jax_config(arch).reduced()
    jm = JaxLM(jcfg)
    rng = np.random.default_rng(10 + MOE.index(arch))
    pnp = _numpy_tree(jm.init(jax.random.PRNGKey(2)), rng)
    tokens = rng.integers(0, jcfg.vocab, (B, 12), dtype=np.int32)
    labels = rng.integers(0, jcfg.vocab, (B, 12), dtype=np.int32)
    labels[0, :3] = -100
    jl32 = float(jax.jit(jm.loss)(jax.tree.map(jnp.asarray, pnp), jnp.asarray(tokens),
                                  jnp.asarray(labels)))
    with jax.enable_x64(True):
        jm64 = JaxLM(dataclasses.replace(jcfg, dtype="float64"))
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), pnp)
        jl, jg = jax.jit(jax.value_and_grad(jm64.loss))(p64, jnp.asarray(tokens),
                                                         jnp.asarray(labels))
        jl, jg = float(jl), jax.tree.map(np.asarray, jg)
    tm32 = convert.load_jax_params(LM(get_config(arch).reduced(), device="cpu"), pnp)
    loss32 = float(tm32.loss(torch.from_numpy(tokens), torch.from_numpy(labels)))
    tm = convert.load_jax_params(LM(_f64(get_config(arch).reduced()), device="cpu"), pnp)
    loss = tm.loss(torch.from_numpy(tokens), torch.from_numpy(labels))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    return dict(arch=arch, jcfg=jcfg, pnp=pnp, tokens=tokens, labels=labels, tm=tm,
                jloss=jl, jloss32=jl32, jgrads=jg, loss=float(loss), loss32=loss32,
                grads=dict(zip(names, grads)))


def _f64(cfg):
    return dataclasses.replace(cfg, dtype="float64")


def test_loss_matches_reference(grads_pair):
    for want in (grads_pair["jloss"], grads_pair["jloss32"]):
        np.testing.assert_allclose(grads_pair["loss32"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads_pair["loss"], grads_pair["jloss"], rtol=1e-6)


def test_every_gradient_matches_reference(grads_pair):
    got = convert.export_jax_tree(grads_pair["tm"], grads_pair["grads"])
    _assert_trees_close(got, grads_pair["jgrads"], 1e-4)
    assert float(np.abs(_flat(got)["pos0.moe.router"]).max()) > 0


def test_train_step_matches_reference(grads_pair):
    """One AdamW step from the same state and batch, both sides in float64 (eps
    1e-3, as in ``test_torch_train.py``)."""
    pnp, jcfg = grads_pair["pnp"], grads_pair["jcfg"]
    cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-3)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    batch = {"tokens": grads_pair["tokens"], "labels": grads_pair["labels"]}
    with jax.enable_x64(True):
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), pnp)
        jstate = {"params": jparams, "opt": jadamw.init_opt_state(jparams)}
        jm64 = JaxLM(dataclasses.replace(jcfg, dtype="float64"))
        jnew, jmet = jax.jit(jax_train_step(jm64, jopt, remat="none"))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jnew, jmet = jax.tree.map(np.asarray, (jnew, jmet))
        start = jax.tree.map(np.asarray, jstate)
    tm = LM(_f64(get_config(grads_pair["arch"]).reduced()), device="cpu")
    state = convert.load_jax_train_state(tm, start)
    new, met = make_train_step(tm, cfg, remat="none")(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=rtol, err_msg=key)
    out = convert.export_jax_train_state(tm, new)
    _assert_trees_close(out["params"], jnew["params"], 1e-5)
    _assert_trees_close(out["opt"].m, jnew["opt"].m, 1e-5)


@pytest.mark.parametrize("remat", ["selective", "full"])
def test_remat_changes_nothing(grads_pair, remat):
    tm = grads_pair["tm"]
    loss = tm.loss(torch.from_numpy(grads_pair["tokens"]),
                   torch.from_numpy(grads_pair["labels"]), remat=remat)
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    assert float(loss) == grads_pair["loss"]
    for (name, _), g in zip(tm.named_parameters(), grads):
        torch.testing.assert_close(g, grads_pair["grads"][name], rtol=0, atol=1e-7, msg=name)


# ------------------------------------------------------------ checkpoints


def _jax_moe_state(dtype, seed):
    cfg = jax_config("qwen3_moe_30b_a3b").reduced(dtype=dtype)
    jm = JaxLM(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    noise = lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)  # noqa: E731
    return {"params": params,
            "opt": jadamw.OptState(jax.tree.map(noise, params),
                                   jax.tree.map(lambda p: jnp.abs(noise(p)), params),
                                   jnp.asarray(5, jnp.int32))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_checkpoints_cross_both_ways(tmp_path, dtype):
    jst = _jax_moe_state(dtype, 0)
    jstore.save(tmp_path / "jax", jst, step=5)
    model = LM(get_config("qwen3_moe_30b_a3b").reduced(dtype=dtype), device="cpu")
    tree, manifest = store.restore(tmp_path / "jax", convert.jax_train_state_like(model))
    state = convert.load_jax_train_state(model, tree)
    assert manifest["step"] == 5 and int(state["opt"].step) == 5
    store.save(tmp_path / "port", convert.export_jax_train_state(model, state), step=6)
    back, manifest = jstore.restore(tmp_path / "port", _jax_moe_state(dtype, 9))
    assert manifest["step"] == 6
    want, got = _flat(jax.tree.map(np.asarray, jst["params"])), _flat(back["params"])
    assert sorted(got) == sorted(want) and "pos0.moe.w_gate" in got
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    for mom in ("m", "v"):
        a = _flat(jax.tree.map(np.asarray, getattr(jst["opt"], mom)))
        b = _flat(getattr(back["opt"], mom))
        for path in a:
            np.testing.assert_array_equal(b[path], a[path], err_msg=f"{mom} {path}")
