"""The training half of the port against the JAX package: the chunked
cross-entropy, ``LM.loss`` and its gradients, rematerialisation, AdamW and the
train step, float32 on the CPU, weights from the JAX package's ``LM.init`` handed
to both sides as numpy.

Gradients of the whole model are held against the JAX package run in float64 (the
same model with ``dtype="float64"``, under ``jax.enable_x64``): at these inputs
JAX's own float32 gradient of the token embedding strays ~2e-3 of its largest
magnitude from its float64 one, the port's float32 gradient ~1e-5, so the float64
run is the reference that can tell a fault from rounding.  The loss is held
against JAX's float32 run as well.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel.trainstep import make_train_step as jax_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert, layers  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.trainstep import (init_train_state,  # noqa: E402
                                            make_train_step)

B, S = 2, 12


def _numpy_tree(tree, rng):
    """jax tree -> nested dicts of float32 numpy; constant leaves (norms at one,
    biases at zero) are perturbed so that a mixed-up one shows."""
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


def _assert_trees_close(got, want, atol, rtol):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=atol, rtol=rtol,
                                   err_msg=path)


@pytest.fixture(scope="module")
def setup():
    """Both models on the same weights, tokens and labels (some -100)."""
    jcfg = jax_config("qwen2_7b").reduced()
    jm = JaxLM(jcfg)
    rng = np.random.default_rng(0)
    pnp = _numpy_tree(jm.init(jax.random.PRNGKey(1)), rng)
    tokens = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    labels = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    labels[0, :3] = -100
    labels[1, -1] = -100
    tm = convert.load_jax_params(LM(get_config("qwen2_7b").reduced(), device="cpu"), pnp)
    return dict(jm=jm, jcfg=jcfg, pnp=pnp, tokens=tokens, labels=labels, tm=tm)


# ------------------------------------------------------------ cross-entropy


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_xent_loss_matches_reference(softcap):
    """-100 labels masked, S = 37 not a multiple of the chunk (8 -> 1-wide chunks
    by the reference's rule), loss and both gradients."""
    cfg = dataclasses.replace(get_config("qwen2_7b").reduced(), logit_softcap=softcap)
    jcfg = dataclasses.replace(jax_config("qwen2_7b").reduced(), logit_softcap=softcap)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 16)).astype(np.float32)
    emb = (rng.standard_normal((50, 16)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 50, (2, 37)).astype(np.int32)
    labels[:, ::5] = -100

    def jloss(x, emb):
        return jlayers.xent_loss(x, emb, jnp.asarray(labels), jcfg, chunk=8)

    jl, (jgx, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
    tx = torch.from_numpy(x).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    tl = layers.xent_loss(tx, te, torch.from_numpy(labels), cfg, chunk=8)
    gx, ge = torch.autograd.grad(tl, (tx, te))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(ge.numpy(), np.asarray(jge), atol=1e-6, rtol=1e-5)
    with torch.no_grad():   # the same without recomputation
        assert float(layers.xent_loss(tx, te, torch.from_numpy(labels), cfg, chunk=8)) \
            == pytest.approx(float(tl), rel=1e-7)


def test_xent_loss_all_masked_is_zero():
    cfg = get_config("qwen2_7b").reduced()
    x, emb = torch.ones(1, 4, 8), torch.ones(10, 8)
    assert float(layers.xent_loss(x, emb, torch.full((1, 4), -100), cfg)) == 0.0


# ------------------------------------------------------------ LM.loss


def _jax64(jcfg):
    """The JAX package's model at float64 (call under ``jax.enable_x64(True)``)."""
    return JaxLM(dataclasses.replace(jcfg, dtype="float64"))


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def loss_and_grads(setup):
    jm, pnp = setup["jm"], setup["pnp"]
    tok, lab = jnp.asarray(setup["tokens"]), jnp.asarray(setup["labels"])
    jl32 = jax.jit(lambda p: jm.loss(p, tok, lab))(jax.tree.map(jnp.asarray, pnp))
    with jax.enable_x64(True):
        jm64 = _jax64(setup["jcfg"])
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p, t, lb: jm64.loss(p, t, lb, remat="none")))(
                _f64(pnp), jnp.asarray(setup["tokens"]), jnp.asarray(setup["labels"]))
        jl, jg = float(jl), jax.tree.map(np.asarray, jg)
    tm = setup["tm"]
    out = {}
    for remat in ("none", "selective", "full"):
        loss = tm.loss(torch.from_numpy(setup["tokens"]), torch.from_numpy(setup["labels"]),
                       remat=remat)
        names = [n for n, _ in tm.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
        out[remat] = (float(loss), dict(zip(names, grads)))
    return dict(jloss=jl, jloss32=float(jl32), jgrads=jg, port=out)


def test_lm_loss_matches_reference(loss_and_grads):
    for want in (loss_and_grads["jloss"], loss_and_grads["jloss32"]):
        np.testing.assert_allclose(loss_and_grads["port"]["none"][0], want,
                                   rtol=1e-5, atol=1e-5)


def test_lm_loss_gradients_match_reference(setup, loss_and_grads):
    grads = convert.export_jax_tree(setup["tm"], loss_and_grads["port"]["none"][1])
    _assert_trees_close(grads, loss_and_grads["jgrads"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("remat", ["selective", "full"])
def test_remat_changes_nothing(loss_and_grads, remat):
    base_loss, base = loss_and_grads["port"]["none"]
    loss, grads = loss_and_grads["port"][remat]
    assert loss == base_loss
    for name in base:
        torch.testing.assert_close(grads[name], base[name], rtol=0, atol=1e-7, msg=name)


def test_unknown_remat_raises(setup):
    with pytest.raises(ValueError, match="remat"):
        setup["tm"].loss(torch.zeros((1, 4), dtype=torch.int64),
                         torch.zeros((1, 4), dtype=torch.int64), remat="some")


# ------------------------------------------------------------ AdamW


def test_adamw_five_steps_match_reference():
    """Identical grads for 5 steps; fp32 and bf16 parameters; clipping active."""
    rng = np.random.default_rng(3)
    shapes = {"a": (6, 5), "b": (7,), "c": (3, 4)}
    dtypes = {"a": np.float32, "b": np.float32, "c": jnp.bfloat16}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5)
    jcfg = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    jp = {k: jnp.asarray(v).astype(dtypes[k]) for k, v in init.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "c" else torch.float32)
          for k, v in init.items()}
    jstate, tstate = jadamw.init_opt_state(jp), adamw.init_opt_state(tp)
    for _ in range(5):
        g = {k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in shapes.items()}
        jp, jstate, jm = jadamw.adamw_update(
            jp, {k: jnp.asarray(v).astype(dtypes[k]) for k, v in g.items()}, jstate, jcfg)
        tp, tstate, tm = adamw.adamw_update(
            tp, {k: torch.from_numpy(v).to(tp[k].dtype) for k, v in g.items()}, tstate, cfg)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        for k in shapes:
            assert tp[k].dtype == (torch.bfloat16 if k == "c" else torch.float32)
            np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                                       atol=1e-6, rtol=1e-6, err_msg=k)
            np.testing.assert_allclose(tstate.m[k].numpy(), np.asarray(jstate.m[k]),
                                       atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(tstate.v[k].numpy(), np.asarray(jstate.v[k]),
                                       atol=1e-6, rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 5


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 10_000, 20_000])
def test_cosine_lr_matches_reference(step):
    cfg = adamw.AdamWConfig()
    np.testing.assert_allclose(
        float(adamw.cosine_lr(cfg, torch.tensor(step))),
        float(jadamw.cosine_lr(jadamw.AdamWConfig(), jnp.asarray(step))), rtol=1e-6)


# ------------------------------------------------------------ train step


@pytest.mark.parametrize("M", [1, 2])
def test_train_step_matches_reference(setup, M):
    """One step from the same state and batch: loss, metrics and every new
    parameter and moment.  The first AdamW step moves a parameter by about
    ``lr * g / (|g| + eps)``, whose slope in g is ``eps / (|g| + eps)^2``: with
    the default eps of 1e-8 a small gradient entry's float32 rounding (~1e-9) is
    magnified up to 1e8 times, so eps is 1e-3 here (slope at most 1e3); the norm
    of float32 gradients is good to ~1e-5."""
    pnp = setup["pnp"]
    cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-3)
    jcfg = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    batch = {"tokens": setup["tokens"], "labels": setup["labels"]}
    with jax.enable_x64(True):
        jparams = _f64(pnp)
        jstate = {"params": jparams, "opt": jadamw.init_opt_state(jparams)}
        jnew, jmet = jax.jit(jax_train_step(_jax64(setup["jcfg"]), jcfg, microbatches=M,
                                            remat="none"))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jnew, jmet = jax.tree.map(np.asarray, (jnew, jmet))
        start = jax.tree.map(np.asarray, jstate)

    tm = LM(get_config("qwen2_7b").reduced(), device="cpu")
    state = convert.load_jax_train_state(tm, start)
    new, met = make_train_step(tm, cfg, microbatches=M, remat="none")(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6), ("tokens", 0)):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=rtol, err_msg=key)
    out = convert.export_jax_train_state(tm, new)
    _assert_trees_close(out["params"], jnew["params"], atol=1e-5, rtol=1e-5)
    _assert_trees_close(out["opt"].m, jnew["opt"].m, atol=1e-7, rtol=1e-4)
    assert int(out["opt"].step) == int(jnew["opt"].step) == 1
    assert new["params"]["embed.tok"] is tm.embed["tok"]   # updated in place


def test_init_train_state_uses_the_models_parameters():
    tm = LM(get_config("qwen2_7b").reduced(), device="cpu")
    state = init_train_state(tm, torch.Generator().manual_seed(0))
    own = dict(tm.named_parameters())
    assert state["params"].keys() == own.keys()
    assert all(state["params"][k] is own[k] for k in own)
    assert all(m.dtype == torch.float32 and not m.any() for m in state["opt"].m.values())
    assert int(state["opt"].step) == 0


def test_train_step_copies_a_foreign_state_into_the_model():
    cfg = get_config("qwen2_7b").reduced()
    a = LM(cfg, device="cpu")
    b = LM(cfg, device="cpu")
    sa = init_train_state(a, torch.Generator().manual_seed(0))
    init_train_state(b, torch.Generator().manual_seed(1))
    foreign = {"params": {k: v.detach().clone() for k, v in sa["params"].items()},
               "opt": sa["opt"]}
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64),
             "labels": torch.ones((1, 4), dtype=torch.int64)}
    opt = adamw.AdamWConfig()
    new, m1 = make_train_step(b, opt, remat="none")(foreign, batch)
    assert new["params"]["final_norm"] is b.final_norm
    sa2 = init_train_state(a, torch.Generator().manual_seed(0))
    _, m2 = make_train_step(a, opt, remat="none")(sa2, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    with pytest.raises(KeyError):
        make_train_step(b, opt)({"params": {"x": torch.zeros(1)}, "opt": sa["opt"]}, batch)
