"""The serving slice of the port as a whole against the JAX package: the four
dense architectures at reduced size, float32 on the CPU, weights from the JAX
package's ``LM.init`` handed to both sides as numpy.  The MoE and
cross-attention families have files of their own (``test_torch_moe.py``,
``test_torch_cross.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch.configs import ALIASES, ARCH_IDS, all_configs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.config import ALL_SHAPES  # noqa: E402
from repro_torch.models.convert import (export_jax_params,  # noqa: E402
                                        load_jax_params)
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.parallel.trainstep import (make_prefill_step,  # noqa: E402
                                            make_serve_step)

DENSE = ["qwen2_7b", "gemma_7b", "qwen3_32b", "granite_34b"]
B, S = 2, 8


def _to_numpy_tree(tree, rng):
    """jax tree -> nested dicts of float32 numpy; constant leaves (norms at
    one, biases at zero) are perturbed so that a mixed-up one shows."""
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if np.ptp(a) == 0:
        a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    return a


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """Both models on the same weights and tokens, with every result the
    tests compare computed once."""
    arch = request.param
    jcfg = jax_config(arch).reduced()
    jm = JaxLM(jcfg)
    rng = np.random.default_rng(DENSE.index(arch))
    pnp = _to_numpy_tree(jm.init(jax.random.PRNGKey(1)), rng)
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
        lg, jcache = jstep(jparams, jcache, jt[:, t:t + 1],
                           jnp.full((B,), t, jnp.int32))
        jchain.append(np.asarray(lg))

    tm = load_jax_params(LM(get_config(arch).reduced(), device="cpu"), pnp)
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        tx = tm.forward(tt[:, :S])
    tlogits, tstacked = make_prefill_step(tm)({"tokens": tt[:, :S]})
    serve = make_serve_step(tm)
    tcache = tm.init_cache(B, S + 2, device="cpu")
    tchain = []
    for t in range(S + 1):
        lg, tcache = serve(tcache, {"tokens": tt[:, t:t + 1],
                                    "pos": torch.full((B,), t,
                                                      dtype=torch.int32)})
        tchain.append(lg.numpy().copy())
    return dict(arch=arch, jm=jm, tm=tm, pnp=pnp, jcfg=jcfg,
                jx=np.asarray(jx), tx=tx.numpy(),
                jlogits=np.asarray(jlogits), tlogits=tlogits.numpy(),
                jflat=jflat, tstacked=tstacked, jstacked=jstacked,
                jchain=jchain, tchain=tchain, jcache=jcache, tcache=tcache)


def test_forward_hidden(pair):
    np.testing.assert_allclose(pair["tx"], pair["jx"], atol=1e-4, rtol=1e-4)


def test_prefill_logits(pair):
    assert pair["tlogits"].shape == (B, pair["jcfg"].vocab)
    np.testing.assert_allclose(pair["tlogits"], pair["jlogits"],
                               atol=1e-4, rtol=1e-4)


def test_prefill_cache_stacked_layout(pair):
    tm, jcfg = pair["tm"], pair["jcfg"]
    assert len(pair["tstacked"]) == jcfg.cycle_len == len(pair["jstacked"])
    for tpos, jpos in zip(pair["tstacked"], pair["jstacked"]):
        assert set(tpos) == {"k", "v"}
        for name in ("k", "v"):
            assert tuple(tpos[name].shape) == jpos[name].shape == (
                jcfg.n_cycles, B, S, jcfg.n_kv_heads, jcfg.hd)
    assert tm.cfg.n_cycles == jcfg.n_cycles


def test_prefill_cache_every_leaf_after_unstack(pair):
    tflat = pair["tm"].unstack_cache(pair["tstacked"])
    assert len(tflat) == len(pair["jflat"]) == pair["jcfg"].n_layers
    for tl, jl in zip(tflat, pair["jflat"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(tl[name].numpy(), np.asarray(jl[name]),
                                       atol=1e-4, rtol=1e-4)


def test_decode_chain_teacher_forced(pair):
    for t, (tl, jl) in enumerate(zip(pair["tchain"], pair["jchain"])):
        np.testing.assert_allclose(tl, jl, atol=2e-3, rtol=2e-3,
                                   err_msg=f"step {t}")
    for tc, jc in zip(pair["tcache"], pair["jcache"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                       atol=2e-3, rtol=2e-3)


def test_decode_agrees_with_prefill(pair):
    """Step S-1 of the chain has seen tokens 0..S-1: the prefill's logits."""
    np.testing.assert_allclose(pair["tchain"][S - 1], pair["tlogits"],
                               atol=2e-3, rtol=2e-3)


def test_n_params(pair):
    assert pair["tm"].n_params() == pair["jm"].n_params()
    assert pair["tm"].n_params() == sum(p.numel()
                                        for p in pair["tm"].parameters())


def test_export_gives_back_what_was_loaded(pair):
    out = export_jax_params(pair["tm"])

    def check(a, b, path=""):
        assert type(a) is type(b) or not isinstance(a, dict), path
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                check(a[k], b[k], f"{path}.{k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)

    check(out, pair["pnp"])


def test_init_fills_every_parameter(pair):
    cfg = pair["tm"].cfg
    m = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    assert all(bool(torch.isfinite(p).all()) for p in m.parameters())
    assert torch.all(m.final_norm == 1)
    logits, _ = m.prefill(torch.zeros((1, 4), dtype=torch.int64))
    assert bool(torch.isfinite(logits).all())
    m2 = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    assert torch.equal(m.blocks[-1].ffn["w_down"], m2.blocks[-1].ffn["w_down"])


# ---------------------------------------------------------------- configs


def _same_fields(tcfg, jcfg):
    assert [f.name for f in dataclasses.fields(tcfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_registry_matches():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert sorted(all_configs()) == sorted(ARCH_IDS)
    for alias, mod in ALIASES.items():
        assert get_config(alias) is get_config(mod)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_config_equals_reference_field_for_field(arch):
    tcfg, jcfg = get_config(arch), jax_config(arch)
    _same_fields(tcfg, jcfg)
    for name in ("hd", "pattern", "cycle_len", "n_cycles"):
        assert getattr(tcfg, name) == getattr(jcfg, name)
    assert [tcfg.block_kind(i) for i in range(tcfg.n_layers)] == \
        [jcfg.block_kind(i) for i in range(jcfg.n_layers)]
    assert [s.name for s in tcfg.shapes()] == [s.name for s in jcfg.shapes()]
    assert [(s.name, why) for s, why in tcfg.skipped_shapes()] == \
        [(s.name, why) for s, why in jcfg.skipped_shapes()]


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_reduced_config_equals_reference_field_for_field(arch):
    _same_fields(get_config(arch).reduced(), jax_config(arch).reduced())
    _same_fields(get_config(arch).reduced(d_model=96, n_layers=3 * 6),
                 jax_config(arch).reduced(d_model=96, n_layers=3 * 6))


@pytest.mark.parametrize("arch", ["qwen2_7b", "whisper_medium",
                                  "llama_3p2_vision_11b"])
def test_input_specs_match_reference(arch):
    tcfg, jcfg = get_config(arch), jax_config(arch)
    assert tcfg.torch_dtype == torch.bfloat16
    for shape, jshape in zip(ALL_SHAPES, __import__(
            "repro.models.config", fromlist=["ALL_SHAPES"]).ALL_SHAPES):
        tspecs, jspecs = tcfg.input_specs(shape), jcfg.input_specs(jshape)
        assert list(tspecs) == list(jspecs)
        for name, (shp, dt) in tspecs.items():
            assert shp == jspecs[name].shape
            assert str(dt).split(".")[-1] == str(jspecs[name].dtype)


# ------------------------------------------------------- every architecture


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_runs_forward_and_a_train_step(arch):
    """The port's twin of the reference's ``test_arch_smoke_forward_and_train_step``:
    each of the ten reduced configs, dense, MoE, cross-attention and recurrent,
    gives a finite forward of the right shape and takes a train step (loss, grads,
    AdamW) that moves its parameters."""
    from repro_torch.data.pipeline import modality_inputs
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.trainstep import init_train_state, make_train_step
    cfg = get_config(arch).reduced()
    model = LM(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    mods = modality_inputs(cfg, 2, gen, "cpu")
    with torch.no_grad():
        x = model.forward(tokens, **mods)
    assert tuple(x.shape) == (2, 32, cfg.d_model) and bool(torch.isfinite(x).all())
    before = {n: p.detach().clone() for n, p in state["params"].items()}
    step = make_train_step(model, AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10))
    state, metrics = step(state, {"tokens": tokens,
                                  "labels": torch.randint(0, cfg.vocab, (2, 32), generator=gen),
                                  **mods})
    assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(metrics["grad_norm"]))
    name = next(iter(before))
    assert not torch.equal(before[name], state["params"][name].detach())


# ------------------------------------------------------- what is refused


def test_dense_model_ignores_modality_inputs():
    """As the reference's ``_memory`` returns None for a model without
    cross-attention, a dense model's steps take a modality input and leave it
    unused."""
    m = LM(get_config("qwen2_7b").reduced(), device="cpu").init(
        torch.Generator().manual_seed(0))
    tokens = torch.arange(6)[None] % m.cfg.vocab
    base, _ = make_prefill_step(m)({"tokens": tokens})
    for key in ("audio_embed", "vision_embed"):
        got, _ = make_prefill_step(m)({"tokens": tokens, key: torch.ones(1, 3, m.cfg.d_model)})
        assert torch.equal(got, base)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_jax_params_refuses_a_wrong_tree(fault):
    cfg = get_config("qwen2_7b").reduced()
    m = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tree = export_jax_params(m)
    if fault == "missing":
        del tree["pos0"]["attn"]["bq"]
        err = KeyError
    elif fault == "extra":
        tree["pos0"]["ffn"]["w_other"] = np.zeros(3, np.float32)
        err = KeyError
    else:
        tree["pos0"]["attn"]["wq"] = tree["pos0"]["attn"]["wq"][:1]
        err = ValueError
    with pytest.raises(err):
        load_jax_params(LM(cfg, device="cpu"), tree)


def test_head_order_survives_the_converter():
    """Permuting q heads in the reference tree must change the output: the
    converter keeps wq's (d, H, hd) layout, head h reading KV head h // G."""
    cfg = get_config("qwen2_7b").reduced()
    m = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tree = export_jax_params(m)
    tokens = torch.arange(6)[None] % cfg.vocab
    base, _ = m.prefill(tokens)
    tree["pos0"]["attn"]["wq"] = tree["pos0"]["attn"]["wq"][:, :, ::-1].copy()
    other, _ = load_jax_params(LM(cfg, device="cpu"), tree).prefill(tokens)
    assert float((base - other).abs().max()) > 1e-4
