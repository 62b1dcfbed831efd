"""The port's sharding layer (``repro_torch.parallel.axes`` / ``sharding``,
``launch.mesh``) against the reference's, on the CPU with no process group: for
every parameter and cache entry of all ten architectures the logical axes and
the ``AxisRules.spec`` equal the reference's ``PartitionSpec`` on a ``(2, 4)``
``("data", "model")`` mesh and on the ``(2, 16, 16)`` production shape (the
reference's ``spec`` reads only ``mesh.shape``, so a stub with that dict stands
in for both meshes); the placements follow the spec; the profiles' rules and
notes are the reference's; ``pad_heads`` leaves the forward unchanged, held
against JAX's; and the mesh builders refuse a process group that is too small.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro.parallel.axes import AxisRules as JaxRules  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.axes import (DEFAULT_RULES, AxisRules, P,  # noqa: E402
                                       active_rules, shard, use_rules)
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _stub(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _leaves(tree, prefix=""):
    """(path, leaf) over nested dicts / tuples; a tuple of axis names is a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, tuple) and not all(isinstance(e, (str, type(None)))
                                             for e in tree):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _models(arch):
    return JaxLM(jax_config(arch)), LM(get_config(arch), device="meta")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh):
    jm, pm = _models(arch)
    jax_axes, port_axes = dict(_leaves(jm.param_axes())), dict(_leaves(pm.param_axes()))
    jax_ab, port_ab = dict(_leaves(jm.abstract_params())), dict(_leaves(pm.abstract_params()))
    assert jax_axes == port_axes
    stub = _stub(mesh)
    for path, axes in jax_axes.items():
        assert tuple(port_ab[path].shape) == tuple(jax_ab[path].shape), path
        assert port_ab[path].device.type == "meta"
        want = JaxRules().spec(axes, jax_ab[path].shape, stub)
        got = AxisRules().spec(axes, port_ab[path].shape, stub)
        assert tuple(got) == tuple(want), (path, got, want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh):
    jm, pm = _models(arch)
    jcfg = jm.cfg
    stub = _stub(mesh)
    # the profile's rules: split-KV decode where kv heads do not divide "model"
    jrules = jshd.profile_for(jcfg, stub).rules
    prules = shd.profile_for(pm.cfg, stub).rules
    assert dict(prules.rules) == dict(jrules.rules)
    jax_axes, port_axes = dict(_leaves(jm.cache_axes())), dict(_leaves(pm.cache_axes()))
    assert jax_axes == port_axes
    jab = dict(_leaves(jm.init_cache(32, 256, abstract=True)))
    pab = dict(_leaves(pm.init_cache(32, 256, device="meta")))
    assert jab.keys() == pab.keys() == jax_axes.keys()
    for path, axes in jax_axes.items():
        assert tuple(pab[path].shape) == tuple(jab[path].shape), path
        want = jrules.spec(axes, jab[path].shape, stub)
        got = prules.spec(axes, pab[path].shape, stub)
        assert tuple(got) == tuple(want), (path, got, want)


@pytest.mark.parametrize("zero3", [True, False])
@pytest.mark.parametrize("arch", ["qwen2_7b", "granite_34b", "zamba2_2p7b",
                                  "qwen3_moe_30b_a3b"])
def test_profiles_equal_reference(arch, zero3):
    stub = _stub("2x16x16")
    want = jshd.profile_for(jax_config(arch), stub, zero3=zero3)
    got = shd.profile_for(get_config(arch), stub, zero3=zero3)
    assert got.notes == want.notes and got.zero3 == want.zero3
    assert dict(got.rules.rules) == dict(want.rules.rules)
    assert dict(got.opt_rules.rules) == dict(want.opt_rules.rules)


def test_axis_rules_divisibility_fallback():
    """Twin of the reference's raw-spec test, and the fallback on a mesh."""
    from jax.sharding import PartitionSpec as JP
    rules = AxisRules()
    assert rules.spec(("batch", None, "heads")) == P(("pod", "data"), None, ("model",))
    assert tuple(rules.spec(("batch", None, "heads"))) == \
        tuple(JP(("pod", "data"), None, ("model",)))
    assert dict(rules.rules) == dict(JaxRules().rules) == DEFAULT_RULES
    stub = types.SimpleNamespace(shape={"data": 2, "model": 8})
    # qwen2's 28 heads do not divide 8: replicated; 4 kv heads do not either
    assert rules.spec(("fsdp", "heads", "head_dim"), (3584, 28, 128), stub) == P("data")
    assert rules.spec(("batch", "seq"), (3, 7), stub) == P()
    assert rules.shardable("heads", 32, stub) and not rules.shardable("heads", 28, stub)
    with pytest.raises(KeyError):
        rules.physical("nope")


@pytest.mark.parametrize("spec_axes,shape,want", [
    (("batch", "seq", "embed"), (8, 16, 64), (Shard(0), Shard(0), Replicate())),
    (("fsdp", "heads", "head_dim"), (64, 4, 16), (Replicate(), Shard(0), Shard(1))),
    (("heads", "head_dim", "fsdp"), (3, 16, 64), (Replicate(), Shard(2), Replicate())),
    (("vocab", "embed"), (128, 64), (Replicate(), Replicate(), Shard(0))),
])
def test_placements_follow_the_spec(spec_axes, shape, want):
    """One placement per mesh dim; "batch" on ("pod", "data") shards dim 0 on
    both, major to minor."""
    mesh = {"pod": 2, "data": 2, "model": 2}
    assert AxisRules().placements(spec_axes, shape, mesh) == want
    assert AxisRules().sharding(spec_axes, shape, mesh).placements == want
    with pytest.raises(ValueError, match="order"):
        AxisRules().placements(("batch",), (8,), {"data": 2, "pod": 2})


def test_shard_is_a_noop_without_a_mesh():
    x = torch.ones(2, 3)
    assert shard(x, "batch", "embed") is x and active_rules() is None
    with use_rules({"data": 1, "model": 1}):
        assert active_rules() is not None
        assert shard(x, "batch", "embed") is x      # a plain tensor stays plain
    assert active_rules() is None
    with use_rules(None):
        assert active_rules() is None


def test_module_shardings_drop_the_layer_dim():
    cfg = get_config("zamba2_2p7b").reduced()
    model = LM(cfg, device="meta")
    mesh = {"data": 2, "model": 2}
    prof = shd.profile_for(cfg, mesh, zero3=True)
    tree = shd.param_shardings(model, mesh, prof.rules)
    per_name = shd.module_shardings(model, tree)
    assert set(per_name) == {n for n, _ in model.named_parameters()}
    axes = dict(model.named_parameters())
    wq = per_name["shared.attn.wq"].placements       # (d, H, hd), not stacked
    assert wq == prof.rules.placements(("fsdp", "heads", "head_dim"),
                                       axes["shared.attn.wq"].shape, mesh)
    w_x = per_name["blocks.0.mamba.w_x"].placements   # stacked (c, d, e) -> (d, e)
    assert w_x == prof.rules.placements(("fsdp", "mlp"), axes["blocks.0.mamba.w_x"].shape,
                                        mesh)
    opt = shd.opt_state_shardings(model, mesh, prof.opt_rules)
    assert opt.step.placements == (Replicate(), Replicate())
    batch = shd.batch_shardings(mesh, {"tokens": torch.empty(8, 16),
                                       "vision_embed": torch.empty(8, 4, 64)}, prof.rules)
    assert batch["tokens"].placements == (Shard(0), Replicate())
    assert batch["vision_embed"].placements == (Shard(0), Replicate())


def test_pad_heads_exactness():
    """Padded q heads with zero wo rows leave the forward unchanged: the port's
    padded model against JAX's unpadded one, from JAX's weights."""
    jcfg = jax_config("qwen2_7b").reduced(n_layers=2, d_model=64, vocab=128, d_ff=128,
                                          n_heads=3, n_kv_heads=1, head_dim=16,
                                          dtype="float32")
    cfg = get_config("qwen2_7b").reduced(n_layers=2, d_model=64, vocab=128, d_ff=128,
                                         n_heads=3, n_kv_heads=1, head_dim=16,
                                         dtype="float32")
    stub = _stub("2x4")
    cfg_p = shd.pad_heads(cfg, stub)
    jcfg_p = jshd.pad_heads(jcfg, stub)
    assert (cfg_p.n_heads, cfg_p.hd, cfg_p.n_kv_heads) == \
        (jcfg_p.n_heads, jcfg_p.hd, jcfg_p.n_kv_heads) == (4, 16, 1)
    assert cfg_p == dataclasses.replace(cfg, n_heads=4, head_dim=16)
    assert shd.pad_heads(cfg_p, stub) is cfg_p
    jm = JaxLM(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    ref = np.asarray(jm.forward(params, jax.numpy.asarray(tokens)))
    rng = np.random.default_rng(99)
    padded = jax.tree.map(lambda a: a, params)
    attn = dict(params["pos0"]["attn"])
    wq = rng.standard_normal((*attn["wq"].shape[:2], 4, 16)).astype(np.float32)
    wq[..., :3, :] = attn["wq"]                       # junk in the extra head
    bq = np.zeros((*attn["bq"].shape[:1], 4, 16), np.float32)
    bq[:, :3] = attn["bq"]
    wo = np.zeros((attn["wo"].shape[0], 4, 16, 64), np.float32)
    wo[:, :3] = attn["wo"]                            # its output rows zero
    attn.update(wq=wq, bq=bq, wo=wo)
    padded["pos0"] = {**params["pos0"], "attn": attn}
    model = convert.load_jax_params(LM(cfg_p, device="cpu"), padded)
    plain = convert.load_jax_params(LM(cfg, device="cpu"), params)
    with torch.no_grad():
        out = model.forward(torch.from_numpy(tokens)).numpy()
        unpadded = plain.forward(torch.from_numpy(tokens)).numpy()
    # exactness as the reference's test holds it, within one framework
    np.testing.assert_allclose(out, unpadded, atol=2e-5, rtol=2e-5)
    # and the port's forward against JAX's, at the forward tests' tolerance
    np.testing.assert_allclose(unpadded, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("build", ["host", "mesh", "production"])
def test_mesh_builders_refuse_too_few_ranks(build):
    """No process group (or one too small) raises; nothing falls back to a
    smaller mesh."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs"):
        if build == "host":
            pmesh.make_host_mesh(device_type="cpu")
        elif build == "mesh":
            pmesh.make_mesh((4, 2), ("data", "model"), device_type="cpu")
        else:
            pmesh.make_production_mesh(multi_pod=True, device_type="cpu")
