"""The port's data pipeline, checkpoint store and trainer against the JAX
package's, on the CPU: identical batches, checkpoints that cross between the two
packages in both directions (bf16 leaves included), the trainer's runs and
checkpoints, and an 8-step trajectory from one JAX-made state."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.parallel.trainstep import init_train_state as jax_init_state  # noqa: E402
from repro.runtime.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.parallel.trainstep import init_train_state  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402


def _tiny(get=get_config, **over):
    kw = dict(n_layers=2, d_model=64, vocab=128, d_ff=128)
    return get("qwen2_7b").reduced(**{**kw, **over})


def _tcfg(tmp_path, steps=12, **over):
    kw = dict(arch=_tiny(), steps=steps, global_batch=4, seq_len=32,
              ckpt_dir=str(tmp_path), ckpt_every=5, log_every=100,
              opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20), device="cpu")
    return TrainerConfig(**{**kw, **over})


# ------------------------------------------------------------ data


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (1234, 3), (99, 1000)])
def test_synthetic_batches_match_reference(seed, step):
    kw = dict(vocab=1000, seq_len=33, global_batch=6, seed=seed)
    got = pipeline.SyntheticLM(pipeline.DataConfig(**kw)).batch(step)
    want = jpipe.SyntheticLM(jpipe.DataConfig(**kw)).batch(step)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("shares", [None, (0.5, 0.25, 0.25), (0.1, 0.6, 0.3)])
def test_synthetic_shards_match_reference(shares):
    kw = dict(vocab=500, seq_len=16, global_batch=10, seed=5, audio_seq=4, d_model=8)
    got = pipeline.SyntheticLM(pipeline.DataConfig(**kw))
    want = jpipe.SyntheticLM(jpipe.DataConfig(**kw))
    for rank in range(3):
        a, b = got.shard(2, rank, 3, shares), want.shard(2, rank, 3, shares)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------ checkpoints


def _jax_state(dtype: str, seed: int = 0):
    """A JAX train state with non-trivial moments and step."""
    jm = JaxLM(_tiny(jax_config, dtype=dtype))
    st = jax_init_state(jm, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    noise = lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)  # noqa: E731
    opt = jadamw.OptState(jax.tree.map(noise, st["params"]),
                          jax.tree.map(lambda p: jnp.abs(noise(p)), st["params"]),
                          jnp.asarray(7, jnp.int32))
    return {"params": st["params"], "opt": opt}


def _assert_same(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, tuple):
        for k in b._fields:
            _assert_same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    else:
        x = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
        np.testing.assert_array_equal(x, np.asarray(b, np.float32), err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, dtype):
    jst = _jax_state(dtype)
    jstore.save(tmp_path, jst, step=7)
    model = LM(_tiny(dtype=dtype), device="cpu")
    like = convert.jax_train_state_like(model)
    tree, manifest = store.restore(tmp_path, like)
    assert manifest["step"] == 7
    assert tree["params"]["pos0"]["attn"]["wq"].dtype == model.blocks[0].attn["wq"].dtype
    state = convert.load_jax_train_state(model, tree)
    assert all(state["params"][n] is p for n, p in model.named_parameters())
    assert model.embed["tok"].dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    _assert_same(convert.export_jax_train_state(model, state), jst)
    assert int(state["opt"].step) == 7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, dtype):
    model = LM(_tiny(dtype=dtype), device="cpu")
    state = convert.load_jax_train_state(model, jax.tree.map(np.asarray, _jax_state(dtype, 3)))
    store.save(tmp_path, convert.export_jax_train_state(model, state), step=11)
    like = _jax_state(dtype, seed=9)
    tree, manifest = jstore.restore(tmp_path, like)
    assert manifest["step"] == 11
    assert tree["params"]["embed"]["tok"].dtype == like["params"]["embed"]["tok"].dtype
    _assert_same(tree, jax.tree.map(np.asarray, _jax_state(dtype, 3)))


def test_keys_are_spelled_as_the_reference_writes_them(tmp_path):
    jstore.save(tmp_path / "jax", _jax_state("float32"), step=1)
    model = LM(_tiny(), device="cpu")
    store.save(tmp_path / "port",
               convert.export_jax_train_state(model, init_train_state(
                   model, torch.Generator().manual_seed(0))), step=1)
    keys = [set(np.load(tmp_path / d / "arrays.npz").files) for d in ("jax", "port")]
    assert keys[0] == keys[1]
    assert {"opt|.step", "opt|.m|embed|tok", "params|pos0|attn|wq"} <= keys[1]
    manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert manifest["keys"] == sorted(keys[1]) and manifest["step"] == 1


def test_restore_refuses_a_wrong_shape(tmp_path):
    model = LM(_tiny(), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    store.save(tmp_path, convert.export_jax_train_state(model, state), step=0)
    other = LM(_tiny(d_ff=64), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        store.restore(tmp_path, convert.jax_train_state_like(other))


def test_async_saver_copies_before_returning_and_reports_failures(tmp_path):
    saver = store.AsyncSaver()
    t = torch.ones(3)
    saver.submit(tmp_path / "a", {"x": t}, step=2)
    t.add_(1)   # the saved copy was taken at submit
    saver.wait()
    tree, _ = store.restore(tmp_path / "a", {"x": torch.empty(3)})
    assert torch.equal(tree["x"], torch.ones(3))
    (tmp_path / "file").write_text("")
    saver.submit(tmp_path / "file" / "b", {"x": t}, step=3)   # a file is in the way
    with pytest.raises(OSError):
        saver.wait()
    assert store.latest_step(tmp_path) is None      # "a" is not named step_*


# ------------------------------------------------------------ trainer


def test_trainer_runs_and_checkpoints(tmp_path):
    tr = Trainer(_tcfg(tmp_path))
    state, hist = tr.run()
    assert hist and np.isfinite(hist[-1]["loss"])
    assert store.latest_step(tmp_path) == 10
    assert tr.adaptations == [] and tr.engine is None
    assert set(hist[-1]) >= {"loss", "grad_norm", "lr", "tokens", "step", "wall"}
    tree, manifest = store.restore(tmp_path / "step_10",
                                   convert.jax_train_state_like(tr.model))
    assert manifest["step"] == 10 and int(tree["opt"].step) == 11


def test_trainer_resumes_from_its_checkpoint(tmp_path):
    """A run of 8 steps equals a run of 6, restored from its step-5 checkpoint
    (which holds the state after step 5) and resumed at step 6."""
    full = Trainer(dataclasses.replace(_tcfg(tmp_path / "a", steps=8), log_every=1))
    _, hist_full = full.run()
    part = Trainer(dataclasses.replace(_tcfg(tmp_path / "b", steps=6), log_every=1))
    part.run()
    resumed = Trainer(dataclasses.replace(_tcfg(tmp_path / "c", steps=8), log_every=1))
    tree, _ = store.restore(tmp_path / "b" / "step_5",
                            convert.jax_train_state_like(resumed.model))
    _, hist = resumed.run(convert.load_jax_train_state(resumed.model, tree), start_step=6)
    assert [h["step"] for h in hist] == [6, 7]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in hist_full[6:]], rtol=1e-6)


def test_trajectory_matches_the_reference_trainer(tmp_path):
    """8 steps from one JAX-made state over the same batches: per-step loss within
    1e-4 of the JAX Trainer's, float32.  At a peak lr of 1e-4: at 1e-3 the tiny
    model's trajectory is chaotic enough that JAX's own float32 run ends 5.6e-3
    away from its float64 run (3e-4: 1.9e-5; 1e-4: 1e-6), so no float32 run can
    be held to 1e-4 there."""
    jcfg = JaxTrainerConfig(arch=_tiny(jax_config), steps=8, global_batch=4, seq_len=32,
                            ckpt_dir=str(tmp_path / "jax"), ckpt_every=0, log_every=1,
                            opt=JaxAdamWConfig(peak_lr=1e-4, warmup_steps=2,
                                               total_steps=20))
    jtr = JaxTrainer(jcfg)
    jstate = jtr.init_state()
    start = jax.tree.map(np.asarray, jstate)
    _, jhist = jtr.run(jstate)
    tr = Trainer(_tcfg(tmp_path / "port", steps=8, ckpt_every=0, log_every=1,
                       opt=AdamWConfig(peak_lr=1e-4, warmup_steps=2, total_steps=20)))
    _, hist = tr.run(convert.load_jax_train_state(tr.model, start))
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == list(range(8))
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose([h["lr"] for h in hist], [h["lr"] for h in jhist], rtol=1e-6)


@pytest.mark.parametrize("arg", ["mesh", "zero3"])
def test_planner_arguments_raise(tmp_path, arg):
    """A mesh needs a process group of its size: without one the mesh builder
    raises (nothing falls back to one device).  Without a mesh ``zero3`` has
    nothing to shard and the one-device run is the same.  The sharded runs are
    held in test_torch_multidev.py; topo, events, scenario and plan in
    test_torch_dynamic.py."""
    if arg == "zero3":
        _, plain = Trainer(_tcfg(tmp_path / "a", steps=3, log_every=1)).run()
        _, zero3 = Trainer(_tcfg(tmp_path / "b", steps=3, log_every=1, zero3=True)).run()
        assert [h["loss"] for h in zero3] == [h["loss"] for h in plain]
        return
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(RuntimeError, match="needs 1 ranks, found 0"):
        Trainer(_tcfg(tmp_path), mesh=make_host_mesh(data=1, device_type="cpu"))
