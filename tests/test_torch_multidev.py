"""The port's sharded training on several CPU ranks (gloo), against the
single-device step and JAX's.

Every case starts its ranks as fresh interpreters joined by a
``torch.distributed`` process group over a localhost rendezvous, each under a
time limit (a hung rank fails the case and every rank is killed), and asserts
inside them; the pytest process itself never joins a group.  Covers: the
sharded qwen2 step on a ``(4, 2)`` ``("data", "model")`` mesh, ZeRO-3 on and off,
against the single-device step from the same JAX-made weights (which is held
against JAX's own step); the ``Trainer`` on a mesh for every family (zamba2 on a
``(4, 1)`` data mesh with ZeRO-3, the others on ``(2, 2)``); an S1 event whose
restore lands bit for bit on the rebuilt placements; and ``restore`` onto
shardings.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.parallel.trainstep import init_train_state as jax_init_state  # noqa: E402
from repro.parallel.trainstep import make_train_step as jax_train_step  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

# every case starts 2-8 interpreters that each import torch; excluded from the
# CI gate's fast subset as the reference's multi-device tests are
pytestmark = pytest.mark.slow

# ------------------------------------------------------------ the sharded step

TINY = dict(n_layers=2, d_model=64, vocab=128, d_ff=128, n_heads=4, n_kv_heads=2,
            head_dim=16, dtype="float32")
LR = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, np.float32)}


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """JAX's single-device step on the reference's multi-device test's model and
    a seeded batch: the weights before, the weights after and the loss, in an
    npz the ranks read."""
    cfg = jax_config("qwen2_7b").reduced(**TINY)
    model = JaxLM(cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)}
    state = jax_init_state(model, jax.random.PRNGKey(0))
    step = jax_train_step(model, JaxAdamWConfig(**LR))
    new, metrics = jax.jit(step)(state, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    path = tmp_path_factory.mktemp("jax_step") / "step.npz"
    np.savez(path, loss=float(metrics["loss"]), **batch,
             **{f"before/{k}": v for k, v in _flat(state["params"]).items()},
             **{f"after/{k}": v for k, v in _flat(new["params"]).items()})
    return path


@pytest.mark.parametrize("zero3", [True, False])
def test_sharded_train_step_matches_single_device(jax_step, zero3):
    """8 ranks, a (4, 2) mesh, three steps from the same weights over the same
    batches.  The sharded step's first change to each parameter is within 2e-3
    of the single-device step's in L2 norm, relative to that change (Adam's
    first change is about lr = 1e-3 an entry, so a missing update is off by 1
    and a sign-flipped one by 2; measured: 2.4e-4 at worst), and within 2e-3 an
    entry; every loss is within 1e-4 and the first gradient norm within 3e-5
    of it, relative.  The single-device step is held to JAX's: loss within
    1e-4, parameters within 2e-3."""
    run_ranks(f"""
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import convert
        from repro_torch.models.lm import LM
        from repro_torch.optim.adamw import AdamWConfig, init_opt_state
        from repro_torch.parallel import sharding as shd
        from repro_torch.parallel.axes import distribute, full
        from repro_torch.parallel.trainstep import make_train_step
        from torch.distributed.tensor import DTensor
        data = np.load({str(jax_step)!r})
        before = {{}}
        for key in data.files:
            if key.startswith("before/"):
                node = before
                *parents, last = key[len("before/"):].split(".")
                for k in parents:
                    node = node.setdefault(k, {{}})
                node[last] = data[key]
        cfg = get_config("qwen2_7b").reduced(**{TINY!r})
        opt = AdamWConfig(**{LR!r})
        rng = np.random.default_rng(1)
        batches = [{{k: torch.from_numpy(data[k]).long() for k in ("tokens", "labels")}}]
        batches += [{{k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32))).long()
                      for k in ("tokens", "labels")}} for _ in range(2)]

        def leaves(t, p=""):
            if isinstance(t, dict):
                out = {{}}
                for k, v in t.items():
                    out.update(leaves(v, f"{{p}}.{{k}}" if p else k))
                return out
            return {{p: np.array(t)}}

        m0 = convert.load_jax_params(LM(cfg, device="cpu"), before)
        params0 = dict(m0.named_parameters())
        s0 = {{"params": params0, "opt": init_opt_state(params0)}}
        step0 = make_train_step(m0, opt, remat="none")

        mesh = make_mesh((4, 2), ("data", "model"), device_type="cpu")
        m1 = convert.load_jax_params(LM(cfg, device="cpu"), before)
        prof = shd.profile_for(cfg, mesh, zero3={zero3})
        psh = shd.module_shardings(m1, shd.param_shardings(m1, mesh, prof.rules))
        osh = shd.module_shardings(m1, shd.opt_state_shardings(m1, mesh, prof.opt_rules).m)
        shd.distribute_params(m1, psh)
        params1 = dict(m1.named_parameters())
        s1 = {{"params": params1, "opt": init_opt_state(params1, osh)}}
        step1 = make_train_step(m1, opt, remat="none", mesh=mesh, rules=prof.rules)

        losses0, losses1 = [], []
        for i, batch in enumerate(batches):
            s0, met0 = step0(s0, batch)
            bsh = shd.batch_shardings(mesh, batch, prof.rules)
            s1, met1 = step1(s1, distribute(batch, bsh))
            losses0.append(float(met0["loss"]))
            losses1.append(float(met1["loss"]))
            if i == 0:
                # copies: the steps update the parameters in place
                one = leaves(convert.export_jax_tree(m0, s0["params"]))
                got = leaves(convert.export_jax_tree(m1, full(s1["params"])))
                gn0, gn1 = float(met0["grad_norm"]), float(met1["grad_norm"])

        # the state keeps its placements; ZeRO-3 shards wq over data, ZeRO-1
        # only its moments
        wq = s1["params"]["blocks.0.attn.wq"]
        mq = s1["opt"].m["blocks.0.attn.wq"]
        assert isinstance(wq, DTensor) and tuple(wq.placements) == psh["blocks.0.attn.wq"].placements
        assert tuple(mq.placements) == osh["blocks.0.attn.wq"].placements
        assert wq.placements[0].is_shard(0) == {zero3} and mq.placements[0].is_shard(0)

        jloss = float(data["loss"])
        assert abs(losses0[0] - jloss) < 1e-4, (losses0[0], jloss)
        assert np.allclose(losses1, losses0, atol=1e-4, rtol=0), (losses1, losses0)
        assert abs(gn1 - gn0) <= 3e-5 * gn0, (gn1, gn0)
        after = {{k[len("after/"):]: data[k] for k in data.files if k.startswith("after/")}}
        init = leaves(before)
        assert got.keys() == one.keys() == after.keys() == init.keys()
        for k in after:
            np.testing.assert_allclose(one[k], after[k], atol=2e-3, rtol=0, err_msg=k)
            d0, d1 = one[k] - init[k], got[k] - init[k]
            np.testing.assert_allclose(d1, d0, atol=2e-3, rtol=0, err_msg=k)
            assert np.abs(d0).max() > 5e-4, (k, np.abs(d0).max())
            # softmax ignores a shift shared by every key, so the key bias's
            # gradient is zero but for rounding, which Adam's first step scales
            # up to about lr: its change agrees less closely
            tol = 5e-2 if k.endswith(".bk") else 2e-3
            rel = float(np.linalg.norm(d1 - d0) / np.linalg.norm(d0))
            assert rel < tol, (k, rel)
    """, 8)


def test_global_norm_reduces_once_over_the_mesh():
    """4 ranks, a (2, 2) mesh: ``global_norm`` over DTensors in every kind of
    placement (replicated, sharded on either mesh dim or both, two mesh dims on
    one tensor dim, unevenly, a pending sum) equals the norm of their gathered
    values within 1e-6, relative, and issues one reduction over the mesh (an
    all-reduce per mesh dim) plus one all-reduce for the pending sum, and no
    other collective."""
    run_ranks("""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
        from torch.distributed.tensor.debug import CommDebugMode
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.optim.adamw import global_norm
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        g = torch.Generator().manual_seed(0)
        R, S0, S1 = Replicate(), Shard(0), Shard(1)
        layouts = [((6, 8), (R, R)), ((6, 8), (S0, R)), ((6, 8), (R, S1)),
                   ((6, 8), (S0, S1)), ((8, 3), (S0, S0)), ((5, 4), (S0, R)),
                   ((7,), (R, S0)), ((4, 4), (S1, R))]
        xs = [distribute_tensor(torch.randn(shape, generator=g), mesh, list(pl))
              for shape, pl in layouts]
        row = mesh.get_coordinate()[0]     # pending over "data", the same across "model"
        local = torch.randn((3, 5), generator=torch.Generator().manual_seed(row))
        xs.append(DTensor.from_local(local, mesh, [Partial(), R]))
        want = torch.sqrt(sum(torch.sum(x.full_tensor() ** 2) for x in xs))
        with CommDebugMode() as comm:
            got = global_norm(xs)
        counts = {str(k).rsplit(".", 1)[-1]: v for k, v in comm.get_comm_counts().items()}
        assert not isinstance(got, DTensor)
        assert abs(float(got) - float(want)) <= 1e-6 * float(want), (float(got), float(want))
        assert {k: v for k, v in counts.items() if v} == {"all_reduce": 3}, counts
    """, 4)


def test_decode_on_a_mesh_matches_one_device():
    """8 ranks, a (2, 4) mesh: reduced gemma-7b (4 query heads, 2 kv heads, so the
    reference's rules split the decode cache's length over "model") prefills 16
    tokens on one device; the next decode step runs on the mesh, its parameters,
    cache and batch placed under the reference's shardings, and gives the
    one-device step's logits within 1e-4 and its cache within 1e-5 (the new k and v
    are products summed over "data" shards in another order).  DTensor has no
    in-place indexed write into a cache split along its length; each rank writes the
    slot into its own shard where it holds it."""
    run_ranks("""
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.lm import LM
        from repro_torch.parallel import sharding as shd
        from repro_torch.parallel.axes import distribute, full, use_rules
        cfg = get_config("gemma_7b").reduced(dtype="float32")
        B, S, T = 4, 16, 24
        one = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).long()
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).long(),
                 "pos": torch.full((B,), S, dtype=torch.long)}
        with torch.no_grad():
            _, stacked = one.prefill(tokens)
            cache = one.serving_cache(stacked, S, T)
            copy = full(tuple({k: v.clone() for k, v in e.items()} for e in cache))
            want, want_cache = one.decode_step(cache, batch["tokens"], batch["pos"])
            mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
            prof = shd.profile_for(cfg, mesh, zero3=True)
            assert prof.rules.physical("kv_seq") == ("model",)
            model = LM(cfg, device="cpu")
            model.load_state_dict(one.state_dict())
            shd.distribute_params(model, shd.module_shardings(
                model, shd.param_shardings(model, mesh, prof.rules)))
            placed = distribute(copy, shd.cache_shardings(model, mesh, prof.rules, B, T))
            b = distribute(batch, shd.batch_shardings(mesh, batch, prof.rules))
            with use_rules(mesh, prof.rules), implicit_replication():
                got, got_cache = model.decode_step(placed, b["tokens"], b["pos"])
            got, got_cache = full(got), full(got_cache)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
        for g_e, w_e in zip(got_cache, want_cache):
            for k in w_e:
                np.testing.assert_allclose(g_e[k].numpy(), w_e[k].numpy(), atol=1e-5, rtol=0)
    """, 8)


def test_mamba_scan_runs_on_each_ranks_shard():
    """4 ranks, a (2, 2) mesh: the SSD scan on DTensors whose batch rows are split
    over "data" and heads over "model" (the reference's rules for zamba2), chunkwise
    over 256 steps from a zero state and sequentially over 64 from a given state,
    gives the one-device output and final state within 1e-5 and every input's
    gradient within 1e-4 or 1e-5 of its size (A's and D's are sums over every row
    and step, summed in another order), and none of its products runs as a DTensor op.  As
    DTensor ops the chunkwise products flatten a split batch dim with a split head
    dim, which torch 2.11's DTensor refuses (zamba2's Trainer on a one-card mesh
    raised there); each rank runs the scan on its own shard."""
    run_ranks("""
        from torch.distributed.tensor import DTensor, distribute_tensor
        from torch.distributed.tensor.experimental import implicit_replication
        from torch.overrides import TorchFunctionMode
        from torch.utils._pytree import tree_leaves
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.layers import _mamba_scan
        from repro_torch.parallel import sharding as shd
        from repro_torch.parallel.axes import full, use_rules

        class DTensorEinsums(TorchFunctionMode):
            def __init__(self):
                super().__init__()
                self.seen = []

            def __torch_function__(self, func, types, args=(), kwargs=None):
                if func is torch.einsum and any(isinstance(a, DTensor)
                                                for a in tree_leaves((args, kwargs))):
                    self.seen.append(args[0])
                return func(*args, **(kwargs or {}))

        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        rules = shd.profile_for(get_config("zamba2_2p7b").reduced(dtype="float32"),
                                mesh, zero3=True).rules
        B, nh, hd, N = 4, 4, 8, 16
        axes = [("batch", None, "heads", None), ("batch", None, None),
                ("batch", None, None), ("batch", None, "heads"), ("heads",), ("heads",),
                ("batch", "heads", None, None)]
        for S, with_state in ((256, False), (64, True)):
            rng = np.random.default_rng(S)
            shapes = [(B, S, nh, hd), (B, S, N), (B, S, N), (B, S, nh), (nh,), (nh,),
                      (B, nh, hd, N)]
            vals = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                    for sh in shapes]
            vals[3] = torch.nn.functional.softplus(vals[3])      # dt > 0
            if not with_state:
                vals, axes_ = vals[:6], axes[:6]
            else:
                axes_ = axes
            gy = torch.from_numpy(rng.standard_normal((B, S, nh, hd)).astype(np.float32))
            gh = torch.from_numpy(rng.standard_normal((B, nh, hd, N)).astype(np.float32))

            def run(ins):
                y, h = _mamba_scan(*ins[:6], hd, h0=ins[6] if len(ins) > 6 else None)
                ((y * gy).sum() + (h * gh).sum()).backward()
                return y, h

            one = [v.clone().requires_grad_() for v in vals]
            y0, h0 = run(one)
            placed = [distribute_tensor(v.clone(), mesh,
                                        rules.placements(a, v.shape, mesh)).requires_grad_()
                      for v, a in zip(vals, axes_)]
            gy = distribute_tensor(gy, mesh, rules.placements(axes[0], gy.shape, mesh))
            gh = distribute_tensor(gh, mesh, rules.placements(axes[6], gh.shape, mesh))
            with use_rules(mesh, rules), implicit_replication(), DTensorEinsums() as mode:
                y1, h1 = run(placed)
            assert mode.seen == [], mode.seen
            assert [p.is_shard() for p in y1.placements] == [True, True], y1.placements
            np.testing.assert_allclose(full(y1).detach().numpy(), y0.detach().numpy(),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(full(h1).detach().numpy(), h0.detach().numpy(),
                                       atol=1e-5, rtol=0)
            for i, (a, b) in enumerate(zip(placed, one)):
                np.testing.assert_allclose(full(a.grad).numpy(), b.grad.numpy(),
                                           atol=1e-4, rtol=1e-5, err_msg=f"input {i}")
    """, 4)


# ------------------------------------------------------------ the Trainer on a mesh

FAMILY_MESH = {a: ((4, 1) if a == "zamba2_2p7b" else (2, 2)) for a in ARCH_IDS}


# ZeRO-3 for every family; ZeRO-1 (parameters replicated over "data", moments
# sharded on it) for the dense family, the launcher's and a mixture of experts
ZERO1_ARCHS = ("qwen2_7b", "zamba2_2p7b", "qwen3_moe_30b_a3b")
# (arch, zero3, mesh shape, tokens a row, torch 2.11's view rule)
TRAINER_CASES = [pytest.param(a, True, FAMILY_MESH[a], 32, False, id=a) for a in ARCH_IDS] + \
    [pytest.param(a, False, FAMILY_MESH[a], 32, False, id=f"{a}-zero1")
     for a in ZERO1_ARCHS] + \
    [pytest.param("gemma_7b", True, (2, 4), 32, False, id="gemma_7b-2x4")] + \
    [pytest.param(a, True, (1, 1), 256, True, id=f"{a}-1x1-strict-views")
     for a in ("zamba2_2p7b", "xlstm_125m", "qwen3_moe_30b_a3b")]


@pytest.mark.parametrize("arch,zero3,shape,seq,strict", TRAINER_CASES)
def test_trainer_on_a_mesh_matches_one_device(arch, zero3, shape, seq, strict, tmp_path):
    """``Trainer(mesh=..., zero3=...)`` against the one-device ``Trainer`` from
    the same seed over the same batches: every step's loss within 1e-4; each
    parameter's change over the two steps within 2e-2 of the one-device
    change in L2 norm, relative to it (a missing update is off by 1; measured:
    5.0e-3 at worst, zamba2's embedding), and within 2e-3 an entry; the state
    in the profile's placements (under ZeRO-1 some moments placed otherwise
    than their parameters), and no parameter left unsharded where the rules
    shard it.  Reduced gemma on ``(2, 4)`` has 4 query heads and 2 kv heads on a
    model axis of 4: DTensor splits the kv projections' columns over "model",
    which the heads must be gathered from before they unflatten (forward and
    backward), as the reference's production cells with kv heads that do not
    divide the model axis need.  The ``strict-views`` cases run one rank's
    ``(1, 1)`` mesh, as a single card does, and 256 tokens, so zamba2's and xlstm's
    scans take their chunkwise forms, under torch 2.11's view rule
    (``torch_ranks.STRICT_VIEWS``): there the scans' products as DTensor ops and
    the MoE's expert outputs, whose row split lands on the capacity when the token
    groups do not divide it, flattened a split dim that was not the first of its
    group; the scans now run on each rank's shard, and those rows are gathered
    before they unflatten."""
    run_ranks(f"""
        import contextlib, io
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.parallel.axes import full
        from repro_torch.parallel.sharding import module_shardings
        from repro_torch.runtime.trainer import Trainer, TrainerConfig
        cfg = get_config({arch!r}).reduced(dtype="float32")
        tc = TrainerConfig(arch=cfg, steps=2, global_batch=4, seq_len={seq}, ckpt_every=0,
                           log_every=1, remat="none", device="cpu", zero3={zero3},
                           ckpt_dir={str(tmp_path)!r},
                           opt=AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10))
        mesh = make_mesh({shape!r}, ("data", "model"), device_type="cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            tr = Trainer(tc, mesh=mesh)
            s1, h1 = tr.run()
            if RANK == 0:                 # the one-device run, on one rank
                one = Trainer(tc)
                init = {{k: p.detach().clone() for k, p in one.init_state()["params"].items()}}
                s0, h0 = one.run()
        want = {{n: sh.placements for n, sh in
                 module_shardings(tr.model, tr.state_sh["params"]).items()}}
        want_m = {{n: sh.placements for n, sh in
                   module_shardings(tr.model, tr.state_sh["opt"].m).items()}}
        for k, p in s1["params"].items():
            assert isinstance(p, DTensor) and tuple(p.placements) == want[k], k
            assert tuple(s1["opt"].m[k].placements) == want_m[k], k
        assert any(pl.is_shard() for p in s1["params"].values() for pl in p.placements)
        # ZeRO-3 places the moments as the parameters; ZeRO-1 shards some of
        # them over "data" where their parameters are not
        moved = [k for k, p in s1["params"].items()
                 if tuple(s1["opt"].m[k].placements) != tuple(p.placements)]
        assert bool(moved) != {zero3}, moved
        f1 = full(s1["params"])          # a collective: every rank gathers
        if RANK == 0:
            l0, l1 = [h["loss"] for h in h0], [h["loss"] for h in h1]
            assert np.allclose(l0, l1, atol=1e-4, rtol=0), (l0, l1)
            for k in s1["params"]:
                d0 = s0["params"][k].detach() - init[k]
                d1 = f1[k] - init[k]
                err = (d1 - d0).abs().max().item()
                assert err < 2e-3, (k, err)
                rel = ((d1 - d0).norm() / d0.norm()).item()
                assert rel < 2e-2, (k, rel)
    """, shape[0] * shape[1], strict_views=strict)


# ------------------------------------------------------------ elastic restore


def test_s1_event_restores_bit_for_bit_on_a_mesh(tmp_path):
    """Two ranks, a (2, 1) mesh with ZeRO-3: at an S1 bandwidth event the Trainer
    checkpoints (rank 0 writes), re-plans, rebuilds and restores; the restored
    state equals the checkpointed one bit for bit and lies in the rebuilt
    placements."""
    run_ranks(f"""
        import contextlib, io
        from torch.distributed.tensor import DTensor
        import repro_torch.core as core
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.parallel import axes, sharding as shd
        from repro_torch.runtime.trainer import Trainer, TrainerConfig

        def snapshot(state):
            # gathered copies: a replicated DTensor's full value may be its
            # local tensor, which later steps update in place
            full = axes.full(state)
            return {{"params": {{k: t.clone() for k, t in full["params"].items()}},
                    "m": {{k: t.clone() for k, t in full["opt"].m.items()}},
                    "v": {{k: t.clone() for k, t in full["opt"].v.items()}},
                    "step": int(full["opt"].step)}}

        class Held(Trainer):
            def _handle_event(self, step, ev, state):
                self.before = snapshot(state)
                restored = super()._handle_event(step, ev, state)
                self.after, self.placed = snapshot(restored), restored
                return restored

        cfg = get_config("qwen2_7b").reduced(n_layers=2, d_model=64, vocab=128, d_ff=128,
                                             dtype="float32")
        tc = TrainerConfig(arch=cfg, steps=4, global_batch=4, seq_len=32, ckpt_every=0,
                           log_every=1, device="cpu", zero3=True, ckpt_dir={str(tmp_path)!r},
                           opt=AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10))
        topo = core.hetero_cluster({{"RTX4090D": 4, "V100": 4}}, gpus_per_node=4)
        events = [(2, core.NetworkEvent(0.0, "bandwidth", factor=0.3, selector="ib"))]
        mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            tr = Held(tc, mesh=mesh, topo=topo, events=events)
            _, hist = tr.run()
        assert tr.replans == 1 and len(hist) == 4 and tr.restores[0]["step"] == 2
        for field in ("params", "m", "v"):
            for k, t in tr.before[field].items():
                assert torch.equal(t, tr.after[field][k]), (field, k)
        assert tr.before["step"] == tr.after["step"] == 2
        want = shd.module_shardings(tr.model, tr.state_sh["params"])
        want_m = shd.module_shardings(tr.model, tr.state_sh["opt"].m)
        for k, p in tr.placed["params"].items():
            assert isinstance(p, DTensor) and tuple(p.placements) == want[k].placements, k
            assert tuple(tr.placed["opt"].m[k].placements) == want_m[k].placements, k
        assert tr.placed["params"]["embed.tok"] is tr.model.embed["tok"]
    """, 2)


def test_restore_onto_shardings(tmp_path):
    """Twin of the reference's: a saved tree restored under shardings is a tree
    of DTensors in those placements with the saved values."""
    run_ranks(f"""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.checkpoint.store import restore, save
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.optim.adamw import OptState
        from repro_torch.parallel.axes import NamedSharding
        mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
        st = {{"params": {{"w": np.arange(24, dtype=np.float32).reshape(4, 6)}},
               "opt": OptState(m={{"w": np.ones((4, 6), np.float32)}},
                               v={{"w": np.full((4, 6), 2, np.float32)}},
                               step=np.asarray(3, np.int32))}}
        if RANK == 0:
            save({str(tmp_path / "step_1")!r}, st, step=1)
        dist.barrier()
        like = {{"params": {{"w": torch.empty(4, 6)}},
                 "opt": OptState(m={{"w": torch.empty(4, 6)}}, v={{"w": torch.empty(4, 6)}},
                                 step=torch.empty((), dtype=torch.int32))}}
        rep, row = NamedSharding(mesh, (Replicate(), Replicate())), \\
            NamedSharding(mesh, (Shard(0), Replicate()))
        sh = {{"params": {{"w": rep}}, "opt": OptState(m={{"w": row}}, v={{"w": row}}, step=rep)}}
        got, manifest = restore({str(tmp_path / "step_1")!r}, like, shardings=sh)
        w, m = got["params"]["w"], got["opt"].m["w"]
        assert isinstance(w, DTensor) and tuple(w.placements) == rep.placements
        assert tuple(m.placements) == row.placements and m.to_local().shape == (2, 6)
        assert torch.equal(w.full_tensor(), torch.from_numpy(st["params"]["w"]))
        assert torch.equal(m.to_local(), torch.ones(2, 6))
        assert int(got["opt"].step.full_tensor()) == 3 and manifest["step"] == 1
    """, 2)
