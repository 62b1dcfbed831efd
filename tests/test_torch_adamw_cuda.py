"""The fused AdamW kernels (``kernels/adamw.py``, ``csrc/adamw.cu``) against the
plain update (``optim.adamw.plain_update``) on the card.

Marked ``cuda``: without an NVIDIA card every test here skips.  On a machine with
one (and ``nvcc``, which builds the kernels at first use):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_adamw_cuda.py

Limits: the norm within 1e-6 relative; m within 1e-6 of the magnitudes it is summed
from (|b1 m| + |(1-b1) g|, since the two may cancel), v within 1e-6 relative; a
16-bit p equal but in at most 1e-4 of its entries, and those one ulp apart, a
float32 p within 1e-6 of |p| + |its step|; two calls the same bit for bit.  No JAX.
"""

from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adamw as adamw_mod  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.optim import adamw as optim_adamw  # noqa: E402

pytestmark = pytest.mark.cuda

#: leaf lengths: under a 16-byte pack, ragged, across a 32768-entry chunk, a few M
LENGTHS = (1, 7, 4095, 65537, 3_000_001)
#: one more leaf whose p and g start one entry into their buffers (not 16-byte aligned)
MISALIGNED = 70001
CFG = optim_adamw.AdamWConfig()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


def _state(card, pdtype, gdtype, grad_scale: float, step: int, seed: int,
           lengths=LENGTHS, misaligned: int = MISALIGNED):
    """(params, grads, OptState) of leaves of ``lengths``, and one misaligned leaf,
    drawn from ``seed`` on the card; the moments as mid-run ones."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def randn(n, scale=1.0):
        return torch.randn(n, generator=gen, device=card) * scale

    params, grads, m, v = {}, {}, {}, {}
    for i, n in enumerate(lengths):
        params[f"leaf{i}"] = randn(n).to(pdtype)
        grads[f"leaf{i}"] = randn(n, grad_scale).to(gdtype)
    if misaligned:
        params["misaligned"] = randn(misaligned + 1).to(pdtype)[1:]
        grads["misaligned"] = randn(misaligned + 1, grad_scale).to(gdtype)[1:]
    for name, p in params.items():
        m[name] = randn(p.numel(), 1e-2 * grad_scale)
        v[name] = randn(p.numel(), grad_scale).square()
    return params, grads, optim_adamw.OptState(
        m, v, torch.tensor(step - 1, dtype=torch.int32, device=card))


def _clone(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` as far from a 16-byte boundary as ``t`` (a misaligned leaf
    stays misaligned)."""
    off = t.data_ptr() % 16 // t.element_size()
    return torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)[off:].copy_(t)


def _copy(params, grads, state):
    clone = lambda tree: {n: _clone(t) for n, t in tree.items()}  # noqa: E731
    return clone(params), grads, optim_adamw.OptState(clone(state.m), clone(state.v),
                                                      state.step.clone())


def _plain(params, grads, state, cfg=CFG):
    """The plain update on copies: (params, moments, norm, learning rate, step)."""
    p, g, s = _copy(params, grads, state)
    return (p, s, *optim_adamw.plain_update(p, g, s, cfg))


def _kernels(params, grads) -> int:
    """The kernels a fused step launches: a sum of squares and an update for each table
    of at most ``MAX_LEAVES`` leaves of one (parameter, gradient) dtype pair, and the
    clip."""
    pairs = Counter((p.dtype, grads[n].dtype) for n, p in params.items())
    return 1 + 2 * sum(-(-k // adamw_mod.MAX_LEAVES) for k in pairs.values())


def _fused(params, grads, state, cfg=CFG):
    """The fused update through ``adamw_update`` on copies: (params, moments, norm,
    learning rate, step, leaves counted fused)."""
    p, g, s = _copy(params, grads, state)
    obs = Obs()
    before = adamw_mod.launches
    p, s, metrics = optim_adamw.adamw_update(p, g, s, cfg, obs=obs)
    assert adamw_mod.launches == before + _kernels(params, grads)
    return (p, s, metrics["grad_norm"], metrics["lr"], s.step,
            obs.metrics.counter_value("optim.adamw.fused_leaves"))


def _check(params, grads, state, got, want, tag: str, cfg=CFG) -> None:
    (gp, gs, gnorm, glr, gstep), (wp, ws, wnorm, wlr, wstep) = got, want
    torch.testing.assert_close(gnorm, wnorm, rtol=1e-6, atol=0, msg=f"{tag}: norm")
    torch.testing.assert_close(glr, wlr, rtol=1e-6, atol=0, msg=f"{tag}: learning rate")
    assert gstep.dtype == torch.int32 and int(gstep) == int(wstep) == int(state.step) + 1
    scale = torch.clamp(cfg.clip_norm / torch.clamp(wnorm, min=1e-12), max=1.0)
    for name, p0 in params.items():
        g = grads[name].float() * scale
        terms = cfg.b1 * state.m[name].abs() + (1 - cfg.b1) * g.abs()
        m_err = (gs.m[name] - ws.m[name]).abs()
        assert bool((m_err <= 1e-6 * terms).all()), \
            f"{tag} {name}: m off by {float((m_err / terms).max()):.3g} of its terms"
        torch.testing.assert_close(gs.v[name], ws.v[name], rtol=1e-6, atol=0,
                                   msg=f"{tag} {name}: v")
        a, b = gp[name].float(), wp[name].float()
        if p0.dtype == torch.float32:
            bound = 1e-6 * (p0.abs() + (b - p0).abs())
            assert bool(((a - b).abs() <= bound).all()), f"{tag} {name}: p"
            continue
        differ = a != b
        ulp = torch.finfo(p0.dtype).eps * b.abs().clamp(min=torch.finfo(p0.dtype).tiny)
        assert int(differ.sum()) <= 1e-4 * p0.numel(), \
            f"{tag} {name}: p differs in {int(differ.sum())} of {p0.numel()} entries"
        assert bool(((a - b).abs()[differ] <= ulp[differ]).all()), \
            f"{tag} {name}: p more than one ulp apart"


@pytest.mark.parametrize("step", [1, 150])
@pytest.mark.parametrize("clip", ["under_1", "at_1"])
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("pdtype", [torch.bfloat16, torch.float16, torch.float32], ids=str)
def test_fused_adamw_matches_the_plain_update(card, pdtype, gdtype, clip, step):
    """Every leaf length, a misaligned leaf, each parameter and gradient type, a clip
    scale under 1 (gradients of norm ~1800) and at 1 (~2e-3), warm-up and cosine."""
    grad_scale = 1.0 if clip == "under_1" else 1e-6
    params, grads, state = _state(card, pdtype, gdtype, grad_scale, step, seed=step)
    *got, fused_leaves = _fused(params, grads, state)
    want = _plain(params, grads, state)
    assert fused_leaves == len(params)
    assert (float(want[2]) > CFG.clip_norm) == (clip == "under_1")
    _check(params, grads, state, got, want, f"{pdtype}/{gdtype} {clip} step {step}")


@pytest.mark.parametrize("step", [1, 3])
def test_fused_adamw_at_its_peak_rate_from_the_first_step(card, step):
    """The benchmark's schedule: no warm-up, a clip at 1, the rate falling from its
    peak from step 1 (``perfbench/harness/reference.py``'s ``AdamW``)."""
    cfg = optim_adamw.AdamWConfig(warmup_steps=0)
    params, grads, state = _state(card, torch.bfloat16, torch.bfloat16, 1.0, step, seed=7)
    *got, _ = _fused(params, grads, state, cfg)
    want = _plain(params, grads, state, cfg)
    _check(params, grads, state, got, want, f"no warm-up, step {step}", cfg)


def test_fused_adamw_is_the_same_bit_for_bit(card):
    params, grads, state = _state(card, torch.bfloat16, torch.bfloat16, 1.0, 150, seed=3)
    first, second = _fused(params, grads, state), _fused(params, grads, state)
    assert torch.equal(first[2], second[2]) and torch.equal(first[3], second[3])
    for name in params:
        assert torch.equal(first[0][name], second[0][name])
        assert torch.equal(first[1].m[name], second[1].m[name])
        assert torch.equal(first[1].v[name], second[1].v[name])


def test_fused_adamw_over_many_leaves_of_mixed_types(card):
    """More leaves than one launch's table takes (80), in two (parameter, gradient)
    type pairs of one step: each pair its own tables, one norm over all."""
    gen = torch.Generator().manual_seed(4)
    lengths = [int(n) for n in torch.randint(1, 5000, (170,), generator=gen)]
    bf16 = _state(card, torch.bfloat16, torch.bfloat16, 1.0, 150, 5, lengths[:90], 0)
    fp32 = _state(card, torch.float32, torch.float32, 1.0, 150, 6, lengths[90:], 0)
    params = {**{f"b{n}": t for n, t in bf16[0].items()},
              **{f"f{n}": t for n, t in fp32[0].items()}}
    grads = {**{f"b{n}": t for n, t in bf16[1].items()},
             **{f"f{n}": t for n, t in fp32[1].items()}}
    state = optim_adamw.OptState(
        {**{f"b{n}": t for n, t in bf16[2].m.items()}, **{f"f{n}": t for n, t in fp32[2].m.items()}},
        {**{f"b{n}": t for n, t in bf16[2].v.items()}, **{f"f{n}": t for n, t in fp32[2].v.items()}},
        bf16[2].step)
    *got, fused_leaves = _fused(params, grads, state)
    assert fused_leaves == 170
    _check(params, grads, state, got, _plain(params, grads, state), "mixed")
