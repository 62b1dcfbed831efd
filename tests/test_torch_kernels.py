"""Plain PyTorch versions of the kernels against the reference's Pallas
kernels (interpret mode on the CPU) and its jnp oracles, in float32: the two
forwards, the attention forward's lse, and the two backwards (against ``jax.vjp``
of the reference's kernel, whose custom VJP differentiates ``mha_reference``, and
``jax.grad`` of its RMSNorm oracle).

The CUDA kernels themselves are held against these plain versions on the card
by ``chip_smoke.py``; here a CPU tensor takes the plain version through the
same public wrappers.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    _flash_vjp_bwd as jax_flash_vjp_bwd  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rmsnorm_mod  # noqa: E402

CASES = [
    # (B, Sq, Skv, H, KV, hd, causal, window) -- tests/test_kernels.py
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 64, 256, 8, 8, 32, True, 0),
    (2, 128, 128, 4, 4, 64, True, 48),
    (1, 1, 128, 4, 2, 64, True, 0),
    (2, 96, 96, 6, 2, 32, False, 0),
    (1, 256, 256, 2, 1, 128, True, 0),
    (1, 32, 32, 4, 4, 16, True, 8),
]
# Across the CUDA wgmma kernel's 128-row q tile and 128-key kv tile edges.
TILE_EDGE_CASES = [
    (1, 129, 129, 4, 2, 128, True, 0),
    (2, 255, 383, 28, 4, 128, True, 0),
    (1, 300, 300, 4, 1, 64, True, 100),
    (2, 200, 200, 8, 8, 128, False, 0),
]
# Tile-edge shapes whose Sq and Skv are multiples of the Pallas test's 32-row
# block: the interpret-mode kernel halves its block until it divides S, so at a
# ragged S it would walk a grid of single rows.
PALLAS_TILE_CASES = [
    (1, 256, 256, 28, 4, 128, True, 0),
    (1, 128, 384, 4, 2, 128, False, 0),
]
# head_dim 256 (gemma-7b; the wgmma kernel's 64-key tiles): gemma's layout (H = KV),
# and a causal case across the 64-key tile, both at multiples of the Pallas test's
# 32-row block; then a ragged Sq < Skv case, for the plain reference alone.
HD256_PALLAS_CASES = [
    (2, 128, 128, 4, 4, 256, True, 0),
    (1, 160, 160, 2, 1, 256, True, 0),
]
HD256_RAGGED_CASES = [(1, 100, 170, 2, 2, 256, True, 0)]
# head_dim 80 (zamba2's shared attention: H = KV, causal, a sliding window; both wgmma
# kernels' 64- and 16-column boxes): causal, a window across the Pallas test's 32-key
# blocks, and a window with fewer queries than keys.
HD80_PALLAS_CASES = [
    (2, 128, 128, 4, 4, 80, True, 0),
    (1, 160, 160, 2, 2, 80, True, 48),
    (1, 64, 192, 4, 4, 80, True, 64),
]
# head_dim 80 at a ragged Sq < Skv with GQA and a window (the backward's ragged tiles;
# for the plain reference and the Pallas kernel's VJP rule alone)
HD80_RAGGED_CASES = [(1, 100, 170, 4, 2, 80, True, 48)]
# The reference's shapes, then the RMSNorm forward's kernel edges: 1024 (the widest
# row a lane group takes), 1032 (the narrowest the row pipeline takes), gemma's
# 3072 and granite's 6144, an odd row count, a width that is not a multiple of 8.
RMS_SHAPES = [(4, 37, 128), (1, 1, 256), (8, 512), (2, 3, 5, 64),
              (2, 1024), (3, 1032), (5, 3072), (3, 6144), (7, 128), (3, 100)]


def _qkv(case, seed, scale=1.0):
    B, Sq, Skv, H, KV, hd = case[:6]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Sq, H, hd)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, Skv, KV, hd)) * scale).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


PALLAS_CASES = CASES + PALLAS_TILE_CASES + HD256_PALLAS_CASES + HD80_PALLAS_CASES


@pytest.mark.parametrize("case", PALLAS_CASES, ids=[str(c) for c in PALLAS_CASES])
def test_mha_reference_matches_pallas_kernel(case):
    q, k, v = _qkv(case, 1)
    kw = dict(causal=case[6], window=case[7])
    got = ref.mha_reference(*_t(q, k, v), **kw).numpy()
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                block_q=32, block_kv=32, interpret=True, **kw))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


ORACLE_CASES = (CASES + TILE_EDGE_CASES + PALLAS_TILE_CASES + HD256_PALLAS_CASES
                + HD256_RAGGED_CASES + HD80_PALLAS_CASES + HD80_RAGGED_CASES)


@pytest.mark.parametrize("case", ORACLE_CASES, ids=[str(c) for c in ORACLE_CASES])
def test_mha_reference_matches_jnp_oracle(case):
    q, k, v = _qkv(case, 2)
    kw = dict(causal=case[6], window=case[7])
    got = ref.mha_reference(*_t(q, k, v), **kw).numpy()
    want = np.asarray(jref.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **kw))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_mha_reference_softcap():
    case = (1, 64, 64, 2, 2, 32, True, 0)
    q, k, v = _qkv(case, 3, scale=3.0)
    got = ref.mha_reference(*_t(q, k, v), causal=True, softcap=20.0).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(jax_flash(jq, jk, jv, causal=True, softcap=20.0,
                                  block_q=32, block_kv=32, interpret=True))
    oracle = np.asarray(jref.mha_reference(jq, jk, jv, causal=True,
                                           softcap=20.0))
    np.testing.assert_allclose(got, pallas, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, oracle, atol=1e-4, rtol=1e-4)


def test_mha_reference_bf16_close_to_f32():
    case = CASES[0]
    q, k, v = _t(*_qkv(case, 4))
    want = ref.mha_reference(q, k, v, causal=True)
    got = ref.mha_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                            causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_rmsnorm_reference_matches_pallas_kernel(shape):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1:]) * 0.1 + 1).astype(np.float32)
    got = ref.rmsnorm_reference(*_t(x, w)).numpy()
    pallas = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(w),
                                    interpret=True))
    oracle = np.asarray(jref.rmsnorm_reference(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=1e-5)


def test_rmsnorm_reference_keeps_dtype_and_eps():
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 64))
                         .astype(np.float32)).bfloat16()
    w = torch.ones(64)
    y = ref.rmsnorm_reference(x, w, eps=1e-2)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    xf = x.float()
    want = xf / torch.sqrt(xf.square().mean(-1, keepdim=True) + 1e-2)
    np.testing.assert_allclose(y.float().numpy(), want.numpy(), atol=2e-2)


def test_ops_on_cpu_take_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    q, k, v = _t(*_qkv(CASES[2], 7))
    got = ops.flash_attention(q, k, v, causal=True, window=48)
    assert torch.equal(got, ref.mha_reference(q, k, v, causal=True, window=48))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((5, 96))
                         .astype(np.float32))
    w = torch.full((96,), 1.5)
    assert torch.equal(ops.rmsnorm(x, w, eps=1e-5),
                       ref.rmsnorm_reference(x, w, 1e-5))
    q.requires_grad_()
    x.requires_grad_()
    (ops.flash_attention(q, k, v).sum() + ops.rmsnorm(x, w).sum()).backward()
    assert ops.launch_counts() == {"rmsnorm": 0, "rmsnorm_bwd": 0,
                                   "flash_attention": 0, "flash_attention_bwd": 0}
    assert ops.flash_launches_by_variant() == {"scalar": 0, "mma_sync": 0,
                                               "sm90_wgmma": 0}
    assert ops.flash_bwd_launches_by_variant() == {"scalar": 0, "mma_sync": 0,
                                                   "sm90_wgmma": 0}
    assert flash_mod.launches == 0 and rmsnorm_mod.launches == 0


def test_ops_stay_differentiable_on_cpu():
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(CASES[6], 9)))
    ops.flash_attention(q, k, v, causal=True, window=8).sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


class FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as lying on CUDA device ``index`` (the
    class attribute), so the wrappers' CUDA-path checks run here.  Only refusals
    are tested with it: an accepted call would go on to build the kernels."""

    index = 0

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", self.index)

    def get_device(self):
        return self.index


class FakeCuda1(FakeCuda):
    index = 1


def _cuda(*ts, cls=FakeCuda):
    return [t.as_subclass(cls) for t in ts]


def test_flash_attention_refuses_more_queries_than_keys():
    q, k, v = _t(*_qkv((1, 8, 4, 2, 2, 16), 10))
    with pytest.raises(ValueError, match="Sq"):
        ops.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="Sq"):
        ops.flash_attention(*_cuda(q, k, v), causal=True)


_FLASH_REFUSALS = {
    # name: (how to break (q, k, v) made at (2, 8, 8, 4, 2, 16) in bf16, error,
    #        what its message says)
    "heads": (lambda q, k, v: (q, k[:, :, :1].repeat(1, 1, 3, 1),
                               v[:, :, :1].repeat(1, 1, 3, 1)),
              ValueError, "do not fit"),
    "head_dim": (lambda q, k, v: (q, k[..., :8], v[..., :8]), ValueError, "do not fit"),
    "v_shape": (lambda q, k, v: (q, k, v[:, :4]), ValueError, "bad shapes"),
    "batch": (lambda q, k, v: (q, k[:1], v[:1]), ValueError, "do not fit"),
    "rank": (lambda q, k, v: (q[0], k, v), ValueError, "bad shapes"),
    "window": ("window", ValueError, "window"),
    "device": ("device", ValueError, "different devices"),
    # a call that needs gradients is checked as strictly as one that does not
    "grad": ("grad", TypeError, "unsupported dtypes"),
    "dtype": (lambda q, k, v: (q.half(), k, v), TypeError, "unsupported dtypes"),
    "float64": (lambda q, k, v: (q.double(), k.double(), v.double()), TypeError,
                "unsupported dtypes"),
    "head_dim_not_compiled": (lambda q, k, v: (q[..., :12], k[..., :12], v[..., :12]),
                              ValueError, "not compiled"),
    "head_dim_stride": (lambda q, k, v: (q, k.transpose(1, 3).contiguous().transpose(1, 3),
                                         v),
                        ValueError, "stride must be 1"),
    "row_alignment": (lambda q, k, v: (q, k, torch.zeros(2, 8, 2, 20, dtype=v.dtype)[..., :16]),
                      ValueError, "16-byte"),
    "base_alignment": (lambda q, k, v: (q, torch.zeros(k.numel() + 1, dtype=k.dtype)[1:]
                                        .view(k.shape), v),
                       ValueError, "16-byte"),
}


_FLASH_CPU_CHECKS = ("heads", "head_dim", "v_shape", "batch", "rank", "window")
_FLASH_CASES = ([(bad, "cpu") for bad in _FLASH_CPU_CHECKS]
                + [(bad, "cuda") for bad in sorted(_FLASH_REFUSALS)])


@pytest.mark.parametrize("bad,device", _FLASH_CASES,
                         ids=[f"{b}-{d}" for b, d in _FLASH_CASES])
def test_flash_attention_refuses_bad_shapes(bad, device):
    """Every check of the wrapper raises; on "cuda" (a CPU tensor posing as a
    CUDA one) the checks of the kernel path too, before any library is loaded."""
    q, k, v = (t.bfloat16() for t in _t(*_qkv((2, 8, 8, 4, 2, 16), 11)))
    breaker, error, says = _FLASH_REFUSALS[bad]
    kw = {}
    if bad == "window":
        kw["window"] = -1
    elif bad == "device":
        q, k, v = _cuda(q, cls=FakeCuda1) + [k, v]   # k, v stay on the CPU
    elif bad == "grad":
        q = q.half().requires_grad_()
    else:
        q, k, v = breaker(q, k, v)
    if device == "cuda" and bad != "device":
        q, k, v = _cuda(q, k, v)
    with pytest.raises(error, match=says):
        ops.flash_attention(q, k, v, **kw)
    assert flash_mod.launches == 0


_RMS_REFUSALS = {
    # name: (how to break x (2, 8) and w (8,), error, what its message says)
    "weight_len": (lambda x, w: (x, w[:4]), ValueError, "does not match"),
    "weight_rank": (lambda x, w: (x, w[None]), ValueError, "does not match"),
    "scalar_x": (lambda x, w: (x[0, 0], w[:0].sum()), ValueError, "does not match"),
    "device": ("device", ValueError, " on "),
    "other_card": ("other_card", ValueError, " on "),
    # a call that needs gradients is checked as strictly as one that does not
    "grad": ("grad", ValueError, "does not match"),
    "dtype": (lambda x, w: (x.long(), w), TypeError, "unsupported dtype"),
    "weight_dtype": (lambda x, w: (x.half(), w.bfloat16()), TypeError, "or float32"),
    "x_layout": (lambda x, w: (x.t().contiguous().t(), w), ValueError, "contiguous"),
    "w_layout": (lambda x, w: (x, torch.ones(16)[::2]), ValueError, "contiguous"),
}


_RMS_CASES = ([("weight_len", "cpu"), ("weight_rank", "cpu"), ("device", "cpu")]
              + [(bad, "cuda") for bad in sorted(_RMS_REFUSALS)])


@pytest.mark.parametrize("bad,device", _RMS_CASES, ids=[f"{b}-{d}" for b, d in _RMS_CASES])
def test_rmsnorm_refuses_mismatched_weight(bad, device):
    """Every check of the wrapper raises, on the CPU path and (a CPU tensor posing
    as a CUDA one) on the kernel path, before any library is loaded."""
    x, w = torch.zeros(2, 8), torch.ones(8)
    breaker, error, says = _RMS_REFUSALS[bad]
    if bad == "device":
        x, w = (_cuda(x)[0], w) if device == "cuda" else (x, _cuda(w)[0])
    elif bad == "other_card":
        x, w = _cuda(x)[0], _cuda(w, cls=FakeCuda1)[0]
    elif bad == "grad":
        x, w = _cuda(x.requires_grad_(), w[:4])
    else:
        x, w = breaker(x, w)
        if device == "cuda":
            x, w = _cuda(x, w)
    with pytest.raises(error, match=says):
        ops.rmsnorm(x, w)
    assert rmsnorm_mod.launches == 0 and rmsnorm_mod.bwd_launches == 0


_FLASH_BWD_REFUSALS = {
    # name: how to break (q, k, v, o, lse, do) of a (2, 8, 8, 4, 2, 16) bf16 call
    "do_shape": lambda q, k, v, o, lse, do: (q, k, v, o, lse, do[:, :4]),
    "o_shape": lambda q, k, v, o, lse, do: (q, k, v, o[:1], lse, do),
    "o_dtype": lambda q, k, v, o, lse, do: (q, k, v, o.half(), lse, do),
    "lse_dtype": lambda q, k, v, o, lse, do: (q, k, v, o, lse.double(), do),
    "lse_shape": lambda q, k, v, o, lse, do: (q, k, v, o, lse[:, :2], do),
    "lse_layout": lambda q, k, v, o, lse, do: (q, k, v, o,
                                               lse.transpose(1, 2).contiguous().transpose(1, 2),
                                               do),
    "lse_device": "lse_device",
}


@pytest.mark.parametrize("bad", sorted(_FLASH_BWD_REFUSALS))
def test_flash_attention_backward_refuses_bad_arguments(bad):
    """The backward's launcher checks what it is handed (CPU tensors posing as
    CUDA ones), before any library is loaded, and counts no launch."""
    q, k, v = (t.bfloat16() for t in _t(*_qkv((2, 8, 8, 4, 2, 16), 12)))
    o, do = torch.zeros_like(q), torch.ones_like(q)
    lse = torch.zeros(2, 4, 8)
    if bad == "lse_device":
        args = _cuda(q, k, v, o) + _cuda(lse, cls=FakeCuda1) + _cuda(do)
    else:
        args = _cuda(*_FLASH_BWD_REFUSALS[bad](q, k, v, o, lse, do))
    with pytest.raises(ValueError):
        flash_mod.launch_backward(*args, True, 0, 0.0)
    assert flash_mod.bwd_launches == 0


@pytest.mark.parametrize("bad", ["shape", "device"])
def test_rmsnorm_backward_refuses_bad_arguments(bad):
    x, w = _cuda(torch.zeros(3, 8), torch.ones(8))
    dy = _cuda(torch.zeros(3, 4))[0] if bad == "shape" else torch.zeros(3, 8)
    with pytest.raises(ValueError, match="dy"):
        rmsnorm_mod.launch_backward(x, w, dy, 1e-6, 0, 0, 0)
    assert rmsnorm_mod.bwd_launches == 0


# ------------------------------------------------------------- backwards

# Across the CUDA wgmma backward's tiles (128 keys; 64 query rows at head_dim 80 and
# 128, 128 at 64; at 256 64 keys and 64 rows), as chip_smoke.py holds them on the card:
# ragged GQA with Sq < Skv, a head_dim 64 window over two key tiles; head_dim 256 with
# GQA, Sq and Skv ragged against its 64-key tiles, and a window across two of them;
# head_dim 80 with GQA and Sq < Skv across two query tiles and three key tiles.
BWD_EDGE_CASES = [
    (2, 191, 321, 28, 4, 128, True, 0),
    (2, 260, 260, 8, 2, 64, True, 150),
    (2, 150, 201, 8, 2, 256, True, 0),
    (1, 260, 260, 4, 2, 256, True, 90),
    (2, 100, 300, 8, 4, 80, True, 0),
]
BWD_CASES = (CASES + [(1, 64, 64, 2, 2, 32, True, 0, 20.0), (1, 96, 128, 4, 2, 32, True, 0, 20.0)]
             + TILE_EDGE_CASES + BWD_EDGE_CASES + HD256_PALLAS_CASES + HD256_RAGGED_CASES
             + HD80_PALLAS_CASES + HD80_RAGGED_CASES)


def _case_kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8] if len(case) > 8 else 0.0)


def _jax_scores(q, k, causal, window, softcap):
    """The reference's masked, scaled (and capped) scores (B, H, Sq, Skv), jnp."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    kr = jnp.repeat(k, H // KV, axis=2)
    s = jnp.einsum("bqhd,bshd->bhqs", q, kr) / np.sqrt(hd)
    if softcap:
        s = jnp.tanh(s / softcap) * softcap
    qpos = jnp.arange(Sq)[:, None] + (Skv - Sq)
    kpos = jnp.arange(Skv)[None, :]
    mask = jnp.ones((Sq, Skv), bool)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return jnp.where(mask, s, -1e30)


@pytest.mark.parametrize("case", BWD_CASES, ids=[str(c) for c in BWD_CASES])
def test_lse_reference_matches_jax_logsumexp(case):
    scale = 3.0 if len(case) > 8 else 1.0
    q, k, _ = _qkv(case, 14, scale)
    kw = _case_kw(case)
    got = ref.flash_attention_lse_reference(*_t(q, k), **kw).numpy()
    want = np.asarray(jax.nn.logsumexp(_jax_scores(jnp.asarray(q), jnp.asarray(k), **kw),
                                       axis=-1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", BWD_CASES, ids=[str(c) for c in BWD_CASES])
def test_attention_backward_reference_matches_jax_vjp(case):
    """dq, dk and dv of the plain backward (from o and lse) against jax.vjp of the
    reference's Pallas kernel (interpret mode; at a ragged S its VJP rule
    ``_flash_vjp_bwd`` alone) and torch autograd of mha_reference; f32 <= 1e-5, 1e-4
    when capped."""
    capped = len(case) > 8
    scale, tol = (3.0, 1e-4) if capped else (1.0, 1e-5)
    q, k, v = _qkv(case, 15, scale)
    do = np.random.default_rng(16).standard_normal(q.shape).astype(np.float32)
    kw = _case_kw(case)
    tq, tk, tv = _t(q, k, v)
    o = ref.mha_reference(tq, tk, tv, **kw)
    lse = ref.flash_attention_lse_reference(tq, tk, **kw)
    got = ref.flash_attention_bwd_reference(tq, tk, tv, o, lse, torch.from_numpy(do), **kw)

    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    if case[1] % 32 == 0 and case[2] % 32 == 0:
        _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, block_q=32, block_kv=32,
                                                   interpret=True, **kw), jq, jk, jv)
        want_jax = vjp(jdo)
    else:
        # at a ragged S the interpret-mode forward would walk a grid of single rows;
        # the kernel's custom VJP rule, called on its own, gives the same gradients
        want_jax = jax_flash_vjp_bwd(kw["causal"], kw["window"], kw["softcap"], 32, 32, True,
                                     (jq, jk, jv), jdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    want_torch = torch.autograd.grad(ref.mha_reference(*leaves, **kw), leaves,
                                     torch.from_numpy(do))
    for name, g, wj, wt in zip(("dq", "dk", "dv"), got, want_jax, want_torch):
        assert g.shape == wt.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), atol=tol, rtol=tol, err_msg=name)
        np.testing.assert_allclose(g.numpy(), wt.numpy(), atol=tol, rtol=tol, err_msg=name)


def test_attention_function_on_cpu_is_the_plain_backward():
    case = CASES[2]
    q, k, v = _t(*_qkv(case, 17))
    do = torch.from_numpy(np.random.default_rng(18).standard_normal(q.shape)
                          .astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, causal=True, window=48),
                              leaves, do)
    o = ref.mha_reference(q, k, v, causal=True, window=48)
    lse = ref.flash_attention_lse_reference(q, k, causal=True, window=48)
    want = ref.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True, window=48)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_rmsnorm_backward_reference_matches_jax_grad(shape):
    rng = np.random.default_rng(19)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1:]) * 0.1 + 1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    dx, dw = ref.rmsnorm_bwd_reference(*_t(x, w, dy))
    _, vjp = jax.vjp(jref.rmsnorm_reference, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=1e-5, rtol=1e-5)
    xt, wt = (a.requires_grad_() for a in _t(x, w))
    gx, gw = torch.autograd.grad(ops.rmsnorm(xt, wt), (xt, wt), torch.from_numpy(dy))
    assert torch.equal(gx, dx) and torch.equal(gw, dw)


def test_rmsnorm_backward_reference_keeps_dtypes():
    x = torch.randn(3, 64, dtype=torch.bfloat16)
    dx, dw = ref.rmsnorm_bwd_reference(x, torch.ones(64), torch.ones(3, 64, dtype=torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32


# --------------------------------------------------------------- C interface

CSRC = Path(flash_mod.__file__).resolve().parent / "csrc"
_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


def _c_type(decl: str):
    """ctypes type of a C declaration's type part (pointers: c_void_p)."""
    decl = decl.replace("const ", "").strip()
    if decl.endswith("*"):
        return ctypes.c_char_p if decl == "char*" else ctypes.c_void_p
    return _C_TYPES[decl]


def _extern_c_functions() -> dict:
    """name -> (restype, [argtypes]) of every ``extern "C"`` function in csrc/."""
    found = {}
    pat = re.compile(r'extern "C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)
    for src in sorted(CSRC.glob("*.cu")):
        for ret, name, params in pat.findall(src.read_text()):
            args = [re.sub(r"\w+$", "", " ".join(p.split())).replace(" *", "*")
                    for p in params.split(",") if p.strip()]
            found[name] = (_c_type(ret.replace(" *", "*")), [_c_type(a) for a in args])
    return found


def test_ctypes_bindings_match_the_c_declarations():
    """The argtypes/restype that ``_build.load()`` binds are those of the
    ``extern "C"`` declarations (a mismatch cuts a pointer or shifts every
    argument on the card); read from the sources, no library is loaded."""
    declared = _extern_c_functions()
    assert set(declared) == set(_build.SIGNATURES)
    for name, (restype, argtypes) in _build.SIGNATURES.items():
        assert declared[name] == (restype, list(argtypes)), name


def _c_struct_fields(source: str, struct: str) -> list:
    body = re.search(r"struct " + struct + r" \{([^}]*)\};",
                     (CSRC / source).read_text()).group(1)
    fields = [re.match(r"(.+?)\s*(\w+)$", " ".join(line.split(";")[0].split())).groups()
              for line in body.strip().splitlines() if ";" in line]
    return [(name, _c_type(typ.replace(" *", "*"))) for typ, name in fields]


def test_rmsnorm_argument_block_matches_the_c_struct():
    assert _c_struct_fields("rmsnorm.cu", "RmsnormCall") == list(_build.RmsnormCall._fields_)


@pytest.mark.parametrize("source,struct", [("rmsnorm_bwd.cu", "RmsnormBwdCall"),
                                           ("flash_attention_bwd.cu", "FlashBwdCall")])
def test_backward_argument_blocks_match_the_c_structs(source, struct):
    assert _c_struct_fields(source, struct) == list(getattr(_build, struct)._fields_)


def test_backward_scratch_padding_matches_the_c_header():
    """The wrapper pads the wgmma backward's per-row scratch as the kernels index it."""
    pad = re.search(r"constexpr int kSqPad = (\d+);", (CSRC / "flash_attention.cuh").read_text())
    assert pad and int(pad.group(1)) == flash_mod.BWD_SQ_PAD


def test_backward_dq_pass_head_dim_matches_the_c_header():
    """The wrapper leaves out the dq accumulator at the head_dim where the wgmma
    backward writes dq in a pass of its own, and only there (the kernel then never
    touches it)."""
    header = (CSRC / "flash_attention.cuh").read_text()
    hd = re.search(r"constexpr int kDqPassHeadDim = (\d+);", header)
    assert hd and int(hd.group(1)) == flash_mod.BWD_DQ_PASS_HEAD_DIM
    assert flash_mod.BWD_DQ_PASS_HEAD_DIM in _c_int_list("flash_attention.cuh", "kSm90BwdHeadDims")
    assert "static constexpr bool kWide = HD == kDqPassHeadDim;" in \
        (CSRC / "flash_attention_bwd_sm90.cu").read_text()


@pytest.mark.parametrize("hd", (64, 80, 128, 256))
@pytest.mark.parametrize("kind", flash_mod.VARIANTS)
def test_backward_scratch_shapes(kind, hd):
    """delta and dq_acc as ``flash::BwdParams`` states them: (B, H, Sq) and none for
    the scalar and mma.sync kernels; D and lse * log2(e) over a padded Sq, and a
    (B, H, padded Sq, hd) accumulator, for the wgmma kernel, at each head_dim it takes
    (at 80 a 64 x 64 and a 64 x 16 block for each 64 rows: 64 * 80 floats), but none
    at 256, whose dq pass writes dq itself."""
    q = torch.zeros(2, 191, 28, hd, dtype=torch.bfloat16)
    delta, dq_acc = flash_mod._bwd_scratch(kind, q)
    assert delta.dtype == torch.float32 and delta.is_contiguous()
    if kind == "sm90_wgmma":
        assert tuple(delta.shape) == (2, 2, 28, 256)
        if hd == 256:
            assert dq_acc is None
        else:
            assert tuple(dq_acc.shape) == (2, 28, 256, hd) and dq_acc.dtype == torch.float32
    else:
        assert tuple(delta.shape) == (2, 28, 191) and dq_acc is None


def _c_int_list(source: str, name: str) -> list:
    """The values of ``constexpr int name[] = {...};`` in a csrc file."""
    body = re.search(r"constexpr int " + name + r"\[\] = \{([^}]*)\};",
                     (CSRC / source).read_text()).group(1)
    return [int(v) for v in body.split(",")]


def _compiled_head_dims(source: str, function: str, pattern: str) -> set:
    """Head_dims that ``function`` of a csrc file dispatches to a kernel."""
    text = (CSRC / source).read_text()
    body = re.search(function + r"\(.*?\n\}", text, re.S).group(0)
    return {int(hd) for hd in re.findall(pattern, body)}


def test_dispatch_rule_routes_16bit_head_dim_256_forward_to_wgmma():
    """``flash::variant_for`` in ``flash_attention.cuh``, read from the source: 16-bit
    head_dim 256 takes the TMA + wgmma kernel (kSm90Wgmma) forward and backward, and
    so does 16-bit head_dim 80; 16-bit head_dim 16 and 32 the mma.sync kernels; fp32
    the scalar kernels both ways; every head_dim the rule sends to a kernel is
    compiled into that kernel's dispatch, forward and backward (so the mma.sync
    backward has no instance at 80 or 256), and no head_dim 80 call is refused; no
    library is loaded."""
    header = (CSRC / "flash_attention.cuh").read_text()
    enum = dict((name, int(code)) for name, code in
                re.findall(r"(k\w+) = (\d+)", re.search(r"enum Variant \{([^}]*)\}",
                                                        header).group(1)))
    assert [flash_mod.VARIANTS[enum[k]] for k in ("kScalar", "kMmaSync", "kSm90Wgmma")] == \
        ["scalar", "mma_sync", "sm90_wgmma"]
    body = re.search(r"inline int variant_for\(int hd, int dtype, bool backward\) \{(.*?)\n\}",
                     header, re.S).group(1)
    assert ("if (!(backward ? one_of(kBwdHeadDims, hd) : one_of(kHeadDims, hd))) return -1;"
            in body)
    assert "if (dtype == 0) return kScalar;" in body
    assert ("backward ? one_of(kSm90BwdHeadDims, hd) : one_of(kSm90HeadDims, hd)" in body
            and "return wgmma ? kSm90Wgmma : kMmaSync;" in body)
    head_dims = {False: _c_int_list("flash_attention.cuh", "kHeadDims"),
                 True: _c_int_list("flash_attention.cuh", "kBwdHeadDims")}
    wgmma = {False: set(_c_int_list("flash_attention.cuh", "kSm90HeadDims")),
             True: set(_c_int_list("flash_attention.cuh", "kSm90BwdHeadDims"))}
    assert tuple(head_dims[False]) == flash_mod.HEAD_DIMS
    assert tuple(head_dims[True]) == flash_mod.BWD_HEAD_DIMS

    def rule(hd, dtype, backward):   # the C rule, as parsed above
        if hd not in head_dims[backward]:
            return -1
        if dtype == 0:
            return enum["kScalar"]
        return enum["kSm90Wgmma"] if hd in wgmma[backward] else enum["kMmaSync"]

    for dtype in (1, 2):   # bfloat16, float16
        assert flash_mod.VARIANTS[rule(256, dtype, False)] == "sm90_wgmma"
        assert flash_mod.VARIANTS[rule(256, dtype, True)] == "sm90_wgmma"
        assert flash_mod.VARIANTS[rule(128, dtype, True)] == "sm90_wgmma"
        assert flash_mod.VARIANTS[rule(80, dtype, False)] == "sm90_wgmma"
        assert flash_mod.VARIANTS[rule(80, dtype, True)] == "sm90_wgmma"
        for hd_ in (16, 32):
            assert all(flash_mod.VARIANTS[rule(hd_, dtype, backward)] == "mma_sync"
                       for backward in (False, True))
    for backward in (False, True):
        assert flash_mod.VARIANTS[rule(256, 0, backward)] == "scalar"
        assert flash_mod.VARIANTS[rule(80, 0, backward)] == "scalar"
    assert all(rule(80, dtype, backward) != -1 for dtype in (0, 1, 2)
               for backward in (False, True))
    assert all(rule(96, dtype, backward) == -1 for dtype in (0, 1, 2)
               for backward in (False, True))
    # the C entries ask for the forward's and the backward's rule
    assert "flash::variant_for(hd, dtype, false)" in (CSRC / "flash_attention.cu").read_text()
    assert "flash::variant_for(c->hd, c->dtype, true)" in \
        (CSRC / "flash_attention_bwd.cu").read_text()
    compiled = {
        (False, "sm90_wgmma"): _compiled_head_dims(
            "flash_attention_sm90.cu", "int launch_sm90",
            r"if \(hd == (\d+)\) return launch<__nv_bfloat16, \1>"),
        (False, "mma_sync"): _compiled_head_dims(
            "flash_attention.cu", "int dispatch_mma",
            r"case (\d+): return \(int\)launch_mma<T, \1,"),
        (True, "sm90_wgmma"): _compiled_head_dims(
            "flash_attention_bwd_sm90.cu", "int launch_bwd_sm90",
            r"if \(hd == (\d+)\) return launch<__nv_bfloat16, \1>"),
        (True, "mma_sync"): _compiled_head_dims(
            "flash_attention_bwd.cu", "int dispatch_mma",
            r"case (\d+): return launch_mma<T, \1>"),
    }
    compiled[(False, "scalar")] = _compiled_head_dims(
        "flash_attention.cu", "int dispatch_scalar", r"case (\d+): return \(int\)launch_scalar<\1>")
    compiled[(True, "scalar")] = _compiled_head_dims(
        "flash_attention_bwd.cu", "int dispatch_scalar", r"case (\d+): return launch_scalar<\1>")
    for backward in (False, True):
        for kind, dtype in (("sm90_wgmma", 1), ("mma_sync", 1), ("scalar", 0)):
            routed = {hd for hd in head_dims[backward]
                      if flash_mod.VARIANTS[rule(hd, dtype, backward)] == kind}
            assert routed == compiled[(backward, kind)], (backward, kind)
