"""Plain PyTorch versions of the two kernels against the reference's Pallas
kernels (interpret mode on the CPU) and its jnp oracles, in float32.

The CUDA kernels themselves are held against these plain versions on the card
by ``chip_smoke.py``; here a CPU tensor takes the plain version through the
same public wrappers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
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
RMS_SHAPES = [(4, 37, 128), (1, 1, 256), (8, 512), (2, 3, 5, 64)]


def _qkv(case, seed, scale=1.0):
    B, Sq, Skv, H, KV, hd = case[:6]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Sq, H, hd)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, Skv, KV, hd)) * scale).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_mha_reference_matches_pallas_kernel(case):
    q, k, v = _qkv(case, 1)
    kw = dict(causal=case[6], window=case[7])
    got = ref.mha_reference(*_t(q, k, v), **kw).numpy()
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                block_q=32, block_kv=32, interpret=True, **kw))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
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
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0}
    assert flash_mod.launches == 0 and rmsnorm_mod.launches == 0


def test_ops_stay_differentiable_on_cpu():
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(CASES[6], 9)))
    ops.flash_attention(q, k, v, causal=True, window=8).sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


def test_flash_attention_refuses_more_queries_than_keys():
    q, k, v = _t(*_qkv((1, 8, 4, 2, 2, 16), 10))
    with pytest.raises(ValueError, match="Sq"):
        ops.flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("bad", ["heads", "head_dim", "v_shape", "batch"])
def test_flash_attention_refuses_bad_shapes(bad):
    q, k, v = _t(*_qkv((2, 8, 8, 4, 2, 16), 11))
    if bad == "heads":
        k, v = k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)
    elif bad == "head_dim":
        k = k[..., :8]
        v = v[..., :8]
    elif bad == "v_shape":
        v = v[:, :4]
    else:
        k, v = k[:1], v[:1]
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)


def test_rmsnorm_refuses_mismatched_weight():
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.zeros(2, 8), torch.ones(4))
