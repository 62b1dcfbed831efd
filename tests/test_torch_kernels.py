"""Plain PyTorch versions of the two kernels against the reference's Pallas
kernels (interpret mode on the CPU) and its jnp oracles, in float32.

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

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
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


@pytest.mark.parametrize("case", CASES + PALLAS_TILE_CASES,
                         ids=[str(c) for c in CASES + PALLAS_TILE_CASES])
def test_mha_reference_matches_pallas_kernel(case):
    q, k, v = _qkv(case, 1)
    kw = dict(causal=case[6], window=case[7])
    got = ref.mha_reference(*_t(q, k, v), **kw).numpy()
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                block_q=32, block_kv=32, interpret=True, **kw))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


ORACLE_CASES = CASES + TILE_EDGE_CASES + PALLAS_TILE_CASES


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
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0}
    assert ops.flash_launches_by_variant() == {"scalar": 0, "mma_sync": 0,
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
    "grad": ("grad", RuntimeError, "forward-only"),
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
        q = q.requires_grad_()
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
    "grad": ("grad", RuntimeError, "forward-only"),
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
        x, w = _cuda(x, w.requires_grad_())
    else:
        x, w = breaker(x, w)
        if device == "cuda":
            x, w = _cuda(x, w)
    with pytest.raises(error, match=says):
        ops.rmsnorm(x, w)
    assert rmsnorm_mod.launches == 0


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


def test_rmsnorm_argument_block_matches_the_c_struct():
    body = re.search(r"struct RmsnormCall \{([^}]*)\};",
                     (CSRC / "rmsnorm.cu").read_text()).group(1)
    fields = [re.match(r"(.+?)\s*(\w+)$", " ".join(line.split(";")[0].split())).groups()
              for line in body.strip().splitlines() if ";" in line]
    c_fields = [(name, _c_type(typ.replace(" *", "*"))) for typ, name in fields]
    assert c_fields == list(_build.RmsnormCall._fields_)
