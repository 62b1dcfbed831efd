"""The float32 flash kernels' arithmetic (``csrc/flash_attention_fp32.cu``), emulated
in numpy and held against the reference: its Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it), its lse, and ``jax.vjp`` of ``mha_reference``
(the kernel's VJP rule).

The kernels run every product on the tensor cores as three TF32 products: a float32
``a`` is split into ``a_hi = a & 0xFFFFE000`` (the top 19 bits, the TF32 value) and
``a_lo = a - a_hi`` (which the tensor core reads to its own top 19 bits), and
``a * b ~ a_lo * b_hi + a_hi * b_lo + a_hi * b_hi`` in float32.  The emulation below
repeats that split, the forward's online softmax over the kernel's key tiles (each of
its two warp groups over half of every tile, merged at the end) and the backward's two
passes (dk / dv over each KV group's query heads and query steps, then dq over the key
tiles, each split the same way), in float32.  The kernels themselves run only on the card,
where ``chip_smoke.py`` holds them against the plain versions; one case here shows
that a single TF32 product would miss the float32 tolerance the split is there to
meet.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import \
    _flash_vjp_bwd as jax_flash_vjp_bwd  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash  # noqa: E402

CSRC = (Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "kernels"
        / "csrc" / "flash_attention_fp32.cu")
# chip_smoke.py's float32 tolerances: the forward absolute and relative (softcap's tanh
# of scores scaled by 3 amplifies the summation order), lse and the backward as a
# share of the reference's largest magnitude
TOL_FLASH_FP32, TOL_FLASH_SOFTCAP, TOL_LSE_FP32, TOL_BWD_FP32 = 2e-5, 1e-4, 1e-4, 1e-4
TF32_MASK = np.uint32(0xFFFFE000)
NEG_INF = np.float32(-1e30)

# (B, Sq, Skv, H, KV, hd, causal, window[, softcap]): every compiled head_dim, causal
# and not, windows, GQA and MQA, Sq < Skv, no mask with Sq > Skv, softcap; Sq and Skv
# multiples of the Pallas test's 32-row block
CASES = [
    (2, 64, 64, 4, 2, 16, True, 0),
    (1, 64, 128, 4, 4, 32, True, 0),
    (2, 96, 96, 4, 2, 32, True, 32),
    (1, 128, 128, 2, 1, 64, False, 0),
    (1, 96, 96, 4, 2, 80, True, 0),
    (1, 64, 96, 4, 4, 80, True, 40),
    (1, 128, 128, 4, 2, 128, True, 0),
    (1, 96, 32, 2, 2, 128, False, 0),
    (1, 64, 64, 2, 2, 256, True, 0),
    (1, 96, 128, 2, 1, 256, True, 48),
    (1, 64, 64, 2, 2, 32, True, 0, 20.0),
    (1, 64, 64, 2, 2, 256, True, 0, 20.0),
]


# ------------------------------------------------------------------ the emulation

def tf32(x: np.ndarray) -> np.ndarray:
    """The TF32 value the tensor core reads: the top 19 bits of each float32."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) & TF32_MASK).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """a_hi = a & 0xFFFFE000 and a_lo = a - a_hi, as the tensor core reads each."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b (batched) as the kernels compute it: three TF32 products, the small
    ones first, summed in float32.  Each product of two TF32 values is exact in
    float32 (11 x 11 significant bits)."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as one TF32 product: what the tensor cores give without the split."""
    return tf32(a) @ tf32(b)


# The kernels' tiles (FwdCfg, DkdvCfg, DqCfg in the source): keys a forward tile,
# query rows a pass-A step, keys a pass-B tile.
def fwd_keys(hd: int) -> int:
    return 32 if hd >= 224 else 64


def dkdv_rows(hd: int) -> int:
    return 32 if hd >= 224 else 64


def dq_keys(hd: int) -> int:
    return 16 if hd >= 224 else 64


def _mask(Sq, Skv, causal, window) -> np.ndarray:
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv)[None, :]
    m = np.ones((Sq, Skv), bool)
    if causal:
        m &= qpos >= kpos
    if window:
        m &= qpos - kpos < window
    return m


def _heads(q, k, v):
    """(B, H, S, hd) views, k and v repeated over each KV group's query heads."""
    G = q.shape[2] // k.shape[2]
    qh = q.transpose(0, 2, 1, 3)
    kr, vr = (np.repeat(t, G, axis=2).transpose(0, 2, 1, 3) for t in (k, v))
    return qh, kr, vr


def _scaled(raw, scale, softcap):
    """The scaled (and capped) score and the cap's derivative."""
    x = raw * scale
    if not softcap:
        return x, np.float32(1)
    th = np.tanh(x / np.float32(softcap))
    return th * np.float32(softcap), np.float32(1) - th * th


def emulate_forward(q, k, v, causal, window, softcap=0.0, mm=mm3):
    """The forward kernel: its two warp groups each take half of every key tile and
    run the online softmax over their halves (running max m, running sum l,
    accumulator rescaled by exp(m_old - m_new)), both products by `mm`; the two
    (m, l, acc) are merged at the end.  Returns (o (B, Sq, H, hd), lse (B, H, Sq))."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    qh, kr, vr = _heads(q, k, v)
    scale = np.float32(1 / np.sqrt(np.float32(hd)))
    mask = _mask(Sq, Skv, causal, window)
    bn = fwd_keys(hd)
    half = bn // 2
    states = []
    for grp in range(2):
        m = np.full((B, H, Sq), NEG_INF, np.float32)
        ll = np.zeros((B, H, Sq), np.float32)
        acc = np.zeros((B, H, Sq, hd), np.float32)
        for n0 in range(grp * half, Skv, bn):
            keys = slice(n0, n0 + half)
            s, _ = _scaled(mm(qh, kr[:, :, keys].swapaxes(-1, -2)), scale, softcap)
            s = np.where(mask[:, keys], s, NEG_INF)
            m_new = np.maximum(m, s.max(-1))
            alpha = np.exp(m - m_new)
            p = np.where(s <= NEG_INF / 2, np.float32(0), np.exp(s - m_new[..., None]))
            ll = ll * alpha + p.sum(-1, dtype=np.float32)
            acc = acc * alpha[..., None] + mm(p, vr[:, :, keys])
            m = m_new
        states.append((m, ll, acc))
    (m0, l0, acc0), (m1, l1, acc1) = states
    m = np.maximum(m0, m1)
    a0, a1 = np.exp(m0 - m), np.exp(m1 - m)
    ll = l0 * a0 + l1 * a1
    acc = acc0 * a0[..., None] + acc1 * a1[..., None]
    lt = np.maximum(ll, np.float32(1e-30))
    return (acc / lt[..., None]).transpose(0, 2, 1, 3), m + np.log(lt)


def emulate_backward(q, k, v, o, lse, do, causal, window, softcap=0.0, mm=mm3):
    """The backward kernels: D = rowsum(dO o O); pass A, for each key of each KV head,
    S^T = K Q^T and dP^T = V dO^T over the G query heads of its group and the query
    steps, dV += P^T dO, dK += dS^T Q, its two warp groups each taking half of every
    step's rows; pass B, dq += dS K over the key tiles, the groups each taking half of
    every tile's keys; each pass adds group 1's sums to group 0's at the end.
    Returns (dq, dk, dv) in the tensors' layouts."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = np.float32(1 / np.sqrt(np.float32(hd)))
    mask = _mask(Sq, Skv, causal, window)
    delta = (do * o).sum(-1, dtype=np.float32).transpose(0, 2, 1)          # (B, H, Sq)
    qh, doh = q.transpose(0, 2, 1, 3), do.transpose(0, 2, 1, 3)
    kh, vh = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    dk = np.zeros((2, B, KV, Skv, hd), np.float32)
    dv = np.zeros((2, B, KV, Skv, hd), np.float32)
    rows = dkdv_rows(hd)
    for gq in range(G):
        heads = np.arange(KV) * G + gq
        for grp in range(2):
            for m0 in range(grp * rows // 2, Sq, rows):
                qrows = slice(m0, m0 + rows // 2)
                qs, ds_ = qh[:, heads, qrows], doh[:, heads, qrows]
                x, capd = _scaled(mm(kh, qs.swapaxes(-1, -2)), scale, softcap)
                dpt = mm(vh, ds_.swapaxes(-1, -2))
                ok = mask[qrows].T
                pt = np.where(ok, np.exp(x - lse[:, heads, None, qrows]), np.float32(0))
                dst = pt * (dpt - delta[:, heads, None, qrows]) * capd
                dv[grp] += mm(pt, ds_)
                dk[grp] += mm(dst, qs)
    dq = np.zeros((2, B, H, Sq, hd), np.float32)
    _, kr, vr = _heads(q, k, v)
    bn = dq_keys(hd)
    for grp in range(2):
        for n0 in range(grp * bn // 2, Skv, bn):
            keys = slice(n0, n0 + bn // 2)
            x, capd = _scaled(mm(qh, kr[:, :, keys].swapaxes(-1, -2)), scale, softcap)
            dp = mm(doh, vr[:, :, keys].swapaxes(-1, -2))
            p = np.where(mask[:, keys], np.exp(x - lse[..., None]), np.float32(0))
            dq[grp] += mm(p * (dp - delta[..., None]) * capd, kr[:, :, keys])
    return (((dq[0] + dq[1]) * scale).transpose(0, 2, 1, 3),
            ((dk[0] + dk[1]) * scale).transpose(0, 2, 1, 3),
            (dv[0] + dv[1]).transpose(0, 2, 1, 3))


# ------------------------------------------------------------------ the reference

def _inputs(case, seed):
    B, Sq, Skv, H, KV, hd = case[:6]
    scale = 3.0 if len(case) > 8 else 1.0
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Sq, H, hd)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, Skv, KV, hd)) * scale).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    return q, k, v, do


def _kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8] if len(case) > 8 else 0.0)


def _jax_lse(q, k, causal, window, softcap):
    """The reference's log-sum-exp of its masked, scaled (and capped) scores."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    s = jnp.einsum("bqhd,bshd->bhqs", jnp.asarray(q),
                   jnp.repeat(jnp.asarray(k), H // KV, axis=2)) / np.sqrt(hd)
    if softcap:
        s = jnp.tanh(s / softcap) * softcap
    s = jnp.where(jnp.asarray(_mask(Sq, Skv, causal, window)), s, -1e30)
    return np.asarray(jax.nn.logsumexp(s, axis=-1))


def _jax_forward(q, k, v, kw):
    return np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32,
                                block_kv=32, interpret=True, **kw))


def _share(got, want) -> float:
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _excess(got, want, tol) -> float:
    """How far |got - want| exceeds tol + tol * |want| (> 0: a miss)."""
    return float((np.abs(got - want) - (tol + tol * np.abs(want))).max())


# ------------------------------------------------------------------ tests

def test_split_is_exact_and_products_are_exact():
    """a_hi keeps 10 mantissa bits (low 13 bits zero), a_hi + a_lo recovers a to
    within float32's own rounding, and a product of two TF32 values is exact in
    float32, so the three products lose only the a_lo * b_lo term."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 7
    hi, lo = split(x)
    assert not np.any(hi.view(np.uint32) & ~TF32_MASK)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - x) <= np.abs(x) * 2.0 ** -21)
    y = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    yh = tf32(y)
    assert np.array_equal((hi * yh).astype(np.float64), hi.astype(np.float64) * yh)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_forward_emulation_matches_reference_kernel(case):
    """The emulated 3xTF32 forward against the reference's Pallas kernel in interpret
    mode (TOL_FLASH_FP32; TOL_FLASH_SOFTCAP under softcap) and its lse against the
    reference's logsumexp (TOL_LSE_FP32 of the largest magnitude)."""
    q, k, v, _ = _inputs(case, 3)
    kw = _kw(case)
    o, lse = emulate_forward(q, k, v, **kw)
    tol = TOL_FLASH_SOFTCAP if kw["softcap"] else TOL_FLASH_FP32
    np.testing.assert_allclose(o, _jax_forward(q, k, v, kw), atol=tol, rtol=tol)
    assert _share(lse, _jax_lse(q, k, **kw)) <= TOL_LSE_FP32


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_backward_emulation_matches_jax_vjp(case):
    """The emulated two-pass backward (from the emulated forward's o and lse) against
    jax.vjp of mha_reference, the reference kernel's VJP rule: dq, dk and dv within
    TOL_BWD_FP32 of the largest magnitude."""
    q, k, v, do = _inputs(case, 4)
    kw = _kw(case)
    o, lse = emulate_forward(q, k, v, **kw)
    got = emulate_backward(q, k, v, o, lse, do, **kw)
    want = jax_flash_vjp_bwd(kw["causal"], kw["window"], kw["softcap"], 32, 32, True,
                             tuple(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        assert _share(g, np.asarray(w)) <= TOL_BWD_FP32, name


@pytest.mark.parametrize("hd", (32, 256))
def test_one_tf32_product_misses_the_float32_tolerance(hd):
    """Why three products: with one TF32 product a causal forward misses
    TOL_FLASH_FP32 against the reference's kernel, where the split meets it."""
    case = (1, 128, 128, 2, 2, hd, True, 0)
    q, k, v, _ = _inputs(case, 5)
    kw = _kw(case)
    want = _jax_forward(q, k, v, kw)
    one, _ = emulate_forward(q, k, v, mm=mm1, **kw)
    three, _ = emulate_forward(q, k, v, **kw)
    assert _excess(one, want, TOL_FLASH_FP32) > 0
    assert np.abs(one - want).max() > 10 * np.abs(three - want).max()
    assert _excess(three, want, TOL_FLASH_FP32) <= 0


def test_emulation_follows_the_kernel_source():
    """The split, the order of the three products and the tiles are the kernel's."""
    src = CSRC.read_text()
    assert "constexpr uint32_t kTf32Mask = 0xFFFFE000u;" in src
    assert "hi = __float_as_uint(x) & kTf32Mask;" in src
    assert "lo = __float_as_uint(x - __uint_as_float(hi));" in src
    body = re.search(r"void mma3\(.*?\n\}", src, re.S).group(0)
    assert re.findall(r"mma_tf32\(d, a\.(\w+), (\w)0, \w1\)", body) == \
        [("lo", "h"), ("hi", "l"), ("hi", "h")]

    def cfg(name: str, field: str) -> str:
        block = re.search(r"struct " + name + r" \{(.*?)\n\};", src, re.S).group(1)
        return re.search(r"static constexpr int " + field + r" = ([^;]*);", block).group(1)

    assert cfg("FwdCfg", "BN") == "HD >= 224 ? 32 : 64"
    assert cfg("DkdvCfg", "BMQ") == "HD >= 224 ? 32 : 64"
    assert cfg("DqCfg", "BN") == "HD >= 224 ? 16 : 64"
    for hd in (16, 32, 64, 80, 128, 224, 256):
        assert fwd_keys(hd) == (32 if hd >= 224 else 64)
        assert dkdv_rows(hd) == (32 if hd >= 224 else 64)
        assert dq_keys(hd) == (16 if hd >= 224 else 64)
