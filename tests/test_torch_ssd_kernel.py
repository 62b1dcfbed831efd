"""The chunked SSD kernels' algebra (``kernels/ssd.py``) on the CPU, and its wrapper.

The CUDA kernels (``csrc/ssd.cu``) run only on the card.  What they compute is written
out in ``kernels/ssd.py`` as plain PyTorch in the kernels' own decomposition
(``ssd_fwd_plain``: chunk states, the state pass, each chunk's output;
``ssd_bwd_plain``: the states again, the reverse pass, each chunk's gradients, dB and
dC over tiles of heads, dA_log and dD over per-chunk partials).  Here both are held
against the model's plain chunkwise form, ``models.layers._ssd_chunked_groups``, and
its autograd: inputs in float64, the plain form float32 inside, so every limit is a
float32 rounding limit (1e-5 of the reference's largest entry).  The kernels' chunk
(64) differs from the model's (64 or 128 here): the algebra is exact for any chunk.

On the card (marker ``cuda``; skips here), ``tools/ssd_bench.py``'s cases hold the
kernels to the same plain form and to the sequential one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_kernel.py
"""

import ast
import ctypes
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
TOL = 1e-5


def _inputs(Bb, S, nh, hd, G, N, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(Bb, S, nh, hd, generator=g, dtype=dtype)
    Bm = torch.randn(Bb, S, G, N, generator=g, dtype=dtype) * 0.5
    Cm = torch.randn(Bb, S, G, N, generator=g, dtype=dtype) * 0.5
    # dt log-uniform in [e^-4, e^-1] and A in [1, e^1.5]: decays from ~0.98 to ~0.01 a
    # token, so some heads carry their state across chunks and some forget it
    dt = torch.exp(torch.empty(Bb, S, nh, dtype=dtype).uniform_(-4, -1, generator=g))
    A_log = torch.empty(nh, dtype=dtype).uniform_(0, 1.5, generator=g)
    D = torch.randn(nh, generator=g, dtype=dtype)
    h0 = torch.randn(Bb, nh, hd, N, generator=g, dtype=torch.float32)
    return x, Bm, Cm, dt, A_log, D, h0


def _rel(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


# groups, heads a group (3: one ragged tile; 10: a full tile of 8 and a ragged one),
# chunks of the model's length, its chunk
GRID = [(G, per, n, chunk) for G in (1, 2) for per in (3, 10) for n in (2, 4)
        for chunk in (64, 128)]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("G,per,n,chunk", GRID)
def test_plain_forward_in_the_kernels_decomposition_matches_the_grouped_form(
        G, per, n, chunk, with_h0):
    x, Bm, Cm, dt, A_log, D, h0 = _inputs(2, n * chunk, G * per, 8, G, 4, seed=G + per + n)
    h0 = h0 if with_h0 else None
    want_y, want_h = L._ssd_chunked_groups(x, Bm, Cm, dt, A_log, D, 8, h0, chunk)
    y, h = ssd.ssd_fwd_plain(x, Bm, Cm, dt, A_log, D, h0, chunk=ssd.CHUNK)
    assert y.dtype == x.dtype
    assert _rel(y, want_y) < TOL and _rel(h, want_h) < TOL


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("G,per,n,chunk", GRID)
def test_plain_backward_in_the_kernels_order_matches_autograd(G, per, n, chunk, with_h0):
    # every gradient, dA_log, dD and dh0 included, from random gradients of y and of
    # the final state
    x, Bm, Cm, dt, A_log, D, h0 = _inputs(2, n * chunk, G * per, 8, G, 4, seed=7 * G + per + n)
    h0 = h0 if with_h0 else None
    leaves = [t.clone().requires_grad_() for t in (x, Bm, Cm, dt, A_log, D)]
    h0_leaf = h0.clone().requires_grad_() if with_h0 else None
    y, h = L._ssd_chunked_groups(*leaves, 8, h0_leaf, chunk)
    gen = torch.Generator().manual_seed(99)
    dy = torch.randn(y.shape, generator=gen, dtype=y.dtype)
    dh = torch.randn(h.shape, generator=gen, dtype=h.dtype)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(),
                               leaves + ([h0_leaf] if with_h0 else []))
    got = ssd.ssd_bwd_plain(x, Bm, Cm, dt, A_log, D, h0, dy, dh, chunk=ssd.CHUNK)
    names = ("dx", "dB", "dC", "ddt", "dA_log", "dD", "dh0")
    for name, g_, w in zip(names, got, want):
        assert g_.dtype == w.dtype, name
        assert _rel(g_, w) < TOL, (name, _rel(g_, w))
    if not with_h0:
        # the state's gradient still comes back, from the final state's
        assert got[6].shape == h.shape


@pytest.mark.parametrize("G,per", [(1, 4), (2, 3)])
def test_the_function_on_the_cpu_gives_autograds_gradients(G, per):
    # ssd_chunked on CPU tensors: the Function with the plain versions, y's gradient
    # alone (the final state unused: its gradient arrives as None)
    x, Bm, Cm, dt, A_log, D, h0 = _inputs(1, 256, G * per, 8, G, 4, seed=3)
    a = [t.clone().requires_grad_() for t in (x, Bm, Cm, dt, A_log, D, h0)]
    b = [t.clone().requires_grad_() for t in (x, Bm, Cm, dt, A_log, D, h0)]
    y, h = ssd.ssd_chunked(*a, chunk=128)
    y_ref, h_ref = L._ssd_chunked_groups(*b[:6], 8, b[6], 128)
    assert _rel(y, y_ref) < TOL and _rel(h, h_ref) < TOL and h.dtype == torch.float32
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(5), dtype=y.dtype)
    (y * dy).sum().backward()
    (y_ref * dy).sum().backward()
    for ta, tb in zip(a, b):
        assert _rel(ta.grad, tb.grad) < TOL


def test_the_cpu_model_path_is_unchanged(monkeypatch):
    # on the CPU _mamba_scan keeps the plain chunkwise forms and their checkpoint: the
    # kernels' wrapper is never called, and y is the plain form's bit for bit
    called = []
    monkeypatch.setattr(ops, "ssd_chunked", lambda *a, **k: called.append(a))
    x, Bm, Cm, dt, A_log, D, _ = _inputs(1, 256, 4, 8, 2, 4, seed=11, dtype=torch.float32)
    leaves = [t.clone().requires_grad_() for t in (x, Bm, Cm, dt, A_log, D)]
    y, h = L._mamba_scan(*leaves, 8)
    want_y, want_h = L._ssd_chunked_groups(x, Bm, Cm, dt, A_log, D, 8, None, L.MAMBA_CHUNK)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    y.sum().backward()
    y1, h1 = L._mamba_scan(x, Bm[:, :, 0], Cm[:, :, 0], dt, A_log, D, 8)
    want1 = L._ssd_chunked(x, Bm[:, :, 0], Cm[:, :, 0], dt, A_log, D, 8, None, L.MAMBA_CHUNK)
    assert torch.equal(y1, want1[0]) and torch.equal(h1, want1[1])
    assert not called and ssd.launches == 0 and ssd.bwd_launches == 0


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card: the dispatch and the wrapper's
    refusals run here (an accepted call would go on to build the kernels)."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)

    def get_device(self):
        return 0


@pytest.mark.parametrize("grouped", [True, False])
def test_cuda_tensors_take_the_kernels_in_both_chunkwise_branches(monkeypatch, grouped):
    # the grouped branch hands B and C as they are, the one-group branch as (B,S,1,N)
    # views
    called = []
    monkeypatch.setattr(ops, "ssd_chunked",
                        lambda *a: called.append(a) or (a[0], a[6]))
    x, Bm, Cm, dt, A_log, D, h0 = _inputs(1, 256, 4, 8, 2, 4, seed=12, dtype=torch.float32)
    if not grouped:
        Bm, Cm = Bm[:, :, 0], Cm[:, :, 0]
    args = [t.as_subclass(_FakeCuda) for t in (x, Bm, Cm, dt, A_log, D, h0)]
    L._mamba_scan(*args[:6], 8, h0=args[6])
    (xa, Ba, Ca, *_rest, h0a, chunk), = called
    assert xa is args[0] and h0a is args[6] and chunk == L.MAMBA_CHUNK
    assert Ba.shape == (1, 256, 2 if grouped else 1, 4) and Ca.shape == Ba.shape


_REFUSALS = {
    "hd_state": (lambda a: (a[0][..., :12], *a[1:6], a[6][:, :, :12]), ValueError,
                 "not compiled in"),
    "seqlen": (lambda a: tuple(t[:, :192] if t.ndim > 1 else t for t in a[:6]) + (a[6],),
               ValueError, "multiple of the chunk"),
    "groups": (lambda a: (a[0][:, :, :3], a[1], a[2], a[3][:, :, :3], a[4][:3], a[5][:3],
                          a[6][:, :3]), ValueError, "groups"),
    "float64": (lambda a: tuple(t.double() if i < 6 else t for i, t in enumerate(a)),
                TypeError, "float32, bfloat16"),
    "mixed": (lambda a: (a[0].bfloat16(), *a[1:]), TypeError, "one type"),
    "h0_dtype": (lambda a: (*a[:6], a[6].double()), ValueError, "h0"),
    "shape": (lambda a: (a[0], a[1][:, :, :, :8], *a[2:]), ValueError, "x"),
}


@pytest.mark.parametrize("bad", sorted(_REFUSALS))
def test_the_wrapper_refuses_what_the_kernels_do_not_take(bad):
    x, Bm, Cm, dt, A_log, D, h0 = _inputs(1, 256, 4, 16, 2, 16, seed=13, dtype=torch.float32)
    breaker, error, says = _REFUSALS[bad]
    args = [t.as_subclass(_FakeCuda) for t in breaker((x, Bm, Cm, dt, A_log, D, h0))]
    with pytest.raises(error, match=says):
        ssd.ssd_chunked(*args, chunk=128)
    assert ssd.launches == 0 and _build._lib is None


def test_the_module_imports_and_runs_on_the_cpu_without_nvcc():
    code = ("import sys; sys.path.insert(0, 'src'); import torch\n"
            "from repro_torch.kernels import ssd, ops, _build\n"
            "x = torch.randn(1, 128, 2, 16); B = torch.randn(1, 128, 1, 16)\n"
            "y, h = ops.ssd_chunked(x, B, B, torch.rand(1, 128, 2), torch.zeros(2),"
            " torch.ones(2), None, 64)\n"
            "assert _build._lib is None and ops.launch_counts()['ssd'] == 0\n"
            "print(tuple(y.shape), tuple(h.shape))\n")
    env = {**os.environ, "PATH": "/nonexistent", "CUDA_HOME": "/nonexistent"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(1, 128, 2, 16) (1, 2, 16, 16)"


def test_launch_counts_hold_the_ssd_calls():
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    assert counts["ssd"] == 0 and counts["ssd_bwd"] == 0
    ssd.launches, ssd.bwd_launches = 3, 2
    assert (ops.launch_counts()["ssd"], ops.launch_counts()["ssd_bwd"]) == (3, 2)
    ops.reset_launch_counts()
    assert ssd.launches == 0 and ssd.bwd_launches == 0


@pytest.mark.parametrize("name,const", [("CHUNK", "kChunk"), ("HEAD_TILE", "kHeadTile")])
def test_wrapper_constants_match_the_c_source(name, const):
    found = re.search(r"constexpr int " + const + r" = (\d+);", (CSRC / "ssd.cu").read_text())
    assert found and int(found.group(1)) == getattr(ssd, name)


def test_compiled_shapes_match_the_c_source():
    found = re.search(r"#define SSD_SHAPES\(X\) (.*)", (CSRC / "ssd.cu").read_text())
    pairs = tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", found.group(1)))
    assert pairs == ssd.SHAPES


def test_argument_block_matches_the_c_struct():
    body = re.search(r"struct SsdCall \{([^}]*)\};", (CSRC / "ssd.cu").read_text()).group(1)
    c_types = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    fields = []
    for line in body.strip().splitlines():
        typ, name = re.match(r"(.+?)\s*(\w+)$", " ".join(line.split(";")[0].split())).groups()
        fields.append((name, ctypes.c_void_p if typ.endswith("*") else c_types[typ]))
    assert fields == list(_build.SsdCall._fields_)


def _patterns(metric: str) -> tuple:
    tree = ast.parse((ROOT / "perfbench" / "metrics" / f"{metric}.py").read_text())
    return next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign) and node.targets[0].id == "MATCH")


def test_kernel_names_leave_the_elementwise_and_product_metrics():
    """Every kernel of ``csrc/ssd.cu`` is named ``repro_ssd_*``, and no name the
    profiler shows for one (the namespace, types and template arguments included)
    holds a pattern by which the elementwise or the products' metric counts a kernel:
    the SSD's time is read by ``ssd_ms_per_step`` alone."""
    text = (CSRC / "ssd.cu").read_text()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", text)
    assert len(kernels) == 6 and all(k.startswith("repro_ssd_") for k in kernels)
    names = set(kernels) | set(re.findall(r"struct (\w+)", text)) | {
        "float", "int", "long long", "bool", "true", "false", "anonymous namespace"}
    patterns = _patterns("elementwise_ms_per_step") + _patterns("matmul_ms_per_step")
    assert not [(n, p) for n in names for p in patterns if p in n.lower()]


def _bench():
    spec = importlib.util.spec_from_file_location("ssd_bench", ROOT / "tools" / "ssd_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_bench_counts_the_cells_work():
    # 2 x 4096 tokens, 112 heads of 64 in 2 groups, d_state 64, the kernels' chunk:
    # ~18.9 GFLOP forward and ~45.5 G backward a layer
    fwd, bwd = _bench().flops(2, 4096, 112, 64, 2, 64, ssd.CHUNK)
    assert fwd == pytest.approx(1.904e10, rel=1e-3) and bwd == pytest.approx(4.573e10, rel=1e-3)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_group_h0", "ragged_bf16_h0", "state128",
                                  "hd128_fp16", "small"])
def test_kernels_match_the_plain_forms_on_the_card(card, case):
    row = _bench().check_case(case)
    assert row["ok"], row
