"""The port's explicit gradient schedules (``repro_torch.parallel.collectives``)
against the reference's: ``_quantize_int8`` bit for bit on the same seeded input,
in process; ``sync_grads``' three schedules on 8 gloo CPU ranks
(``torch_ranks.run_ranks``), the twin of the reference's
``tests/test_parallel_multidev.py::test_collective_schedules_equivalent`` and,
with gradients that differ by rank, against the numpy mean."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.parallel.collectives import _quantize_int8 as jax_quantize  # noqa: E402
from repro_torch.parallel.collectives import _quantize_int8  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

QUANT_CASES = [((64,), 1.0), ((8, 33), 3e-3), ((4, 6, 7), 250.0), ((1,), 1.0),
               ((5, 5), 0.0)]


@pytest.mark.parametrize("shape,scale", QUANT_CASES, ids=lambda v: str(v))
def test_quantize_int8_is_the_references_bit_for_bit(shape, scale):
    """float32: the same q (int8) and the same scale bits as ``jnp``'s formula,
    halves rounded to even on both sides (an input of exact halves is included)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if x.size > 4:
        m = float(np.abs(x).max())
        x.flat[:4] = np.float32(m / 127.0) * np.float32([0.5, 1.5, -2.5, 3.5])
    q, s = _quantize_int8(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s.item()).tobytes() == np.asarray(js, np.float32).tobytes()


# every case starts 8 interpreters that each import torch
@pytest.mark.slow
def test_schedules_equivalent():
    """Twin of the reference's test on the same ``g``: ``"allreduce"`` and
    ``"rs_ag"`` agree within 1e-6 (leaf ``b``'s 7 entries pad to 8 for the
    reduce-scatter), int8's error is within ``scale`` of the mean and its error
    feedback state is returned; a DTensor gradient is refused."""
    run_ranks("""
        from torch.distributed.tensor import Replicate, distribute_tensor
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.collectives import allreduce_naive, sync_grads
        mesh = make_mesh((8,), ("data",), device_type="cpu")
        g = {"a": torch.arange(24.0).reshape(4, 6), "b": torch.ones(7)}
        ar, e0 = sync_grads(g, mesh, "data", schedule="allreduce")
        rs, e1 = sync_grads(g, mesh, "data", schedule="rs_ag")
        assert e0 is None and e1 is None
        for k in g:
            np.testing.assert_allclose(ar[k].numpy(), rs[k].numpy(), atol=1e-6)
            np.testing.assert_allclose(ar[k].numpy(), g[k].numpy(), atol=1e-6)
        q, err = sync_grads(g, mesh, "data", schedule="int8")
        scale = float(g["a"].abs().max()) / 127
        assert float((q["a"] - g["a"]).abs().max()) <= scale + 1e-6
        assert err is not None and set(err) == set(g)
        for k in g:
            assert err[k].shape == g[k].shape
        try:
            allreduce_naive(distribute_tensor(g["a"], mesh, [Replicate()]))
        except TypeError:
            pass
        else:
            raise AssertionError("a DTensor was taken")
    """, 8)


@pytest.mark.slow
@pytest.mark.parametrize("schedule", ["allreduce", "rs_ag", "int8"])
def test_schedules_against_the_numpy_mean(schedule):
    """Each rank's gradients differ (seeded by rank; odd sizes that the
    reduce-scatter pads).  allreduce and rs_ag: the mean within 1e-6.  int8: each
    rank sends its dequantized ``g + err``, within half its scale of it, so the
    mean is within the ranks' mean half-scale; ``new_err`` is exactly ``g -
    deq``; a second step fed that state
    leaves the two steps' sum within one step's error bound of the exact sum."""
    run_ranks(f"""
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.collectives import _quantize_int8, sync_grads
        mesh = make_mesh((8,), ("data",), device_type="cpu")
        shapes = {{"w": (5, 3), "v": (13,), "u": (2, 2, 2)}}

        def grads(r, step):
            rng = np.random.default_rng(100 * step + r)
            return {{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                    for k, s in shapes.items()}}

        g = grads(RANK, 0)
        want = {{k: np.mean([grads(r, 0)[k].numpy() for r in range(WORLD)], axis=0)
                for k in shapes}}
        out, err = sync_grads(g, mesh, "data", schedule={schedule!r})
        if {schedule!r} != "int8":
            assert err is None
            for k in shapes:
                np.testing.assert_allclose(out[k].numpy(), want[k], atol=1e-6, rtol=0)
        else:
            half = {{k: np.mean([float(grads(r, 0)[k].abs().max()) / 127 / 2
                                for r in range(WORLD)]) for k in shapes}}
            for k in shapes:
                assert np.abs(out[k].numpy() - want[k]).max() <= half[k] + 1e-6, k
                q, scale = _quantize_int8(g[k])
                assert torch.equal(err[k], g[k] - q.float() * scale), k
            g2 = grads(RANK, 1)
            out2, _ = sync_grads(g2, mesh, "data", schedule="int8", err=err)
            for k in shapes:
                exact = want[k] + np.mean([grads(r, 1)[k].numpy() for r in range(WORLD)],
                                          axis=0)
                bound = np.mean([float(grads(r, 1)[k].abs().max()) / 127
                                 for r in range(WORLD)]) + half[k] * 2
                assert np.abs(out[k].numpy() + out2[k].numpy() - exact).max() <= bound, k
    """, 8)


@pytest.mark.slow
def test_fig3_tool_on_gloo_ranks():
    """``tools/fig3_allreduce_torch.py --ranks 2``: the reference benchmark's six
    analytic rows (the decomposition faster in each, by about n at 1 GB), then
    the three schedules timed on two gloo ranks, each checked against the mean
    by the tool itself."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(root / "tools" / "fig3_allreduce_torch.py"),
                        "--ranks", "2"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    rows = [x["analytic"] for x in lines if "analytic" in x]
    assert len(rows) == 6 and all(row["decomposed_ms"] < row["naive_ms"] for row in rows)
    assert rows[2]["speedup"] == pytest.approx(8, rel=0.01)
    measured = lines[-1]["measured"]
    assert measured["ranks"] == 2 and set(measured["schedules"]) == {"allreduce", "rs_ag",
                                                                     "int8"}
    assert all(v["ms"] > 0 for v in measured["schedules"].values())
