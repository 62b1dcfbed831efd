"""The port's pipeline with uneven stages (``repro_torch.parallel.pipeline``)
against the reference: ``pad_stages`` against JAX's in process, and
``pipeline_forward`` on 4 gloo CPU ranks (``torch_ranks.run_ranks``), the twin of
``tests/test_parallel_multidev.py::test_pipeline_uneven_stages_fwd_bwd``: the
forward within 1e-5 of the reference's sequential loop and each rank's stage
gradients within 1e-4 of ``jax.grad`` of it, both run in this process on the
same numpy weights, with no scaling on either side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.parallel.pipeline import pad_stages as jax_pad_stages  # noqa: E402
from repro_torch.parallel.pipeline import pad_stages  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402


@pytest.mark.parametrize("sizes", [[2, 2, 2, 1], [3, 1], [1, 4, 2], [5]], ids=str)
def test_pad_stages_is_the_references(sizes):
    L = sum(sizes)
    rng = np.random.default_rng(L)
    tree = {"w": rng.standard_normal((L, 3, 4)).astype(np.float32),
            "b": rng.standard_normal((L, 5)).astype(np.float32)}
    sp, mask = pad_stages({k: torch.from_numpy(v) for k, v in tree.items()}, sizes)
    jsp, jmask = jax_pad_stages({k: jnp.asarray(v) for k, v in tree.items()}, sizes)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.dtype == torch.bool
    for k in tree:
        np.testing.assert_array_equal(sp[k].numpy(), np.asarray(jsp[k]))


def _reference(L, d, M, mb, seed):
    """The reference test's model and its sequential loop in JAX: weights, inputs,
    outputs and the gradient of ``sum(out ** 2)`` with respect to the weights."""
    rng = np.random.default_rng(seed)
    Ws = (rng.standard_normal((L, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, mb, d)).astype(np.float32)

    def run(W):
        r = jnp.asarray(x)
        for i in range(L):
            r = jnp.tanh(r @ W[i])
        return r

    out = run(jnp.asarray(Ws))
    grad = jax.grad(lambda W: jnp.sum(run(W) ** 2))(jnp.asarray(Ws))
    return Ws, x, np.asarray(out), np.asarray(grad)


# every case starts 2-4 interpreters that each import torch
@pytest.mark.slow
@pytest.mark.parametrize("sizes,M,mb", [([2, 2, 2, 1], 6, 3), ([5, 2], 3, 2)],
                         ids=["4-stages", "2-stages"])
def test_pipeline_uneven_stages_fwd_bwd(sizes, M, mb, tmp_path):
    L, d = sum(sizes), 16
    Ws, x, out, grad = _reference(L, d, M, mb, seed=0)
    path = tmp_path / "ref.npz"
    np.savez(path, Ws=Ws, x=x, out=out, grad=grad)
    run_ranks(f"""
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.pipeline import pad_stages, pipeline_forward
        ref = np.load({str(path)!r})
        sizes = {sizes!r}
        mesh = make_mesh((len(sizes),), ("pipe",), device_type="cpu")
        Ws = torch.from_numpy(ref["Ws"])
        sp, mask = pad_stages({{"w": Ws}}, sizes)
        sp["w"].requires_grad_(True)
        x = torch.from_numpy(ref["x"])
        fn = lambda p, h: torch.tanh(h @ p["w"])
        out = pipeline_forward(fn, sp, mask, x, mesh=mesh)
        np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=1e-5, rtol=0)
        (out ** 2).sum().backward()
        g = sp["w"].grad
        start, n = sum(sizes[:RANK]), sizes[RANK]
        np.testing.assert_allclose(g[RANK, :n].numpy(), ref["grad"][start:start + n],
                                   atol=1e-4, rtol=0)
        # padding layers and the other ranks' stages get nothing on this rank
        assert float(g[RANK, n:].abs().sum()) == 0.0
        others = [s for s in range(len(sizes)) if s != RANK]
        assert float(g[others].abs().sum()) == 0.0
    """, len(sizes))
