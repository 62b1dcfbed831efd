"""The port's dry run (``repro_torch.launch.dryrun``) on torch's fake process
group, the twin of the reference's
``tests/test_parallel_multidev.py::test_small_mesh_dryrun_lowers_and_compiles``:
reduced gemma-7b, ``ShapeSpec("mini_train", 64, 8, "train")``, a ``(2, 4)``
mesh of 8 fake ranks, ZeRO-3, 2 microbatches.  Each case runs in a fresh
interpreter (the fake group is that process's default group; the pytest process
never joins one) and prints one JSON line that the test reads."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

# every case starts an interpreter that imports torch and runs a step under
# DTensor on fake tensors
pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parents[1]


def _run(body: str, timeout: float = 300) -> dict:
    code = textwrap.dedent("""
        import json
        import torch
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import make_mesh
    """) + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=timeout)
    assert r.returncode == 0, r.stderr[-6000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_mini_train_cell(tmp_path):
    """The local flops equal a hand count of the products each rank runs; the
    step issues all-reduces, all-gathers and reduce-scatters; the tracked peak
    is positive; the report, written, is read back by ``summarize``.

    Hand count, remat none (8 ranks: every dense product of this cell is split
    over both mesh dims, the kv projections' columns over "model" too): each
    product 6 * T * params / 8 over the step's T = 512 tokens, the cross-entropy's
    chunks recompute their logits in the backward (2 * T * d * V / 8 more), and
    attention runs the kernel's plain version on each rank's shard: per layer
    and microbatch 8 products (forward 2, its lse 1, backward 5) of 2 * S^2 * hd
    for each of the rank's 2 rows x 1 head.  With remat full the forward is run
    again, so the count grows."""
    out = _run(f"""
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.launch import summarize
        from repro_torch.models.config import ShapeSpec
        cfg = get_config("gemma_7b").reduced()
        shape = ShapeSpec("mini_train", 64, 8, "train")
        with dr.fake_group(8):
            mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
            r = dr.dry_run(cfg, shape, mesh, mesh_name="2x4", arch="gemma_7b",
                           zero3=True, microbatches=2, remat="none")
            full = dr.dry_run(cfg, shape, mesh, mesh_name="2x4", zero3=True,
                              microbatches=2, remat="full")
        (__import__("pathlib").Path({str(tmp_path)!r}) / "gemma_7b.mini_train.2x4.json"
         ).write_text(json.dumps(r))
        rows = summarize.load(reports=__import__("pathlib").Path({str(tmp_path)!r}))
        d, V, L, H, KV, hd, F = (cfg.d_model, cfg.vocab, cfg.n_layers, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, cfg.d_ff)
        print(json.dumps({{"r": r, "full_flops": full["flops"], "rows": rows,
                          "table": summarize.table(rows),
                          "dims": [d, V, L, H, KV, hd, F]}}))
    """)
    r, (d, V, L, H, KV, hd, F) = out["r"], out["dims"]
    T, S, M, ranks = 8 * 64, 64, 2, 8
    per_layer = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * F
    dense = 6 * T * (L * per_layer + d * V) / ranks
    xent_recompute = 2 * T * d * V / ranks
    rows_local, heads_local = 8 // M // 2, H // 4
    attention = L * M * 8 * 2 * S * S * hd * rows_local * heads_local
    assert r["flops"] > 0
    assert r["flops"] == pytest.approx(dense + xent_recompute + attention, rel=1e-12)
    assert out["full_flops"] > r["flops"]
    assert {"all_reduce", "all_gather", "reduce_scatter"} <= set(r["coll_counts"])
    assert all(r["coll_bytes"][k] > 0 for k in ("all_reduce", "all_gather",
                                                   "reduce_scatter"))
    assert r["peak_bytes"] > 0 and r["fits"]
    assert r["zero3"] and r["microbatches"] == 2 and r["chips"] == 8
    assert r["t_compute"] == pytest.approx(r["flops"] / 989e12)
    assert [row["arch"] for row in out["rows"]] == ["gemma_7b"]
    assert "| gemma_7b | mini_train | 2x4 |" in out["table"]


def test_local_against_global_flops():
    """A product with rows split over "data" and replicated over "model": each
    rank does a half of it (2 data shards), which ``LocalFlopCounter`` counts,
    where ``FlopCounterMode`` counts the whole; split over both dims of a (16,
    16) mesh, each of the 256 ranks does 1/256 of it."""
    out = _run("""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from torch.utils.flop_counter import FlopCounterMode
        res = {}
        n = 2 * 512 * 256 * 384
        for world, shape, placements in ((8, (2, 4), [Shard(0), Replicate()]),
                                         (256, (16, 16), [Shard(0), Shard(1)])):
            with dr.fake_group(world):
                mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
                with FakeTensorMode():
                    x = distribute_tensor(torch.empty(512, 256), mesh, placements)
                    w = distribute_tensor(torch.empty(256, 384), mesh,
                                          [Replicate(), Replicate()])
                    with FlopCounterMode(display=False) as glob, \
                            dr.LocalFlopCounter() as loc:
                        x @ w
                res[str(world)] = [glob.get_total_flops(), loc.flops, n]
        print(json.dumps(res))
    """)
    glob, local, n = out["8"]
    assert glob == n and local == n / 2
    glob, local, n = out["256"]
    assert local == n / 256 and glob >= n


def test_cli_writes_reports_that_summarize_reads(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on a production cell (xlstm-125m
    x decode_32k on the (16, 16) mesh of 256 fake ranks): the report lands in
    ``--out`` and ``python -m repro_torch.launch.summarize --reports`` tables it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "xlstm_125m", "--shape", "decode_32k", "--mesh", "single",
                        "--out", str(tmp_path)], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rep = json.loads((tmp_path / "xlstm_125m.decode_32k.single.json").read_text())
    assert rep["status"] == "ok" and rep["chips"] == 256 and rep["flops"] > 0
    s = subprocess.run([sys.executable, "-m", "repro_torch.launch.summarize",
                        "--reports", str(tmp_path)], capture_output=True, text=True,
                       env=env, timeout=120)
    assert s.returncode == 0, s.stderr
    assert "| xlstm_125m | decode_32k | single |" in s.stdout
    assert "1 ok cells" in s.stdout
