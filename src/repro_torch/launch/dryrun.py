"""Multi-pod dry run (the reference's ``launch/dryrun.py``): every (arch x shape
x mesh) cell's real step, run with no allocation.

Where the reference lowers and compiles each cell on 256 or 512 forced host
devices, the port runs the step itself on fake tensors:

  * the default process group is torch's fake backend with 256 (the ``(16,
    16)`` "single" mesh) or 512 (the ``(2, 16, 16)`` "multi" mesh) ranks, this
    process being rank 0: its collectives move nothing;
  * ``launch.mesh.make_production_mesh(device_type="cpu")`` gives the mesh;
  * under ``FakeTensorMode`` the model and the ``Trainer``'s sharded state
    (``parallel.sharding``; ZeRO-3 per :func:`needs_zero3`) are built without
    storage, and one step of ``make_train_step``, ``make_prefill_step`` or
    ``make_serve_step`` runs under :class:`LocalFlopCounter` (each rank's own
    operations), :class:`CommCounter` (DTensor's collectives by kind) and
    ``MemTracker`` (rank 0's peak, the state included);
  * the memory policy escalates the microbatches while the tracked peak is above
    ``roofline.HBM_BYTES`` (the reference: 16 GB after compiling).

Fake CPU tensors take the kernels' plain versions, so attention is counted as
the reference's jnp path is: the full square, and its memory with it (the card's
flash kernel allocates no score matrix, so the tracked peak of a long sequence
is above what the card holds).  The port's model loops in Python over its layers
and time chunks, so every operation is counted and no probe lowering is needed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_7b --shape train_4k --mesh single

Reports go to ``reports/dryrun_torch/`` (``launch.summarize`` reads them).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES_BY_NAME, ArchConfig, ShapeSpec
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.axes import distribute, mesh_shape, use_rules
from repro_torch.parallel.trainstep import (abstract_train_state, make_prefill_step,
                                            make_serve_step, make_train_step)

REPORTS = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"

# The reference's thresholds, 6 GB of a v5e's 16 GB, as shares of HBM_BYTES: 30 GB
# of an H100's 80; with HBM_BYTES = 16e9 the decisions are the reference's.
RESIDENT_SHARE = 6e9 / 16e9
ACTIVATION_SHARE = 6e9 / 16e9


# ---------------------------------------------------------------------------
# Per-cell policy (the planner's memory model, Eq. 6, applied to the mesh)
# ---------------------------------------------------------------------------


def needs_zero3(cfg: ArchConfig, shape: ShapeSpec, model_extent: int) -> bool:
    n = rl.meta_lm(cfg).n_params()
    if shape.kind == "train":
        resident = 4.0 * n / model_extent          # bf16 p+g, moments zero1'd
    else:
        resident = 2.0 * n / model_extent
    return resident > RESIDENT_SHARE * rl.HBM_BYTES


def choose_microbatches(cfg: ArchConfig, shape: ShapeSpec,
                        dp_extent: int) -> int:
    """Smallest grad-accumulation factor whose activation estimate fits."""
    if shape.kind != "train":
        return 1
    per_dev_batch = max(shape.global_batch // dp_extent, 1)
    # MoE working set: top_k routed copies + dispatch/combine buffers
    # (~K*(1+cf)*d_ff per token), much larger than the expert d_ff alone.
    d_ff_eff = cfg.top_k * cfg.d_ff * (1 + cfg.moe_capacity_factor) \
        if cfg.n_experts else cfg.d_ff
    for M in (1, 2, 4, 8, 16, 32):
        if M > per_dev_batch:
            return per_dev_batch
        mb_tokens = per_dev_batch // M * shape.seq_len
        stored = cfg.n_layers * mb_tokens * cfg.d_model * 2      # remat=full
        work = mb_tokens * max(d_ff_eff, 4 * cfg.d_model) * 2 * 4
        if stored + work < ACTIVATION_SHARE * rl.HBM_BYTES:
            return M
    return per_dev_batch


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------


class LocalFlopCounter(TorchDispatchMode):
    """Operations each rank runs itself, by ``torch.utils.flop_counter``'s
    formulas.  ``FlopCounterMode`` over DTensors counts the global op (2*4096^3
    for a product sharded (16, 16)); this mode divides an op on DTensors by the
    mesh dims its output is split or pending a sum over (``Shard``, ``Partial``:
    the work those ranks share), and leaves it whole over the dims it is
    replicated on (every rank does it), as the reference's per-device cost
    analysis counts replicated work.  An op on plain tensors (a kernel's plain
    version under ``local_map``, on the local shard) counts as it is.  It must
    be the innermost mode, so that it sees an op before DTensor splits it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(getattr(func, "_overloadpacket", None))
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            first = next((o for o in tree_flatten(out)[0]
                          if isinstance(o, torch.Tensor)), None)
            if isinstance(first, DTensor):
                n /= math.prod(size for size, p in zip(first.device_mesh.shape,
                                                       first.placements)
                               if not p.is_replicate())
            self.flops += n
        return out


_KINDS = {"all_reduce": "all_reduce", "all_gather_into_tensor": "all_gather",
          "reduce_scatter_tensor": "reduce_scatter", "all_to_all_single": "all_to_all"}


class CommCounter(CommDebugMode):
    """DTensor's ``CommDebugMode`` that also sums, by kind, the local bytes each
    collective takes in (per execution: a collective in a loop counts at every
    trip)."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented:
            name = str(getattr(func, "_overloadpacket", func)).rsplit(".", 1)[-1]
            kind = _KINDS.get(name)
            if kind and args and isinstance(args[0], torch.Tensor):
                self.bytes[kind] = self.bytes.get(kind, 0.0) + \
                    args[0].numel() * args[0].element_size()
        return out

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for k, v in self.get_comm_counts().items():
            kind = _KINDS.get(str(k).rsplit(".", 1)[-1], str(k).rsplit(".", 1)[-1])
            if v:
                out[kind] = out.get(kind, 0) + v
        return out


@contextlib.contextmanager
def fake_group(world: int):
    """The default process group on torch's fake backend, ``world`` ranks, this
    process rank 0; destroyed on exit."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  registers "fake"
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# One step on fake tensors
# ---------------------------------------------------------------------------


def _tensors(tree) -> list[torch.Tensor]:
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def run_step(cfg: ArchConfig, shape: ShapeSpec, mesh, prof, *, microbatches: int,
             remat: str = "full") -> dict:
    """One step of ``cfg`` at ``shape`` on ``mesh`` under ``FakeTensorMode``: the
    rank's own flops, the collectives by kind (counts and bytes) and rank 0's
    tracked peak with its breakdown."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    ms = mesh_shape(mesh)
    if cfg.n_experts:
        # group-local MoE dispatch aligned with the data shards (the global
        # sort would gather every token -- see layers.moe_block)
        dp_ext = ms.get("data", 1) * ms.get("pod", 1)
        t_mb = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1) // microbatches
        if t_mb % dp_ext == 0:
            cfg = dataclasses.replace(cfg, moe_groups=dp_ext)
    with FakeTensorMode():
        model = LM(cfg, device="cpu")
        shd.distribute_params(model, shd.module_shardings(
            model, shd.param_shardings(model, mesh, prof.rules)))
        batch = {k: torch.zeros(s, dtype=torch.long if not dt.is_floating_point else dt)
                 for k, (s, dt) in cfg.input_specs(shape).items()}
        batch = distribute(batch, shd.batch_shardings(mesh, batch, prof.rules))
        held: list = [batch]
        if shape.kind == "train":
            state = abstract_train_state(model, shd.module_shardings(
                model, shd.opt_state_shardings(model, mesh, prof.opt_rules).m))
            held.append(state["opt"])
            step = make_train_step(model, AdamWConfig(), microbatches=microbatches,
                                   remat=remat, mesh=mesh, rules=prof.rules)
            call = lambda: step(state, batch)   # noqa: E731
        elif shape.kind == "prefill":
            prefill = make_prefill_step(model)
            call = lambda: prefill(batch)   # noqa: E731
        else:
            cache = model.init_cache(shape.global_batch, shape.seq_len, device="cpu")
            cache = distribute(cache, shd.cache_shardings(
                model, mesh, prof.rules, shape.global_batch, shape.seq_len))
            held.append(cache)
            serve = make_serve_step(model)
            call = lambda: serve(cache, batch)   # noqa: E731
        mem = MemTracker()
        mem.track_external(model, *[t for tree in held for t in _tensors(tree)])
        with mem, CommCounter() as comm, LocalFlopCounter() as fl:
            if shape.kind == "train":
                call()
            else:
                with torch.no_grad(), use_rules(mesh, prof.rules), \
                        implicit_replication():
                    call()
        peaks = mem.get_tracker_snapshot("peak")
    dev, peak = max(peaks.items(), key=lambda kv: kv[1]["Total"])
    return {"flops": fl.flops, "coll_counts": comm.counts(), "coll_bytes": comm.bytes,
            "peak_bytes": float(peak["Total"]),
            "peak_detail": {str(getattr(k, "value", k)): float(v)
                            for k, v in peak.items() if k != "Total"}}


def dry_run(cfg: ArchConfig, shape: ShapeSpec, mesh, *, mesh_name: str,
            arch: str | None = None, zero3: bool | None = None,
            microbatches: int | None = None, remat: str = "full") -> dict:
    """The cell's report on ``mesh`` (a ``DeviceMesh`` over the fake group):
    ZeRO-3 and the microbatches from the policy unless given, the step run,
    microbatches doubled while the tracked peak is above ``HBM_BYTES``."""
    ms = mesh_shape(mesh)
    model_extent = ms.get("model", 1)
    dp_extent = ms.get("data", 1) * ms.get("pod", 1)
    if zero3 is None:
        zero3 = needs_zero3(cfg, shape, model_extent)
    M = microbatches or choose_microbatches(cfg, shape, dp_extent)
    prof = shd.profile_for(cfg, mesh, zero3=zero3)
    per_dev_batch = max(shape.global_batch // dp_extent, 1)
    t0 = time.perf_counter()
    while True:
        got = run_step(cfg, shape, mesh, prof, microbatches=M, remat=remat)
        # memory-driven microbatch escalation (Eq. 6 applied after the step)
        if (got["peak_bytes"] <= rl.HBM_BYTES or shape.kind != "train"
                or M >= per_dev_batch):
            break
        M = min(M * 2, per_dev_batch)
    t_step = time.perf_counter() - t0
    rep = rl.build_report(
        arch=arch or cfg.name, shape=shape, mesh_name=mesh_name, mesh_shape=ms,
        cfg=cfg, flops=got["flops"], peak_bytes=got["peak_bytes"], zero3=zero3,
        zero1=True, microbatches=M, coll_counts=got["coll_counts"],
        coll_bytes=got["coll_bytes"], peak_detail=got["peak_detail"],
        remat_policy=remat)
    return {"status": "ok", "t_step_s": round(t_step, 1), "zero3": zero3,
            "microbatches": M, "remat": remat, "profile_notes": list(prof.notes),
            **rep.to_dict()}


def dry_run_cell(arch: str, shape_name: str, mesh_kind: str) -> dict:
    """One cell on the production mesh (``"single"``: (16, 16); ``"multi"``:
    (2, 16, 16)); the default process group must be a fake one of the mesh's
    size (:func:`fake_group`)."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    if shape not in cfg.shapes():
        reason = dict(cfg.skipped_shapes()).get(shape, "not applicable")
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skip", "reason": str(reason)}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
    out = dry_run(cfg, shape, mesh, mesh_name=mesh_kind, arch=arch)
    print(f"  peak (rank 0, tracked): {out['peak_bytes'] / 1e9:.2f} GB "
          f"-> fits{rl.HBM_BYTES / 1e9:g}GB={out['fits']} "
          f"(zero3={out['zero3']} M={out['microbatches']})")
    print(f"  flops/dev={out['flops']:.3e} bytes/dev={out['bytes']:.3e}")
    print(f"  roofline: compute={out['t_compute'] * 1e3:.1f}ms "
          f"memory={out['t_memory'] * 1e3:.1f}ms "
          f"collective={out['t_collective'] * 1e3:.1f}ms "
          f"-> {out['bottleneck']}-bound  useful={out['useful_ratio']:.2f}")
    print(f"  collectives (per execution): {out['coll_counts']}")
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    # the reference's flags: torch has no buffer donation and the port needs no
    # probe, so both are accepted and change nothing
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--out", type=Path, default=REPORTS)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES_BY_NAME)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    args.out.mkdir(parents=True, exist_ok=True)

    results = []
    for mk in meshes:
        with fake_group(512 if mk == "multi" else 256):
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch} × {shape} × {mk}"
                    print(f"[dryrun] {tag}", flush=True)
                    t0 = time.perf_counter()
                    try:
                        r = dry_run_cell(arch, shape, mk)
                    except Exception as e:  # noqa: BLE001 -- report, keep going
                        r = {"arch": arch, "shape": shape, "mesh": mk,
                             "status": "fail", "error": repr(e),
                             "trace": traceback.format_exc()[-2000:]}
                        print(f"  FAIL: {e!r}")
                    r["wall_s"] = round(time.perf_counter() - t0, 1)
                    results.append(r)
                    path = args.out / f"{arch}.{shape}.{mk}.json"
                    path.write_text(json.dumps(r, indent=1, default=str))
                    print(f"  -> {r['status']} ({r['wall_s']}s)", flush=True)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"\n[dryrun] done: {n_ok} ok, {n_skip} skip, {n_fail} FAIL "
          f"of {len(results)} cells")
    if n_fail:
        for r in results:
            if r["status"] == "fail":
                print(f"  FAILED {r['arch']} {r['shape']} {r['mesh']}: "
                      f"{r['error']}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
