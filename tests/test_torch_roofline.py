"""The port's roofline arithmetic (``repro_torch.launch.roofline``), dry-run
policy (``launch.dryrun``) and table (``launch.summarize``) against the
reference's: the analytic terms equal for every architecture x shape x mesh, the
memory policy's decisions equal with the reference's 16 GB, the port's own
link-pricing rule on hand-worked cases, and the summary table equal on the same
report dicts."""

import pytest

pytest.importorskip("torch")

import repro.launch.dryrun as jdryrun  # noqa: E402
import repro.launch.roofline as jrl  # noqa: E402
import repro.launch.summarize as jsummarize  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.config import SHAPES_BY_NAME as JAX_SHAPES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, roofline as rl, summarize  # noqa: E402
from repro_torch.models.config import SHAPES_BY_NAME  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES_BY_NAME]


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_terms_are_the_references(arch, shape):
    """``analytic_hbm_bytes`` (ZeRO-3 on and off, 1 and 4 microbatches, remat full
    and none, attention fused and not), ``analytic_collectives`` (ZeRO-1 on and
    off), ``recurrent_correction`` and ``model_flops_estimate``: each term within
    1e-12 of the reference's, relative, on every mesh."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    sh, jsh = SHAPES_BY_NAME[shape], JAX_SHAPES[shape]
    for ms in MESHES.values():
        for zero3 in (True, False):
            for M in (1, 4):
                for remat in ("full", "none"):
                    for fused in (False, True):
                        kw = dict(zero3=zero3, microbatches=M, remat=remat,
                                  attn_fused=fused)
                        _close(rl.analytic_hbm_bytes(cfg, sh, ms, **kw),
                               jrl.analytic_hbm_bytes(jcfg, jsh, ms, **kw))
            for zero1 in (True, False):
                kw = dict(zero3=zero3, zero1=zero1, microbatches=2)
                _close(rl.analytic_collectives(cfg, sh, ms, **kw),
                       jrl.analytic_collectives(jcfg, jsh, ms, **kw))
        _close(rl.recurrent_correction(cfg, sh, ms),
               jrl.recurrent_correction(jcfg, jsh, ms))
    assert rl.model_flops_estimate(cfg, sh) == pytest.approx(
        jrl.model_flops_estimate(jcfg, jsh), rel=1e-12, abs=0)


@pytest.mark.parametrize("enc", [None, 3])
def test_combine_probe_costs_is_the_references(enc):
    f1 = {"flops": 3.5e12, "bytes": 7.25e9}
    f2 = {"flops": 5.0e12, "bytes": 9.0e9}
    fe = {"flops": 4.25e12, "bytes": 8.0e9}
    kw = dict(f1=f1, f2=f2, n_cycles=14, microbatches=4)
    if enc:
        kw.update(f_enc1=fe, n_enc=enc)
    _close(rl.combine_probe_costs(**kw), jrl.combine_probe_costs(**kw))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_memory_policy_at_16gb_is_the_references(arch, shape, monkeypatch):
    """With ``HBM_BYTES = 16e9`` the shares give the reference's 6 GB thresholds:
    ``needs_zero3`` and ``choose_microbatches`` decide as the reference's on every
    model and data extent; at the H100's 80 GB the thresholds are 30 GB."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    sh, jsh = SHAPES_BY_NAME[shape], JAX_SHAPES[shape]
    monkeypatch.setattr(rl, "HBM_BYTES", 16e9)
    assert dryrun.RESIDENT_SHARE * rl.HBM_BYTES == 6e9
    for ext in (1, 2, 4, 8, 16, 32):
        assert dryrun.needs_zero3(cfg, sh, ext) == jdryrun.needs_zero3(jcfg, jsh, ext)
        assert dryrun.choose_microbatches(cfg, sh, ext) == \
            jdryrun.choose_microbatches(jcfg, jsh, ext)
    monkeypatch.setattr(rl, "HBM_BYTES", 80e9)
    assert dryrun.RESIDENT_SHARE * rl.HBM_BYTES == 30e9


def test_the_h100_constants():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.HBM_BYTES) == (989e12, 3.35e12, 80e9)
    assert (rl.NVLINK_BW, rl.IB_BW, rl.NODE_GPUS) == (450e9, 50e9, 8)


@pytest.mark.parametrize("mesh,axis,bw", [
    ({"data": 2, "model": 4}, "model", 450e9),       # innermost, within a node
    ({"data": 2, "model": 4}, "data", 50e9),         # outer axis: across nodes
    ({"data": 16, "model": 16}, "model", 50e9),      # innermost but 16 > 8
    ({"data": 16, "model": 16}, "data", 50e9),
    ({"pod": 2, "data": 16, "model": 16}, "pod", 50e9),
    ({"data": 32, "model": 8}, "model", 450e9),      # exactly one node
    ({"data": 8}, "data", 450e9),                    # a lone axis is innermost
])
def test_link_pricing(mesh, axis, bw):
    assert rl.link_bw(axis, mesh) == bw


def test_collective_seconds_hand_worked():
    """(2, 4): 9e9 B on "model" over NVLink = 20 ms; 1.5e9 B on "data" over IB
    in two classes = 30 ms, serialised within the axis; the term is the slower
    axis.  On (16, 16) the same "model" traffic rides IB: 180 ms."""
    vol = {"tp_allreduce_model": 9e9, "dp_reduce_scatter_data": 1e9,
           "dp_all_gather_data": 0.5e9}
    assert rl.collective_seconds(vol, {"data": 2, "model": 4}) == \
        pytest.approx(max(9e9 / 450e9, 1.5e9 / 50e9))
    assert rl.collective_seconds(vol, {"data": 16, "model": 16}) == \
        pytest.approx(9e9 / 50e9)
    assert rl.collective_seconds({}, {"data": 2}) == 0.0


REPORT_ROWS = [
    {"arch": "qwen2_7b", "shape": "train_4k", "mesh": "single", "status": "ok",
     "t_compute": 1.2263, "t_memory": 0.4629, "t_collective": 0.5303,
     "bottleneck": "compute", "useful_ratio": 0.1434, "fits": True, "zero3": False,
     "microbatches": 4},
    {"arch": "qwen2_7b", "shape": "decode_32k", "mesh": "multi", "status": "ok",
     "t_compute": 0.0042, "t_memory": 0.0125, "t_collective": 0.00031,
     "bottleneck": "memory", "useful_ratio": 0.91, "fits": False, "zero3": True,
     "microbatches": 1},
    {"arch": "gemma_7b", "shape": "long_500k", "mesh": "single", "status": "skip",
     "reason": "pure full-attention arch: 500k needs a sub-quadratic kernel"},
    {"arch": "dbrx_132b", "shape": "prefill_32k", "mesh": "single", "status": "fail",
     "error": "RuntimeError('something went wrong in the step')"},
    {"arch": "dbrx_132b", "shape": "train_4k", "mesh": "multi", "status": "ok",
     "t_compute": 12.5, "t_memory": 3.25, "t_collective": 40.0,
     "bottleneck": "collective", "useful_ratio": 0.5, "fits": True, "zero3": True,
     "microbatches": 16},
]


def test_summarize_table_is_the_references():
    assert summarize.table(REPORT_ROWS) == jsummarize.table(REPORT_ROWS)
    assert summarize.fmt_ms(0.0123) == jsummarize.fmt_ms(0.0123)
    assert summarize.fmt_ms(12.5) == jsummarize.fmt_ms(12.5)
