"""Rules every slice of the port keeps: the package, ``chip_smoke.py`` and the
port's example import nothing of JAX or of the JAX package, and the package
calls no library kernel in place of its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "examples" / "serve_torch.py",
           ROOT / "examples" / "train_e2e_torch.py",
           ROOT / "examples" / "dynamic_network_torch.py",
           ROOT / "examples" / "quickstart_torch.py",
           ROOT / "tools" / "profile_serve_torch.py", ROOT / "tools" / "profile_train_torch.py",
           ROOT / "tools" / "flash_bench.py", ROOT / "tools" / "flash_bwd_phases.py",
           ROOT / "tools" / "flash_fwd_phases.py", ROOT / "tools" / "flash_hd80_variants.py",
           ROOT / "tools" / "count_collectives.py", ROOT / "tools" / "train_mesh_norm.py",
           ROOT / "tools" / "calibrate_fabric_torch.py",
           ROOT / "tools" / "fig3_allreduce_torch.py"]
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}
FORBIDDEN_CALLS = ("scaled_dot_product_attention", "rms_norm", "compile")


def _imports(tree: ast.AST):
    for node in ast.walk(tree):            # nested imports included
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _rel(p: Path) -> str:
    return str(p.relative_to(ROOT))


def test_package_is_there():
    assert len(PACKAGE) >= 20
    assert all(p.is_file() for p in SCRIPTS)


@pytest.mark.parametrize("path", PACKAGE + SCRIPTS, ids=_rel)
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree) if m.split(".")[0] in FORBIDDEN_ROOTS]
    assert not bad, f"{_rel(path)} imports {bad}"


@pytest.mark.parametrize("path", PACKAGE, ids=_rel)
def test_package_calls_no_library_kernel(path):
    """No F.scaled_dot_product_attention, F.rms_norm / torch.rms_norm or
    torch.compile anywhere in the package (attribute access or import)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in FORBIDDEN_CALLS:
            owner = node.value
            name = getattr(owner, "id", getattr(owner, "attr", ""))
            if name in ("F", "torch", "functional", "nn"):
                bad.append(f"{name}.{node.attr}")
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("torch"):
            bad += [a.name for a in node.names if a.name in FORBIDDEN_CALLS]
    assert not bad, f"{_rel(path)} uses {bad}"


def test_package_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            f"sys.path.insert(0, {str(ROOT / 'src')!r}); "
            "import repro_torch.models.lm, repro_torch.models.convert, "
            "repro_torch.kernels.ops, repro_torch.configs, "
            "repro_torch.parallel.trainstep, repro_torch.optim.adamw, "
            "repro_torch.data.pipeline, repro_torch.checkpoint.store, "
            "repro_torch.runtime.trainer, repro_torch.launch.train, "
            "repro_torch.core, repro_torch.obs, repro_torch.scenarios, "
            "repro_torch.scenarios.harness, repro_torch.service, "
            "repro_torch.parallel.axes, repro_torch.parallel.sharding, "
            "repro_torch.launch.mesh, repro_torch.parallel.collectives, "
            "repro_torch.parallel.pipeline, repro_torch.launch.roofline, "
            "repro_torch.launch.dryrun, repro_torch.launch.summarize; "
            "print(len(repro_torch.configs.all_configs()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "10"


def test_quickstart_runs_on_the_cpu():
    """examples/quickstart_torch.py, the twin of examples/quickstart.py: the plan
    on 4 RTX4090D + 4 V100, then the Trainer on the reduced config.  One thread:
    ~6 s alone; torch's default of a thread per core stalls it on a machine whose
    cores the other test workers hold."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
                          "--device", "cpu"], capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "best plan" in out.stdout and "predicted step" in out.stdout
    first, last = map(float, out.stdout.strip().splitlines()[-1].split()[1::2])
    assert last < first


def test_chip_smoke_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


KERNEL_SOURCES = sorted(p for p in (ROOT / "src" / "repro_torch" / "kernels" / "csrc").iterdir()
                        if p.suffix in (".cu", ".cuh"))
REPLACED = ("src/repro/kernels/rmsnorm.py", "src/repro/kernels/flash_attention.py")
#: the sources that replace no TPU kernel, and the reference's code each stands for
NO_TPU_KERNEL = {"src/repro_torch/kernels/csrc/adamw.cu":
                 "src/repro/optim/adamw.py (adamw_update)",
                 "src/repro_torch/kernels/csrc/ssd.cu":
                 "src/repro/models/layers.py (_mamba_scan)"}


@pytest.mark.parametrize("path", KERNEL_SOURCES, ids=_rel)
def test_kernel_sources_name_what_they_replace(path):
    """Every CUDA source's header note names the TPU kernel it replaces (file and
    function), and what bounds it on this card; the fused AdamW and the chunked SSD,
    which replace none, name the reference's code they stand for (``NO_TPU_KERNEL``)."""
    head = path.read_text().split("#include")[0]
    if _rel(path) in NO_TPU_KERNEL:
        assert f"Replaces no TPU kernel: it stands for {NO_TPU_KERNEL[_rel(path)]}" in head
    else:
        assert any(r in head for r in REPLACED), f"{_rel(path)} names no TPU kernel"
        assert "_kernel" in head, f"{_rel(path)} names no TPU kernel function"
    assert "Bound on this card" in head
