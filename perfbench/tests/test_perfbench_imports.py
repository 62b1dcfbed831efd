"""Nothing under ``perfbench/`` imports JAX or the JAX package, and the yardstick
(the reference, the feed, the weights, the counts, the comparison, the trace
reader, the metrics' readers) imports nothing of the program either.  Module names
are compared by their whole top-level name: ``repro_torch`` is not ``repro``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the files that drive the program; every other one is the yardstick
PROGRAM_SIDE = {"harness/train_cell.py", "calibrate.py", "tests/cpu_cells.py",
           "tests/test_perfbench_reference.py", "tests/test_perfbench_faults.py",
           "tests/test_perfbench_control.py", "tests/test_perfbench_reference_module.py"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted(p for p in BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_a_program_free_yardstick(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN
    if str(path.relative_to(BENCH)) not in PROGRAM_SIDE:
        assert "repro_torch" not in names


def test_the_check_compares_whole_top_level_names():
    assert {"repro_torch"} & FORBIDDEN == set()
    assert top_level_imports(BENCH / "harness" / "train_cell.py") >= {"harness"}
