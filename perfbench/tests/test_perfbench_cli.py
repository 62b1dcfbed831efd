"""The command refuses to measure where it cannot: with no CUDA device it exits
non-zero and prints no result; in a directory that holds only ``BENCHMARK.json``
and the benchmark's files (no program) likewise."""

import json
import os
import shutil
import subprocess
import sys

from harness import spec

CELL = spec.benchmark()["workloads"][0]["name"]


def run(cwd, env=None):
    cmd = [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed", str(2**31 + 3),
           "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=env)


def no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


def test_exits_non_zero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = run(spec.ROOT, env)
    assert done.returncode != 0
    assert no_result(done.stdout)
    assert "CUDA device" in done.stderr


def test_exits_non_zero_with_the_benchmark_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = run(tmp_path)
    assert done.returncode != 0
    assert no_result(done.stdout)
