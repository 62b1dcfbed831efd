"""Gloo CPU ranks for the port's multi-rank tests: ``run_ranks`` starts fresh
interpreters joined by one ``torch.distributed`` process group over a localhost
rendezvous, each under a time limit (a hung rank fails the case and every rank
is killed), and asserts inside them; the pytest process itself never joins a
group."""

import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
# a case takes 3-20 s alone; the limit leaves room for a loaded machine and still
# ends a hung rank long before the test run's own limit
RANK_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# torch 2.11's DTensor (the CUDA build the port runs on) refuses a view that
# flattens a sharded dim other than the first of the flattened group, where later
# versions make a strided shard of it; ``run_ranks(..., strict_views=True)`` holds
# the ranks' DTensor to that rule, so such a view fails here as it does on the card
STRICT_VIEWS = """
import torch.distributed.tensor._ops._view_ops as _views
_flatten = _views._ViewShardingPropagator._analyze_flatten
def _strict_flatten(self, cmd):
    if self.strict_view:
        for dim in cmd.input_dims[1:]:
            if self._find_plain_shard(dim)[0] is not None:
                raise RuntimeError(f"a view flattens dim {dim.input_dim}, sharded and "
                                   f"not the first of its group")
    return _flatten(self, cmd)
_views._ViewShardingPropagator._analyze_flatten = _strict_flatten
"""


def run_ranks(body: str, n: int, timeout: float = RANK_TIMEOUT_S, *,
              strict_views: bool = False) -> list[str]:
    """Run ``body`` in ``n`` fresh interpreters, ranks of one gloo group (``RANK``
    and ``WORLD`` are defined in it); every rank must exit 0 within ``timeout``
    seconds.  Returns each rank's output.  ``strict_views``: DTensor's views
    under torch 2.11's rule (:data:`STRICT_VIEWS`)."""
    head = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        RANK, WORLD = int(sys.argv[1]), {n}
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{_free_port()}",
                                world_size=WORLD, rank=RANK)
    """) + (STRICT_VIEWS if strict_views else "")
    code = head + textwrap.dedent(body) + "\ndist.destroy_process_group()\n"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(n)]
    deadline, outs = time.monotonic() + timeout, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a rank did not finish within {timeout} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-6000:]}"
    return outs
