"""Train-state checkpoints in the reference's on-disk format, with async save.

``arrays.npz`` holds one array per leaf, keyed by the ``|``-joined path of the
leaf in the state tree, exactly as the reference's ``checkpoint/store.py``
writes it: dict keys as they are, a NamedTuple's fields as ``.name`` (so
``params|pos0|attn|wq``, ``opt|.m|embed|tok``, ``opt|.step``).  bf16 leaves are
written as float32 (npz has no bf16) and cast back through ``like`` on restore.
``manifest.json`` holds the step, the plan and the keys.  So a checkpoint that one
package writes, the other restores.

The tree is the reference's layout (stacked ``pos{p}`` leaves):
``models.convert.export_jax_train_state`` makes it from the port's train state,
``models.convert.load_jax_train_state`` takes it back.  Leaves may be torch
tensors (any device), numpy arrays, or DTensors, which are written whole
(gathered from their shards).  ``restore(..., shardings=...)`` places every
restored leaf under a sharding, so that a state checkpointed on one layout
reshards onto another.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.parallel.axes import distribute

Pytree = Any
_SEP = "|"


def _items(tree: Pytree, prefix: tuple = ()):
    """(path, leaf) pairs; a NamedTuple field is spelled ``.name`` as JAX does."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _items(getattr(tree, k), prefix + (f".{k}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _map(fn, tree: Pytree, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, k), prefix + (f".{k}",))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, prefix + (str(i),)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _to_numpy(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host array (bf16 as float32); ``copy``: never a view of it."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if leaf.dtype == torch.bfloat16:     # npz has no native bf16
            leaf = leaf.float()
        return leaf.to("cpu", copy=copy).numpy()
    arr = np.array(leaf, copy=copy) if copy else np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _flatten(tree: Pytree) -> dict[str, np.ndarray]:
    return {_SEP.join(path): _to_numpy(leaf) for path, leaf in _items(tree)}


def save(path: str | Path, state: Pytree, *, step: int,
         plan_json: str = "", extra: dict | None = None) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = _flatten(state)
    tmp = path / ".tmp.arrays.npz"
    np.savez(tmp, **flat)
    tmp.rename(path / "arrays.npz")      # atomic-ish publish
    manifest = {"step": step, "plan": plan_json,
                "treedef": "repro_torch: " + ", ".join(sorted(flat)),
                "keys": sorted(flat), "time": time.time(), **(extra or {})}
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))


class AsyncSaver:
    """Background checkpoint writes, one in flight.  ``submit`` copies the state
    to the host before it returns (training may then change it); a failed write
    is raised by the next ``wait`` or ``submit``."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def submit(self, path, state, *, step: int, plan_json: str = "") -> None:
        self.wait()
        host_state = _map(lambda _, leaf: _to_numpy(leaf, copy=True), state)
        self._thread = threading.Thread(
            target=self._write, args=(path, host_state, step, plan_json), daemon=True)
        self._thread.start()

    def _write(self, path, state, step, plan_json) -> None:
        try:
            save(path, state, step=step, plan_json=plan_json)
        except Exception as exc:   # handed to the caller by wait()
            self._error = exc

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def restore(path: str | Path, like: Pytree, *,
            shardings: Pytree = None) -> tuple[Pytree, dict]:
    """Restore into the structure of ``like``: each leaf takes ``like``'s dtype
    (a torch leaf gives a CPU tensor, a numpy leaf a numpy array).  Raises on a
    missing key or a shape that differs.

    ``shardings``: a tree of ``like``'s structure whose leaves are
    ``parallel.axes.NamedSharding`` objects; each restored leaf is then a DTensor
    under its sharding (the elastic reshard onto a new layout)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as data:
        def take(prefix, leaf):
            key = _SEP.join(prefix)
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"restore: {key} has shape {arr.shape}, "
                                 f"expected {tuple(leaf.shape)}")
            if isinstance(leaf, torch.Tensor):
                return torch.from_numpy(np.array(arr)).to(leaf.dtype)
            return arr.astype(leaf.dtype)
        tree = _map(take, like)
    if shardings is not None:
        tree = distribute(tree, shardings)
    return tree, manifest


def latest_step(root: str | Path) -> int | None:
    root = Path(root)
    steps = [int(p.name.split("_")[-1]) for p in root.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None
