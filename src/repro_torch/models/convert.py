"""Parameter exchange with the reference's tree layout.

The reference keeps its parameters as nested dicts: ``embed.tok``,
``final_norm`` and one ``pos{p}`` per pattern position whose leaves
(``attn.*``, ``ffn.*``) carry a leading ``n_cycles`` dim.  Layer
``i = c * cycle_len + p`` of :class:`repro_torch.models.lm.LM` is slice ``c`` of
``pos{p}``.  Arrays cross as numpy; shapes are identical on both sides
(``wq (d,H,hd)`` and so on), so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import LM


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _targets(model: LM) -> dict[str, list[torch.nn.Parameter]]:
    """Reference leaf path -> the module's parameters it holds, one per
    slice of its leading dim (a single one for unstacked leaves)."""
    cfg = model.cfg
    out = {"embed.tok": [model.embed["tok"]],
           "final_norm": [model.final_norm]}
    for p in range(cfg.cycle_len):
        layers = [model.blocks[c * cfg.cycle_len + p]
                  for c in range(cfg.n_cycles)]
        for group in ("attn", "ffn"):
            for name in getattr(layers[0], group).keys():
                out[f"pos{p}.{group}.{name}"] = [
                    getattr(blk, group)[name] for blk in layers]
    return out


@torch.no_grad()
def load_jax_params(model: LM, params_np: dict) -> LM:
    """Copy the reference's parameter tree (nested dicts of numpy arrays)
    into ``model``.  Raises on a missing, extra or mis-shaped leaf."""
    leaves = _leaves(params_np)
    targets = _targets(model)
    missing = sorted(set(targets) - set(leaves))
    extra = sorted(set(leaves) - set(targets))
    if missing or extra:
        raise KeyError(f"load_jax_params: missing leaves {missing}, "
                       f"unexpected leaves {extra}")
    for path, params in targets.items():
        arr = np.asarray(leaves[path])
        stacked = path.startswith("pos")
        want = ((len(params),) if stacked else ()) + tuple(params[0].shape)
        if arr.shape != want:
            raise ValueError(f"load_jax_params: {path} has shape "
                             f"{arr.shape}, expected {want}")
        src = torch.from_numpy(np.array(arr, dtype=np.float32))
        for c, prm in enumerate(params):
            prm.copy_(src[c] if stacked else src)
    return model


@torch.no_grad()
def export_jax_params(model: LM) -> dict:
    """The reverse of :func:`load_jax_params`: the reference's tree as nested
    dicts of float32 numpy arrays."""
    out: dict = {}
    for path, params in _targets(model).items():
        arrs = [p.detach().float().cpu().numpy() for p in params]
        leaf = np.stack(arrs) if path.startswith("pos") else arrs[0]
        node = out
        *parents, last = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out
