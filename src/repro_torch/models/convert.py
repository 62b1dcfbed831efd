"""Parameter and train-state exchange with the reference's tree layout.

The reference keeps its parameters as nested dicts: ``embed.tok``,
``final_norm`` and one ``pos{p}`` per pattern position whose leaves
(``attn.*``, ``ffn.*``, ``moe.*``, ``cross.*``, ``mamba.*``, ``mlstm.*``,
``slstm.*``, zamba2's ``in_proj``) carry a leading ``n_cycles`` dim; zamba2 adds
``shared.*`` (held once, not stacked), whisper ``encoder.*`` (leading
``encoder_layers`` dim) and ``enc_norm``.  Layer ``i = c * cycle_len + p`` of
:class:`repro_torch.models.lm.LM` is slice ``c`` of ``pos{p}``, encoder layer
``j`` slice ``j`` of ``encoder``.  Arrays cross as numpy; shapes are identical
on both sides (``wq (d,H,hd)``, ``router (d,E)``, ``w_gate (E,d,f)``, ``gate
(1,)`` and so on), so nothing is transposed.

The train state is ``{"params": ..., "opt": OptState(m, v, step)}`` on both sides;
in the port ``params``, ``m`` and ``v`` are dicts keyed by the module's parameter
names (``blocks.3.attn.wq``), in the reference trees of the layout above.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.lm import LM
from repro_torch.optim.adamw import OptState


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def is_stacked(path: str) -> bool:
    """Whether a reference leaf carries a leading layer dim."""
    return path.startswith(("pos", "encoder."))


def target_names(model: LM) -> dict[str, list[str]]:
    """Reference leaf path -> the names of the module's parameters it holds, one
    per slice of its leading dim (a single one for unstacked leaves)."""
    cfg = model.cfg
    out = {"embed.tok": ["embed.tok"], "final_norm": ["final_norm"]}
    stacks = [(f"pos{p}", [f"blocks.{c * cfg.cycle_len + p}" for c in range(cfg.n_cycles)])
              for p in range(cfg.cycle_len)]
    if cfg.encoder_layers:
        stacks.append(("encoder", [f"encoder.{j}" for j in range(cfg.encoder_layers)]))
    for root, layers in stacks:
        for name, _ in model.get_submodule(layers[0]).named_parameters():
            out[f"{root}.{name}"] = [f"{lyr}.{name}" for lyr in layers]
    if "shared_attn" in cfg.pattern:
        out.update({f"shared.{name}": [f"shared.{name}"]
                    for name, _ in model.shared.named_parameters()})
    if cfg.encoder_layers:
        out["enc_norm"] = ["enc_norm"]
    return out


def _targets(model: LM) -> dict[str, list[torch.nn.Parameter]]:
    """Reference leaf path -> the module's parameters it holds."""
    return {path: [model.get_parameter(n) for n in names]
            for path, names in target_names(model).items()}


def _nest(flat: dict) -> dict:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _leaf_tensor(leaves: dict, path: str, want: tuple) -> torch.Tensor:
    """The leaf at dotted ``path`` (numpy array or tensor) as float32 on the CPU,
    or a DTensor leaf as a float32 DTensor where it lies; raises if its shape is
    not ``want``."""
    arr = leaves[path]
    if isinstance(arr, DTensor):
        t = arr.detach().float()
    elif isinstance(arr, torch.Tensor):
        t = arr.detach().float().cpu()
    else:
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
    if tuple(t.shape) != want:
        raise ValueError(f"{path} has shape {tuple(t.shape)}, expected {want}")
    return t


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
        stacked = is_stacked(path)
        want = ((len(params),) if stacked else ()) + tuple(params[0].shape)
        src = _leaf_tensor(leaves, path, want)
        for c, prm in enumerate(params):
            prm.copy_(src[c] if stacked else src)
    return model


@torch.no_grad()
def export_jax_tree(model: LM, named: dict) -> dict:
    """Tensors keyed by the module's parameter names (parameters, their gradients
    or moments) -> the reference's tree of float32 numpy arrays (``pos{p}`` leaves
    stacked)."""
    flat = {}
    for path, names in target_names(model).items():
        arrs = [named[n].detach().float().cpu().numpy() for n in names]
        flat[path] = np.stack(arrs) if is_stacked(path) else arrs[0]
    return _nest(flat)


def export_jax_params(model: LM) -> dict:
    """The reverse of :func:`load_jax_params`: the reference's tree as nested
    dicts of float32 numpy arrays."""
    return export_jax_tree(model, dict(model.named_parameters()))


@torch.no_grad()
def _import_moments(model: LM, tree) -> dict:
    """A reference moment tree -> float32 tensors keyed by parameter name, on the
    model's device (DTensor leaves: DTensors in the leaf's placements, less its
    stacked dim)."""
    leaves, targets = _leaves(tree), target_names(model)
    if set(leaves) != set(targets):
        raise KeyError(f"moments: missing leaves {sorted(set(targets) - set(leaves))}, "
                       f"unexpected leaves {sorted(set(leaves) - set(targets))}")
    out = {}
    for path, names in targets.items():
        params = [model.get_parameter(n) for n in names]
        stacked = is_stacked(path)
        src = _leaf_tensor(leaves, path, ((len(names),) if stacked else ())
                           + tuple(params[0].shape))
        for c, (n, prm) in enumerate(zip(names, params)):
            t = src[c] if stacked else src
            out[n] = t.clone() if isinstance(t, DTensor) else \
                t.to(prm.device, torch.float32).clone()
    return out


def load_jax_train_state(model: LM, tree: dict) -> dict:
    """The reference's train state ``{"params": tree, "opt": OptState(m, v,
    step)}`` (numpy arrays, torch tensors, or a restored checkpoint; ``opt`` may
    be the reference's OptState or anything with fields m, v, step) -> the
    port's: the parameters are copied into ``model`` and its own parameters are
    the state's ``params``."""
    load_jax_params(model, tree["params"])
    opt = tree["opt"]
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    step = int(opt.step.full_tensor() if isinstance(opt.step, DTensor)
               else np.asarray(opt.step))
    step = torch.tensor(step, dtype=torch.int32, device=dev)
    return {"params": params,
            "opt": OptState(_import_moments(model, opt.m), _import_moments(model, opt.v),
                            step)}


def export_jax_train_state(model: LM, state: dict) -> dict:
    """The port's train state -> the reference's layout, float32 numpy leaves
    (the step int32): what ``checkpoint.store.save`` writes."""
    opt = state["opt"]
    return {"params": export_jax_tree(model, state["params"]),
            "opt": OptState(export_jax_tree(model, opt.m), export_jax_tree(model, opt.v),
                            np.asarray(opt.step.detach().cpu().numpy(), dtype=np.int32))}


def jax_train_state_like(model: LM) -> dict:
    """The shapes and dtypes of the reference's train state for ``model`` as meta
    tensors (parameters in the model's dtype, moments fp32, step int32): the
    ``like`` that ``checkpoint.store.restore`` casts to."""
    def tree(dtype=None):
        flat = {}
        for path, names in target_names(model).items():
            prm = model.get_parameter(names[0])
            shape = ((len(names),) if is_stacked(path) else ()) + tuple(prm.shape)
            flat[path] = torch.empty(shape, dtype=dtype or prm.dtype, device="meta")
        return _nest(flat)
    return {"params": tree(),
            "opt": OptState(tree(torch.float32), tree(torch.float32),
                            torch.empty((), dtype=torch.int32, device="meta"))}
