"""Train / prefill / serve step makers (the reference's ``parallel/trainstep.py``).

``make_train_step`` builds one optimizer step: microbatched gradient
accumulation (a Python loop in place of ``lax.scan``), global-norm clipping,
AdamW, metrics.  Given a mesh and its rules, the train step runs on DTensors
under ``use_rules`` (the model's ``shard`` sites redistribute its activations)
and ``implicit_replication`` (a plain tensor made inside the step, such as the
positions or a scalar, counts as replicated); without one, on plain tensors of
one device.

The reference's steps take the parameter tree as their first argument; here the
parameters live in the ``LM`` module.  The train state's ``params`` are the
module's own parameter tensors (``init_train_state``), updated in place by the
step; the serving steps take only what changes from call to call.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.parallel.axes import AxisRules, use_rules

MOD_KEYS = ("audio_embed", "vision_embed")


def _split_mods(model: LM, batch: dict) -> tuple[dict, dict]:
    """(the batch without its modality inputs, those inputs in the model's dtype
    on its device).  The kernels take one dtype, so an fp32 embedding meets a
    bf16 model as bf16; JAX would instead promote the bf16 x f32 products of
    the memory's projections to f32.  In float32 the two agree."""
    param = model.embed["tok"]
    mods = {k: v.to(param.device, param.dtype) for k, v in batch.items()
            if k in MOD_KEYS}
    rest = {k: v for k, v in batch.items() if k not in MOD_KEYS}
    return rest, mods


@torch.no_grad()
def _bind_params(model: LM, params: dict) -> dict:
    """The model's own parameters holding ``params``' values: a state whose
    tensors are not the model's (one restored from a checkpoint) is copied in."""
    own = dict(model.named_parameters())
    if own.keys() != params.keys():
        raise KeyError(f"train state params {sorted(set(params) ^ set(own))} do not "
                       "match the model's")
    for name, t in params.items():
        if t is not own[name]:
            own[name].copy_(t)
    return own


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(model: LM, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1,
                    remat: str = "selective", mesh: Any = None,
                    rules: AxisRules | None = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state = {"params": {name: tensor}, "opt": OptState}``;
    ``batch = {"tokens": (B,S) int, "labels": (B,S) int}`` and, for the models
    with cross-attention, ``audio_embed`` or ``vision_embed``.  With
    ``microbatches`` M > 1 the batch is cut into M row blocks whose gradients are
    summed in fp32 and divided by M, as the loss is.  Metrics (0-d tensors on the
    device, plain also on a mesh): ``loss``, ``grad_norm``, ``lr``, ``tokens``.
    With ``mesh`` the state and batch are DTensors (``runtime.trainer`` places
    them) and the step runs under ``rules``.
    """

    def loss_fn(mb: dict) -> torch.Tensor:
        rest, mods = _split_mods(model, mb)
        return model.loss(rest["tokens"], rest["labels"], remat=remat, **mods)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        if mesh is None:
            return _train_step(state, batch)
        with use_rules(mesh, rules), implicit_replication():
            return _train_step(state, batch)

    def _train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = _bind_params(model, state["params"])
        leaves = list(params.values())
        M = microbatches
        if M == 1:
            loss = loss_fn(batch)
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
        else:
            n = batch["tokens"].shape[0] // M
            loss, grads = 0.0, None
            for i in range(M):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_i = loss_fn(mb)
                g_i = [g.float() for g in torch.autograd.grad(l_i, leaves)]
                if grads is None:
                    grads = g_i
                else:
                    for acc, g in zip(grads, g_i):
                        acc.add_(g)
                loss = loss + l_i.detach()
            loss = loss / M
            for acc in grads:
                acc.div_(M)
        new_params, new_opt, om = adamw_update(params, dict(zip(params, grads)),
                                               state["opt"], opt_cfg)
        tokens = batch["tokens"]
        metrics = {"loss": _plain(loss), **om,
                   "tokens": torch.tensor(float(tokens.shape[0] * tokens.shape[1]),
                                          dtype=torch.float32)}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_train_state(model: LM, generator: torch.Generator) -> dict:
    """Random-initialise ``model`` from ``generator``; its parameters and zeroed
    moments are the state."""
    model.init(generator)
    params = dict(model.named_parameters())
    return {"params": params, "opt": init_opt_state(params)}


def abstract_train_state(model: LM, opt_shardings: dict | None = None) -> dict:
    """``model``'s train state without drawing its weights: its own parameters as
    they are and zeroed moments, under ``opt_shardings`` (parameter name ->
    ``NamedSharding``) when given.  Built under ``FakeTensorMode`` it holds no
    storage, as the reference's ``ShapeDtypeStruct`` state does (the dry run)."""
    params = dict(model.named_parameters())
    return {"params": params, "opt": init_opt_state(params, opt_shardings)}


def make_prefill_step(model: LM) -> Callable:
    """Returns ``prefill_step(batch) -> (last-token logits, stacked cache)``;
    ``batch = {"tokens": (B,S) int, [audio_embed | vision_embed]}``."""
    def prefill_step(batch: dict):
        rest, mods = _split_mods(model, batch)
        return model.prefill(rest["tokens"], **mods)
    return prefill_step


def make_serve_step(model: LM) -> Callable:
    """Returns ``serve_step(cache, batch) -> (logits, cache)``;
    ``batch = {"tokens": (B,1) int, "pos": (B,) int, [audio_embed |
    vision_embed]}``.  The cache is the flat per-layer tuple and is updated in
    place."""
    def serve_step(cache, batch: dict):
        rest, mods = _split_mods(model, batch)
        return model.decode_step(cache, rest["tokens"], rest["pos"], **mods)
    return serve_step
