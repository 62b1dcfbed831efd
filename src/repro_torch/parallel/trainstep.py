"""Prefill / serve step makers (the serving half of the reference's
``parallel/trainstep.py``; ``make_train_step`` comes with the training path).

The reference's steps take the parameter tree as their first argument; here
the parameters live in the ``LM`` module, so the steps take only what changes
from call to call.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.models.lm import LM

MOD_KEYS = ("audio_embed", "vision_embed")


def _split_mods(batch: dict) -> tuple[dict, dict]:
    mods = {k: v for k, v in batch.items() if k in MOD_KEYS}
    rest = {k: v for k, v in batch.items() if k not in MOD_KEYS}
    return rest, mods


def _refuse_mods(mods: dict) -> None:
    if mods:
        raise NotImplementedError(
            f"modality inputs {sorted(mods)} need the encoder and "
            "cross-attention blocks, which are not ported yet")


def make_prefill_step(model: LM) -> Callable:
    """Returns ``prefill_step(batch) -> (last-token logits, stacked cache)``;
    ``batch = {"tokens": (B,S) int}``."""
    def prefill_step(batch: dict):
        rest, mods = _split_mods(batch)
        _refuse_mods(mods)
        return model.prefill(rest["tokens"])
    return prefill_step


def make_serve_step(model: LM) -> Callable:
    """Returns ``serve_step(cache, batch) -> (logits, cache)``;
    ``batch = {"tokens": (B,1) int, "pos": (B,) int}``.  The cache is the
    flat per-layer tuple and is updated in place."""
    def serve_step(cache, batch: dict):
        rest, mods = _split_mods(batch)
        _refuse_mods(mods)
        return model.decode_step(cache, rest["tokens"], rest["pos"])
    return serve_step
