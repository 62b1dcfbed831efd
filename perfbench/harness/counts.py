"""The yardstick's arithmetic: the chip's peaks, the work of a training step, and
the least time the attention kernels could take at the cell's shapes.

Copied from ``chip_smoke.py`` (its peaks, ``visible_pairs`` and ``train_reading``'s
MFU count) and from its flash bounds, so that a change to the program cannot move
them.  What depends on the model comes from the configuration's reference module
(``spec.reference(cfg)``), not from the program: the parameters that run
(``params_run``), the attention calls (``attention_calls``) and any further
operations (``other_flops``).
"""

from __future__ import annotations

from harness import reference, spec

#: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_16BIT_FLOPS = 989e12


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs a query sees over a sequence of ``S``: all of them, those
    at or before it, and of those the ones less than ``window`` behind it."""
    if not causal:
        return S * S
    w = min(window, S) if window else S
    # query i sees min(i + 1, w) keys
    return w * (w + 1) // 2 + (S - w) * w


def step_flops(cfg: dict, traffic: dict) -> float:
    """The model operations of one training step: 6 a parameter and token,
    attention's 12 * head_dim a visible pair (forward 4, backward 8) at each
    attention call, and the reference module's ``other_flops``.  Recomputed work is
    not counted."""
    model = spec.reference(cfg)
    tokens = traffic["global_batch"] * traffic["seq_len"]
    attn = sum(12.0 * a["hd"] * visible_pairs(a["S"], True, a["window"]) * a["B"] * a["H"]
               * a["calls"] for a in model.attention_calls(cfg, traffic))
    return 6.0 * model.params_run(cfg) * tokens + attn + model.other_flops(cfg, traffic)


def _flash_bytes(a: dict, elem: int, backward: bool) -> float:
    """Each input read once, each output written once.  Forward: q, k, v in, o
    and the float32 row log-sum-exp out; backward: q, k, v, o, dO and lse in, dq,
    dk, dv out."""
    q = a["B"] * a["S"] * a["H"] * a["hd"]
    kv = a["B"] * a["S"] * a["KV"] * a["hd"]
    lse = 4.0 * a["B"] * a["H"] * a["S"]
    if backward:
        return elem * (4 * q + 4 * kv) + lse
    return elem * (2 * q + 2 * kv) + lse


def flash_bound_s(cfg: dict, traffic: dict, backward: bool) -> float:
    """The least time all of a step's flash calls in one direction could take on
    the chip: for each call the larger of its operations at the 16-bit peak (4 *
    head_dim a visible pair forward, 10 * head_dim backward) and its bytes at the
    memory's peak."""
    elem = reference.DTYPES[cfg["torch_dtype"]].itemsize
    per_pair = 10.0 if backward else 4.0
    total = 0.0
    for a in spec.reference(cfg).attention_calls(cfg, traffic):
        ops = per_pair * a["hd"] * visible_pairs(a["S"], True, a["window"]) * a["B"] * a["H"]
        one = max(ops / PEAK_16BIT_FLOPS, _flash_bytes(a, elem, backward) / PEAK_BYTES_PER_S)
        total += one * a["calls"]
    return total
