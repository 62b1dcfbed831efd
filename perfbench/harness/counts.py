"""The yardstick's arithmetic: the chip's peaks, the work of a training step, and
the least time the attention kernels could take at the cell's shapes.

Copied from ``chip_smoke.py`` (its peaks, ``visible_pairs`` and ``train_reading``'s
MFU count) and from its flash bounds, so that a change to the program cannot move
them.  The parameter count is the reference's (``reference.params_run``), not the
program's.
"""

from __future__ import annotations

from harness import reference

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


def attention_shape(cfg: dict, traffic: dict) -> dict:
    """One attention call of the cell: batch, heads, key heads, head size, length,
    window, and how many such calls a forward pass makes."""
    return {"B": traffic["global_batch"], "S": traffic["seq_len"],
            "H": cfg["num_attention_heads"], "KV": cfg["num_key_value_heads"],
            "hd": cfg["head_dim"], "window": cfg["attention_window"],
            "calls": reference.attention_layers(cfg)}


def step_flops(cfg: dict, traffic: dict) -> float:
    """The model operations of one training step: 6 a parameter and token, and
    attention's 12 * head_dim a visible pair (forward 4, backward 8) at each
    attention layer.  Recomputed work is not counted."""
    a = attention_shape(cfg, traffic)
    tokens = a["B"] * a["S"]
    attn = 12.0 * a["hd"] * visible_pairs(a["S"], True, a["window"]) * a["B"] * a["H"] \
        * a["calls"]
    return 6.0 * reference.params_run(cfg) * tokens + attn


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
    a = attention_shape(cfg, traffic)
    elem = reference.DTYPES[cfg["torch_dtype"]].itemsize
    per_pair = 10.0 if backward else 4.0
    ops = per_pair * a["hd"] * visible_pairs(a["S"], True, a["window"]) * a["B"] * a["H"]
    one = max(ops / PEAK_16BIT_FLOPS, _flash_bytes(a, elem, backward) / PEAK_BYTES_PER_S)
    return one * a["calls"]
