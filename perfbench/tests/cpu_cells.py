"""Cells at the widths of the port's ``reduced()`` configurations, for runs of the
harness on the CPU: each benchmark configuration's family, narrow, few layers, a
short sequence, float32."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config

from harness import spec

#: the configuration file's keys and the ArchConfig fields they come from
KEYS = {"hidden_size": "d_model", "num_attention_heads": "n_heads",
        "num_key_value_heads": "n_kv_heads", "head_dim": "hd", "intermediate_size": "d_ff",
        "vocab_size": "vocab", "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
        "qkv_bias": "qkv_bias", "tie_word_embeddings": "tie_embeddings",
        "attention_window": "attn_window", "torch_dtype": "dtype", "param_dtype": "dtype"}
OVERRIDES = ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab", "attn_window",
             "attn_q_chunk", "dtype")

TRAFFIC = {"kind": "train", "loop": "closed", "generator": "synthetic_lm",
           "global_batch": 2, "seq_len": 64, "check_steps": 3, "trace_steps": 2,
           "trace_host_steps": 1}


def reduced_config(name: str, **changes) -> dict:
    """The benchmark configuration ``name`` (its file) at its port's reduced widths."""
    full = spec.config(spec.benchmark(), name)
    arch = dataclasses.replace(get_config(full["port_arch"]).reduced(), **changes)
    cfg = {k: v for k, v in full.items() if k not in KEYS}
    cfg.update({key: getattr(arch, attr) for key, attr in KEYS.items()
                if key in full or key == "param_dtype"})
    cfg["num_hidden_layers"] = arch.n_layers
    cfg["port_overrides"] = {k: getattr(arch, k) for k in OVERRIDES}
    return cfg


def cell(name: str, limit: float = 1e-3, **changes) -> dict:
    """Everything ``train_cell.run`` takes for the reduced cell of configuration
    ``name``, with every limit at ``limit``."""
    bench = spec.benchmark()
    metrics = {trace: spec.metrics_for(bench, "", trace) for trace in (False, True)}
    return {"cell": {"name": f"cpu.{name}", "config": name, "traffic": "cpu", "chips": 1},
            "cfg": reduced_config(name, **changes), "traffic": dict(TRAFFIC),
            "limits": {k: {"limit": limit}
                       for k in ("loss0_gap", "grad_gap", "grad_proj_gap", "change_gap")},
            "metrics": metrics}
