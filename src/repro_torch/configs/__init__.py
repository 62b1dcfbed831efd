"""Assigned-architecture registry: ``get_config(id)`` / ``ARCH_IDS``.

One module per architecture (exact configs from the assignment table);
``get_config`` returns its ``CONFIG``.  ``ARCH_IDS`` × ``config.shapes()`` is the matrix of cells.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import (ALL_SHAPES, SHAPES_BY_NAME, ArchConfig,
                                 ShapeSpec)

ARCH_IDS: tuple[str, ...] = (
    "gemma_7b",
    "qwen2_7b",
    "qwen3_32b",
    "granite_34b",
    "qwen3_moe_30b_a3b",
    "dbrx_132b",
    "whisper_medium",
    "zamba2_2p7b",
    "llama_3p2_vision_11b",
    "xlstm_125m",
)

#: architectures the port runs beyond the ten the JAX package mirrors
#: (``ARCH_IDS``); ``get_config`` takes them too
EXTRA_ARCH_IDS: tuple[str, ...] = (
    "zamba2_7b",
)

# assignment ids (with dashes/dots) -> module names
ALIASES = {
    "gemma-7b": "gemma_7b",
    "qwen2-7b": "qwen2_7b",
    "qwen3-32b": "qwen3_32b",
    "granite-34b": "granite_34b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "dbrx-132b": "dbrx_132b",
    "whisper-medium": "whisper_medium",
    "zamba2-2.7b": "zamba2_2p7b",
    "llama-3.2-vision-11b": "llama_3p2_vision_11b",
    "xlstm-125m": "xlstm_125m",
    "zamba2-7b": "zamba2_7b",
}


def get_config(arch: str) -> ArchConfig:
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if mod not in ARCH_IDS + EXTRA_ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def all_configs() -> dict[str, ArchConfig]:
    """The ten architectures of ``ARCH_IDS``."""
    return {a: get_config(a) for a in ARCH_IDS}
