"""Public kernel entry points.

``flash_attention`` and ``rmsnorm`` launch the hand-written CUDA kernels for
CUDA tensors (building the library at first use) and raise if they cannot;
for CPU tensors they return the plain versions' results.  No CUDA tensor ever
reaches a plain version through these functions.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm_mod

flash_attention = _flash_mod.flash_attention
rmsnorm = _rmsnorm_mod.rmsnorm
mha_reference = ref.mha_reference
rmsnorm_reference = ref.rmsnorm_reference

_COUNTED = {"rmsnorm": _rmsnorm_mod, "flash_attention": _flash_mod}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _COUNTED.items()}


def flash_launches_by_variant() -> dict[str, int]:
    """Flash-attention launches per kernel variant (``scalar``, ``mma_sync``,
    ``sm90_wgmma``) since the last :func:`reset_launch_counts`."""
    return dict(_flash_mod.launches_by_variant)


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0
    for key in _flash_mod.launches_by_variant:
        _flash_mod.launches_by_variant[key] = 0
