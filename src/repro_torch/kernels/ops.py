"""Public kernel entry points.

``flash_attention`` and ``rmsnorm`` launch the hand-written CUDA kernels for
CUDA tensors (building the library at first use) and raise if they cannot;
for CPU tensors they return the plain versions' results.  Both are
differentiable: their backwards are kernels too on the card and plain versions
on the CPU.  No CUDA tensor ever reaches a plain version through these
functions.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm_mod

flash_attention = _flash_mod.flash_attention
rmsnorm = _rmsnorm_mod.rmsnorm
mha_reference = ref.mha_reference
flash_attention_lse_reference = ref.flash_attention_lse_reference
flash_attention_bwd_reference = ref.flash_attention_bwd_reference
rmsnorm_reference = ref.rmsnorm_reference
rmsnorm_bwd_reference = ref.rmsnorm_bwd_reference

#: name -> (module, its counter): the forward and backward launches of each kernel
_COUNTED = {"rmsnorm": (_rmsnorm_mod, "launches"),
            "rmsnorm_bwd": (_rmsnorm_mod, "bwd_launches"),
            "flash_attention": (_flash_mod, "launches"),
            "flash_attention_bwd": (_flash_mod, "bwd_launches")}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTED.items()}


def flash_launches_by_variant() -> dict[str, int]:
    """Flash-attention forward launches per kernel variant (``scalar``,
    ``mma_sync``, ``sm90_wgmma``) since the last :func:`reset_launch_counts`."""
    return dict(_flash_mod.launches_by_variant)


def flash_bwd_launches_by_variant() -> dict[str, int]:
    """Flash-attention backward launches per variant (``scalar``, ``mma_sync``,
    ``sm90_wgmma``) since the last :func:`reset_launch_counts`."""
    return dict(_flash_mod.bwd_launches_by_variant)


def reset_launch_counts() -> None:
    for mod, attr in _COUNTED.values():
        setattr(mod, attr, 0)
    for counts in (_flash_mod.launches_by_variant, _flash_mod.bwd_launches_by_variant):
        for key in counts:
            counts[key] = 0
