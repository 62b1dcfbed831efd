"""Public kernel entry points.

``flash_attention``, ``rmsnorm`` and ``ssd_chunked`` launch the hand-written CUDA
kernels for CUDA tensors (building the library at first use) and raise if they
cannot; for CPU tensors they return the plain versions' results.  All three are
differentiable: their backwards are kernels too on the card and plain versions
on the CPU.  No CUDA tensor ever reaches a plain version through these
functions.
"""

from __future__ import annotations

from repro_torch.kernels import adamw as _adamw_mod
from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm_mod
from repro_torch.kernels import ssd as _ssd_mod

flash_attention = _flash_mod.flash_attention
rmsnorm = _rmsnorm_mod.rmsnorm
ssd_chunked = _ssd_mod.ssd_chunked
mha_reference = ref.mha_reference
flash_attention_lse_reference = ref.flash_attention_lse_reference
flash_attention_bwd_reference = ref.flash_attention_bwd_reference
rmsnorm_reference = ref.rmsnorm_reference
rmsnorm_bwd_reference = ref.rmsnorm_bwd_reference

#: name -> (module, its counter): the forward and backward launches of each kernel,
#: the fused AdamW's kernels (``optim.adamw.adamw_update`` on plain CUDA tensors), and
#: the chunked SSD's forward and backward calls (``models.layers._mamba_scan``)
_COUNTED = {"rmsnorm": (_rmsnorm_mod, "launches"),
            "rmsnorm_bwd": (_rmsnorm_mod, "bwd_launches"),
            "flash_attention": (_flash_mod, "launches"),
            "flash_attention_bwd": (_flash_mod, "bwd_launches"),
            "adamw": (_adamw_mod, "launches"),
            "ssd": (_ssd_mod, "launches"),
            "ssd_bwd": (_ssd_mod, "bwd_launches")}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTED.items()}


def flash_launches_by_variant() -> dict[str, int]:
    """Flash-attention forward launches per kernel variant (``tf32x3``,
    ``sm90_wgmma``) since the last :func:`reset_launch_counts`."""
    return dict(_flash_mod.launches_by_variant)


def flash_bwd_launches_by_variant() -> dict[str, int]:
    """Flash-attention backward launches per variant (``tf32x3``, ``sm90_wgmma``)
    since the last :func:`reset_launch_counts`."""
    return dict(_flash_mod.bwd_launches_by_variant)


def flash_launches_by_head_dim() -> dict[str, dict[str, int]]:
    """Flash-attention launches since the last :func:`reset_launch_counts` by
    direction, head_dim and variant: ``{"forward": {"224/sm90_wgmma": n, ...},
    "backward": {...}}``."""
    return {way: {f"{hd}/{kind}": n for (hd, kind), n in sorted(table.items())}
            for way, table in (("forward", _flash_mod.launches_by_head_dim),
                               ("backward", _flash_mod.bwd_launches_by_head_dim))}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTED.values():
        setattr(mod, attr, 0)
    for counts in (_flash_mod.launches_by_variant, _flash_mod.bwd_launches_by_variant):
        for key in counts:
            counts[key] = 0
    _flash_mod.launches_by_head_dim.clear()
    _flash_mod.bwd_launches_by_head_dim.clear()
