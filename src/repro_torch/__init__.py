"""PyTorch/CUDA port of the accelerator half of ``repro`` (the JAX reference).

Same sub-package and function names as ``repro`` where there is a counterpart;
PyTorch's idiom inside.  The package imports ``torch``, numpy and the standard
library only: never ``jax`` and nothing of ``repro``.

Ported so far: the dense decoder-LM serving and training paths (``models``,
``configs``, ``parallel.trainstep``, ``optim``, ``data``, ``checkpoint``, the
planner-free ``runtime.trainer``) and the hand-written Hopper kernels they run
on the card (``kernels``: RMSNorm and attention, forward and backward).
"""
