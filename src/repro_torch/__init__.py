"""PyTorch/CUDA port of the accelerator half of ``repro`` (the JAX reference).

Same sub-package and function names as ``repro`` where there is a counterpart;
PyTorch's idiom inside.  The package imports ``torch``, numpy and the standard
library only: never ``jax`` and nothing of ``repro``.

Ported so far: the dense decoder-LM serving path (``models``, ``configs``,
``parallel.trainstep``'s serving half) and the two hand-written Hopper kernels
it runs on the card (``kernels``).
"""
