"""PyTorch/CUDA port of ``repro`` (the JAX reference).

Same sub-package and function names as ``repro`` where there is a counterpart;
PyTorch's idiom inside.  The package imports ``torch``, numpy and the standard
library only: never ``jax`` and nothing of ``repro``.  ``core``, ``obs`` and
``scenarios`` are the reference's framework-free planner modules, copied with
their module paths renamed; they import neither torch nor JAX, so the planner's
spawn workers start without either.

Ported so far: serving and training of all ten architectures (``models``,
``configs``, ``parallel.trainstep``, ``optim``, ``data``, ``checkpoint``), the
planner (``core``: cluster model, simulator cost model, pruned search, re-planning
engine and dynamic orchestrator; ``obs``; the scenario traces), the planner-driven
one-device ``runtime.trainer`` (S1/S2/S3 events: checkpoint, re-plan, rebuild,
restore) and its launcher ``launch.train``, and the hand-written Hopper kernels
they run on the card (``kernels``: RMSNorm and attention, forward and backward).
"""
