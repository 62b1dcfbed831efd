"""PyTorch/CUDA port of ``repro`` (the JAX reference).

Same sub-package and function names as ``repro`` where there is a counterpart;
PyTorch's idiom inside.  The package imports ``torch``, numpy and the standard
library only: never ``jax`` and nothing of ``repro``.  ``core``, ``obs``,
``scenarios`` and ``service`` are the reference's framework-free planner modules,
copied with their module paths renamed; they import neither torch nor JAX, so the
planner's and the scenario harness's spawn workers start without either.

Ported so far: serving and training of all ten architectures (``models``,
``configs``, ``parallel.trainstep``, ``optim``, ``data``, ``checkpoint``), the
planner (``core``: cluster model, simulator cost model, pruned search, re-planning
engine and dynamic orchestrator; ``obs``; ``scenarios``: traces, the replay harness
and tenancy; ``service``: the planner service), the sharding layer
(``parallel.axes`` and ``parallel.sharding``: the reference's axis rules and sharding
profiles as DTensor placements; ``launch.mesh``), the planner-driven
``runtime.trainer`` on one device or a mesh (ZeRO-3 / ZeRO-1; S1/S2/S3 events:
checkpoint, re-plan, rebuild, restore onto the new placements) and its launcher
``launch.train``, and the hand-written Hopper kernels they run on the card
(``kernels``: RMSNorm and attention, forward and backward, reached on a mesh through
``local_map``).  Still to come: the collectives and the pipeline
(``parallel.collectives``, ``parallel.pipeline``) and the roofline / dry-run tooling.
"""
