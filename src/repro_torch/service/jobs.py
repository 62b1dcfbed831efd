"""Job specifications for the multi-job planner service.

A :class:`JobSpec` is everything the service needs to plan one training
job: the model, its batch geometry, how many devices it wants, and its
admission priority.  :func:`model_signature` and :meth:`JobSpec.signature`
canonicalize the *shape* of the request — two specs with equal signatures
are isomorphic for planning (same model architecture, same batch geometry,
same device count), so the admission layer buckets them and the shared
cache serves one cold search to all of them, independent of job or model
*names*.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from repro_torch.core.opgraph import ModelDesc


def model_signature(model: ModelDesc) -> tuple:
    """Canonical name-free shape key of a model: every :class:`ModelDesc`
    field except ``name``, in declaration order.  Two models with equal
    signatures produce identical op graphs, parameter counts and plan
    search spaces — the planner cannot tell them apart, so the cross-job
    cache must not either."""
    return tuple(getattr(model, f.name) for f in fields(ModelDesc)
                 if f.name != "name")


@dataclass(frozen=True)
class JobSpec:
    """One tenant's planning request.

    ``priority`` orders admission (higher first; FIFO within a level);
    ``arrival_s`` / ``duration_s`` place the job on the service timeline
    (a finished job frees its devices for the queue).  ``name`` is the
    job's identity — it never participates in bucketing.
    """

    name: str
    model: ModelDesc
    global_batch: int
    seq: int
    n_devices: int
    priority: int = 0
    arrival_s: float = 0.0
    duration_s: float = 0.0
    gpus_per_node: int = 8

    def signature(self) -> tuple:
        """The isomorphism bucket key: jobs with equal signatures want the
        same search on the same-shaped device slice and may share one cold
        plan (remapped per slice)."""
        return (model_signature(self.model), self.global_batch, self.seq,
                self.n_devices, self.gpus_per_node)
