"""``repro_torch.service`` — planner-as-a-service: a persistent in-process
daemon multiplexing N concurrent training jobs on one shared cluster
(the ROADMAP's "shared cluster, many jobs, heavy
traffic" open item).

  * :mod:`repro_torch.service.jobs` — :class:`JobSpec` + the name-free
    :func:`model_signature` bucketing key,
  * :mod:`repro_torch.service.admission` — bounded :class:`AdmissionQueue`
    (priority + FIFO tie-break, isomorphic-twin bucketing, backpressure),
  * :mod:`repro_torch.service.cache` — :class:`SharedStrategyCache`, the
    versioned cross-job store with exact event-driven invalidation,
  * :mod:`repro_torch.service.service` — :class:`PlannerService` itself, plus
    the :class:`LinkLoadBoard` / :class:`ContentionChargedReconfig` pair
    that charges concurrent reshards onto shared links.

See ``docs/service.md`` for architecture, semantics, and the operator
runbook; ``benchmarks/bench_service.py`` measures sustained replan
throughput and p99 latency under a multi-tenant arrival storm.
"""

from .admission import AdmissionQueue
from .cache import SharedStrategyCache, StoredPlan
from .jobs import JobSpec, model_signature
from .service import (ContentionChargedReconfig, JobHandle, LinkLoadBoard,
                      PlannerService, ServiceReport)

__all__ = [
    "AdmissionQueue", "ContentionChargedReconfig", "JobHandle", "JobSpec",
    "LinkLoadBoard", "PlannerService", "ServiceReport",
    "SharedStrategyCache", "StoredPlan", "model_signature",
]
