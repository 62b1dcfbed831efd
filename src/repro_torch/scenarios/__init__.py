"""Scenario traces: cloud-environment event generation and record/replay, copied
from the reference's ``repro.scenarios`` (the same seeds give the same traces and
the same JSONL bytes).

  * :mod:`repro_torch.scenarios.generators` — seeded stochastic event generators
    (spot preemption, diurnal WAN, congestion bursts, straggler churn,
    cross-region degradation),
  * :mod:`repro_torch.scenarios.trace` — the versioned JSONL trace format with
    ``record``/``load`` round-trip,
  * :mod:`repro_torch.scenarios.catalog` — the named scenario registry.

The reference's package also holds ``harness`` (replay through the simulator and
the re-planning engine under several policies, process-parallel) and ``tenancy``
(multi-tenant job arrivals for the planner service).  Those belong with the
planner service and are not ported yet, so this package exports only the three
modules above.
"""

from .catalog import (ScenarioSpec, build, build_trace, get_scenario,
                      list_scenarios, register)
from .generators import (congestion_bursts, diurnal_bandwidth,
                         link_degradation, spot_preemptions, straggler_churn)
from .trace import TRACE_FORMAT, TRACE_VERSION, Trace, compose_traces

__all__ = [k for k in dir() if not k.startswith("_")]
