"""Scenario subsystem: cloud-environment trace generation, record/replay,
and parallel multi-scenario evaluation (the substrate for every adaptability
claim — paper §2.2 dynamic scenarios, §4 parallel simulation).

  * :mod:`repro_torch.scenarios.generators` — seeded stochastic event generators
    (spot preemption, diurnal WAN, congestion bursts, straggler churn,
    cross-region degradation),
  * :mod:`repro_torch.scenarios.trace` — the versioned JSONL trace format with
    ``record``/``load`` round-trip,
  * :mod:`repro_torch.scenarios.catalog` — the named scenario registry,
  * :mod:`repro_torch.scenarios.harness` — replay through the simulator +
    ``ReplanEngine`` with static/adapted/greedy-oracle/DP-oracle policies
    (switch costs modeled via ``repro_torch.core.ReconfigCostModel``),
    process-parallel across scenarios, multi-seed mean/CI sweeps,
  * :mod:`repro_torch.scenarios.tenancy` — seeded multi-tenant job-arrival
    streams + the ``multi_tenant`` scenario family driving the
    planner-service benchmarks.
"""

from .catalog import (ScenarioSpec, build, build_trace, get_scenario,
                      list_scenarios, register)
from .generators import (congestion_bursts, diurnal_bandwidth,
                         link_degradation, spot_preemptions, straggler_churn)
from .harness import (FamilySummary, HarnessConfig, PolicyResult,
                      ScenarioHarness, ScenarioReport, run_payloads,
                      run_scenario, summarize_reports)
from .tenancy import (DEFAULT_SHAPES, TENANT_MODELS, JobArrival, JobShape,
                      TenantScenarioSpec, build_tenant, get_tenant_scenario,
                      job_arrivals, list_tenant_scenarios, register_tenant,
                      to_job_specs)
from .trace import TRACE_FORMAT, TRACE_VERSION, Trace, compose_traces

__all__ = [k for k in dir() if not k.startswith("_")]
