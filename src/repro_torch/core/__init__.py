"""Core contribution of the paper: automatic parallelization planning for
heterogeneous, dynamic clusters via multi-edge topology modelling, a
discrete-event simulator cost model, and parallel branch-and-bound search."""

from .cluster import (DEVICE_PROFILES, ClusterTopology, DeviceInstance,
                      DeviceSpec, Edge, MultiEdgeLink, NetworkEvent,
                      dgx_h100_node, hetero_cluster, homogeneous_cluster,
                      multi_pod_tpu, tpu_pod)
from .costmodel import (MeshCollectiveModel, allreduce_time, collective_time,
                        graph_compute_lower_bound, op_time, transfer_time)
from .dynamic import (AdaptationRecord, DynamicOrchestrator, PlanTemplates,
                      reassign_for_straggler)
from .fabric import (FabricModel, calibrated, default_fabric,
                     set_default_fabric, use_fabric)
from .engine import (CacheStats, HierarchicalReplanEngine,
                     HierarchicalReplanResult, ReplanEngine, ReplanResult,
                     StrategyCache, TopologyFingerprint, fingerprint_topology)
from .islands import (ComposedPlan, HierarchicalResult, Island, IslandPlan,
                      inter_island_sync_bound, partition_islands,
                      plan_hierarchical, remap_plan)
from .opgraph import (CommOp, ModelDesc, OpGraph, OpNode, allreduce_decomposed,
                      allreduce_naive, build_llm_graph, layer_costs,
                      layer_flops)
from .planner import (PlanResult, SearchStats, StrategyPoint,
                      megatron_tuned_plan,
                      branch_and_bound_assign, bnb_layer_split,
                      enumerate_strategies, exhaustive_assign, greedy_assign,
                      hetero_batch_shares, materialize_plan, plan_hybrid,
                      point_lower_bound)
from .reconfig import ReconfigCost, ReconfigCostModel, plan_sequence_dp
from .routing import Route, RoutingTable
from .plans import (ParallelPlan, StageAssignment, megatron_default_plan,
                    split_devices, stages_from_sizes, uniform_stages)
from .mip import (LPBoundContext, MIPResult, SimplexResult, lp_bound_context,
                  lp_lower_bound, mip_optimum, simplex_solve)
from .search import (CandidateOutcome, SearchExecutor, coarse_lower_bound,
                     materialize_variant, point_feasible, score_candidates)
from .simulator import (EpochSim, SimResult, StepSim, check_memory,
                        memory_feasible, simulate_epoch, simulate_many,
                        simulate_schedule, simulate_training_step)

__all__ = [k for k in dir() if not k.startswith("_")]
