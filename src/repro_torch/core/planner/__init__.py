from repro_torch.core.planner.cost_model import (HW, forward_flops,
                                                 kv_cache_bytes,
                                                 roofline_terms,
                                                 step_collective_bytes,
                                                 step_flops, step_hbm_bytes)
from repro_torch.core.planner.elastic import (ElasticController, StageCost,
                                              auto_size_workers,
                                              estimate_stage_costs,
                                              simulate_stage_pipeline)
from repro_torch.core.planner.planner import (PlanResult, candidate_plans,
                                              plan_resources)
from repro_torch.core.planner.profiling import (make_profile_fn,
                                                profile_reduced_blocks,
                                                stage_latencies_from_registry)
from repro_torch.core.planner.simulator import (ClusterPlan, CostOracle,
                                                Workload, simulate)

__all__ = ["HW", "roofline_terms", "step_flops", "step_hbm_bytes",
           "step_collective_bytes", "forward_flops", "kv_cache_bytes",
           "simulate", "Workload", "ClusterPlan", "CostOracle",
           "plan_resources", "PlanResult", "candidate_plans",
           "make_profile_fn", "profile_reduced_blocks",
           "stage_latencies_from_registry", "StageCost",
           "estimate_stage_costs", "auto_size_workers",
           "simulate_stage_pipeline", "ElasticController"]
