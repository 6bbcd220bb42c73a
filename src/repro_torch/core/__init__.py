"""repro.core — the paper's contribution: kernel-level DVFS planning for
waste reduction (strict/relaxed), vs pass-level and vs EDP.

The port's copy of the JAX package's ``core/__init__.py``, with the H100
chip model and without the HLO calibration (the port compiles no HLO)."""
from .freq import AUTO, ClockPair, FrequencyGrid, h100_grid, \
    paper_grid_3080ti, tpu_v5e_grid
from .power_model import Chip, KernelSpec, get_chip, rtx3080ti_like, \
    a4000_like, tpu_v5e_like, h100_like, CHIPS
from .workload import (WorkloadBuilder, build_workload, workload_totals,
                       decode_slot_buckets, decode_bucket_workloads)
from .measure import Campaign, MeasurementTable, NoiseModel
from .objectives import WastePolicy, edp, ed2p, compute_waste, pct
from .planner import (Plan, local_plan, global_plan, global_plan_dp,
                      pass_level_plan, edp_local_plan, edp_global_plan,
                      edp_pass_plan)
from .coalesce import CoalescedPlan, coalesced_global_plan, expand_sequence
from .search import search_plan, SearchReport, evaluate_against_truth
from .schedule import DVFSSchedule, ScheduleEntry, schedule_from_plan, \
    schedule_from_coalesced
from .phase_plan import (PhasePlan, PhasePlanBundle, plan_phase_bundle,
                         TrainPlanBundle, plan_train_bundle, compile_phase,
                         train_phase_of, TRAIN_PHASES)

__all__ = [
    "AUTO", "ClockPair", "FrequencyGrid", "paper_grid_3080ti",
    "tpu_v5e_grid", "h100_grid", "Chip", "KernelSpec", "get_chip",
    "rtx3080ti_like", "a4000_like", "tpu_v5e_like", "h100_like", "CHIPS",
    "WorkloadBuilder", "build_workload", "workload_totals", "Campaign",
    "MeasurementTable", "NoiseModel", "WastePolicy", "edp", "ed2p",
    "compute_waste", "pct",
    "Plan", "local_plan", "global_plan", "global_plan_dp",
    "pass_level_plan", "edp_local_plan", "edp_global_plan", "edp_pass_plan",
    "CoalescedPlan", "coalesced_global_plan", "expand_sequence",
    "DVFSSchedule", "ScheduleEntry", "schedule_from_plan",
    "schedule_from_coalesced", "search_plan", "SearchReport",
    "evaluate_against_truth", "decode_slot_buckets",
    "decode_bucket_workloads", "PhasePlan", "PhasePlanBundle",
    "plan_phase_bundle", "TrainPlanBundle", "plan_train_bundle",
    "compile_phase", "train_phase_of", "TRAIN_PHASES",
]
