"""The port's own copy of ``repro.core``.

Lagom core: the paper's contribution.

  comm_params — the six tunable collective parameters (s_j)
  workload    — overlap-group IR (CompOp / CommOp / OverlapGroup)
  hardware    — cluster profiles (A40-PCIe, A40-NVLink, TPU v5e, H100 SXM) + the
                named-profile registry (by_name / profiles)
  topology    — hierarchical fabric model: N pods of a Hardware island
                joined by a named inter-pod fabric (HierarchicalHardware)
  contention  — Eqs. 4–6 + communication-time model
  cost_model  — Eqs. 1–3 closed form
  simulator   — event-driven ProfileTime oracle
  faults      — scripted fault schedules (degraded links, stragglers,
                jitter bursts, flaps) injected into the oracle
  profiling   — batched/vectorized ProfileTime engine + caches
  scheduler   — cross-group interleaved tuning (resumable step machines)
  priority    — metric H (Eq. 7)
  tuner       — Algorithms 1–2 (Lagom)
  autoccl     — AutoCCL baseline tuner
  baselines   — NCCL/XLA default configs
  extract     — model × plan × shape -> Workload
  apply       — tuned configs -> the port's runtime knobs (chunked collectives)
  session     — the front door: tune(...) -> TunedPlan (portable artifact)
                + the SearchBackend registry
  plan_repo   — PlanRepository: (fingerprint × hardware) plan store for
                automatic reuse at launch (--plan-repo)
  retune      — online re-tuning: telemetry-calibrated, drift-scoped warm
                re-search + zero-downtime publish (RetuneService)
"""
from repro_torch.core.comm_params import CommConfig, min_config, vendor_default
from repro_torch.core.extract import (ParallelPlan, extract_decode_workload,
                                      extract_workload, parse_parallel)
from repro_torch.core.faults import (FaultEvent, FaultSchedule,
                                     parse_fault_schedule)
from repro_torch.core.hardware import (A40_NVLINK, A40_PCIE, H100_SXM, PROFILES,
                                       TPU_V5E, Hardware, by_name, profiles,
                                       register_profile)
from repro_torch.core.plan_repo import PlanRepoError, PlanRepository
from repro_torch.core.topology import (FABRICS, Fabric, HierarchicalHardware,
                                       fabric_by_name, flat, hierarchical,
                                       resolve_topology, two_pod)
from repro_torch.core.session import (PlanMismatchError, SearchBackend,
                                      SearchOutcome, TunedPlan, available_methods,
                                      register_backend,
                                      structure_fingerprint, tune,
                                      workload_fingerprint, workload_shape)

# ``retune`` names both the submodule and the session front door.  Import
# the submodule here (first import of ``repro_torch.core.retune`` would
# otherwise re-bind the package attribute to the module mid-run), then
# deterministically re-bind the name to the function: ``from repro_torch.core
# import retune`` always means the front door.
import repro_torch.core.retune as _retune_module  # noqa: E402,F401
from repro_torch.core.session import retune  # noqa: E402
from repro_torch.core.simulator import Measurement, Simulator
from repro_torch.core.workload import CommOp, CompOp, OverlapGroup, Workload

__all__ = [
    "CommConfig", "min_config", "vendor_default",
    "ParallelPlan", "extract_decode_workload", "extract_workload",
    "parse_parallel",
    "Hardware", "A40_PCIE", "A40_NVLINK", "TPU_V5E", "H100_SXM", "PROFILES",
    "by_name", "profiles", "register_profile",
    "Fabric", "FABRICS", "fabric_by_name", "HierarchicalHardware",
    "flat", "hierarchical", "two_pod", "resolve_topology",
    "Simulator", "Measurement",
    "FaultEvent", "FaultSchedule", "parse_fault_schedule",
    "CompOp", "CommOp", "OverlapGroup", "Workload",
    "tune", "retune", "TunedPlan", "PlanMismatchError", "SearchBackend",
    "SearchOutcome", "register_backend", "available_methods",
    "structure_fingerprint", "workload_fingerprint", "workload_shape",
    "PlanRepository", "PlanRepoError",
]
