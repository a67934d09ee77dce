"""SLO-driven profiling & adaptive replanning: the layer between the
compiler and the runtime that closes the measure -> model -> plan ->
replan loop (port of the reference package's ``profiling/``).

* :mod:`repro_torch.profiling.profiler` — offline batch-sweep profiler
  (``OpLatencyCurve`` / ``FlowProfile``), plus live-curve refresh from
  ``ChainProfile`` measurements;
* :mod:`repro_torch.profiling.estimator` — M/M/c + critical-path DAG latency
  estimator (``LatencyEstimator``);
* :mod:`repro_torch.profiling.optimizer` — SLO-aware configuration search
  (``propose`` -> ``PlanConfig``);
* :mod:`repro_torch.profiling.controller` — online controller that snapshots
  runtime metrics and hot-applies safe config deltas (``SLOController``);
* :mod:`repro_torch.profiling.replan` — zero-downtime blue/green replanning
  (``BlueGreenReplanner``): compile off the hot path, pre-warm
  executables, canary-verify, atomically swap generations.
"""
from repro_torch.profiling.controller import ControllerEvent, SLOController
from repro_torch.profiling.estimator import (LatencyEstimate,
                                             LatencyEstimator, Workload,
                                             erlang_c)
from repro_torch.profiling.optimizer import NodeConfig, PlanConfig, propose
from repro_torch.profiling.profiler import (BucketStats, FlowProfile,
                                            OpLatencyCurve,
                                            profile_flow_curves,
                                            profile_plan, refresh_from_plan)
from repro_torch.profiling.replan import (BlueGreenReplanner, ReplanReport,
                                          warm_deployment)

__all__ = [
    "BlueGreenReplanner", "BucketStats", "ControllerEvent", "FlowProfile",
    "LatencyEstimate", "LatencyEstimator", "NodeConfig", "OpLatencyCurve",
    "PlanConfig", "ReplanReport", "SLOController", "Workload", "erlang_c",
    "profile_flow_curves", "profile_plan", "propose", "refresh_from_plan",
    "warm_deployment",
]
