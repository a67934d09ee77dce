"""Dataflow-to-FaaS compilation (paper §4), as an explicit pipeline (port
of the reference package's ``core/compiler.py``):

    logical ``Dataflow``
      -> ``PhysicalPlan`` IR        (``PhysicalPlan.from_dataflow``)
      -> optimization passes        (``repro_torch.core.passes``)
      -> runtime DAG                (``RuntimeDag.from_plan``)

Scheduling annotations (placement, batching, device residency) travel on
the IR and are consumed verbatim by the runtime lowering.  The reference's
``verify=`` (static plan verifier), ``plan_config=`` (SLO optimizer
choices), competitive execution, locality and ``register=False``
(blue/green) are not ported yet.
"""
from __future__ import annotations

import itertools
from typing import List, Optional

from repro_torch.core.dataflow import Dataflow
from repro_torch.core.ir import PhysicalPlan
from repro_torch.core.passes import (PassContext, PassPipeline, PassTrace,
                                     build_pipeline)
from repro_torch.core.table import Table
from repro_torch.runtime.dag import RuntimeDag

_flow_ids = itertools.count()


def compile_flow(flow: Dataflow, runtime, *, fusion: bool = False,
                 jit_fusion: bool = True, batched_lowering: bool = True,
                 place_kernels: bool = True,
                 pipeline: Optional[PassPipeline] = None,
                 name: Optional[str] = None) -> "DeployedFlow":
    """Compile + register ``flow`` on ``runtime``.  Pass either
    optimization flags (mapped to a pass configuration via
    ``build_pipeline``, lowering onto the runtime's device) or an explicit
    ``pipeline``."""
    flow.typecheck()
    plan = PhysicalPlan.from_dataflow(flow)
    if pipeline is None:
        pipeline = build_pipeline(
            fusion=fusion, jit_fusion=jit_fusion,
            batched_lowering=batched_lowering, place_kernels=place_kernels,
            device=runtime.device)
    ctx = PassContext()
    plan = pipeline.run(plan, ctx)
    dag = runtime.register_plan(plan, name or f"flow{next(_flow_ids)}")
    return DeployedFlow(flow, plan, dag, runtime, ctx.trace)


class DeployedFlow:
    def __init__(self, flow: Dataflow, plan: PhysicalPlan, dag: RuntimeDag,
                 runtime, pass_trace: Optional[List[PassTrace]] = None):
        self.flow = flow
        self.plan = plan
        self.dag = dag
        self.runtime = runtime
        self.pass_trace = pass_trace or []

    @property
    def rewritten(self) -> Dataflow:
        """The optimized plan, lifted back to a logical ``Dataflow``
        (compatibility view; prefer ``.plan``)."""
        return self.plan.to_dataflow()

    def execute(self, table: Table):
        return self.runtime.call_dag(self.dag.name, table)

    @property
    def function_names(self):
        return list(self.dag.nodes)

    def explain(self) -> str:
        """Human-readable compile report: plan + per-pass trace."""
        lines = [repr(self.plan), ""]
        lines += [repr(t) for t in self.pass_trace]
        return "\n".join(lines)
