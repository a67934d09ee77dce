"""Dataflow-to-FaaS compilation (paper §4), as an explicit pipeline (port
of the reference package's ``core/compiler.py``):

    logical ``Dataflow``
      -> ``PhysicalPlan`` IR        (``PhysicalPlan.from_dataflow``)
      -> optimization passes        (``repro_torch.core.passes``)
      -> runtime DAG                (``RuntimeDag.from_plan``)

The pass pipeline carries the paper's rewrites (fusion, competitive
execution, locality) plus lowering of fused tensor chains onto the
runtime's device; scheduling annotations (placement, batching,
wait-for-any, dynamic-dispatch locality refs) travel on the IR and are
consumed verbatim by the runtime lowering.  ``anyof`` nodes get
*wait-for-any* semantics; fused ``lookup`` chains get the
*to-be-continued* dynamic-dispatch treatment: the scheduler defers
placement of the node until the resolved ref exists, then prefers an
executor caching it (paper's split-DAG decision point).
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
                 competitive_exec: bool = False, locality: bool = False,
                 jit_fusion: bool = True, batched_lowering: bool = True,
                 default_replicas: int = 3,
                 place_kernels: bool = True,
                 pipeline: Optional[PassPipeline] = None,
                 plan_config=None,
                 name: Optional[str] = None,
                 register: bool = True,
                 verify=None,
                 verify_input=None,
                 verify_budget_bytes: Optional[int] = None) -> "DeployedFlow":
    """Compile + register ``flow`` on ``runtime``.  Pass either
    optimization flags (mapped to a pass configuration via
    ``build_pipeline``, lowering onto the runtime's device) or an
    explicit ``pipeline``.  ``plan_config`` (duck-typed on the SLO
    optimizer's ``PlanConfig``) threads per-node choices through the
    pass pipeline AND applies its runtime-side knobs
    (``apply_runtime(runtime, dag)``) to the fresh deployment.

    ``register=False`` compiles OFF the serving path: the DAG is prepared
    (generation assigned, drivable via ``Runtime.call_dag_object``) but no
    traffic routes to it and any live deployment under ``name`` is
    untouched — the blue/green replanner's green-compile step.  The caller
    activates it later with ``runtime.register_dag(dep.dag, plan=dep.plan)``
    and applies the plan-config's runtime knobs after the swap.

    ``verify`` runs the static plan verifier (``repro_torch.analysis``)
    over the optimized plan BEFORE the DAG is registered or prepared, so
    a rejected plan never launches a kernel or allocates on the device:
    ``True``/``"error"`` raises ``VerificationError`` on any
    severity=error diagnostic; ``"warn"`` only attaches the report
    (``DeployedFlow.verification``); ``None``/``False`` skips analysis.
    ``verify_input`` (a sample request ``Table`` or a ``{column:
    tensor}`` dict of meta tensors) enables shape/dtype/kernel-launch/
    memory inference, on the runtime's device; ``verify_budget_bytes``
    overrides the device-memory budget (default: the runtime pool's
    cache budget)."""
    flow.typecheck()
    plan = PhysicalPlan.from_dataflow(flow)
    # remember the flag set (None under an explicit pipeline): a replan
    # recompile must reproduce the pass configuration, because plan-config
    # op ids are only stable across recompiles with the SAME flags
    compile_flags = None if pipeline is not None else {
        "fusion": fusion, "competitive_exec": competitive_exec,
        "locality": locality, "jit_fusion": jit_fusion,
        "batched_lowering": batched_lowering,
        "default_replicas": default_replicas,
        "place_kernels": place_kernels}
    if pipeline is None:
        pipeline = build_pipeline(
            fusion=fusion, competitive_exec=competitive_exec,
            locality=locality, jit_fusion=jit_fusion,
            batched_lowering=batched_lowering,
            default_replicas=default_replicas,
            place_kernels=place_kernels,
            plan_config=plan_config, device=runtime.device)
    ctx = PassContext()
    plan = pipeline.run(plan, ctx)
    dag_name = name or f"flow{next(_flow_ids)}"
    verification = None
    if verify:
        # verify BEFORE register/prepare: nothing has run yet, so raising
        # here guarantees a rejected plan never reaches the card or traffic
        from repro_torch.analysis import VerificationError, analyze
        sample = verify_input if isinstance(verify_input, Table) else None
        specs = verify_input if isinstance(verify_input, dict) else None
        verification = analyze(
            plan, runtime=runtime, plan_config=plan_config,
            sample=sample, input_specs=specs,
            budget_bytes=verify_budget_bytes, name=dag_name)
        if verify != "warn" and not verification.ok:
            raise VerificationError(verification,
                                    context=f"compile of {dag_name!r}")
    if register:
        dag = runtime.register_plan(plan, dag_name)
    else:
        dag = RuntimeDag.from_plan(plan, dag_name)
        runtime.prepare_dag(dag)
    deployed = DeployedFlow(flow, plan, dag, runtime, ctx.trace)
    deployed.compile_flags = compile_flags
    deployed.verification = verification
    if plan_config is not None and register:
        plan_config.apply_runtime(runtime, dag)
    return deployed


class DeployedFlow:
    def __init__(self, flow: Dataflow, plan: PhysicalPlan, dag: RuntimeDag,
                 runtime, pass_trace: Optional[List[PassTrace]] = None):
        self.flow = flow
        self.plan = plan
        self.dag = dag
        self.runtime = runtime
        self.pass_trace = pass_trace or []
        #: the build_pipeline flag set this flow was compiled with (None
        #: when an explicit pipeline was passed) — what a blue/green
        #: recompile must reuse for op-id-stable plan-config application
        self.compile_flags: Optional[dict] = None
        #: the static verifier's Report when compiled with ``verify=``
        #: (None when verification was skipped)
        self.verification = None

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
        """Human-readable compile report: plan + per-pass trace, plus —
        when the runtime's tracer holds kept traces for this flow — the
        per-node SLO-miss attribution table (where the milliseconds of
        the interesting requests actually went)."""
        lines = [repr(self.plan), ""]
        lines += [repr(t) for t in self.pass_trace]
        tracer = getattr(self.runtime, "tracer", None)
        if tracer is not None and tracer.enabled:
            kept = tracer.kept(self.dag.name)
            if kept:
                from repro_torch.obs.attribution import attribute
                att = attribute(kept)
                lines += ["", f"-- observed attribution "
                          f"({att.n_traces} kept traces, "
                          f"{att.n_miss} SLO misses, {att.n_shed} shed) --",
                          att.table()]
        return "\n".join(lines)
