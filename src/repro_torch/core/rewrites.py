"""Dataflow rewrites (paper §4) — compatibility shims (port of the
reference package's ``core/rewrites.py``).

The transforms live as passes over the physical-plan IR
(``repro_torch.core.passes``); these wrappers keep the logical-level
API: each lowers the ``Dataflow`` to a ``PhysicalPlan``, runs the
corresponding pass, and lifts the result back to a ``Dataflow``.

* ``fuse_chains``  -> ``FuseChainsPass``
* ``competitive``  -> ``CompetitivePass``
* ``fuse_lookups`` -> ``FuseLookupsPass``
* ``apply_rewrites`` -> ``build_pipeline`` over the optimization flags

New code should use ``PhysicalPlan.from_dataflow`` + ``PassPipeline``
directly (as ``repro_torch.core.compiler`` does) and skip the round-trip.
"""
from __future__ import annotations

from repro_torch.core.dataflow import Dataflow
from repro_torch.core.ir import PhysicalPlan
from repro_torch.core.passes import (CompetitivePass, FuseChainsPass,
                               FuseLookupsPass, PassContext, build_pipeline)


def _via_pass(flow: Dataflow, p) -> Dataflow:
    plan = PhysicalPlan.from_dataflow(flow)
    return p.run(plan, PassContext()).to_dataflow()


def fuse_chains(flow: Dataflow, *, across_resource_classes: bool = False,
                preserve_lookup_boundaries: bool = False) -> Dataflow:
    """Collapse single-consumer linear chains into ``Fuse`` ops (§4)."""
    return _via_pass(flow, FuseChainsPass(
        across_resource_classes=across_resource_classes,
        preserve_lookup_boundaries=preserve_lookup_boundaries))


def competitive(flow: Dataflow, *, default_replicas: int = 3) -> Dataflow:
    """Replicate high-variance ops and consume with ``anyof`` (§4)."""
    return _via_pass(flow, CompetitivePass(default_replicas=default_replicas))


def fuse_lookups(flow: Dataflow) -> Dataflow:
    """Fuse lookups into their consumer for data locality (§4)."""
    return _via_pass(flow, FuseLookupsPass())


def apply_rewrites(flow: Dataflow, *, fusion: bool = False,
                   competitive_exec: bool = False,
                   locality: bool = False,
                   default_replicas: int = 3) -> Dataflow:
    flow.typecheck()
    pipeline = build_pipeline(fusion=fusion, competitive_exec=competitive_exec,
                              locality=locality, jit_fusion=False,
                              default_replicas=default_replicas)
    plan = pipeline.run(PhysicalPlan.from_dataflow(flow))
    out = plan.to_dataflow()
    out.typecheck()
    return out
