"""Static device-memory footprint bound (CF301; port of the reference
package's ``analysis/memory.py``).

Warming a deployment runs every batch-lowered chain at every padding
bucket — including the covering bucket a full batcher merge pads to —
so the first warm materializes each chain's live columns at the LARGEST
bucket.  This module bounds that footprint statically (live columns ×
bucket cap × element size, step by step through each fused chain, from
the specs the abstract walk recorded) and diagnoses chains whose peak
exceeds a configurable budget *before* the warm runs out of device
memory.  Bytes are ``numel × element_size`` of each column's spec.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.infer import EdgeType
from repro_torch.core.ir import PhysicalPlan
from repro_torch.core.lowering import BatchedJittedFuse, bucket_rows


def _row_bytes(specs) -> int:
    total = 0
    for s in specs:
        if s is None:
            return -1
        total += s.numel() * s.element_size()
    return total


def chain_peak_row_bytes(step_specs) -> Optional[int]:
    """Peak live bytes per ROW through a fused chain, given the row-level
    specs before its first step and after each (``EdgeType.steps``): at
    every step the step's inputs and outputs are live simultaneously
    (donation can at best alias one of them — we bound, not model, the
    allocator)."""
    if not step_specs or any(s is None for s in step_specs[0]):
        return None
    peak = _row_bytes(step_specs[0])
    for cur, nxt in zip(step_specs, step_specs[1:]):
        peak = max(peak, _row_bytes(cur) + _row_bytes(nxt))
    return peak


def footprint_bytes(plan: PhysicalPlan, types: Dict[int, EdgeType],
                    max_batch_of=None) -> Dict[int, tuple]:
    """Per device-resident batch-lowered chain with inferred specs:
    op id -> (peak bytes at its largest bucket, bytes per row, that
    bucket).  ``max_batch_of(op_id)`` supplies the effective merge cap
    (defaults to 1 = no batching)."""
    out: Dict[int, tuple] = {}
    for o in plan.ops:
        op = o.op
        if not isinstance(op, BatchedJittedFuse):
            continue
        et = types.get(o.op_id)
        per_row = chain_peak_row_bytes(et.steps) if et is not None else None
        if per_row is None or per_row < 0:
            continue
        mb = int(max_batch_of(o.op_id)) if max_batch_of is not None else 1
        sizes = set(op.bucket_sizes or (1,))
        if mb > 1:
            sizes.add(bucket_rows(mb, op.bucket_sizes))
        cap = max(sizes)
        out[o.op_id] = (per_row * cap, per_row, cap)
    return out


def footprint_diagnostics(plan: PhysicalPlan, types: Dict[int, EdgeType],
                          *, budget_bytes: Optional[int],
                          max_batch_of=None) -> List[Diagnostic]:
    """CF301 for every device-resident batch-lowered chain whose static
    footprint (:func:`footprint_bytes`) exceeds ``budget_bytes``.
    ``types`` must carry the walk's specs (from
    :func:`repro_torch.analysis.infer.infer`); chains without them are
    skipped."""
    out: List[Diagnostic] = []
    if budget_bytes is None or budget_bytes <= 0:
        return out
    for op_id, (peak, per_row, cap) in footprint_bytes(
            plan, types, max_batch_of).items():
        if peak > budget_bytes:
            op = plan.op(op_id).op
            out.append(Diagnostic(
                "CF301",
                f"op {op_id} ({op.name}) peaks at "
                f"~{peak / 2**20:.1f} MiB on device at bucket {cap} "
                f"({per_row / 2**20:.3f} MiB/row), over the "
                f"{budget_bytes / 2**20:.1f} MiB budget — the first warm "
                f"at that bucket would run out of device memory",
                op_id=op_id,
                hint="shrink the bucket table / max_batch, split the "
                     "chain, or raise the device-memory budget"))
    return out
