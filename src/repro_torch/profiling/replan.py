"""Zero-downtime blue/green replanning: the *replan* step the controller
escalates to when the fix needs compile-time changes (port of the
reference package's ``profiling/replan.py``).

The paper's position (and InferLine's) is that a serving dataflow must be
re-optimizable without taking traffic down.  The controller's hot-apply
path covers runtime-safe knobs; everything else — lowering mode flips,
placement, competitive topology, bucket sets — needs a recompile, and a
naive re-registration would serve cold executables to live traffic (and,
before generation-keyed runtime state, corrupt the old deployment's
batchers).  :class:`BlueGreenReplanner` does it safely:

1. **compile** — ``compile_flow(plan_config=…, register=False)`` builds
   the green plan + DAG entirely off the serving path; blue keeps serving.
2. **warm** — :func:`warm_deployment` walks the green DAG topologically at
   every padding bucket size with the exec-path router bypassed
   (``forced_batched_routing``), building every (chain, bucket, variant)
   entry of the shared ``EXECUTABLE_CACHE`` before any traffic can reach
   it.  Chains unchanged from blue hit the cache (zero new traces);
   changed ones pay their first builds here, not on a request.  On a
   card what a cold bucket really costs is the caching allocator's
   growth and first library calls at the new shapes, which the same walk
   pays.
3. **canary-verify** — a few requests driven through the green DAG via
   ``Runtime.call_dag_object`` (not traffic-visible, not recorded in the
   controller's metric series), outputs checked against the BLUE
   generation's output for the same input — a replan changes execution
   strategy, never semantics, so the generations must agree.  (Blue as
   reference keeps the check on warm executables; ``reference="local"``
   swaps in the logical flow's interpreted ground truth, which pays
   first-time eager-op compiles and is kept for offline use.)  A mismatch
   or error ABORTS the replan; blue stays live and untouched.
4. **swap** — ``Runtime.register_dag`` atomically routes new ``call_dag``
   requests to green while in-flight executions finish on blue; blue's
   batchers retire when their generation's last request completes and
   close once quiescent.  The proposal's runtime knobs (batcher windows,
   autoscaler targets) are applied to green; hot-applied batch config
   carries over automatically where node names match
   (``Runtime._node_batch_cfg`` is keyed logically), and live router
   state (``ChainProfile``) carries over wherever chain signatures match
   (the executable cache keys by signature, not by deployment).
5. **confirm** — the controller's next tick measures the post-swap config
   against the SLO (``post_replan_confirm`` in the event detail).

The ``DeployedFlow`` handle is updated in place, so every holder — the
controller, benchmarks, user code — follows the swap transparently.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.compiler import compile_flow
from repro_torch.core.lowering import (EXECUTABLE_CACHE,
                                       BatchedJittedFuse,
                                       forced_batched_routing)
from repro_torch.core.table import DeviceTable, Table
from repro_torch.profiling.profiler import ProfileCtx, _replicate


@dataclasses.dataclass
class ReplanReport:
    """What one blue/green replan attempt did, phase by phase."""
    dag_name: str
    ok: bool = False
    phase: str = "init"        # compile | warm | canary | swap | done
    reason: str = ""           # why it aborted, when it did
    blue_generation: int = 0
    green_generation: int = 0
    warm: Dict[str, Any] = dataclasses.field(default_factory=dict)
    canary: Dict[str, Any] = dataclasses.field(default_factory=dict)
    timings_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# warm: build every (chain, bucket) executable before traffic arrives
# ---------------------------------------------------------------------------

def _walk_sizes(runtime, deployed, extra_rows=()) -> List[int]:
    """Row counts the warm walk must cover: every configured padding
    bucket, PLUS the bucket a full batcher merge pads to — the batcher
    coalesces up to ``max_batch`` single-row requests, and past the
    largest configured bucket padding doubles, so a max-size batch can
    land on a bucket outside the configured set."""
    from repro_torch.core.lowering import bucket_rows
    plan, dag = deployed.plan, deployed.dag
    by_op_id = {n.plan_op_id: n for n in dag.nodes.values()}
    sizes = set(extra_rows)
    for o in plan.ops:
        op = o.op
        if not isinstance(op, BatchedJittedFuse):
            continue
        sizes.update(op.bucket_sizes)
        node = by_op_id.get(o.op_id)
        if node is not None and node.batching:
            cfg = runtime._node_batch_cfg.get((dag.name, node.name), {})
            mb = int(cfg.get("max_batch", runtime.max_batch))
            sizes.add(bucket_rows(mb, op.bucket_sizes))
    return sorted(sizes or {1})


def _observed_buckets(runtime, dag, coverage) -> List[int]:
    """Buckets live traffic actually landed on, most-frequent first: the
    row-count histogram read from the runtime's ``batch/<dag>/.../size``
    metric series (prefix-matched — node names change across lowering
    flips, and a green DAG shares its blue predecessor's name, so blue's
    traffic shape steers green's warm order).  Each observed batch size
    maps to the padding bucket that would serve it."""
    from repro_torch.core.lowering import bucket_rows
    prefix = f"batch/{dag.name}/"
    hist: Dict[int, int] = {}
    snapshot = getattr(runtime, "metrics_snapshot", lambda: {})()
    for key, series in snapshot.items():
        if not (key.startswith(prefix) and key.endswith("/size")):
            continue
        for v in series:
            b = bucket_rows(max(1, int(v)), coverage)
            hist[b] = hist.get(b, 0) + 1
    return [b for b, _ in sorted(hist.items(),
                                 key=lambda kv: (-kv[1], kv[0]))]


def warm_deployment(runtime, deployed, sample: Table,
                    buckets: Optional[List[int]] = None,
                    extra_rows=()) -> Dict[str, Any]:
    """Pre-build a compiled deployment's executables through the shared
    ``EXECUTABLE_CACHE``: walk the DAG topologically once per padding
    bucket size, feeding each node its upstream's real output, with the
    exec-path router bypassed so the batched callable runs even at sizes
    the live router would send per-row.  A 1-row walk additionally
    warms the per-row executables (the live singleton path).

    Walking the *runtime* node functions — not the bare ops — matters:
    they capture the device-residency flags (``emit_device``/donation), so
    exactly the executable variants live traffic will request get traced.

    Returns trace/entry accounting: ``fresh_traces`` is how many first
    builds this warm paid so that post-swap traffic pays zero.  Coverage
    assumes single-row requests (the serving norm): a merge of multi-row
    requests can exceed ``max_batch`` rows and land on a bucket beyond the
    warmed set — pass those sizes via ``extra_rows``."""
    dag = deployed.dag
    plan = deployed.plan
    if buckets is None:
        buckets = _walk_sizes(runtime, deployed, extra_rows)
    # warm the buckets live traffic is actually hitting FIRST — if the
    # swap races the warm walk (or the walk aborts), the executables most
    # likely to be requested next are already traced; the remainder of
    # the coverage set follows so nothing is left cold
    observed = _observed_buckets(runtime, dag, buckets)
    buckets = ([b for b in observed if b in set(buckets)]
               + [b for b in buckets if b not in set(observed)])
    ctx = ProfileCtx(getattr(runtime, "kvs", None))
    before = EXECUTABLE_CACHE.traces()
    stats_before = EXECUTABLE_CACHE.stats()
    errors: List[str] = []
    chain_ops = [o.op for o in plan.ops]
    with forced_batched_routing(chain_ops):
        for b in buckets:
            src = _replicate(sample, b)
            results: Dict[str, Any] = {}
            for node in dag.topo():
                if node.deps:
                    ins = [results.get(d) for d in node.deps]
                    if node.wait_any:
                        ins = [next((t for t in ins if t is not None),
                                    None)]
                else:
                    ins = [src]
                if any(t is None for t in ins):
                    continue        # upstream failed; best-effort walk
                try:
                    results[node.name] = node.fn(list(ins), ctx)
                except Exception as e:      # warm is best-effort; the
                    errors.append(          # canary judges correctness
                        f"{node.name}@bucket{b}: {type(e).__name__}: {e}")
    after = EXECUTABLE_CACHE.traces()
    stats_after = EXECUTABLE_CACHE.stats()
    return {
        "buckets": list(buckets),
        "observed": observed,
        "traces_before": before,
        "traces_after": after,
        "fresh_traces": after - before,
        "fresh_entries": stats_after["entries"] - stats_before["entries"],
        "errors": errors,
    }


# ---------------------------------------------------------------------------
# canary: green must reproduce the logical flow's results before it serves
# ---------------------------------------------------------------------------

#: values compared as tensors (the reference compares them as numpy arrays)
_NUMERIC = (torch.Tensor, np.ndarray, np.generic, int, float)


def _values_differ(gv, wv, rtol: float) -> bool:
    """Numeric values compare as tensors, on the host, wherever they lie:
    integer and bool columns exactly (``torch.equal``), float columns on
    float32 copies with ``torch.allclose(rtol, atol=1e-6)``."""
    gt, wt = torch.as_tensor(gv).cpu(), torch.as_tensor(wv).cpu()
    if gt.is_floating_point() or wt.is_floating_point() \
            or gt.is_complex() or wt.is_complex():
        return not torch.allclose(gt.to(torch.float32), wt.to(torch.float32),
                                  rtol=rtol, atol=1e-6)
    return not torch.equal(gt, wt)


def _rows_match(got: Table, want: Table, rtol: float) -> Optional[str]:
    """None when ``got`` reproduces ``want`` row for row, else what
    differs first (row count, arity, shape or values).  Never raises for
    a numeric column: bf16 and CUDA tensors compare as tensors."""
    if len(got.rows) != len(want.rows):
        return f"row count {len(got.rows)} != {len(want.rows)}"
    for i, (g, w) in enumerate(zip(got.rows, want.rows)):
        if len(g.values) != len(w.values):
            return f"row {i}: arity {len(g.values)} != {len(w.values)}"
        for j, (gv, wv) in enumerate(zip(g.values, w.values)):
            if isinstance(gv, _NUMERIC) and isinstance(wv, _NUMERIC):
                gs, ws = tuple(torch.as_tensor(gv).shape), \
                    tuple(torch.as_tensor(wv).shape)
                if gs != ws:
                    return f"row {i} col {j}: shape {gs} != {ws}"
                if _values_differ(gv, wv, rtol):
                    return f"row {i} col {j}: values differ"
            elif gv != wv:
                return f"row {i} col {j}: values differ"
    return None


# ---------------------------------------------------------------------------
# the replanner
# ---------------------------------------------------------------------------

class BlueGreenReplanner:
    """compile → warm → canary-verify → swap, with blue serving
    throughout.  Callable, so it plugs directly into
    ``SLOController(on_replan=replanner)`` — the controller's default
    escalation path constructs one automatically.

    ``sample`` is a representative request table (used for warming and
    canaries; without it both steps are skipped, with a note — the swap
    then pays cold traces only for chains that actually changed).
    ``compile_flags`` defaults to the flags the deployment was compiled
    with (recorded on ``DeployedFlow``); an explicit-pipeline deployment
    must pass them, because PlanConfig op ids are only stable across
    recompiles with the same pass configuration."""

    def __init__(self, runtime, deployed, *, sample: Optional[Table] = None,
                 autoscaler=None, canary_requests: int = 2,
                 canary_timeout_s: float = 60.0, verify: bool = True,
                 reference: str = "blue", rtol: float = 1e-5,
                 compile_flags: Optional[dict] = None):
        self.runtime = runtime
        self.deployed = deployed
        self.sample = sample
        self.autoscaler = autoscaler
        self.canary_requests = canary_requests
        self.canary_timeout_s = canary_timeout_s
        self.verify = verify
        self.reference = reference        # "blue" | "local"
        self.rtol = rtol
        if compile_flags is None:
            compile_flags = getattr(deployed, "compile_flags", None)
        self.compile_flags = compile_flags
        self.history: List[ReplanReport] = []
        # set by a successful swap: everything needed to re-register blue
        # atomically if the confirm tick shows green missing the SLO
        self._rollback: Optional[Dict[str, Any]] = None

    #: reports kept (a controller re-escalating for hours must not grow
    #: the history without bound)
    HISTORY_CAP = 32

    def __call__(self, proposal) -> ReplanReport:
        return self.replan(proposal)

    def _phase_event(self, phase: str, t0: float, t1: float,
                     **attrs) -> None:
        """Control-plane span for one swap phase (prepare/warm/canary/
        swap/confirm/rollback) — exported on the trace's control track
        so a during-swap p99 blip is attributable to its phase."""
        tracer = getattr(self.runtime, "tracer", None)
        if tracer is None or not getattr(tracer, "enabled", False):
            return
        ce = getattr(tracer, "control_event", None)
        if ce is not None:
            ce(f"replan@{self.deployed.dag.name}", t0, t1, phase=phase,
               **attrs)

    # -- phases --------------------------------------------------------------
    def _reference(self, blue_dag, rep: ReplanReport):
        """The output green must reproduce: blue's, for the same input
        (warm executables, no compile on the hot path), or the logical
        flow's interpreted ground truth with ``reference="local"``."""
        sample = self.sample
        req = _replicate(sample, max(1, len(sample.rows)))
        try:
            if self.reference == "local":
                return self.deployed.flow.execute_local(
                    req, ProfileCtx(getattr(self.runtime, "kvs", None)))
            out = self.runtime.call_dag_object(blue_dag, req) \
                .result(timeout=self.canary_timeout_s)
            if isinstance(out, DeviceTable):
                out = out.to_table()
            return out
        except Exception as e:
            rep.canary["reference_error"] = f"{type(e).__name__}: {e}"
            return None

    def _canary(self, green, blue_dag, rep: ReplanReport) -> bool:
        sample = self.sample
        want = self._reference(blue_dag, rep)
        if want is None:
            # no reference means no verification: abort rather than swap
            # an unverified green (the documented contract — pass
            # verify=False to swap without canaries)
            rep.canary.update(requests=0, ok=False,
                              error="reference unavailable: "
                              + str(rep.canary.get("reference_error")))
            return False
        for i in range(self.canary_requests):
            req = _replicate(sample, max(1, len(sample.rows)))
            try:
                out = self.runtime.call_dag_object(green.dag, req) \
                    .result(timeout=self.canary_timeout_s)
            except Exception as e:
                rep.canary.update(requests=i + 1, ok=False,
                                  error=f"{type(e).__name__}: {e}")
                return False
            if isinstance(out, DeviceTable):
                out = out.to_table()
            mismatch = _rows_match(out, want, self.rtol)
            if mismatch is not None:
                rep.canary.update(requests=i + 1, ok=False,
                                  error=f"mismatch: {mismatch}")
                return False
        rep.canary.update(requests=self.canary_requests, ok=True)
        return True

    def replan(self, proposal) -> ReplanReport:
        """Run the full lifecycle for one proposed ``PlanConfig``.  On any
        pre-swap failure the report says why and BLUE IS UNTOUCHED; after
        the swap point the report is ``ok`` and the ``DeployedFlow``
        handle points at green."""
        rt = self.runtime
        dep = self.deployed
        blue = dep.dag
        rep = ReplanReport(dag_name=blue.name,
                           blue_generation=blue.generation)
        self.history.append(rep)
        del self.history[:-self.HISTORY_CAP]

        if self.compile_flags is None:
            rep.phase, rep.reason = "compile", \
                ("deployment compiled with an explicit pipeline; pass "
                 "compile_flags to BlueGreenReplanner")
            return rep

        # 1) compile green off the hot path (blue keeps serving)
        rep.phase = "compile"
        t0 = time.perf_counter()
        try:
            green = compile_flow(dep.flow, rt, plan_config=proposal,
                                 name=blue.name, register=False,
                                 **self.compile_flags)
        except Exception as e:
            rep.reason = f"compile failed: {type(e).__name__}: {e}"
            self._phase_event("prepare", t0, time.perf_counter(), ok=False)
            return rep
        rep.timings_s["compile"] = time.perf_counter() - t0
        rep.green_generation = green.dag.generation
        self._phase_event("prepare", t0, time.perf_counter(), ok=True,
                          green_generation=green.dag.generation)

        swapped = False
        try:
            # 2) pre-warm every (chain, bucket, variant) executable — the
            #    proposal's batcher sizes included, since a full merge
            #    pads to THEIR covering bucket, configured set or not
            rep.phase = "warm"
            t0 = time.perf_counter()
            if self.sample is not None:
                extra = {cfg.max_batch for cfg in proposal.nodes.values()
                         if cfg.max_batch > 1}
                rep.warm = warm_deployment(rt, green, self.sample,
                                           extra_rows=sorted(extra))
            else:
                rep.notes.append("no sample: warm skipped")
            rep.timings_s["warm"] = time.perf_counter() - t0
            self._phase_event("warm", t0, time.perf_counter(),
                              skipped=self.sample is None)

            # 3) canary-verify green end to end before traffic sees it
            rep.phase = "canary"
            t0 = time.perf_counter()
            if self.verify and self.sample is not None:
                if not self._canary(green, blue, rep):
                    rep.reason = ("canary failed — blue stays live: "
                                  + str(rep.canary.get("error")))
                    self._phase_event("canary", t0, time.perf_counter(),
                                      ok=False,
                                      error=str(rep.canary.get("error")))
                    return rep
            else:
                rep.notes.append("canary skipped")
            rep.timings_s["canary"] = time.perf_counter() - t0
            self._phase_event("canary", t0, time.perf_counter(), ok=True,
                              skipped=not (self.verify
                                           and self.sample is not None))

            # 4) atomic swap: new requests -> green, in-flight finish on
            #    blue, blue's batchers drain and close on quiescence
            rep.phase = "swap"
            t0 = time.perf_counter()
            blue_state = {"dag": blue, "plan": dep.plan,
                          "pass_trace": getattr(dep, "pass_trace", None)}
            rt.register_dag(green.dag, plan=green.plan)
            swapped = True
            applied = proposal.apply_runtime(rt, green.dag,
                                             autoscaler=self.autoscaler)
            rep.notes.extend(applied)
            # the handle every holder shares now IS the green deployment
            dep.plan = green.plan
            dep.dag = green.dag
            dep.pass_trace = green.pass_trace
            # keep blue resurrectable until the confirm tick passes: its
            # batchers drain but its DAG/plan stay valid, so a failed
            # confirm can swap it straight back in
            self._rollback = blue_state
            adm = getattr(rt, "admission_for", lambda _n: None)(blue.name)
            if adm is not None:
                adm.update(plan=green.plan, config=proposal)
            rep.timings_s["swap"] = time.perf_counter() - t0
            self._phase_event("swap", t0, time.perf_counter(),
                              green_generation=green.dag.generation,
                              blue_generation=blue.generation)
            rep.phase = "done"
            rep.ok = True
            return rep
        finally:
            if not swapped:
                # aborted after green existed: its canary-created
                # batchers (and their threads) must not leak — each
                # re-escalation would otherwise compile a fresh green
                # and pile up another generation's batchers
                try:
                    rt.discard_dag(green.dag)
                except Exception:
                    pass

    # -- rollback ------------------------------------------------------------
    def can_swap_back(self) -> bool:
        return self._rollback is not None

    def swap_back(self, reason: str = "") -> Optional[Dict[str, Any]]:
        """Automatic rollback: re-register the previous (blue) generation
        after a swap whose confirm tick failed.  ``register_dag`` clears
        blue's retired/draining marks atomically, so its (possibly fresh)
        batchers serve immediately; green drains and retires exactly like
        any superseded generation — zero dropped requests either way.
        Records a ``replan/rollback`` metric and returns a small report,
        or None when there is nothing to roll back to."""
        state = self._rollback
        if state is None:
            return None
        self._rollback = None
        rt = self.runtime
        dep = self.deployed
        blue_dag, blue_plan = state["dag"], state["plan"]
        rt.register_dag(blue_dag, plan=blue_plan)
        dep.plan = blue_plan
        dep.dag = blue_dag
        if state["pass_trace"] is not None:
            dep.pass_trace = state["pass_trace"]
        adm = getattr(rt, "admission_for", lambda _n: None)(blue_dag.name)
        if adm is not None:
            adm.update(plan=blue_plan)
        record = getattr(rt, "record_metric", None)
        if record is not None:
            from repro_torch.obs import keys as okeys
            record(okeys.REPLAN_ROLLBACK, time.perf_counter())
        t_rb = time.perf_counter()
        self._phase_event("rollback", t_rb, t_rb, reason=reason,
                          restored_generation=blue_dag.generation)
        report = {"rolled_back": True, "reason": reason,
                  "dag": blue_dag.name,
                  "restored_generation": blue_dag.generation}
        if self.history:
            self.history[-1].notes.append(
                f"rolled back to gen {blue_dag.generation}: {reason}")
        return report
