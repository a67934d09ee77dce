"""Lowering of fused tensor chains (port of the reference package's
``core/lowering.py``).

Graph-level fusion (``FuseChainsPass``) collapses a linear chain into one
``Fuse`` node, which still *interprets* its sub-operators one Python call
at a time with runtime typechecks.  When the chain is entirely
``torch.Tensor`` ``Map``/``Filter`` operators placed on a GPU-class
executor, the port composes the per-op functions into one callable.

``JittedFuse`` keeps the exact ``Fuse`` interface (schema/grouping
propagation, ``ops`` list) so every graph-level invariant still holds;
only ``apply`` changes: each row runs the composed chain once, on the
chain's device.  (PyTorch runs eagerly, so there is no trace to cache per
row; the name is kept so the two packages read alike.)

``BatchedJittedFuse`` executes the whole chain as ONE batched dispatch per
batch.  Row counts are padded up to power-of-two buckets, and the batched
callable of each ``(chain signature, bucket shapes, dtypes, masked,
donate)`` key lives in a process-wide ``ExecutableCache``, so identical
chains across re-registrations share it (``traces()`` counts first
builds).  The reference vmaps the chain with ``jax.vmap``; here a step
that carries a natively batched callable (``fn.__batched__``: model
stages, kernel twins) is called once on the stacked rows — so a CUDA
kernel launches once per batch — and only plain row-wise steps go
through ``torch.func.vmap``.  Ragged batches split into shape-uniform
groups; values that cannot be stacked, and steps ``torch.func.vmap``
cannot batch, fall back to the per-row path.  A :class:`KernelError`
never takes a fallback: it propagates.

Device residency, filter-as-mask and cost-based exec-path routing work as
in the reference: ``apply_batched`` accepts and (``emit_device=True``)
emits a :class:`~repro_torch.core.table.DeviceTable`; ``Filter`` members
become a boolean mask column compacted only at the device->host boundary;
and a :class:`ChainProfile` routes small batches per row when that is
measured cheaper.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import operators as ops
from repro_torch.core.table import DeviceTable, Table, value_key
from repro_torch.device import resolve_device
from repro_torch.kernels.build import KernelError
from repro_torch.obs.trace import scope

#: annotation types treated as "tensor" for lowering.  Deliberately NOT
#: np.ndarray: the lowered chain emits tensors, so only fns that already
#: declare torch.Tensor keep their downstream value types unchanged.
_ARRAY_TYPES: Tuple[type, ...] = (torch.Tensor,)


def _array_annotation(t) -> bool:
    return any(t is a for a in _ARRAY_TYPES)


def array_annotation(t) -> bool:
    """Is ``t`` a tensor annotation for lowering purposes?  Public name
    for the eligibility test ``map_is_torch_lowerable``/
    ``filter_is_torch_lowerable`` apply per argument: the static verifier
    (``repro_torch.analysis``) gates abstract interpretation on the same
    predicate, so the two can never disagree about what lowers."""
    return _array_annotation(t)


def untraceable(err: BaseException) -> bool:
    """Is ``err`` a sign that a step cannot run on the lowered path (as
    opposed to a data error or a device failure)?  Type/shape errors, and
    ``torch.func.vmap``'s refusals (data-dependent control flow,
    ``.item()``), which it raises as ``RuntimeError("vmap: ...")``.  A
    :class:`KernelError` is never one: a kernel that fails to build or
    launch must surface, not latch a fallback."""
    if isinstance(err, KernelError):
        return False
    if isinstance(err, (TypeError, ValueError, NotImplementedError)):
        return True
    return isinstance(err, RuntimeError) and str(err).startswith("vmap")


def map_is_torch_lowerable(m: ops.Operator) -> bool:
    """A ``Map`` whose argument and return annotations are all tensors."""
    if not isinstance(m, ops.Map):
        return False
    arg_types = m._arg_types
    if not arg_types or any(a is None or not _array_annotation(a)
                            for a in arg_types):
        return False
    return all(_array_annotation(t) for _, t in m._schema)


def filter_is_torch_lowerable(f: ops.Operator) -> bool:
    """A ``Filter`` whose arguments are all tensors and whose predicate is
    declared ``-> bool``: it lowers into the chain as a boolean mask."""
    if not isinstance(f, ops.Filter):
        return False
    arg_types, ret = ops.fn_signature(f.fn)
    if ret is not bool:
        return False
    return bool(arg_types) and all(a is not None and _array_annotation(a)
                                   for a in arg_types)


def op_is_torch_lowerable(op: ops.Operator) -> bool:
    return map_is_torch_lowerable(op) or filter_is_torch_lowerable(op)


def fuse_is_torch_lowerable(fuse: ops.Operator, placement: str,
                            min_ops: int = 2) -> bool:
    """Eligibility: a ``Fuse`` of >= ``min_ops`` tensor maps/filters
    placed on a GPU-class node (accelerator-attached executor)."""
    return (isinstance(fuse, ops.Fuse)
            and not isinstance(fuse, JittedFuse)
            and placement == "gpu"
            and len(fuse.ops) >= min_ops
            and all(op_is_torch_lowerable(m) for m in fuse.ops))


def _chain_steps(chain_ops: List[ops.Operator]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(("filter" if isinstance(m, ops.Filter) else "map", m.fn)
                 for m in chain_ops)


def _batched_step(fn: Callable) -> Callable:
    """The batch form of one row-wise step: its natively batched callable
    when it carries one, else ``torch.func.vmap`` of the step."""
    native = getattr(fn, "__batched__", None)
    return native if native is not None else torch.func.vmap(fn)


def compose_steps(steps, *, masked_input: bool, with_keep: bool,
                  batched: bool = False, name: Optional[str] = None
                  ) -> Callable:
    """The ONE definition of chain composition, shared by the per-row and
    batched executables (the router swaps between them, so their
    keep-mask semantics must be identical): apply maps in sequence, AND
    every filter's predicate into the keep bit.

    ``masked_input`` — the callable takes the keep mask as its first
    argument; ``with_keep`` — prepend the final keep to the outputs
    (always true when ``masked_input``); ``batched`` — arguments are
    stacked rows and each step runs in its batch form.  Each step runs
    in a ``step`` scope (``repro_torch.obs.trace.scope``) named by its
    function and position; ``name`` (the chain's) stands for the node
    where no executor recorder is open."""
    steps = tuple(s if isinstance(s, tuple) else ("map", s) for s in steps)
    ops_named = tuple(getattr(fn, "__name__", kind) for kind, fn in steps)
    if batched:
        steps = tuple((kind, _batched_step(fn)) for kind, fn in steps)
    emit_keep = masked_input or with_keep

    @torch.no_grad()
    def composed(*args):
        if masked_input:
            keep, vals = args[0], args[1:]
        else:
            keep, vals = True, args
        for i, (kind, fn) in enumerate(steps):
            with scope("step", ops_named[i], node=name, index=i):
                if kind == "filter":
                    k = fn(*vals)
                    keep = k if keep is True else torch.logical_and(
                        torch.as_tensor(keep), k)
                else:
                    out = fn(*vals)
                    vals = out if isinstance(out, tuple) else (out,)
        if not emit_keep:
            return tuple(vals)
        return (torch.as_tensor(keep),) + tuple(vals)

    return composed


def _is_kernel_twin(fn) -> bool:
    """A step ``PlaceKernelsPass`` put in: tagged with a kernel call but
    not itself the oracle step that carries a twin."""
    return getattr(fn, "__kernel__", None) is not None and \
        not hasattr(fn, "__kernel_placed__")


def _sync(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (host-side timing needs it)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(v, device: torch.device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


#: guards the dispatch counters: several executor threads run one chain
#: at once when the runtime serves concurrent batches
_COUNTS_LOCK = threading.Lock()


@dataclasses.dataclass
class JittedFuse(ops.Fuse):
    """A fused chain of tensor map/filter operators composed into ONE
    callable, run once per row on ``device`` (the CUDA device unless the
    pipeline named another).  Filters contribute a boolean ``keep``
    output rather than control flow; the caller drops rows whose keep is
    False."""
    device: Any = None

    def __post_init__(self):
        steps = _chain_steps(self.ops)
        self._steps = steps
        self._has_filter = any(k == "filter" for k, _ in steps)
        # the interpreted fallback runs the steps on the request's raw
        # values, wherever they lie (the host, for a served request): a
        # chain holding placed kernels never takes it, so their work
        # cannot move off the chain's device on its own
        self._holds_kernels = any(_is_kernel_twin(fn) for _, fn in steps)
        self._sig = chain_signature(self.ops)
        self._row_fn = compose_steps(steps, masked_input=False,
                                     with_keep=self._has_filter,
                                     name=self.name)
        last_map = next((m for m in reversed(self.ops)
                         if isinstance(m, ops.Map)), None)
        self._out_arity = (len(last_map._schema) if last_map is not None
                           else len(self.ops[0]._arg_types))
        self._dev: Optional[torch.device] = None
        self._fallback = False
        self._jit_succeeded = False
        self.row_dispatches = 0     # per-row chain executions issued
        self._prof: Optional[ChainProfile] = None
        self._prof_version = -1
        self._timing_tick = 0
        self._force_time = False    # set by a per-row routing probe

    @property
    def dev(self) -> torch.device:
        """The chain's device, resolved on first use (raises without a
        card unless the pipeline named the CPU)."""
        if self._dev is None:
            self._dev = resolve_device(self.device)
        return self._dev

    def profile(self) -> "ChainProfile":
        """This chain's measured cost profile (cached handle into the
        process-wide executable cache; refreshed after a cache clear)."""
        v = EXECUTABLE_CACHE.version
        if self._prof is None or self._prof_version != v:
            self._prof = EXECUTABLE_CACHE.profile(self._sig)
            self._prof_version = v
        return self._prof

    @property
    def name(self):
        return "jit[" + ",".join(o.name for o in self.ops) + "]"

    def _row_call(self, r):
        """One per-row execution on the chain's device; returns the output
        Row, or None for a row a fused filter dropped."""
        dev = self.dev
        with scope("upload", node=self.name, rows=1) as sc:
            vals = tuple(_to_device(v, dev) for v in r.values)
        if sc:
            # a value already on the device moved nothing
            sc.note(bytes=sum(d.nbytes for v, d in zip(r.values, vals)
                              if d is not v))
        out = self._row_fn(*vals)
        with _COUNTS_LOCK:
            self.row_dispatches += 1
        keep = None
        if self._has_filter:
            keep, out = out[0], tuple(out[1:])
        if len(out) != self._out_arity:
            raise ops.TypecheckError(
                f"{self.name}: returned {len(out)} values, schema "
                f"expects {self._out_arity}")
        self._jit_succeeded = True
        if keep is not None and not bool(keep):
            return None
        return r.replace(tuple(out))

    def apply(self, tables: List[Table], ctx=None) -> Table:
        if self._fallback:
            return ops.Fuse.apply(self, tables, ctx)
        (t,) = tables
        schema = self.out_schema([t.schema])
        rows = []
        # router timing is SAMPLED (the host sync drains the device's
        # queue, so it must not tax every call) and only taken where a
        # batched lowering's router reads it
        timed = False
        if getattr(self, "adaptive_routing", False) and \
                self._jit_succeeded and len(t.rows) > 1:
            timed = self._force_time or \
                self._timing_tick % TIMING_SAMPLE_EVERY == 0
            self._timing_tick += 1
        self._force_time = False
        t0 = time.perf_counter()
        try:
            for r in t.rows:
                out = self._row_call(r)
                if out is not None:
                    rows.append(out)
        except ops.TypecheckError:
            raise
        except Exception as e:
            # annotations said "tensor" but the chain cannot run composed
            # on the device.  Only latch the interpreted fallback before
            # any composed call has succeeded; a per-request error on a
            # proven chain — and every KernelError — propagates.
            if self._jit_succeeded or self._holds_kernels or \
                    not untraceable(e):
                raise
            self._fallback = True
            return ops.Fuse.apply(self, tables, ctx)
        if timed and rows:
            _sync(self.dev)
            self.profile().note_per_row(
                (time.perf_counter() - t0) / len(t.rows))
        out_t = Table(schema, grouping=t.grouping)
        out_t.rows = rows
        return out_t


# ---------------------------------------------------------------------------
# batched execution: shape buckets + executable cache
# ---------------------------------------------------------------------------

#: default row-count buckets: powers of two.  A batch of n rows is padded up
#: to the smallest bucket >= n, bounding the distinct shapes per chain.
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """How a low-priority request executes under overload pressure — only
    variants the executable cache already holds:

    * ``per_row`` — route to the per-row executable (skips stack/pad/
      gather entirely);
    * ``bucket_cap`` — when the request does batch, cap its padding bucket;
    * ``competitive`` — False disables competitive replication for the
      request.

    The admission gate (``serving/admission.py``) assigns a policy to a
    request class; the executor sets it with :func:`degraded_execution`
    around the request's node fn, on the worker thread, where the router
    reads it.
    """
    per_row: bool = True
    bucket_cap: Optional[int] = 8
    competitive: bool = False


_DEGRADE_TLS = threading.local()


@contextlib.contextmanager
def degraded_execution(policy: Optional["DegradePolicy"]):
    """Execute the enclosed chain calls under ``policy`` (None = no-op)."""
    prev = getattr(_DEGRADE_TLS, "policy", None)
    _DEGRADE_TLS.policy = policy
    try:
        yield
    finally:
        _DEGRADE_TLS.policy = prev


def active_degrade() -> Optional["DegradePolicy"]:
    """The DegradePolicy in effect on this thread, or None."""
    return getattr(_DEGRADE_TLS, "policy", None)


#: per-row router timing is sampled 1-in-N; aligned with
#: ChainProfile.PROBE_EVERY
TIMING_SAMPLE_EVERY = 16


def bucket_rows(n: int, buckets: Tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n; beyond the table, next power of two."""
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1] if buckets else 1
    while b < n:
        b *= 2
    return b


def chain_signature(chain_ops: List[ops.Operator]) -> Tuple[Any, ...]:
    """Identity of a fused chain: the tuple of its (op kind, function)
    pairs.  Two ``Fuse`` nodes built from the same function objects share
    executables; a redefined function yields a new entry."""
    return _chain_steps(chain_ops)


def crossover_from_costs(per_row_s: Optional[float],
                         batched_s: Dict[int, float],
                         max_n: int = 1024) -> Optional[int]:
    """THE crossover rule, shared by the live router (``ChainProfile``)
    and the offline profiler's ``OpLatencyCurve``: the smallest batch size
    n at which one batched dispatch at n's covering measured bucket beats
    n per-row dispatches, or None while either path is unmeasured."""
    if per_row_s is None or not batched_s:
        return None
    measured = sorted(batched_s)
    for n in range(1, min(max_n, measured[-1]) + 1):
        b = next((batched_s[m] for m in measured if m >= n), None)
        if b is not None and n * per_row_s >= b:
            return n
    return None


class ChainProfile:
    """Measured execution costs of one chain, feeding the exec-path router.

    ``per_row_s`` is an EWMA of warm per-row latency (seconds per row);
    ``batched_s[bucket]`` an EWMA of warm whole-batch latency (seconds per
    dispatch, host->host, device synchronised) at that padded bucket."""

    __slots__ = ("alpha", "per_row_s", "per_row_samples",
                 "batched_s", "batched_samples", "_since_probe", "_lock")

    #: after this many consecutive same-path routings at a bucket, take
    #: the other path once so its estimate stays fresh
    PROBE_EVERY = 16

    #: never probe the per-row direction with more rows than this
    PROBE_ROW_CAP = 8

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.per_row_s: Optional[float] = None
        self.per_row_samples = 0
        self.batched_s: Dict[int, float] = {}
        self.batched_samples: Dict[int, int] = {}
        self._since_probe: Dict[int, int] = {}
        self._lock = threading.Lock()

    def _ewma(self, old: Optional[float], new: float) -> float:
        if old is None:
            return new
        # clamp the sample: a scheduler stall can be 100x the true cost
        return (1.0 - self.alpha) * old + self.alpha * min(new, 3.0 * old)

    def note_per_row(self, seconds_per_row: float) -> None:
        if seconds_per_row <= 0:
            return
        with self._lock:
            self.per_row_s = self._ewma(self.per_row_s, seconds_per_row)
            self.per_row_samples += 1

    def note_batched(self, bucket: int, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            n = self.batched_samples.get(bucket, 0) + 1
            self.batched_samples[bucket] = n
            if n == 1:
                # the first warm execution still pays one-time costs
                return
            self.batched_s[bucket] = self._ewma(
                self.batched_s.get(bucket), seconds)

    def prefer_per_row(self, n: int, bucket: int) -> bool:
        """True when n per-row dispatches are measured cheaper than one
        batched dispatch at ``bucket``.  Unmeasured paths prefer
        batching."""
        with self._lock:
            b = self.batched_s.get(bucket)
            if b is None or self.per_row_s is None:
                return False
            return n * self.per_row_s < b

    def route_decision(self, n: int, bucket: int) -> Tuple[bool, bool]:
        """``(route_per_row, is_probe)``: ``prefer_per_row`` plus symmetric
        probing every ``PROBE_EVERY``-th decision at a bucket."""
        prefer = self.prefer_per_row(n, bucket)
        with self._lock:
            seen = self._since_probe.get(bucket, 0) + 1
            if seen >= self.PROBE_EVERY:
                self._since_probe[bucket] = 0
                if prefer:
                    return False, True             # refresh batched cost
                return n <= self.PROBE_ROW_CAP, True   # refresh per-row
            self._since_probe[bucket] = seen
            return prefer, False

    def route_per_row(self, n: int, bucket: int) -> bool:
        return self.route_decision(n, bucket)[0]

    def crossover_rows(self, max_n: int = 1024) -> Optional[int]:
        """Smallest batch size at which the batched path is measured to
        win, or None while either path is unmeasured.  Candidate buckets
        are the measured ones."""
        with self._lock:
            per_row_s = self.per_row_s
            batched_s = dict(self.batched_s)
        return crossover_from_costs(per_row_s, batched_s, max_n)

    # -- serialization (profiler persistence across processes) ---------------
    def to_dict(self) -> Dict[str, Any]:
        """JSON-serializable state: the EWMAs and sample counts the router
        needs, bucket keys as strings (``from_dict`` restores ints)."""
        with self._lock:
            return {
                "alpha": self.alpha,
                "per_row_s": self.per_row_s,
                "per_row_samples": self.per_row_samples,
                "batched_s": {str(b): s for b, s in self.batched_s.items()},
                "batched_samples": {str(b): n for b, n
                                    in self.batched_samples.items()},
            }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChainProfile":
        p = cls(alpha=float(d.get("alpha", 0.3)))
        per_row = d.get("per_row_s")
        p.per_row_s = float(per_row) if per_row is not None else None
        p.per_row_samples = int(d.get("per_row_samples", 0))
        p.batched_s = {int(b): float(s)
                       for b, s in (d.get("batched_s") or {}).items()}
        p.batched_samples = {int(b): int(n)
                             for b, n in (d.get("batched_samples") or {})
                             .items()}
        return p

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            per_row_s = self.per_row_s
            per_row_samples = self.per_row_samples
            batched_s = dict(self.batched_s)
            batched_samples = dict(self.batched_samples)
        return {
            "per_row_ms": (per_row_s * 1e3
                           if per_row_s is not None else None),
            "per_row_samples": per_row_samples,
            "batched_ms": {b: s * 1e3 for b, s in sorted(batched_s.items())},
            "batched_samples": dict(sorted(batched_samples.items())),
            "crossover_rows": self.crossover_rows(),
        }


class ExecutableCache:
    """Process-wide cache of batched chain executables.

    Entries are keyed on ``(chain signature, bucket shapes, dtypes, masked,
    donate)``.  All entries of one chain share its composed batched
    callable per ``(masked, donate)`` variant; ``misses`` count new
    combinations and ``traces`` count first builds — zero new traces for
    a repeated identical chain is the cache's contract.  The cache also
    carries each chain's measured :class:`ChainProfile`."""

    def __init__(self, max_chains: int = 128):
        self._lock = threading.Lock()
        self.max_chains = max_chains
        #: bumped on clear()/eviction so ops can cache their profile handle
        self.version = 0
        self._fns: "collections.OrderedDict[Tuple, Dict[str, Any]]" = \
            collections.OrderedDict()
        self._entries: Dict[Tuple, int] = {}
        self._profiles: "collections.OrderedDict[Tuple, ChainProfile]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def executable(self, sig: Tuple, steps, shapes: Tuple, dtypes: Tuple,
                   *, masked: bool = False, donate: bool = False,
                   name: Optional[str] = None) -> Callable:
        """The batched callable for this (chain, bucket shapes, dtypes).
        The masked variant takes the boolean liveness column first;
        ``name`` is the chain's, for its step scopes (the first chain of a
        signature to build a variant names it)."""
        with self._lock:
            rec = self._fns.get(sig)
            if rec is None:
                rec = {"counter": [0], "fns": {}}
                self._fns[sig] = rec
                while len(self._fns) > self.max_chains:
                    old_sig, _ = self._fns.popitem(last=False)
                    self._entries = {k: v for k, v in self._entries.items()
                                     if k[0] != old_sig}
                    if self._profiles.pop(old_sig, None) is not None:
                        self.version += 1
                    self.evictions += 1
            else:
                self._fns.move_to_end(sig)
            variant = (bool(masked), bool(donate))
            fn = rec["fns"].get(variant)
            if fn is None:
                fn = rec["fns"][variant] = compose_steps(
                    steps, masked_input=masked, with_keep=masked,
                    batched=True, name=name)
            key = (sig, shapes, dtypes) + variant
            if key in self._entries:
                self._entries[key] += 1
                self.hits += 1
            else:
                self._entries[key] = 0
                self.misses += 1
                rec["counter"][0] += 1
            return fn

    def profile(self, sig: Tuple) -> ChainProfile:
        """The chain's measured cost profile (created on first access)."""
        with self._lock:
            p = self._profiles.get(sig)
            if p is None:
                p = self._profiles[sig] = ChainProfile()
                while len(self._profiles) > self.max_chains:
                    self._profiles.popitem(last=False)
                    self.version += 1
            else:
                self._profiles.move_to_end(sig)
            return p

    def traces(self, sig: Optional[Tuple] = None) -> int:
        """Total first builds, optionally per chain."""
        with self._lock:
            if sig is not None:
                rec = self._fns.get(sig)
                return rec["counter"][0] if rec else 0
            return sum(r["counter"][0] for r in self._fns.values())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"chains": len(self._fns), "entries": len(self._entries),
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "traces": sum(r["counter"][0]
                                  for r in self._fns.values())}

    def clear(self):
        with self._lock:
            self._fns.clear()
            self._entries.clear()
            self._profiles.clear()
            self.hits = self.misses = self.evictions = 0
            self.version += 1


#: the process-wide cache: identical fused chains across plans and
#: re-registrations reuse batched executables.
EXECUTABLE_CACHE = ExecutableCache()


@dataclasses.dataclass
class BatchedJittedFuse(JittedFuse):
    """A fused chain executed as ONE batched dispatch per batch.

    ``apply_batched`` stacks the table's rows into a :class:`DeviceTable`
    on the chain's device (padding the row count up to a power-of-two
    bucket), looks up the batched callable in ``EXECUTABLE_CACHE`` and
    runs the whole batch through it once.  Rows with heterogeneous shapes
    split into shape-uniform groups (one dispatch each).

    Device residency: handed a ``DeviceTable`` the chain runs without
    touching the host, and with ``emit_device=True`` returns one.

    Exec-path routing: the chain's measured :class:`ChainProfile` decides
    per call whether n rows run as one batched dispatch or n per-row
    ones; singletons always take the per-row path.  The per-row path and
    the interpreted ``Fuse`` path remain as fallbacks for non-stackable
    values and steps that cannot be batched — never for a KernelError.
    """
    bucket_sizes: Tuple[int, ...] = DEFAULT_BUCKETS
    adaptive_routing: bool = True

    def __post_init__(self):
        super().__post_init__()
        self._batch_succeeded = False
        self._vmap_fallback = False   # batching failed; per-row works
        self.batch_dispatches = 0
        self.rows_batched = 0

    @property
    def name(self):
        return "vjit[" + ",".join(o.name for o in self.ops) + "]"

    # -- exec-path routing ---------------------------------------------------
    def _route_per_row(self, n: int) -> bool:
        if n <= 1:
            return True
        pol = active_degrade()
        if pol is not None and pol.per_row:
            return True
        if not self.adaptive_routing:
            return False
        route, probe = self.profile().route_decision(
            n, bucket_rows(n, self.bucket_sizes))
        if route and probe:
            self._force_time = True
        return route

    # -- batched execution ---------------------------------------------------
    def _stack_groups(self, rows):
        """Group rows by per-column (shape, dtype); returns
        [(indices, [col lists])] preserving original order within groups.
        Values stay where they are (tensors on the device are stacked
        there, host values are stacked on the host and uploaded once per
        column)."""
        groups: Dict[Tuple, Tuple[List[int], List[List[Any]]]] = {}
        for i, r in enumerate(rows):
            vals = list(r.values)
            key = tuple(value_key(v) for v in vals)
            idxs, cols = groups.setdefault(key, ([], [[] for _ in vals]))
            idxs.append(i)
            for c, v in zip(cols, vals):
                c.append(v)
        return list(groups.values())

    def _run_device(self, dt: DeviceTable, donate: bool) -> DeviceTable:
        """ONE batched dispatch over a device-resident batch; the result
        stays on the device."""
        masked = self._has_filter or dt.mask is not None
        shapes = tuple(tuple(c.shape) for c in dt.columns)
        dtypes = tuple(str(c.dtype) for c in dt.columns)
        do = bool(donate and dt.donatable)
        fn = EXECUTABLE_CACHE.executable(self._sig, self._steps, shapes,
                                         dtypes, masked=masked, donate=do,
                                         name=self.name)
        if masked:
            mask = dt.mask
            if mask is None:
                mask = torch.ones(dt.cap, dtype=torch.bool, device=dt.device)
            outs = fn(mask, *dt.columns)
            new_mask, out_cols = outs[0], outs[1:]
        else:
            out_cols = fn(*dt.columns)
            new_mask = None
        if len(out_cols) != self._out_arity:
            raise ops.TypecheckError(
                f"{self.name}: returned {len(out_cols)} values, schema "
                f"expects {self._out_arity}")
        with _COUNTS_LOCK:
            self.batch_dispatches += 1
            self.rows_batched += dt.nrows
        if do:
            # ownership passed on; make accidental reuse visible
            dt.donatable = False
        return DeviceTable(self.out_schema([dt.schema]), list(out_cols),
                           dt.nrows, dt.row_ids, dt.groups,
                           grouping=dt.grouping, mask=new_mask,
                           donatable=True)

    def _apply_device(self, dt: DeviceTable, ctx, emit_device: bool,
                      donate_out: bool):
        """Device-resident fast path: DeviceTable in, DeviceTable (or host
        table, at the chain boundary) out."""
        if self._fallback:
            return ops.Fuse.apply(self, [dt.to_table()], ctx)
        if self._vmap_fallback:
            return JittedFuse.apply(self, [dt.to_table()], ctx)
        try:
            out_dt = self._run_device(dt, donate=True)
        except ops.TypecheckError:
            raise
        except Exception as e:
            if not untraceable(e) or (self._batch_succeeded
                                      and self._jit_succeeded):
                raise
            if self._jit_succeeded:
                self._vmap_fallback = True
                return JittedFuse.apply(self, [dt.to_table()], ctx)
            if self._batch_succeeded or self._holds_kernels:
                raise
            self._fallback = True
            return ops.Fuse.apply(self, [dt.to_table()], ctx)
        self._batch_succeeded = True
        if emit_device:
            out_dt.donatable = donate_out
            return out_dt
        return out_dt.to_table()

    def apply_batched(self, tables: List[Table], ctx=None, *,
                      emit_device: bool = False,
                      donate_out: bool = False):
        (t,) = tables
        if isinstance(t, DeviceTable):
            return self._apply_device(t, ctx, emit_device, donate_out)
        if self._fallback:
            return ops.Fuse.apply(self, tables, ctx)
        if self._vmap_fallback:
            return JittedFuse.apply(self, tables, ctx)
        n = len(t.rows)
        if n == 1 and not emit_device:
            return JittedFuse.apply(self, tables, ctx)
        if not t.rows:
            return Table(self.out_schema([t.schema]), grouping=t.grouping)
        if not emit_device and self._route_per_row(n):
            return JittedFuse.apply(self, tables, ctx)
        t_start = time.perf_counter()      # stacking cost included
        try:
            groups = self._stack_groups(t.rows)
        except Exception:
            return JittedFuse.apply(self, tables, ctx)
        out_rows: List[Any] = [None] * n
        vmapped_any = False      # did a batched dispatch succeed THIS call?
        try:
            for idxs, cols in groups:
                k = len(idxs)
                if k == 1 and (len(groups) > 1 or not emit_device):
                    i = idxs[0]
                    out_rows[i] = self._row_call(t.rows[i])
                    continue
                bucket = bucket_rows(k, self.bucket_sizes)
                pol = active_degrade()
                if pol is not None and pol.bucket_cap:
                    capped = tuple(b for b in self.bucket_sizes
                                   if b <= pol.bucket_cap)
                    if capped and k <= capped[-1]:
                        bucket = bucket_rows(k, capped)
                with scope("upload", node=self.name, rows=k) as sc:
                    dt = DeviceTable.from_columns(
                        t.schema, cols, [t.rows[i].row_id for i in idxs],
                        [t.rows[i].group for i in idxs], pad_to=bucket,
                        grouping=t.grouping, device=self.dev)
                if sc:
                    sc.note(bytes=dt.nbytes)
                was_fresh = EXECUTABLE_CACHE.misses
                out_dt = self._run_device(dt, donate=True)
                vmapped_any = True
                if emit_device and len(groups) == 1:
                    self._batch_succeeded = True
                    out_dt.donatable = donate_out
                    return out_dt
                for pos, row in out_dt.host_rows():
                    out_rows[idxs[pos]] = row
                if len(groups) == 1 and EXECUTABLE_CACHE.misses == was_fresh:
                    self.profile().note_batched(
                        bucket, time.perf_counter() - t_start)
        except ops.TypecheckError:
            raise
        except Exception as e:
            # the per-row and batched executables are judged separately:
            # a chain can run per row yet fail to batch.  Proven
            # executables never latch, and neither does a KernelError.
            if not untraceable(e) or (self._batch_succeeded
                                      and self._jit_succeeded):
                raise
            if self._jit_succeeded:
                self._vmap_fallback = True
                return JittedFuse.apply(self, tables, ctx)
            if self._batch_succeeded or self._holds_kernels:
                raise
            self._fallback = True
            return ops.Fuse.apply(self, tables, ctx)
        if vmapped_any:
            self._batch_succeeded = True
        out_t = Table(self.out_schema([t.schema]), grouping=t.grouping)
        out_t.rows = [r for r in out_rows if r is not None]
        return out_t

    def apply(self, tables: List[Table], ctx=None) -> Table:
        return self.apply_batched(tables, ctx)

    # -- cache warming (blue/green replanning) -------------------------------
    def warm(self, tables: List[Table], ctx=None, *,
             emit_device: bool = False, donate_out: bool = False):
        """Execute the chain once with the exec-path router bypassed
        (always the batched callable), so this call builds the batch's
        bucket entry in ``EXECUTABLE_CACHE`` whatever the measured
        crossover would route.  Same contract as ``apply_batched``; a
        singleton input still takes the per-row path, exactly the path a
        live singleton takes."""
        with forced_batched_routing([self]):
            return self.apply_batched(tables, ctx, emit_device=emit_device,
                                      donate_out=donate_out)


@contextlib.contextmanager
def forced_batched_routing(chain_ops):
    """Temporarily disable adaptive exec-path routing on the given lowered
    chains, so every multi-row call takes the batched callable (the
    cache-warming walk must build the batched path at every bucket even
    where the live router would route small batches per row).  Restores
    each chain's previous routing flag on exit."""
    prev = [(o, o.adaptive_routing) for o in chain_ops
            if isinstance(o, BatchedJittedFuse)]
    for o, _ in prev:
        o.adaptive_routing = False
    try:
        yield
    finally:
        for o, flag in prev:
            o.adaptive_routing = flag


def lower_fuse(fuse: ops.Fuse, *, batched: bool = False,
               bucket_sizes: Tuple[int, ...] = DEFAULT_BUCKETS,
               device=None) -> JittedFuse:
    """Lower an interpreted ``Fuse`` into a ``JittedFuse`` (or, with
    ``batched=True``, a ``BatchedJittedFuse``) on ``device``."""
    if batched:
        lowered: JittedFuse = BatchedJittedFuse(
            list(fuse.ops), device=device, bucket_sizes=bucket_sizes)
    else:
        lowered = JittedFuse(list(fuse.ops), device=device)
    lowered.resource_class = fuse.resource_class
    lowered.batching = fuse.batching
    lowered.high_variance = fuse.high_variance
    lowered.competitive_replicas = fuse.competitive_replicas
    return lowered
