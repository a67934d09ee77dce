"""Public kernel wrappers + the kernel registry (port of the reference
package's ``kernels/ops.py``).

Each wrapper dispatches on the device of its tensors: CPU tensors take the
kernel's plain PyTorch version, CUDA tensors launch the hand-written CUDA
kernel or raise :class:`KernelError`.  There is no interpret mode and no
fallback from the card to a plain version.

The **kernel registry** lets the compiler place kernels into lowered
chains (``PlaceKernelsPass``):

* ``KERNEL_REGISTRY`` describes each kernel: the dispatching wrapper, its
  naive oracle from :mod:`repro_torch.kernels.ref`, the step's column
  names, and which keyword params are *semantic* (they change the math;
  the oracle takes them too).  The CUDA kernels pick their own tiles and
  mask ragged edges, so no kernel has tile params.
* ``kernel_step(name, bound=None, **params)`` builds a dataflow ``Map``
  step: ``torch.Tensor``-annotated, computing via the *oracle* (so
  un-placed plans and ``execute_local`` stay correct), tagged with a
  :class:`KernelCall`.  ``bound`` closes over trailing kernel arguments
  as constants (``wkv6``'s per-model ``u``).  Steps are memoized per
  ``(kernel, params, bound identities)`` so recompiles of the same flow
  share function identity — ``chain_signature`` keys the executable
  cache on the function objects.
* Every step carries its kernel twin (``__kernel_placed__``): the same
  signature, computing via the wrapper.  Per row it adds ``B=1``; its
  ``__batched__`` attribute is the natively batched callable, which a
  batched lowered chain calls once on the stacked rows (one kernel launch
  per batch) instead of vmapping the step.
* ``register_pattern(fn, kernel, **params)`` pattern-matches an existing
  user function object to a kernel, for code that cannot be annotated.
* ``kernel_call_of(fn)`` is the static verifier's probe: the call behind
  a step or its twin.  Both carry their ``bound`` values
  (``__kernel_bound__``), so the verifier can run the oracle in the
  twin's place on fake tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.glue import (add_rmsnorm, gated_act, rope,
                                      rope_cache_write)
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.wkv6 import wkv6

__all__ = ["KernelError", "flash_attention", "decode_attention", "wkv6",
           "rglru_scan", "add_rmsnorm", "rope", "rope_cache_write",
           "gated_act",
           "KernelCall", "KernelSpec", "KERNEL_REGISTRY", "kernel_step",
           "register_pattern", "match_kernel", "kernel_call_of", "placed_fn",
           "placed_twin"]


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """Identity of one kernel placement: kernel name + sorted params.
    Hashable, so it keys the step/placement memo tables — which is what
    makes step function objects (and therefore ``chain_signature`` cache
    keys) stable across recompiles of the same flow."""
    kernel: str
    params: Tuple[Tuple[str, Any], ...] = ()

    def kwargs(self) -> Dict[str, Any]:
        return dict(self.params)

    def __repr__(self):
        ps = ", ".join(f"{k}={v}" for k, v in self.params)
        return f"{self.kernel}({ps})"


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One placeable kernel: the dispatching wrapper, its oracle, the
    step's column names, and the semantic params both of them take."""
    name: str
    fn: Callable                 # dispatching wrapper, leading batch dim
    ref: Callable                # naive oracle, leading batch dim
    args: Tuple[str, ...]        # step argument (column) order
    sem_params: Tuple[str, ...] = ()

    def check_params(self, params: Dict[str, Any]) -> None:
        unknown = set(params) - set(self.sem_params)
        if unknown:
            raise ValueError(f"{self.name}: unknown params {sorted(unknown)}")

    def check_tiles(self, shapes) -> "list":
        """Static shape validation: the constraints the CUDA kernel's
        wrapper enforces at launch, checked against operand shapes
        (``shapes`` maps operand column -> shape tuple, batched or
        row-level: rules index dims from the end).  Returns problem
        strings; empty means the kernel takes these shapes."""
        problems = []
        for what, cols, rule in _TILE_RULES.get(self.name, ()):
            if not shapes or any(c not in shapes for c in cols):
                continue
            dims = [tuple(shapes[c]) for c in cols]
            try:
                ok = rule(*dims)
            except IndexError:
                ok = False
            if not ok:
                problems.append(f"{self.name}: needs {what} "
                                f"(got {dict(zip(cols, dims))})")
        return problems


#: per kernel: (constraint, operand columns, predicate over their shapes)
#: — what the CUDA kernels really require.  None needs a length to divide
#: a tile: the kernels mask the ragged edge.  Dims are indexed from the
#: end so the rules hold for batched operands and row-level specs alike.
_TILE_RULES: Dict[str, Tuple[Tuple[str, Tuple[str, ...], Callable], ...]] = {
    "flash_attention": (
        ("head_dim a multiple of 8 up to 256", ("q",),
         lambda q: q[-1] % 8 == 0 and q[-1] <= 256),
        ("q heads a multiple of kv heads", ("q", "k"),
         lambda q, k: q[-3] % k[-3] == 0),
    ),
    "decode_attention": (
        ("head_dim a multiple of 32 up to 256", ("q",),
         lambda q: q[-1] % 32 == 0 and q[-1] <= 256),
        ("q heads a multiple of kv heads", ("q", "k_cache"),
         lambda q, k: q[-2] % k[-3] == 0),
    ),
    "wkv6": (
        ("head_dim up to 128 (a column of S in one warp)", ("r",),
         lambda r: r[-1] <= 128),
        ("r, k, v, w of one shape", ("r", "k", "v", "w"),
         lambda r, k, v, w: r == k == v == w),
    ),
    "rglru_scan": (
        ("x shaped like a", ("a", "x"), lambda a, x: a == x),
    ),
}


KERNEL_REGISTRY: Dict[str, KernelSpec] = {
    "flash_attention": KernelSpec(
        name="flash_attention", fn=flash_attention, ref=ref.attention_ref,
        args=("q", "k", "v"),
        sem_params=("causal", "window", "softcap", "scale")),
    "decode_attention": KernelSpec(
        name="decode_attention", fn=decode_attention,
        ref=ref.decode_attention_ref,
        args=("q", "k_cache", "v_cache", "k_positions", "q_position"),
        sem_params=("window", "softcap", "scale")),
    "wkv6": KernelSpec(
        name="wkv6", fn=wkv6, ref=ref.wkv6_ref,
        args=("r", "k", "v", "w", "u")),
    "rglru_scan": KernelSpec(
        name="rglru_scan", fn=rglru_scan, ref=ref.rglru_scan_ref,
        args=("a", "x")),
}

#: user fn object -> KernelCall, for code that can't carry the step tag
KERNEL_PATTERNS: Dict[Callable, KernelCall] = {}


def register_pattern(fn: Callable, kernel: str, **params) -> Callable:
    """Pattern-match ``fn`` (an existing map function computing what
    ``kernel`` computes) to the kernel, so ``PlaceKernelsPass`` swaps it.
    Returns ``fn`` for decorator use."""
    KERNEL_PATTERNS[fn] = _call(kernel, params)
    return fn


def _call(kernel: str, params: Dict[str, Any]) -> KernelCall:
    if kernel not in KERNEL_REGISTRY:
        raise ValueError(f"unknown kernel {kernel!r}; have "
                         f"{sorted(KERNEL_REGISTRY)}")
    KERNEL_REGISTRY[kernel].check_params(params)
    return KernelCall(kernel, tuple(sorted(params.items())))


def match_kernel(fn) -> Optional[KernelCall]:
    """The ``PlaceKernelsPass`` probe: the step tag, else the pattern
    table."""
    call = getattr(fn, "__kernel__", None)
    if call is not None:
        return call
    return KERNEL_PATTERNS.get(fn)


def kernel_call_of(fn) -> Optional[KernelCall]:
    """The static verifier's probe (same resolution as ``match_kernel``):
    the ``KernelCall`` behind a step function, whether it is the oracle
    step or its placed kernel twin."""
    return match_kernel(fn)


# -- step construction -------------------------------------------------------

def _named_fn(fname: str, argnames: Tuple[str, ...],
              inner: Callable) -> Callable:
    """A function with explicit positional args (``fn_signature`` reads
    ``__code__``) and torch.Tensor annotations, delegating to ``inner``."""
    src = (f"def {fname}({', '.join(argnames)}):\n"
           f"    return _inner({', '.join(argnames)})")
    ns: Dict[str, Any] = {"_inner": inner}
    exec(src, ns)                                       # noqa: S102
    f = ns[fname]
    f.__annotations__ = {a: torch.Tensor for a in argnames}
    f.__annotations__["return"] = torch.Tensor
    return f


def _rowwise(batched: Callable) -> Callable:
    """Per-row view of a natively batched callable: adds ``B=1``."""
    def per_row(*cols):
        return batched(*[c[None] for c in cols])[0]
    return per_row


def _make_placed(spec: KernelSpec, call: KernelCall,
                 bound: Tuple[Any, ...] = ()) -> Callable:
    """The kernel twin of a step: per row it calls the wrapper with
    ``B=1``; its ``__batched__`` takes the stacked rows in one launch.
    ``bound`` values follow the columns, unbatched."""
    kw = call.kwargs()

    def batched(*cols):
        return spec.fn(*cols, *bound, **kw)

    fn = _named_fn(f"kernel_{spec.name}", spec.args, _rowwise(batched))
    fn.__batched__ = batched
    fn.__kernel__ = call
    fn.__kernel_bound__ = bound
    return fn


def _make_step(spec: KernelSpec, call: KernelCall,
               bound: Tuple[Any, ...] = ()) -> Callable:
    kw = call.kwargs()

    def batched(*cols):
        return spec.ref(*cols, *bound, **kw)

    fn = _named_fn(spec.name, spec.args, _rowwise(batched))
    fn.__batched__ = batched
    fn.__kernel__ = call
    fn.__kernel_bound__ = bound
    fn.__kernel_placed__ = _make_placed(spec, call, bound)
    return fn


#: (KernelCall, bound ids) -> step fn; KernelCall -> twin — function-object
#: stability across recompiles is what keeps executable-cache keys and
#: router state shared
_STEPS: Dict[Tuple[KernelCall, Tuple[Tuple[str, int], ...]], Callable] = {}
_PLACED: Dict[KernelCall, Callable] = {}


def kernel_step(kernel: str, *, bound: Optional[Dict[str, Any]] = None,
                **params) -> Callable:
    """A dataflow map step for ``kernel``: torch.Tensor-annotated, oracle
    semantics, tagged for placement.  ``bound`` holds trailing kernel
    arguments closed over as constants rather than consumed as columns
    (``wkv6``'s ``u``, which is per model, not per row).  Memoized per
    ``(kernel, params, bound identities)``."""
    call = _call(kernel, params)
    spec = KERNEL_REGISTRY[kernel]
    bound = bound or {}
    n_bound = len(bound)
    if n_bound and tuple(bound) != spec.args[-n_bound:]:
        raise ValueError(f"{kernel}: bound args {list(bound)} must be the "
                         f"trailing args of {spec.args}")
    key = (call, tuple((k, id(v)) for k, v in bound.items()))
    fn = _STEPS.get(key)
    if fn is None:
        if n_bound:
            spec = dataclasses.replace(spec, args=spec.args[:-n_bound])
        fn = _STEPS[key] = _make_step(spec, call, tuple(bound.values()))
    return fn


def placed_fn(call: KernelCall) -> Callable:
    """The memoized kernel twin for a *pattern-matched* call (steps built
    by ``kernel_step`` already carry theirs on ``__kernel_placed__``)."""
    fn = _PLACED.get(call)
    if fn is None:
        fn = _PLACED[call] = _make_placed(KERNEL_REGISTRY[call.kernel], call)
    return fn


def placed_twin(fn: Callable) -> Optional[Callable]:
    """Resolve the kernel replacement for a map function, if any: the
    step's own twin, else the registry twin of its matched call."""
    twin = getattr(fn, "__kernel_placed__", None)
    if twin is not None:
        return twin
    call = match_kernel(fn)
    if call is not None:
        return placed_fn(call)
    return None
