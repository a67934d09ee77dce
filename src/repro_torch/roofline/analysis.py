"""Three-term roofline of a step on the H100 (port of the reference
package's ``roofline/analysis.py``).

``Roofline`` turns a step's FLOPs, HBM bytes and collective bytes per
GPU into the three times the card needs at least (compute at the bf16
tensor-core peak, memory at HBM bandwidth, collectives over NVLink) and
names the largest.  Its numbers come from the analytic model
(``roofline.flops.estimate``) or from :func:`from_counted`, which counts
a torch callable the way the reference reads XLA's ``cost_analysis()``:

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, convolutions and attention; elementwise work is not counted,
  as a matmul-dominated step's roofline needs only the products);
* bytes as each aten op's input plus output bytes, views excluded (the
  counterpart of XLA's "bytes accessed": every op reads its operands from
  HBM and writes its result there, nothing fused);
* collective bytes as the output bytes of the c10d collective ops, 0 at
  world size 1.

The count runs under ``FakeTensorMode``, so a full-width step allocates
nothing and launches nothing.  A hand-written CUDA kernel launched
through ``ctypes`` is invisible to a dispatch mode, so count the model's
plain path (``use_kernels=False``): the kernels compute the same
function.

The reference also parses collective bytes out of XLA's optimized HLO
text; a torch program has no HLO, so those parsers have no counterpart.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          is_traceable_wrapper_subclass)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.roofline import hw

#: namespaces of the c10d collective ops a dispatch mode sees
COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")


@dataclasses.dataclass
class Roofline:
    flops: float                  # per device
    hbm_bytes: float              # per device
    coll_bytes: float             # per device (output-bytes heuristic)
    model_flops: float = 0.0      # 6*N_active*D global (2* for inference)
    chips: int = 1

    @property
    def t_compute(self) -> float:
        return self.flops / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (hw.NVLINK_BW_PER_LINK * hw.NVLINK_LINKS)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (global executed flops): how much compute is
        'useful'."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
        }


#: ops that move nothing: waiting on a collective's result
_NO_TRAFFIC = {torch.ops._c10d_functional.wait_tensor.default}
#: collectives outside the c10d namespaces: DTensor's all-to-all that
#: moves a shard to another tensor dim (registered when DTensor loads)
_COLLECTIVES = set()
try:
    import torch.distributed.tensor  # noqa: F401  registers the op
    _COLLECTIVES.add(torch.ops._dtensor.shard_dim_alltoall.default)
except (ImportError, AttributeError):    # a build without distributed
    pass


def _nbytes(tree) -> Dict[int, int]:
    """{id: bytes} of the tensors among a pytree's leaves."""
    return {id(t): t.numel() * t.element_size() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


#: set while DTensor derives an op's output shape by running the op on
#: global-shape fake tensors: that is no work of the rank's
_PROPAGATING = threading.local()


def in_propagation() -> bool:
    return getattr(_PROPAGATING, "depth", 0) > 0


def _mark_sharding_propagation() -> None:
    """Wrap DTensor's output-shape derivation so that the counters (and
    the dry-run's memory tracker) can tell its global-shape fake ops from
    the rank's own."""
    try:
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator as SP)
    except ImportError:                  # a build without distributed
        return
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        fn = SP.__dict__.get(name)
        if fn is None or getattr(fn, "_marked", False):
            continue

        def marked(self, *a, _fn=fn, **k):
            _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
            try:
                return _fn(self, *a, **k)
            finally:
                _PROPAGATING.depth -= 1
        marked._marked = True
        setattr(SP, name, marked)


def _wraps(args, kwargs) -> bool:
    """Whether an op's arguments hold a tensor subclass that wraps local
    tensors (a DTensor): the counters decline its op and see the ops it
    runs on the rank's own shards instead."""
    return any(is_traceable_wrapper_subclass(t)
               for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    """Sums, over the aten ops it sees, the FLOPs of each (the formulas of
    ``torch.utils.flop_counter``, which decomposes an op it has none for)
    and the bytes each op reads and writes (its tensor inputs, and the
    outputs that are not one of its inputs); views and metadata queries
    (ops that return no tensor, such as ``prim.device``) move nothing and
    count nothing.  Output bytes of the collectives are also summed
    apart, by op.  Under a mesh it counts one rank's local ops."""

    def __init__(self):
        super().__init__()
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.hbm_bytes = 0
        self.coll_bytes = 0
        self.coll_by_op: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _wraps(args, kwargs):
            return NotImplemented
        if in_propagation():
            return func(*args, **kwargs)
        flops = self.registry.get(func._overloadpacket)
        if flops is None and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if flops is not None:
            self.flops += flops(*args, **kwargs, out_val=out)
        written = _nbytes(out)
        if func.is_view or not written or func in _NO_TRAFFIC:
            return out
        ins = _nbytes((args, kwargs))
        self.hbm_bytes += sum(ins.values()) + sum(
            v for k, v in written.items() if k not in ins)
        if func.namespace in COLLECTIVE_NAMESPACES or func in _COLLECTIVES:
            n = sum(written.values())
            self.coll_bytes += n
            name = func.__name__.split(".")[0]
            self.coll_by_op[name] = self.coll_by_op.get(name, 0) + n
        return out


def run_counted(fn: Callable, *args: Any, fake_mode=None, grad: bool = False,
                modes=(), **kwargs: Any) -> "_Counter":
    """Run ``fn(*args, **kwargs)`` under a :class:`_Counter` and return
    it.  ``fake_mode`` is an active mode whose fake tensors the arguments
    already are (the dry-run's DTensors), else the arguments are faked
    here; ``grad`` runs ``fn`` in grad mode (a train step); ``modes`` are
    entered inside the fake mode, around the count (a memory
    tracker)."""
    import contextlib
    from torch._subclasses.fake_tensor import FakeTensorMode

    _mark_sharding_propagation()
    mode = fake_mode or FakeTensorMode(allow_non_fake_inputs=True)

    def fake(x):
        return (mode.from_tensor(x) if fake_mode is None
                and isinstance(x, torch.Tensor) else x)

    args = tuple(fake(a) for a in args)
    kwargs = {k: fake(v) for k, v in kwargs.items()}
    with contextlib.ExitStack() as stack:
        if fake_mode is None:
            stack.enter_context(mode)
        stack.enter_context(torch.set_grad_enabled(grad))
        for m in modes:
            stack.enter_context(m)
        counter = stack.enter_context(_Counter())
        fn(*args, **kwargs)
    return counter


def count(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` on fake copies of its tensor arguments
    (tensors it closes over, such as weights, are used as they are: a
    fake mode computes no data) and return its counted ``flops``,
    ``hbm_bytes`` and ``coll_bytes``.  Nothing is allocated on a device
    and no kernel runs."""
    c = run_counted(fn, *args, **kwargs)
    return {"flops": float(c.flops), "hbm_bytes": float(c.hbm_bytes),
            "coll_bytes": float(c.coll_bytes)}


def from_counted(fn: Callable, *args: Any, model_flops: float, chips: int,
                 **kwargs: Any) -> Roofline:
    """The roofline of one call of ``fn`` as :func:`count` counts it (the
    torch counterpart of the reference's ``from_compiled``).  The counts
    are this process's, i.e. one device's (under a mesh, one rank's)."""
    c = count(fn, *args, **kwargs)
    return Roofline(flops=c["flops"], hbm_bytes=c["hbm_bytes"],
                    coll_bytes=c["coll_bytes"], model_flops=model_flops,
                    chips=chips)
