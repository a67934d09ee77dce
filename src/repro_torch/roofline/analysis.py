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
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
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


def _nbytes(tree) -> Dict[int, int]:
    """{id: bytes} of the tensors among a pytree's leaves."""
    return {id(t): t.numel() * t.element_size() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


class _ByteCounter(TorchDispatchMode):
    """Sums, over the aten ops it sees, the bytes each op reads and writes
    (its tensor inputs, and the outputs that are not one of its inputs);
    views and metadata queries (ops that return no tensor, such as
    ``prim.device``) move nothing and count nothing.  Output bytes of c10d
    collectives are also summed apart."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.coll_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        written = _nbytes(out)
        if func.is_view or not written:
            return out
        ins = _nbytes((args, kwargs))
        self.hbm_bytes += sum(ins.values()) + sum(
            v for k, v in written.items() if k not in ins)
        if func.namespace in COLLECTIVE_NAMESPACES:
            self.coll_bytes += sum(written.values())
        return out


def count(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` on fake copies of its tensor arguments
    (tensors it closes over, such as weights, are used as they are: a
    fake mode computes no data) and return its counted ``flops``,
    ``hbm_bytes`` and ``coll_bytes``.  Nothing is allocated on a device
    and no kernel runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(x):
        return mode.from_tensor(x) if isinstance(x, torch.Tensor) else x

    args = tuple(fake(a) for a in args)
    kwargs = {k: fake(v) for k, v in kwargs.items()}
    flop_counter = FlopCounterMode(display=False)
    with mode, torch.no_grad(), flop_counter, _ByteCounter() as bytes_:
        fn(*args, **kwargs)
    return {"flops": float(flop_counter.get_total_flops()),
            "hbm_bytes": float(bytes_.hbm_bytes),
            "coll_bytes": float(bytes_.coll_bytes)}


def from_counted(fn: Callable, *args: Any, model_flops: float, chips: int,
                 **kwargs: Any) -> Roofline:
    """The roofline of one call of ``fn`` as :func:`count` counts it (the
    torch counterpart of the reference's ``from_compiled``).  The counts
    are this process's, i.e. one device's."""
    c = count(fn, *args, **kwargs)
    return Roofline(flops=c["flops"], hbm_bytes=c["hbm_bytes"],
                    coll_bytes=c["coll_bytes"], model_flops=model_flops,
                    chips=chips)
