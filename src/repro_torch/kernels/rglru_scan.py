"""RG-LRU scan: the diagonal linear recurrence ``h_t = a_t * h_{t-1} + x_t``.

Port of ``src/repro/kernels/rglru_scan.py`` (the TPU kernel
``_rglru_kernel``).  ``rglru_scan`` dispatches on the tensors' device: on
the CPU it runs :func:`rglru_scan_plain`; on the card it launches the
hand-written CUDA kernel ``csrc/rglru_scan.cu`` or raises
:class:`~repro_torch.kernels.build.KernelError`.

The work is bound by bytes: one multiply-add per element read, so its
least time is the bytes of ``a``, ``x``, ``h0`` and the f32 output over
3.35 TB/s.  To keep every load in flight at once the kernel splits T as
well as R (:func:`scan_plan`): one channel a thread, segments of T to the
warps of a block and the blocks of a thread-block cluster (2 blocks of 4
warps at the served T = 256); each segment is staged in shared memory
and folded from zero, the carries between segments pass through shared
and distributed shared memory, and each segment is then run again from
its carry.  It takes any T and R;
``rglru_scan.last_instance`` names the plan of the last launch (see the
source note in the ``.cu`` file for the design).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: The plain PyTorch version: the sequential f32 loop of :mod:`.ref`.
#: CPU tensors run it; the kernel is held to it.
rglru_scan_plain = ref.rglru_scan_ref

STAGED_STEPS = 32         # kStage in csrc/rglru_scan.cu
MAX_CLUSTER = 8           # blocks of one cluster along T (portable size)
MAX_WARPS = 8             # kMaxWarps: segments of T per block
WARPS = 4                 # segments per block before T asks for more
MIN_SEGMENT = 8           # fewer steps per warp than this add no warps


def scan_plan(T: int):
    """How the kernel cuts T: (blocks per cluster, warps per block, steps
    per warp segment).  Blocks of ``WARPS`` warps of at least
    ``MIN_SEGMENT`` steps, as many per cluster as keep each segment
    staged (``STAGED_STEPS``); past 8 blocks, more warps; past that,
    segments are swept twice."""
    warps = max(1, min(WARPS, -(-T // MIN_SEGMENT)))
    nt = max(1, min(MAX_CLUSTER, -(-T // (warps * STAGED_STEPS))))
    if nt * warps * STAGED_STEPS < T:
        warps = min(MAX_WARPS, -(-T // (nt * STAGED_STEPS)))
    return nt, warps, -(-T // (nt * warps))


def check_inputs(a, x, h0) -> None:
    """What the CUDA kernel takes; raises KernelError on anything else."""
    err = build.KernelError
    if a.dim() != 3 or x.shape != a.shape:
        raise err(f"rglru_scan: a{tuple(a.shape)} and x{tuple(x.shape)} "
                  "must share one [B,T,R] shape")
    B, _, R = a.shape
    if B > 65535:
        raise err(f"rglru_scan: B={B} exceeds the grid's y limit of 65535")
    if a.dtype not in build.DTYPE_CODE or x.dtype != a.dtype:
        raise err(f"rglru_scan: dtypes {a.dtype}/{x.dtype}; needs one of "
                  "float32 or bfloat16 for both")
    if h0 is not None and (tuple(h0.shape) != (B, R)
                           or not h0.is_floating_point()):
        raise err(f"rglru_scan: h0 {tuple(h0.shape)} {h0.dtype} must be a "
                  f"floating [B, R] = {(B, R)}")


def rglru_scan(a, x, h0=None):
    """a, x: [B, T, R]; h0: [B, R] or None (zero state).  Returns the h
    trajectory [B, T, R] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``rglru_scan.launches``; ``rglru_scan.last_instance``
    names its plan) or raise KernelError."""
    args = (a, x) if h0 is None else (a, x, h0)
    dev = build.card_of("rglru_scan", args)
    if dev is None:
        return rglru_scan_plain(a, x, h0)
    check_inputs(a, x, h0)
    B, T, R = a.shape
    a, x = a.contiguous(), x.contiguous()
    hf = h0.float().contiguous() if h0 is not None else None
    out = torch.empty((B, T, R), dtype=torch.float32, device=dev)
    nt, warps, seg = scan_plan(T)
    build.launch(rglru_scan, dev, a.data_ptr(), x.data_ptr(),
                 hf.data_ptr() if hf is not None else None, out.data_ptr(),
                 B, T, R, build.DTYPE_CODE[a.dtype], nt, warps, seg)
    rglru_scan.last_instance = (
        f"cluster {nt} x {warps} warps, "
        f"{'staged' if seg <= STAGED_STEPS else 'two sweeps'}")
    return out


rglru_scan.launches = 0
rglru_scan.last_instance = None
