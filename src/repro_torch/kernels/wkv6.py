"""WKV6: the RWKV-6 recurrence over a whole sequence from a zero state.

Port of ``src/repro/kernels/wkv6.py`` (the TPU kernel ``_wkv_kernel``).
``wkv6`` dispatches on the tensors' device: on the CPU it runs
:func:`wkv6_plain`; on the card it launches the hand-written CUDA kernel
``csrc/wkv6.cu`` or raises :class:`~repro_torch.kernels.build.KernelError`.

Beside ``y`` the kernel can write the final state S ``[B, H, hd, hd]``
(``return_state=True``): the prefill's decode cache takes it from there,
where the reference runs the recurrence a second time to get it.

The work is bound by bytes: about ``5 * B * T * H * hd^2`` f32
operations on CUDA cores take less time than reading r, k, v, w and
writing y and S once.  The kernel keeps S in registers, cut into tiles of
4 rows by 4 columns, one per thread (:func:`lanes`): a block owns up
to 64 columns of one (b, h), the lanes that share a column group lie in
one warp, and their partial sums of ``r . S`` are combined by a shuffle
reduce-scatter every 8 steps.  f32 inputs with 16-byte aligned rows are
staged with ``cp.async``, everything else through registers;
``wkv6.last_instance`` names the tile and the staging of the last launch
(see the source note in the ``.cu`` file for the design).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

MAX_HEAD_DIM = 128        # 32 lanes (one warp) of 4 rows per column


def lanes(hd: int) -> int:
    """The lanes of 4 rows that share a column group in the kernel's
    instance for head_dim ``hd`` (its rows, 32, 64 or 128, over 4)."""
    return (32 if hd <= 32 else 64 if hd <= 64 else MAX_HEAD_DIM) // 4


def wkv6_plain(r, k, v, w, u, *, return_state: bool = False):
    """The plain PyTorch version: the sequential f32 loop of :mod:`.ref`.
    Returns y [B,T,H,hd] f32, and the final state with ``return_state``."""
    y, S = ref.wkv6_state_ref(r, k, v, w, u)
    return (y, S) if return_state else y


def check_inputs(r, k, v, w, u) -> None:
    """What the CUDA kernel takes; raises KernelError on anything else."""
    err = build.KernelError
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise err(f"wkv6: r, k, v, w must share one [B,T,H,hd] shape "
                  f"(got {[tuple(t.shape) for t in (r, k, v, w)]})")
    B, T, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise err(f"wkv6: u{tuple(u.shape)} must be [H, hd] = {(H, hd)}")
    if hd > MAX_HEAD_DIM:
        raise err(f"wkv6: head_dim {hd} exceeds {MAX_HEAD_DIM}")
    if B > 65535:
        raise err(f"wkv6: B={B} exceeds the grid's y limit of 65535")
    if r.dtype not in build.DTYPE_CODE or any(t.dtype != r.dtype
                                         for t in (k, v, w)):
        raise err(f"wkv6: dtypes {[t.dtype for t in (r, k, v, w)]}; needs "
                  "one of float32 or bfloat16 for r, k, v and w")
    if not u.is_floating_point():
        raise err(f"wkv6: u must be floating point (got {u.dtype})")


def staged_async(r, k, v, w) -> bool:
    """Whether the kernel stages these (contiguous) inputs with cp.async:
    f32 rows that start 16-byte aligned."""
    return (r.dtype == torch.float32 and r.shape[-1] % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in (r, k, v, w)))


def wkv6(r, k, v, w, u, *, return_state: bool = False):
    """r, k, v, w: [B, T, H, hd]; u: [H, hd].  Returns y [B, T, H, hd]
    f32, and with ``return_state`` also the final state [B, H, hd, hd]
    f32 (the recurrence starts from zero).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``wkv6.launches``; ``wkv6.last_instance`` names the
    thread tile and the staging) or raise KernelError."""
    args = (r, k, v, w, u)
    dev = build.card_of("wkv6", args)
    if dev is None:
        return wkv6_plain(*args, return_state=return_state)
    check_inputs(*args)
    B, T, H, hd = r.shape
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    uf = u.float().contiguous()
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=dev)
    S = (torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
         if return_state else None)
    aligned = staged_async(r, k, v, w)
    build.launch(wkv6, dev, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                 w.data_ptr(), uf.data_ptr(), y.data_ptr(),
                 S.data_ptr() if S is not None else None,
                 B, T, H, hd, build.DTYPE_CODE[r.dtype], int(aligned))
    wkv6.last_instance = (f"{lanes(hd)} lanes of 4 rows x 4 columns, "
                          f"{'cp.async' if aligned else 'register'} staging")
    return (y, S) if return_state else y


wkv6.launches = 0
wkv6.last_instance = None
