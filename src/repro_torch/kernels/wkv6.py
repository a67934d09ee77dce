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
writing y and S once (see the source note in the ``.cu`` file for the
design).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

MAX_HEAD_DIM = 128        # thread j keeps column j of S in registers


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


def wkv6(r, k, v, w, u, *, return_state: bool = False):
    """r, k, v, w: [B, T, H, hd]; u: [H, hd].  Returns y [B, T, H, hd]
    f32, and with ``return_state`` also the final state [B, H, hd, hd]
    f32 (the recurrence starts from zero).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``wkv6.launches``) or raise KernelError."""
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
    build.launch(wkv6, dev, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                 w.data_ptr(), uf.data_ptr(), y.data_ptr(),
                 S.data_ptr() if S is not None else None,
                 B, T, H, hd, build.DTYPE_CODE[r.dtype])
    return (y, S) if return_state else y


wkv6.launches = 0
