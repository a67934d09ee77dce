"""Decode attention: ONE query token per sequence against a ring KV cache.

Port of ``src/repro/kernels/decode_attention.py`` (the TPU kernel
``_decode_kernel``).  ``decode_attention`` dispatches on the tensors'
device: on the CPU it runs :func:`decode_attention_plain`; on the card it
launches the hand-written CUDA kernel ``csrc/decode_attention.cu`` or
raises :class:`~repro_torch.kernels.build.KernelError`.

The kernel is memory-bound: its least time on an H100 is the K and V
bytes it must read over 3.35 TB/s.  It reads the cache through the
caller's strides, so the model's transposed ``[B, W, K, hd]`` ring cache
is never copied (see the source note in the ``.cu`` file for the design).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

#: The plain PyTorch version: the naive oracle of :mod:`.ref` (f32 math,
#: masked logits at -1e30, so an all-empty ring cache returns the mean of
#: V).  CPU tensors run it; the kernel is held to it.
decode_attention_plain = ref.decode_attention_ref

def _tile_rows(hd: int) -> int:
    """Cache slots staged per tile: K and V tiles in f32 plus positions
    stay under 40 KB of shared memory (no opt-in above 48 KB needed)."""
    rows = max(1, min(64, 40960 // (8 * hd + 4)))
    return 1 << (rows.bit_length() - 1)


def _aligned(t: torch.Tensor, vec: int) -> bool:
    return (t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1]))


def check_inputs(q, k_cache, v_cache, k_positions, q_position) -> None:
    """What the CUDA kernel takes; raises KernelError on anything else."""
    err = build.KernelError
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise err(f"decode_attention: bad ranks/shapes q{tuple(q.shape)} "
                  f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    B, H, hd = q.shape
    Bk, K, S, hdk = k_cache.shape
    if Bk != B or hdk != hd or H % K:
        raise err(f"decode_attention: q{tuple(q.shape)} does not match "
                  f"cache{tuple(k_cache.shape)}")
    if hd % 32 or hd > 256:
        raise err(f"decode_attention: needs head_dim a multiple of 32 up "
                  f"to 256 (hd={hd})")
    if q.dtype not in build.DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise err(f"decode_attention: dtypes {q.dtype}/{k_cache.dtype}/"
                  f"{v_cache.dtype}; needs float32 or bfloat16 throughout")
    if k_positions.dtype != torch.int32 or q_position.dtype != torch.int32:
        raise err("decode_attention: positions must be int32")
    if tuple(k_positions.shape) != (B, S) or tuple(q_position.shape) != (B,):
        raise err(f"decode_attention: positions {tuple(k_positions.shape)}"
                  f"/{tuple(q_position.shape)} for B={B}, S={S}")
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise err("decode_attention: head_dim must be the contiguous dim")


def decode_attention(q, k_cache, v_cache, k_positions, q_position, *,
                     window: int = 0, softcap: float = 0.0,
                     scale: Optional[float] = None):
    """q: [B, H, hd]; k_cache/v_cache: [B, K, S, hd] (any strides with a
    contiguous last dim); k_positions: [B, S] int32 (-1 empty);
    q_position: [B] int32.  Returns [B, H, hd] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``decode_attention.launches``) or raise KernelError."""
    args = (q, k_cache, v_cache, k_positions, q_position)
    dev = build.card_of("decode_attention", args)
    if dev is None:
        return decode_attention_plain(*args, window=window, softcap=softcap,
                                      scale=scale)
    check_inputs(*args)
    B, H, hd = q.shape
    K, S = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    vec = 16 // q.element_size()
    aligned = int(_aligned(k_cache, vec) and _aligned(v_cache, vec))
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    strides = build.strides_arg([
        q.stride(0), q.stride(1),
        *k_cache.stride()[:3], *v_cache.stride()[:3],
        k_positions.stride(0), k_positions.stride(1), q_position.stride(0)])
    build.launch(decode_attention, dev, q.data_ptr(), k_cache.data_ptr(),
                 v_cache.data_ptr(), k_positions.data_ptr(),
                 q_position.data_ptr(), out.data_ptr(), B, H, K, S, hd,
                 _tile_rows(hd), strides, float(scale), float(softcap),
                 int(window), build.DTYPE_CODE[q.dtype], aligned)
    return out


decode_attention.launches = 0
