"""Decode attention: ONE query token per sequence against a ring KV cache.

Port of ``src/repro/kernels/decode_attention.py`` (the TPU kernel
``_decode_kernel``).  ``decode_attention`` dispatches on the tensors'
device: on the CPU it runs :func:`decode_attention_plain`; on the card it
launches the hand-written CUDA kernel ``csrc/decode_attention.cu`` or
raises :class:`~repro_torch.kernels.build.KernelError`.

The kernel is memory-bound: its least time on an H100 is the K and V
bytes of the valid slots over 3.35 TB/s.  It splits the ring cache over
``splits`` blocks per (b, kv head) (flash-decoding, :func:`split_plan`),
skips tiles of slots that hold no valid key, and merges the splits'
partials in a second kernel behind the same C entry point; the number
of splits of the last launch is ``decode_attention.last_splits``.  It
reads the cache through the caller's strides, so the model's transposed
``[B, W, K, hd]`` ring cache is never copied (see the source note in the
``.cu`` file for the design).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

#: The plain PyTorch version: the naive oracle of :mod:`.ref` (f32 math,
#: masked logits at -1e30, so an all-empty ring cache returns the mean of
#: V).  CPU tensors run it; the kernel is held to it.
decode_attention_plain = ref.decode_attention_ref

#: cache slots per tile of the split kernel (``kTS`` in the ``.cu`` file)
TILE = 32
#: blocks to aim for: about four per SM of an H100 (132 SMs), all
#: resident at once; at the served shape every split is one tile, so a
#: block's path is its set-up and one tile
TARGET_BLOCKS = 4 * 132


@functools.lru_cache(maxsize=None)
def split_plan(B: int, K: int, S: int):
    """(splits, chunk): each of ``splits`` blocks per (b, kv head) owns
    ``chunk`` consecutive ring slots, a multiple of :data:`TILE`, so that
    B * K * splits blocks cover the card about four times.  The last
    split may own fewer slots."""
    tiles = -(-S // TILE)
    want = max(1, min(tiles, -(-TARGET_BLOCKS // (B * K))))
    chunk = -(-tiles // want) * TILE
    return -(-S // chunk), chunk


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
    (two kernels, counted as one launch in ``decode_attention.launches``)
    or raise KernelError."""
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
    splits, chunk = split_plan(B, K, S)
    # f32 scratch for the splits' partials: (m, l) [B, H, splits, 2],
    # then acc [B, H, splits, hd]
    part = torch.empty(B * H * splits * (2 + hd), dtype=torch.float32,
                       device=dev)
    part_ml = part.data_ptr()
    strides = build.strides_arg([
        q.stride(0), q.stride(1),
        *k_cache.stride()[:3], *v_cache.stride()[:3],
        k_positions.stride(0), k_positions.stride(1), q_position.stride(0)])
    build.launch(decode_attention, dev, q.data_ptr(), k_cache.data_ptr(),
                 v_cache.data_ptr(), k_positions.data_ptr(),
                 q_position.data_ptr(), out.data_ptr(), part_ml,
                 part_ml + B * H * splits * 2 * 4, B, H, K, S, hd, splits,
                 chunk, strides, float(scale), float(softcap), int(window),
                 build.DTYPE_CODE[q.dtype], aligned)
    decode_attention.last_splits = splits
    return out


decode_attention.launches = 0
decode_attention.last_splits = None
