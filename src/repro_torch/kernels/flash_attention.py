"""Flash attention (the prefill): causal / windowed / softcapped GQA
attention with an online softmax over kv tiles.

Port of ``src/repro/kernels/flash_attention.py`` (the TPU kernel
``_flash_kernel``).  ``flash_attention`` dispatches on the tensors'
device: on the CPU it runs :func:`flash_attention_plain`; on the card it
launches the hand-written CUDA kernel ``csrc/flash_attention.cu`` or
raises :class:`~repro_torch.kernels.build.KernelError`.

The C entry point holds three hand-written instances, picked by
:func:`instance_for` from the dtype and head_dim, never by catching a
failure: ``"wgmma"`` (bf16 at head_dim 64 or 128: one warpgroup per
64-row query tile, TMA loads, tensor-core products, kv tiles that the
masks empty skipped), ``"pingpong"`` (bf16 at head_dim 256: a producer
warp and two consumer warpgroups per 128-row query tile, taking turns at
the tensor cores) and ``"simt"`` (f32, and bf16 at every other head_dim:
scalar f32 FMAs, empty kv tiles skipped).  ``flash_attention.last_instance``
names the instance of the last launch; ``flash_attention.windowed_launches``
counts the launches with a window (gemma2's local layers) apart, and
``flash_attention.launches_by_heads`` counts them by ``(B, H, K)``, so
that ``chip_smoke.py``'s kernels line can give the local and the global
rows, and each model of a run that serves several, their own launch
counts.

The least time of the work on an H100 is the larger of its operations
(about 2 * B * H * S^2 * hd for the causal products, over 989 TFLOP/s)
and its bytes (q, k, v and out once, over 3.35 TB/s).  The kernel
accepts any S (the ragged edge is masked in the kernel) and reads q, k
and v through their strides.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

#: The plain PyTorch version: the naive oracle of :mod:`.ref` (f32 math,
#: masked logits at -1e30, GQA via ``h // G``).  CPU tensors run it; the
#: kernel is held to it.
flash_attention_plain = ref.attention_ref

#: the instances behind the C entry point, by their ``instance`` code
INSTANCES = ("simt", "wgmma", "pingpong")
#: query rows per block of the tensor-core instances (``kBQ`` in their
#: namespaces ``tc`` and ``ws`` of the ``.cu`` file)
Q_TILE = {"wgmma": 64, "pingpong": 128}


def _aligned(t: torch.Tensor, vec: int) -> bool:
    return (t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1]))


def instance_for(q: torch.Tensor) -> str:
    """The kernel instance that serves ``q``'s dtype and head_dim."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128):
        return "wgmma"
    if q.dtype == torch.bfloat16 and q.shape[-1] == 256:
        return "pingpong"
    return "simt"


def check_inputs(q, k, v):
    """What the CUDA kernel takes; raises KernelError on anything else.
    Returns (instance, aligned): the instance that serves the inputs
    (``instance_for``'s) and whether every row start of q, k and v is
    16-byte aligned."""
    err = build.KernelError
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise err(f"flash_attention: bad ranks/shapes q{tuple(q.shape)} "
                  f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, S, hd = q.shape
    Bk, K, Sk, hdk = k.shape
    if (Bk, Sk, hdk) != (B, S, hd) or H % K:
        raise err(f"flash_attention: q{tuple(q.shape)} does not match "
                  f"k{tuple(k.shape)}")
    if hd % 8 or hd > 256:
        raise err(f"flash_attention: head_dim {hd} must be a multiple of "
                  "8 up to 256")
    if q.dtype not in build.DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise err(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype};"
                  " needs float32 or bfloat16 throughout")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise err("flash_attention: head_dim must be the contiguous dim")
    instance = instance_for(q)
    aligned = all(_aligned(t, 16 // t.element_size()) for t in (q, k, v))
    # grid (q tiles, B*H) for the SIMT instance, (B*H, q tiles) for the
    # tensor-core ones; y is limited to 65535
    grid_y = B * H if instance == "simt" else -(-S // Q_TILE[instance])
    if grid_y > 65535:
        raise err(f"flash_attention: the {instance} instance's grid y "
                  f"({grid_y}) exceeds its limit of 65535")
    if instance != "simt" and not aligned:
        raise err(f"flash_attention: the {instance} instance reads q, k "
                  "and v through TMA, which needs 16-byte-aligned bases "
                  "and strides in multiples of 16 bytes")
    return instance, aligned


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None):
    """q: [B, H, S, hd]; k, v: [B, K, S, hd] with H = K * G (any strides
    with a contiguous last dim).  Returns [B, H, S, hd] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``flash_attention.launches``; the instance that ran is
    ``flash_attention.last_instance``) or raise KernelError."""
    dev = build.card_of("flash_attention", (q, k, v))
    if dev is None:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    instance, aligned = check_inputs(q, k, v)
    B, H, S, hd = q.shape
    K = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, H, S, hd), dtype=q.dtype, device=dev)
    strides = build.strides_arg([*q.stride()[:3], *k.stride()[:3],
                                 *v.stride()[:3]])
    build.launch(flash_attention, dev, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), B, H, K, S, hd, strides,
                 float(scale), float(softcap), int(bool(causal)),
                 int(window), build.DTYPE_CODE[q.dtype], int(aligned),
                 INSTANCES.index(instance))
    flash_attention.last_instance = instance
    if window > 0:
        build.count(flash_attention, "windowed_launches")
    build.count(flash_attention, "launches_by_heads", (B, H, K))
    return out


flash_attention.launches = 0
flash_attention.windowed_launches = 0
flash_attention.launches_by_heads = {}
flash_attention.last_instance = None
