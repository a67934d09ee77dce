"""The decoder layer's elementwise glue, fused: four hand-written CUDA
kernels that replace runs of eager launches of the transformer's serving
forward and decode step (``models/transformer.py``), and their plain
PyTorch versions.

* :func:`add_rmsnorm` — the residual add and the RMSNorm after it
  (``csrc/add_rmsnorm.cu``): 11 launches in one.
* :func:`rope` — the prefill's RoPE of q and k (``csrc/rope.cu``): 34
  launches in one.
* :func:`rope_cache_write` — a decode step's RoPE of q and k and its
  ring-cache write (``csrc/rope_cache_write.cu``): about 41 in one.
* :func:`gated_act` — the gated MLP's ``act(gate) * up``
  (``csrc/gated_act.cu``): 2 in one.

None replaces a TPU kernel: the reference leaves this glue to XLA, which
fuses it.  The kernels compute what the eager composition computes, in
its order: every intermediate it keeps in f32 stays f32, and every
rounding to the model's dtype happens where it rounds (the one
difference: ``add_rmsnorm`` sums a row's squares in another order).  The
plain versions here are that composition: they call the
``models.layers`` functions the kernels stand for; CPU (and fake)
tensors take them, CUDA tensors launch the kernel or raise
:class:`~repro_torch.kernels.build.KernelError`.  Each wrapper counts its
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.models import layers

#: the ``act`` codes of ``csrc/gated_act.cu``: silu, and any other name
#: the tanh form of gelu, as ``layers._act`` reads it
ACT_SILU, ACT_GELU = 0, 1


def _dtype_code(name: str, *tensors) -> int:
    dtype = tensors[0].dtype
    if dtype not in build.DTYPE_CODE or any(t.dtype != dtype
                                            for t in tensors):
        raise build.KernelError(
            f"{name}: dtypes {[t.dtype for t in tensors]}; needs one of "
            "float32 or bfloat16 throughout")
    return build.DTYPE_CODE[dtype]


def _empty(like):
    """An output: a contiguous tensor of ``like``'s shape, dtype and
    device.  ``empty_like`` of a contiguous tensor costs the host a third
    of what ``torch.empty`` with a shape, dtype and device costs (about
    2.4 against 6.4 microseconds a call on an H100 machine's host, where
    naming a memory format adds 2.5), and the wrappers run a few hundred
    times a decode step."""
    if like.is_contiguous():
        return torch.empty_like(like)
    return torch.empty_like(like, memory_format=torch.contiguous_format)


def _vec_ok(n: int, *tensors) -> bool:
    """Whether 16-byte vectors cover ``n`` elements of every tensor (all
    of one dtype): each starts 16-byte aligned and ``n`` is a whole number
    of vectors."""
    vec = 16 // tensors[0].element_size()
    return n % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


# ---------------------------------------------------------------------------
# add_rmsnorm
# ---------------------------------------------------------------------------
def add_rmsnorm_plain(x, delta, scale, eps: float = 1e-6):
    """``(x + delta, layers.rmsnorm(x + delta, scale, eps))``; without
    ``delta``, ``(x, layers.rmsnorm(x, scale, eps))``."""
    if delta is not None:
        x = x + delta
    return x, layers.rmsnorm(x, scale, eps)


def add_rmsnorm(x, delta: Optional[torch.Tensor], scale,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, delta: [..., D] (delta may be None); scale: [D].  Returns the
    residual ``x + delta`` (x itself without delta) and its RMSNorm
    ``h``, both in x's dtype.

    CPU tensors take :func:`add_rmsnorm_plain`; CUDA tensors launch one
    kernel (counted in ``add_rmsnorm.launches``) or raise KernelError."""
    args = (x, scale) if delta is None else (x, delta, scale)
    dev = build.card_of("add_rmsnorm", args)
    if dev is None:
        return add_rmsnorm_plain(x, delta, scale, eps)
    D = x.shape[-1]
    if tuple(scale.shape) != (D,) or (delta is not None
                                      and delta.shape != x.shape):
        raise build.KernelError(
            f"add_rmsnorm: x{tuple(x.shape)}, delta"
            f"{None if delta is None else tuple(delta.shape)}, scale"
            f"{tuple(scale.shape)}; needs delta shaped like x, scale [D]")
    if not all(t.is_contiguous() for t in args):
        raise build.KernelError("add_rmsnorm: x, delta and scale must be "
                                "contiguous")
    code = _dtype_code("add_rmsnorm", *args)
    h = _empty(x)
    x_out = x if delta is None else _empty(x)
    if h.numel() == 0:
        return x_out, h
    vec = int(_vec_ok(D, *args, x_out, h))
    build.launch(add_rmsnorm, dev, x.data_ptr(),
                 None if delta is None else delta.data_ptr(),
                 scale.data_ptr(), x_out.data_ptr(), h.data_ptr(),
                 x.numel() // D, D, float(eps), code, vec)
    return x_out, h


add_rmsnorm.launches = 0


# ---------------------------------------------------------------------------
# RoPE: the prefill's (rope) and the decode step's (rope_cache_write)
# ---------------------------------------------------------------------------
def rope_plain(q, k, positions, freqs):
    """Both rotations of :func:`rope`: ``layers.apply_rope`` with the
    table ``freqs`` (None: no rotation)."""
    return (layers.apply_rope(q, positions, 0.0, freqs),
            layers.apply_rope(k, positions, 0.0, freqs))


def _check_rope(name, q, k, freqs) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise build.KernelError(f"{name}: q{tuple(q.shape)} and "
                                f"k{tuple(k.shape)} must be 4-d")
    hd = q.shape[-1]
    if k.shape[-1] != hd or hd % 2 or hd > 1024:
        raise build.KernelError(
            f"{name}: head_dims {hd}/{k.shape[-1]}; needs one even "
            "head_dim up to 1024")
    if any(t.stride(-1) != 1 for t in (q, k)):
        raise build.KernelError(f"{name}: head_dim must be the contiguous "
                                "dim")
    if freqs is not None and (freqs.dtype != torch.float32
                              or tuple(freqs.shape) != (hd // 2,)
                              or not freqs.is_contiguous()):
        raise build.KernelError(
            f"{name}: freqs {freqs.dtype}{tuple(freqs.shape)}; needs "
            f"contiguous float32 [{hd // 2}]")


def rope(q, k, positions, freqs: Optional[torch.Tensor]):
    """q: [B, S, H, hd]; k: [B, S, K, hd] (any strides with head_dim
    contiguous); positions: [S] or [B, S] int32; freqs: f32 [hd / 2], the
    table of ``layers.rope_frequencies``, or None for no rotation.
    Returns the rotated (q, k), contiguous; without ``freqs``, (q, k).

    CPU tensors take :func:`rope_plain`; CUDA tensors launch one kernel
    for both (counted in ``rope.launches``) or raise KernelError."""
    if freqs is None:
        return q, k
    dev = build.card_of("rope", (q, k, positions, freqs))
    if dev is None:
        return rope_plain(q, k, positions, freqs)
    _check_rope("rope", q, k, freqs)
    B, S, H, hd = q.shape
    if k.shape[:2] != q.shape[:2]:
        raise build.KernelError(f"rope: q{tuple(q.shape)} and "
                                f"k{tuple(k.shape)} differ in [B, S]")
    if positions.dtype != torch.int32 or tuple(positions.shape) not in (
            (S,), (B, S)):
        raise build.KernelError(
            f"rope: positions {positions.dtype}{tuple(positions.shape)}; "
            f"needs int32 [S] or [B, S] for B={B}, S={S}")
    code = _dtype_code("rope", q, k)
    pb, ps = ((0, positions.stride(0)) if positions.dim() == 1
              else positions.stride())
    qo, ko = _empty(q), _empty(k)
    strides = build.strides_arg([*q.stride()[:3], *k.stride()[:3], pb, ps])
    build.launch(rope, dev, q.data_ptr(), k.data_ptr(), positions.data_ptr(),
                 freqs.data_ptr(), qo.data_ptr(), ko.data_ptr(), B, S, H,
                 k.shape[2], hd, strides, code)
    return qo, ko


rope.launches = 0


def rope_cache_write_plain(q, k, v, pos, kc, vc, pc, freqs):
    """The decode step's RoPE and ring write (``transformer._decode_core``
    without ``kv_quant``): q and k rotated at ``pos`` by the table
    ``freqs`` (None: not rotated), then k, v and pos written into slot
    ``pos % W`` of row b of kc, vc and pc, IN PLACE.  Returns the rotated
    q."""
    q = layers.apply_rope(q, pos[:, None], 0.0, freqs)
    k = layers.apply_rope(k, pos[:, None], 0.0, freqs)
    W = kc.shape[1]
    slot = (pos % W).long()                                       # [B]
    b_idx = torch.arange(q.shape[0], device=q.device)
    kc[b_idx, slot] = k[:, 0]
    vc[b_idx, slot] = v[:, 0]
    pc[b_idx, slot] = pos.to(pc.dtype)
    return q


def rope_cache_write(q, k, v, pos, kc, vc, pc,
                     freqs: Optional[torch.Tensor]):
    """q: [B, 1, H, hd]; k, v: [B, 1, K, hd]; pos: [B] int32; kc, vc:
    [B, W, K, hd] and pc: [B, W] int32, one layer's ring (any strides with
    head_dim contiguous), written IN PLACE; freqs: as :func:`rope`.
    Returns q rotated at ``pos`` (q itself without ``freqs``).

    CPU tensors take :func:`rope_cache_write_plain`; CUDA tensors launch
    one kernel (counted in ``rope_cache_write.launches``) or raise
    KernelError."""
    args = (q, k, v, pos, kc, vc, pc) + (() if freqs is None else (freqs,))
    dev = build.card_of("rope_cache_write", args)
    if dev is None:
        return rope_cache_write_plain(q, k, v, pos, kc, vc, pc, freqs)
    _check_rope("rope_cache_write", q, k, freqs)
    B, _, H, hd = q.shape
    K, W = kc.shape[2], kc.shape[1]
    if (q.shape[1] != 1 or tuple(k.shape) != (B, 1, K, hd)
            or v.shape != k.shape or kc.dim() != 4 or kc.shape[0] != B
            or kc.shape[3] != hd or vc.shape != kc.shape
            or tuple(pc.shape) != (B, W) or tuple(pos.shape) != (B,)):
        raise build.KernelError(
            f"rope_cache_write: q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} kc{tuple(kc.shape)} vc{tuple(vc.shape)} "
            f"pc{tuple(pc.shape)} pos{tuple(pos.shape)} do not fit one "
            "decode step's ring")
    if pos.dtype != torch.int32 or pc.dtype != torch.int32:
        raise build.KernelError("rope_cache_write: pos and pc must be int32")
    if any(t.stride(-1) != 1 for t in (v, kc, vc)):
        raise build.KernelError("rope_cache_write: head_dim must be the "
                                "contiguous dim")
    code = _dtype_code("rope_cache_write", q, k, v, kc, vc)
    qo = q if freqs is None else _empty(q)
    strides = build.strides_arg([
        q.stride(0), q.stride(2), k.stride(0), k.stride(2), v.stride(0),
        v.stride(2), *kc.stride()[:3], *vc.stride()[:3], *pc.stride(),
        pos.stride(0)])
    build.launch(rope_cache_write, dev, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), pos.data_ptr(),
                 None if freqs is None else freqs.data_ptr(), qo.data_ptr(),
                 kc.data_ptr(), vc.data_ptr(), pc.data_ptr(), B, H, K, W,
                 hd, strides, code)
    return qo


rope_cache_write.launches = 0


# ---------------------------------------------------------------------------
# gated_act
# ---------------------------------------------------------------------------
def gated_act_plain(gate, up, act: str):
    """``layers._act(gate, act) * up``."""
    return layers._act(gate, act) * up


def gated_act(gate, up, act: str):
    """gate, up: one shape and dtype; act: ``silu``, else the tanh form
    of gelu (``layers._act``).  Returns ``act(gate) * up`` with the
    activation rounded to the dtype before the product, as the eager
    composition rounds it.

    CPU tensors take :func:`gated_act_plain`; CUDA tensors launch one
    kernel (counted in ``gated_act.launches``) or raise KernelError."""
    dev = build.card_of("gated_act", (gate, up))
    if dev is None:
        return gated_act_plain(gate, up, act)
    if gate.shape != up.shape or not (gate.is_contiguous()
                                      and up.is_contiguous()):
        raise build.KernelError(
            f"gated_act: gate{tuple(gate.shape)} and up{tuple(up.shape)} "
            "must be contiguous and of one shape")
    code = _dtype_code("gated_act", gate, up)
    out = _empty(gate)
    n = gate.numel()
    if n == 0:
        return out
    build.launch(gated_act, dev, gate.data_ptr(), up.data_ptr(),
                 out.data_ptr(), n,
                 ACT_SILU if act == "silu" else ACT_GELU, code,
                 int(_vec_ok(n, gate, up, out)))
    return out


gated_act.launches = 0
