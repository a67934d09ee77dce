"""The MoE layer's routing, placement and combine, fused: three
hand-written CUDA kernels around the three grouped expert products of
``models/moe.py`` ``moe_apply_grouped``, and their plain PyTorch versions.

* :func:`moe_route` — the router and the pairs' counts
  (``csrc/moe_route.cu``, two kernels in one call): f32 logits, softmax,
  the stable top-k, the load-balance loss, each expert's end among the
  expert-sorted pairs and each tile's bases.
* :func:`moe_permute` — each (token, expert) pair's place among the
  expert-sorted pairs and the gather of its row (``csrc/moe_permute.cu``).
* :func:`moe_combine` — each token's k expert rows weighted by its gates,
  summed in f32 in the experts' order (``csrc/moe_combine.cu``).

A MoE call on the card is then these three, the three grouped products
(each with its own data-preparation launch) and the gated activation
(``glue.gated_act``): 11 launch calls, where the eager composition makes
about 35.

None replaces a TPU kernel: the reference routes, sorts and combines with
XLA ops.  The plain versions here are the eager composition, op for op
(:func:`moe_route_plain`, :func:`moe_permute_plain` and
:func:`moe_combine_plain`, which ``moe_apply_grouped`` runs without
``use_kernels`` or under a mesh); CPU (and fake) tensors take them, and
CUDA tensors launch the kernel
or raise :class:`~repro_torch.kernels.build.KernelError`: for a float16
x, more than ``MAX_EXPERTS`` experts or ``MAX_K`` choices, or an input
that requires grad under grad mode.  The kernels compute the
same function in f32 throughout and choose the same experts but at
ties that the f32 sums break; the router's product and softmax sum in
other, fixed orders, so their floats can differ from the plain versions'
in the last bits.  The combine adds a token's rows in the experts'
order, the masked combine's.  Each wrapper counts its calls in
``<wrapper>.launches`` (``moe_route``'s call launches two kernels).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

#: the most experts and choices a token the kernels take
MAX_EXPERTS, MAX_K = 256, 8


class Routes(NamedTuple):
    """A router call's result.  ``order`` (the pairs in stable expert
    order, int64 [T k]) comes from the plain version and ``work`` (the
    int32 workspace of counts and bases that ``moe_permute`` reads) from
    the kernel; each leaves the other None."""
    top_w: torch.Tensor           # [T, k] f32: the gates
    top_i: torch.Tensor           # [T, k] int64: the experts
    ends: torch.Tensor            # [E] int32: torch._grouped_mm's offs
    aux: torch.Tensor             # [] f32: the load-balance loss
    order: Optional[torch.Tensor]
    work: Optional[torch.Tensor]


def route_tile(tokens: int) -> int:
    """The tokens of one ``moe_route`` (and ``moe_permute``) block: one
    where a call has few, so each reads the router's weights on its own
    block, else eight, which share each weight read."""
    return 1 if tokens <= 4 else 8


# ---------------------------------------------------------------------------
# plain versions: the eager composition of moe_apply_grouped
# ---------------------------------------------------------------------------
def router_plain(xf, router_w, k: int, mean=None, renorm: bool = True):
    """xf: [T, D] -> (weights [T, k] f32, experts [T, k] int64, aux loss
    scalar f32).  f32 logits and softmax, the k largest probabilities
    (renormalised by ``max(sum, 1e-9)`` with ``renorm``, as they are
    without), and the Switch load-balance loss from each token's first
    choice.  Ties go to the lower expert, as ``jax.lax.top_k`` has them:
    a stable descending sort, where ``torch.topk`` leaves the order of
    ties open.  ``mean`` (optional) averages the two load-balance
    statistics over ranks."""
    logits = xf.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                        # [T, E]
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    if renorm:
        top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    T, E = probs.shape
    me = probs.mean(dim=0)                                       # router frac
    # first-choice counts without a one-hot (or bincount, whose length
    # depends on the data under fake tensors)
    ce = torch.zeros(E, dtype=torch.float32, device=xf.device).scatter_add_(
        0, top_i[:, 0], torch.ones(T, dtype=torch.float32,
                                   device=xf.device)) / T
    if mean is not None:       # statistics over every rank's tokens
        me, ce = mean(me), mean(ce)
    aux = E * torch.sum(me * ce)
    return top_w, top_i, aux


def sort_pairs_plain(top_i, E: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """top_i: [T, k] -> (order [T k] int64, ends [E] int32): the pairs
    (t k + j) in stable order of their experts, and each expert's end
    among them (the inclusive prefix of its pair counts)."""
    flat_e = top_i.reshape(-1)                                   # [T*k]
    order = torch.argsort(flat_e, stable=True)      # pairs, by expert
    counts = torch.zeros(E, dtype=torch.int64, device=top_i.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    return order, torch.cumsum(counts, 0).to(torch.int32)


def moe_route_plain(xf, router_w, k: int, renorm: bool,
                    mean=None) -> Routes:
    """:func:`router_plain` (``mean`` as there) and
    :func:`sort_pairs_plain`."""
    top_w, top_i, aux = router_plain(xf, router_w, k, mean, renorm)
    order, ends = sort_pairs_plain(top_i, router_w.shape[-1])
    return Routes(top_w, top_i, ends, aux, order, None)


def moe_permute_plain(xf, routes: Routes):
    """The pairs' rows ``xf[order // k]`` [T k, D], and each pair's place
    among them, ``pos`` [T, k] int32 (``order``'s inverse)."""
    T, k = routes.top_i.shape
    order = routes.order
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    return xf[order // k], pos.reshape(T, k).to(torch.int32)


def moe_combine_plain(out_rows, routes: Routes, pos):
    """The expert rows ``out_rows`` [T k, D] (the pairs in the plain
    routes' ``order``; ``pos`` is its inverse, and not read) weighted by
    their gates and added into an f32 output per token, rounded once to
    the rows' dtype."""
    (T, k), D = routes.top_w.shape, out_rows.shape[1]
    order = routes.order
    gate = routes.top_w.reshape(-1)[order]
    y = torch.zeros((T, D), dtype=torch.float32, device=out_rows.device)
    y.index_add_(0, order // k, gate[:, None] * out_rows.float())
    return y.to(out_rows.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def moe_route(xf, router_w, k: int, renorm: bool) -> Routes:
    """xf: [T, D] (float32 or bfloat16); router_w: [D, E] float32.
    Returns the :class:`Routes` of the tokens' k experts each.

    CPU tensors take :func:`moe_route_plain`; CUDA tensors launch the
    route and scan kernels in one call (counted once in
    ``moe_route.launches``) or raise KernelError."""
    dev = build.card_of("moe_route", (xf, router_w))
    if dev is None:
        return moe_route_plain(xf, router_w, k, renorm)
    if (xf.dim() != 2 or router_w.dim() != 2
            or router_w.shape[0] != xf.shape[1] or xf.shape[0] < 1):
        raise build.KernelError(
            f"moe_route: xf{tuple(xf.shape)}, router_w"
            f"{tuple(router_w.shape)}; needs xf [T >= 1, D], router_w "
            "[D, E]")
    T, D = xf.shape
    E = router_w.shape[1]
    if not 1 <= k <= min(E, MAX_K) or E > MAX_EXPERTS:
        raise build.KernelError(
            f"moe_route: E {E}, k {k}; needs E <= {MAX_EXPERTS} and "
            f"1 <= k <= min(E, {MAX_K})")
    if (router_w.dtype != torch.float32 or xf.dtype not in build.DTYPE_CODE
            or not (xf.is_contiguous() and router_w.is_contiguous())):
        raise build.KernelError(
            f"moe_route: xf {xf.dtype}, router_w {router_w.dtype}; needs "
            "contiguous xf in float32 or bfloat16 and a contiguous float32 "
            "router")
    tile = route_tile(T)
    tiles = -(-T // tile)
    top_w = torch.empty((T, k), dtype=torch.float32, device=dev)
    top_i = torch.empty((T, k), dtype=torch.int64, device=dev)
    work = torch.empty(E + 3 * tiles * E, dtype=torch.int32, device=dev)
    sums = torch.empty(1 + tiles * E, dtype=torch.float32, device=dev)
    vec = int(E % 4 == 0 and _aligned(router_w))
    build.launch(moe_route, dev, xf.data_ptr(), router_w.data_ptr(),
                 top_w.data_ptr(), top_i.data_ptr(), work.data_ptr(),
                 sums.data_ptr(), T, D, E, k, int(renorm), tile,
                 build.DTYPE_CODE[xf.dtype], vec)
    return Routes(top_w, top_i, work[:E], sums[0], None, work)


moe_route.launches = 0


def moe_permute(xf, routes: Routes) -> Tuple[torch.Tensor, torch.Tensor]:
    """xf: [T, D] contiguous; routes: :func:`moe_route`'s for xf.  Returns
    (rows [T k, D], the pairs' rows in expert order; pos [T, k] int32,
    each pair's place among them).

    CPU tensors take :func:`moe_permute_plain`; CUDA tensors launch one
    kernel (counted in ``moe_permute.launches``) or raise KernelError."""
    dev = build.card_of("moe_permute", (xf, routes.top_i))
    if dev is None:
        return moe_permute_plain(xf, routes)
    T, k = routes.top_i.shape
    D = xf.shape[1]
    if routes.work is None or xf.shape[0] != T or not xf.is_contiguous():
        raise build.KernelError(
            f"moe_permute: xf{tuple(xf.shape)} against routes of {T} "
            "tokens; needs contiguous xf [T, D] and moe_route's routes")
    rows = torch.empty((T * k, D), dtype=xf.dtype, device=dev)
    pos = torch.empty((T, k), dtype=torch.int32, device=dev)
    es = xf.element_size()
    vec = int(D * es % 16 == 0 and _aligned(xf, rows))
    build.launch(moe_permute, dev, xf.data_ptr(), routes.top_i.data_ptr(),
                 routes.work.data_ptr(), pos.data_ptr(), rows.data_ptr(), T,
                 D, routes.ends.shape[0], k, route_tile(T), es, vec)
    return rows, pos


moe_permute.launches = 0


def moe_combine(out_rows, routes: Routes, pos):
    """out_rows: [T k, D] contiguous, the expert products of
    :func:`moe_permute`'s rows; routes, pos: as that call's.  Returns y
    [T, D] in out_rows' dtype: each token's rows weighted by its gates,
    summed in f32 in the experts' order and rounded once.

    CPU tensors take :func:`moe_combine_plain`; CUDA tensors launch one
    kernel (counted in ``moe_combine.launches``) or raise KernelError."""
    dev = build.card_of("moe_combine", (out_rows, routes.top_w, pos))
    if dev is None:
        return moe_combine_plain(out_rows, routes, pos)
    T, k = routes.top_w.shape
    D = out_rows.shape[1]
    if (out_rows.shape[0] != T * k or not out_rows.is_contiguous()
            or out_rows.dtype not in build.DTYPE_CODE
            or pos.dtype != torch.int32 or tuple(pos.shape) != (T, k)):
        raise build.KernelError(
            f"moe_combine: out_rows {out_rows.dtype}{tuple(out_rows.shape)},"
            f" pos {pos.dtype}{tuple(pos.shape)} for {T} tokens of {k}; "
            "needs contiguous float32 or bfloat16 rows [T k, D] and int32 "
            "pos [T, k]")
    y = torch.empty((T, D), dtype=out_rows.dtype, device=dev)
    vec = int(D * out_rows.element_size() % 16 == 0
              and _aligned(out_rows, y))
    build.launch(moe_combine, dev, out_rows.data_ptr(),
                 routes.top_w.data_ptr(), pos.data_ptr(), y.data_ptr(), T,
                 D, k, build.DTYPE_CODE[out_rows.dtype], vec)
    return y


moe_combine.launches = 0
