"""Mixture-of-Experts FFN (port of the reference package's
``models/moe.py``, its single-device half).

Two functions compute the same thing:

* :func:`moe_apply_reference` — the reference's exact masked combine: every
  expert runs over every token and a token keeps the outputs of the k
  experts it was routed to.  Its work grows with T x E; it is the plain
  version, which the tests and ``chip_smoke.py`` hold the served path to.
* :func:`moe_apply` — the served path.  The T*k routed (token, expert)
  pairs are sorted by expert, so each expert's rows are contiguous, and
  one grouped product per weight matrix (``torch._grouped_mm``, with the
  group ends on the device) runs each expert over its own rows only; the
  gated rows are then added into an f32 output.  Its work grows with the
  routed pairs, no token is dropped (the reference at world size 1 drops
  none either: ``capacity_factor`` plays no part), and nothing is read
  back to the host, so the static verifier can walk it.  The router, the
  pairs' placement with the rows' gather, the gated activation and the
  combine are the layer's ops (``models/layer_ops.py``): on the card
  with ``use_kernels`` and no mesh the kernels of
  :mod:`repro_torch.kernels.moe` and ``glue.gated_act``, 11 launch calls
  a call around the three products where the eager composition makes
  about 35.  As every kernel wrapper does, they raise ``KernelError`` on
  the card for what the kernels do not take (a float16 x, more than 256
  experts or 8 choices, an input that autograd would differentiate).

Under a mesh whose model axis has more than one rank, :func:`moe_apply`
takes the reference's expert-parallel path, :func:`moe_apply_ep`: each
rank routes its own tokens into per-expert capacity buckets of
``_capacity(T, k, E, capacity_factor)`` rows (a stable sort of the expert
ids ranks the pairs, so the same pairs drop as in the reference), the
buckets go to the experts' ranks with one ``all_to_all`` over the model
axis (or every rank gathers all experts' weights, ``dispatch=
"allgather"``), and the outputs come back the same way.  That body runs
in a ``local_map`` region (:func:`~repro_torch.models.partition.
local_region`) on each rank's local tokens and expert shards, as the
reference's ``shard_map`` runs it: DTensor's own rules would gather the
whole batch for the router's sort and the bucket scatter.  At a model
axis of 1 under a mesh the served path runs in such a region too, on
each rank's own tokens (``torch._grouped_mm`` has no DTensor rule), and
its load-balance statistics are averaged over the data ranks, so the
loss is the global one.

The router renormalises each token's k weights to sum to 1 where
``cfg.norm_topk_prob`` holds (arctic, llama4: the reference's router);
with it off (deepseek-moe) a token keeps its k softmax probabilities.

:func:`moe_apply_grouped` counts its calls in ``moe_apply_grouped.calls``,
the routed (token, expert) pairs, tokens x k, in
``moe_apply_grouped.pairs``, and the calls that launched the kernels in
``moe_apply_grouped.fused``: host counters, which read nothing back from
the device.  :func:`recorded_routes` lists the
experts each router call chose, for the checks that compare routes.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import moe as kmoe
from repro_torch.models import layer_ops, layers
from repro_torch.models.partition import (AxisInfo, P, all_gather,
                                          all_to_all, is_dtensor,
                                          local_region, pmean, reshard)

_EXPERT_MATS = ("w_gate", "w_up", "w_down")


def moe_init(cfg: ModelConfig, dtype: torch.dtype, n_layers: int, *,
             generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Stacked MoE params for ``n_layers`` MoE layers: an f32 router
    ``[n, D, E]`` and expert stacks ``[n, E, D, F]`` / ``[n, E, F, D]``,
    normal(0, 1/sqrt(fan_in)) as in the reference.  Each expert's slice is
    drawn in f32 and written straight into the ``dtype`` stack, so no f32
    copy of a whole stack (35.7 GB for arctic's two-layer ``w_up``) is
    ever held."""
    D, F, E = cfg.d_model, cfg.expert_ff, cfg.num_experts

    def stack(shape, fan_in):
        out = torch.empty((n_layers, E) + shape, dtype=dtype, device=device)
        if out.device.type == "meta":
            return out
        for i in range(n_layers):
            for e in range(E):
                out[i, e] = layers.dense_init(shape, dtype, fan_in=fan_in,
                                              generator=generator,
                                              device=device)
        return out

    p = {"router": layers.dense_init((n_layers, D, E), torch.float32,
                                     fan_in=D, generator=generator,
                                     device=device),
         "w_up": stack((D, F), D),
         "w_down": stack((F, D), F)}
    if cfg.gated_mlp:
        p["w_gate"] = stack((D, F), D)
    return p


def quantize_expert_weights(moe_params: Dict[str, Any]) -> Dict[str, Any]:
    """int8-quantize the stacked expert weights: each ``[n, E, D, F]``-like
    tensor becomes ``{"q": int8, "s": f32 [n, E, F]}``, one scale per
    (expert, out-feature) over the reduction dim, ``max|w| / 127`` (at
    least 1e-8 / 127), values rounded half to even and clipped to +-127.
    Computed one (layer, expert) slice at a time, in f32."""
    out = dict(moe_params)
    for name in _EXPERT_MATS:
        if name not in moe_params:
            continue
        w = moe_params[name]
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty(w.shape[:2] + w.shape[-1:], dtype=torch.float32,
                        device=w.device)
        for i in range(0 if w.device.type == "meta" else w.shape[0]):
            for e in range(w.shape[1]):
                wf = w[i, e].float()
                amax = torch.clamp_min(wf.abs().amax(dim=-2), 1e-8)
                # a tensor divisor, as in ``layers.kv_quantize``
                s[i, e] = amax / amax.new_tensor(127.0)
                q[i, e] = torch.clamp(torch.round(wf / s[i, e]), -127,
                                      127).to(torch.int8)
        out[name] = {"q": q, "s": s}
    return out


def _maybe_dequant(w, dtype=torch.bfloat16):
    """int8 weights back to ``dtype`` (bfloat16 by default, even in an f32
    model, as in the reference; its products then promote).  The product
    is taken in f32 and rounded once to ``dtype``, in one pass: no f32 copy
    of the stack is made."""
    if isinstance(w, dict) and "q" in w:
        out = torch.empty(w["q"].shape, dtype=dtype, device=w["q"].device)
        return torch.mul(w["q"], w["s"][..., None, :], out=out)
    return w


def _expert_ffn(x, w_gate, w_up, w_down, act: str, gated: bool):
    """x: [..., E, C, D]; weights: [E, D, F] / [E, F, D] (or int8
    dicts)."""
    w_gate = _maybe_dequant(w_gate)
    w_up = _maybe_dequant(w_up)
    w_down = _maybe_dequant(w_down)
    dt = torch.promote_types(x.dtype, w_up.dtype)
    x = x.to(dt)
    up = torch.einsum("...ecd,edf->...ecf", x, w_up.to(dt))
    if gated:
        g = torch.einsum("...ecd,edf->...ecf", x, w_gate.to(dt))
        h = layers._act(g, act) * up
    else:
        h = layers._act(up, act)
    return torch.einsum("...ecf,efd->...ecd", h, w_down.to(dt))


def _router(xf, router_w, k: int, mean=None, renorm: bool = True):
    """xf: [T, D] -> (weights [T, k] f32, experts [T, k] int64, aux loss
    scalar f32): :func:`repro_torch.kernels.moe.router_plain`, the eager
    router (f32 logits and softmax, the stable top-k, renormalised with
    ``renorm``, the Switch load-balance loss; ``mean`` averages its two
    statistics over ranks), its choices noted for
    :func:`recorded_routes`."""
    out = kmoe.router_plain(xf, router_w, k, mean, renorm)
    _record(out[1])
    return out


#: the list :func:`recorded_routes` collects into, None outside it
_ROUTES: Optional[list] = None


def _record(top_i) -> None:
    if _ROUTES is not None:
        _ROUTES.append(top_i)


@contextlib.contextmanager
def recorded_routes():
    """Within the block every router call of this module (:func:`_router`
    and :func:`moe_apply_grouped`'s, on either path) appends
    the experts it chose ([T, k], in the call's order) to the list it
    yields.  Not thread-safe: the checks that compare routes call the
    model from one thread."""
    global _ROUTES
    outer, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = outer


def moe_apply_reference(x, params, cfg: ModelConfig):
    """x: [B, S, D] -> (y [B, S, D], aux).  The reference's exact masked
    combine over all E experts, accumulated in f32 (the plain version)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    xf = x.reshape(-1, D)
    top_w, top_i, aux = _router(xf, params["router"], k,
                                renorm=cfg.norm_topk_prob)
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)

    def sl(w, e):
        if isinstance(w, dict):
            return {n: t[e:e + 1] for n, t in w.items()}
        return w[e:e + 1]

    w_g = params.get("w_gate")
    for e in range(E):
        h = _expert_ffn(xf[None], sl(w_g, e) if w_g is not None else None,
                        sl(params["w_up"], e), sl(params["w_down"], e),
                        cfg.act, cfg.gated_mlp)[0]
        gate = torch.where(top_i == e, top_w, 0.0).sum(dim=-1)
        out = out + gate[:, None] * h.float()
    return out.reshape(B, S, D).to(x.dtype), aux


def _grouped(x, w, ends):
    """Rows of ``x`` [N, K] (expert-contiguous; expert e owns rows
    ``ends[e-1]:ends[e]``) times their expert's ``w`` [E, K, M] -> [N, M].
    On fake tensors (the static verifier) only the shape is made: this
    torch's shape rule for ``_grouped_mm`` accepts bfloat16 alone, while
    its CPU and CUDA kernels take float32 too."""
    if isinstance(x, FakeTensor):
        return x.new_empty((x.shape[0], w.shape[-1]))
    return torch._grouped_mm(x, w, offs=ends)


def moe_apply_grouped(x, params, cfg: ModelConfig, mean=None, ops=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux): the served path, the same
    function as :func:`moe_apply_reference` (see the module docstring),
    by the ``moe_*`` fields of ``ops`` (``layer_ops(cfg, None)`` when
    None).  ``mean`` (a mesh's statistics) goes to its plain route."""
    if ops is None:
        ops = layer_ops.layer_ops(cfg, None)
    B, S, D = x.shape
    k = cfg.num_experts_per_tok
    xf = x.reshape(-1, D)
    stats = {} if mean is None else {"mean": mean}
    routes = ops.moe_route(xf, params["router"], k, cfg.norm_topk_prob,
                           **stats)
    _record(routes.top_i)
    with _COUNT_LOCK:              # executor threads run layers at once
        moe_apply_grouped.calls += 1
        moe_apply_grouped.pairs += xf.shape[0] * k
        moe_apply_grouped.fused += routes.work is not None
    rows, pos = ops.moe_permute(xf, routes)

    def stack(name):       # int8 experts: bf16 as in the reference, to x's
        return _maybe_dequant(params[name]).to(x.dtype)

    up = _grouped(rows, stack("w_up"), routes.ends)
    if cfg.gated_mlp:
        h = ops.moe_act(_grouped(rows, stack("w_gate"), routes.ends), up,
                        cfg.act)
    else:
        h = layers._act(up, cfg.act)
    del up
    out_rows = _grouped(h, stack("w_down"), routes.ends)
    y = ops.moe_combine(out_rows, routes, pos)
    return y.reshape(B, S, D), routes.aux


_COUNT_LOCK = threading.Lock()
moe_apply_grouped.calls = 0
moe_apply_grouped.pairs = 0
moe_apply_grouped.fused = 0


# ---------------------------------------------------------------------------
# Expert-parallel path (a mesh with more than one model rank)
# ---------------------------------------------------------------------------
def _capacity(tokens: int, k: int, E: int, factor: float) -> int:
    return max(1, int(math.ceil(tokens * k * factor / E)))


def bucket_ranks(flat_e, E: int):
    """Each (token, expert) pair's rank within its expert's bucket, in
    pair order: a stable sort of the expert ids (``jnp.argsort`` is
    stable), so the pairs ranked past a capacity, which drop, are the
    same in both packages."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(E, dtype=torch.int64, device=flat_e.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    ranks_sorted = torch.arange(n, device=flat_e.device) - starts[
        flat_e[order]]
    return torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)


def _dispatch_combine_local(xf, router_w, w_gate, w_up, w_down, *,
                            cfg: ModelConfig, mp: int, group=None,
                            dispatch: str = "all_to_all"):
    """One rank's part of the expert-parallel layer.  xf: [T, D] local
    tokens; expert weights are the local shard [E/mp, D, F] (or int8
    dicts); ``group`` is the model axis's process group.  Each (token,
    expert) pair gets a rank within its expert from a stable sort of the
    expert ids; pairs ranked past the capacity C are dropped.  Returns
    (y [T, D], aux)."""
    T, D = xf.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(T, k, E, cfg.capacity_factor)

    top_w, top_i, aux = _router(xf, router_w, k, renorm=cfg.norm_topk_prob)
    flat_e = top_i.reshape(-1)                                   # [T*k]
    flat_w = top_w.reshape(-1)
    dev = xf.device
    token_idx = torch.arange(T * k, device=dev) // k
    ranks = bucket_ranks(flat_e, E)
    keep = ranks < C
    safe_rank = torch.where(keep, ranks, C - 1)

    # dispatch buffer [E, C, D]
    contrib = torch.where(keep[:, None], xf[token_idx],
                          torch.zeros((), dtype=xf.dtype, device=dev))
    buf = torch.zeros((E, C, D), dtype=xf.dtype, device=dev).index_put_(
        (flat_e, safe_rank), contrib, accumulate=True)

    if dispatch == "all_to_all" and mp > 1:
        recv = all_to_all(buf.reshape(mp, E // mp, C, D), group)
        h = _expert_ffn(recv, w_gate, w_up, w_down, cfg.act, cfg.gated_mlp)
        out_buf = all_to_all(h, group).reshape(E, C, D)
    elif mp > 1:
        # baseline "allgather" dispatch: gather full expert weights per rank
        def gather(w):
            if isinstance(w, dict):
                return {n: all_gather(t, group) for n, t in w.items()}
            return all_gather(w, group)
        out_buf = _expert_ffn(buf, gather(w_gate) if cfg.gated_mlp else None,
                              gather(w_up), gather(w_down), cfg.act,
                              cfg.gated_mlp)
    else:
        out_buf = _expert_ffn(buf, w_gate, w_up, w_down, cfg.act,
                              cfg.gated_mlp)

    gathered = out_buf[flat_e, safe_rank] * keep[:, None]
    y = (flat_w[:, None] * gathered.float()).reshape(T, k, D)
    return y.sum(dim=1).to(xf.dtype), aux


def _weight_args(params, cfg: ModelConfig):
    """(names, tensors) of the expert matrices, int8 dicts flattened to
    ``<name>.q`` / ``<name>.s``; the gate stands in for itself only when
    the MLP is gated."""
    names, ts = [], []
    for name in _EXPERT_MATS:
        if name == "w_gate" and not cfg.gated_mlp:
            continue
        w = params[name]
        if isinstance(w, dict):
            names += [f"{name}.q", f"{name}.s"]
            ts += [w["q"], w["s"]]
        else:
            names.append(name)
            ts.append(w)
    return names, ts


def _weight_tree(names, ts):
    out: Dict[str, Any] = {}
    for n, t in zip(names, ts):
        if "." in n:
            base, part = n.split(".")
            out.setdefault(base, {})[part] = t
        else:
            out[n] = t
    return out


def _weight_spec(name: str, mp_ax) -> P:
    """Each rank's expert shard, whole (the FSDP dim gathered): int8
    scales [E, F], everything else [E, D, F] / [E, F, D]."""
    return P(mp_ax, None) if name.endswith(".s") else P(mp_ax, None, None)


def moe_apply_ep(x, params, cfg: ModelConfig, ax: AxisInfo, *,
                 seq_sharded: bool, dispatch: str = "all_to_all"):
    """Expert-parallel MoE.  x: [B, S, D] (a DTensor under ``ax``'s
    mesh).

    ``seq_sharded``: the residual stream is sharded [B->data, S->model, D]
    (train/prefill).  Otherwise (decode) tokens are [B->data, 1, D] and each
    model-row rank takes a sub-slice of the local batch.
    """
    import torch.distributed as dist
    mp, mp_ax, dp = ax.mp_size, ax.model, ax.batch
    E = cfg.num_experts
    if E % mp:
        raise ValueError(f"{E} experts do not divide over {mp} model ranks")
    mesh = ax.mesh
    group = mesh.get_group(mp_ax)
    data_groups = [mesh.get_group(a) for a in (dp or ())]
    names, ws = _weight_args(params, cfg)

    def fn(x_loc, router_w, *w_loc):
        w = _weight_tree(names, w_loc)
        w_gate = w.get("w_gate")
        B_loc, S_loc, D = x_loc.shape
        kw = dict(cfg=cfg, mp=mp, group=group, dispatch=dispatch)
        if seq_sharded:
            y, aux = _dispatch_combine_local(
                x_loc.reshape(-1, D), router_w, w_gate, w["w_up"],
                w["w_down"], **kw)
            out = y.reshape(B_loc, S_loc, D)
        else:
            # split local tokens across the model axis, then all_gather
            T = B_loc * S_loc
            pad = (-T) % mp
            xf = torch.nn.functional.pad(x_loc.reshape(T, D), (0, 0, 0, pad))
            per = (T + pad) // mp
            i = dist.get_group_rank(group, dist.get_rank())
            y, aux = _dispatch_combine_local(
                xf[i * per:(i + 1) * per], router_w, w_gate, w["w_up"],
                w["w_down"], **kw)
            out = all_gather(y, group)[:T].reshape(B_loc, S_loc, D)
        return out, pmean(aux, [group] + data_groups)

    xs = P(dp, mp_ax if seq_sharded else None, None)
    w_specs = [_weight_spec(n, mp_ax) for n in names]
    args = ([reshard(ax, x, *xs), reshard(ax, params["router"], None, None)]
            + [reshard(ax, t, *s) for t, s in zip(ws, w_specs)])
    in_specs = [xs, P(None, None)] + w_specs
    return local_region(ax, fn, in_specs, (xs, P()),
                        grad_specs=[None] + ["partial"] * (len(ws) + 1))(
        *args)


def _moe_apply_local(x, params, cfg: ModelConfig, ax: AxisInfo, ops):
    """The served grouped path under a mesh with one model rank: each
    rank runs its own batch rows, with the experts whole; the router's
    load-balance statistics are averaged over the data ranks."""
    mesh = ax.mesh
    dp = ax.batch
    data_groups = [mesh.get_group(a) for a in (dp or ())]
    names, ws = _weight_args(params, cfg)

    def fn(x_loc, router_w, *w_loc):
        p = {"router": router_w, **_weight_tree(names, w_loc)}
        return moe_apply_grouped(x_loc, p, cfg,
                                 mean=lambda t: pmean(t, data_groups),
                                 ops=ops)

    xs = P(dp, None, None)
    w_specs = [P(*[None] * t.ndim) for t in ws]
    args = ([reshard(ax, x, *xs), reshard(ax, params["router"], None, None)]
            + [reshard(ax, t, *s) for t, s in zip(ws, w_specs)])
    return local_region(ax, fn, [xs, P(None, None)] + w_specs, (xs, P()),
                        grad_specs=[None] + ["partial"] * (len(ws) + 1))(
        *args)


def moe_apply(x, params, cfg: ModelConfig, ax: Optional[AxisInfo] = None, *,
              seq_sharded: bool = True, dispatch: str = "all_to_all",
              ops=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer.  Returns (y, aux).  Without a mesh (or on plain
    tensors), or with one model rank, the served grouped path
    (:func:`moe_apply_grouped` by ``ops``, ``layer_ops(cfg, ax)`` when
    None); with more model ranks the reference's expert-parallel path
    (:func:`moe_apply_ep`)."""
    if ops is None:
        ops = layer_ops.layer_ops(cfg, ax)
    if ax is None or not is_dtensor(x):
        return moe_apply_grouped(x, params, cfg, ops=ops)
    if ax.mp_size == 1:
        return _moe_apply_local(x, params, cfg, ax, ops)
    return moe_apply_ep(x, params, cfg, ax, seq_sharded=seq_sharded,
                        dispatch=dispatch)
