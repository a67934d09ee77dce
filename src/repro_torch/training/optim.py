"""Optimizers: AdamW and Adafactor (port of the reference package's
``training/optim.py``).

Written from scratch on tensors (no ``torch.optim``), numerically the
reference's: the schedule, the clip factor and the bias corrections are
f32 tensors on the params' device, so a step reads nothing back to the
host.  State trees mirror the params tree with the reference's keys
(``m``, ``v``, ``step``; Adafactor's ``v`` holds ``{vr, vc}`` for a
factored leaf and ``{v}`` otherwise), so a checkpoint of either package
restores in the other.

``update(params, grads, state)`` writes the new params and state IN
PLACE, under ``torch.no_grad`` (the params are the leaf tensors autograd
differentiates), and returns the global grad norm (f32 scalar tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # adafactor
    factored_min_dim: int = 128
    decay_rate: float = 0.8


def leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in ``jax.tree`` order (sorted keys at
    every level)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``,
    called in :func:`leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then constant, in f32."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf, summed in leaf
    order."""
    total = None
    for t in leaves(tree):
        sq = torch.sum(torch.square(t.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_scale(tree, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, norm): the scalar clip factor ``min(1, max_norm / norm)``,
    applied per leaf inside the update so no scaled copy of the grads is
    made."""
    norm = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0), norm


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step_dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig) -> torch.Tensor:
    """One AdamW step, in place: f32 moments, bias correction in f32,
    decoupled weight decay on matrices (ndim >= 2) only."""
    state["step"] += 1
    step = state["step"].float()
    lr = schedule(cfg, state["step"])
    scale, gnorm = clip_scale(grads, cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - _f32(b1, step) ** step
    bc2 = 1 - _f32(b2, step) ** step
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return gnorm


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no first moment, PaLM-style)
# ---------------------------------------------------------------------------
def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


def adafactor_init(params) -> Dict[str, Any]:
    def init(p):
        f32, dev = torch.float32, p.device
        if _factored(p):
            return {"vr": torch.zeros(p.shape[:-1], dtype=f32, device=dev),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=f32, device=dev)}
        return {"v": torch.zeros(p.shape, dtype=f32, device=dev)}

    step_dev = leaves(params)[0].device
    return {"v": tree_map(init, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def _v_leaves(params, vtree) -> List[Dict[str, torch.Tensor]]:
    """Adafactor's per-param state dicts, in the params' leaf order."""
    if isinstance(params, dict):
        return [d for k in sorted(params)
                for d in _v_leaves(params[k], vtree[k])]
    return [vtree]


@torch.no_grad()
def adafactor_update(params, grads, state, cfg: OptConfig) -> torch.Tensor:
    """One Adafactor step, in place: factored ``vr``/``vc`` for leaves
    whose two trailing dims are both >= 128, RMS update clipping,
    decoupled weight decay on matrices.  Leaves are updated largest
    first, one at a time, so one leaf's f32 temporaries are freed before
    the next leaf's are made."""
    state["step"] += 1
    step = state["step"].float()
    lr = schedule(cfg, state["step"])
    scale, gnorm = clip_scale(grads, cfg.grad_clip)
    beta = 1.0 - step ** -cfg.decay_rate
    ps, gs = leaves(params), leaves(grads)
    vs = _v_leaves(params, state["v"])
    for i in sorted(range(len(ps)), key=lambda i: -ps[i].numel()):
        p, v = ps[i], vs[i]
        g = gs[i].float() * scale
        g2 = torch.square(g) + 1e-30
        if _factored(p):
            v["vr"].copy_(beta * v["vr"] + (1 - beta) * g2.mean(dim=-1))
            v["vc"].copy_(beta * v["vc"] + (1 - beta) * g2.mean(dim=-2))
            del g2
            vr = v["vr"]
            denom = (vr[..., None] / vr.mean(dim=-1, keepdim=True)[..., None]
                     ) * v["vc"][..., None, :]
            delta = g * torch.rsqrt(denom + 1e-30)
            del denom
        else:
            v["v"].copy_(beta * v["v"] + (1 - beta) * g2)
            del g2
            delta = g * torch.rsqrt(v["v"] + 1e-30)
        del g
        rms = torch.sqrt(torch.mean(torch.square(delta)) + 1e-30)
        delta = delta / torch.clamp_min(rms, 1.0)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        del delta
    return gnorm


# ---------------------------------------------------------------------------
Optimizer = Tuple[Callable[[Any], Dict[str, Any]],
                  Callable[[Any, Any, Dict[str, Any]], torch.Tensor]]


def make_optimizer(name: str, cfg: Optional[OptConfig] = None) -> Optimizer:
    """(init(params) -> state, update(params, grads, state) -> grad norm)."""
    cfg = cfg or OptConfig(name=name)
    if name == "adamw":
        return adamw_init, lambda p, g, s: adamw_update(p, g, s, cfg)
    if name == "adafactor":
        return adafactor_init, lambda p, g, s: adafactor_update(p, g, s, cfg)
    raise ValueError(f"unknown optimizer {name}")
