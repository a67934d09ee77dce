"""The training step: loss -> grads -> optimizer update (port of the
reference package's ``training/train_step.py``).

The params are leaf tensors with ``requires_grad``; the step
differentiates ``Model.loss`` with ``torch.autograd.grad`` (nothing is
left in ``.grad``) and the optimizer updates the params and its state in
place, under ``torch.no_grad``.  The loss runs the model's plain
composition, as the reference's does (its Pallas kernels have no
backward, and neither have the port's CUDA kernels): a model built with
``use_kernels=True`` raises :class:`~repro_torch.kernels.build.KernelError`
in a train step on the card.  ``make_eval_step`` runs under
``torch.no_grad`` and may use the kernels.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.interop import torch_dtype
from repro_torch.models.registry import Model
from repro_torch.training import optim

State = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]


def trainable(params):
    """``params`` with every leaf a grad-requiring leaf tensor (in
    place)."""
    for p in optim.leaves(params):
        p.requires_grad_(True)
    return params


def init_train_state(model: Model,
                     generator: Optional[torch.Generator] = None,
                     opt_cfg: Optional[optim.OptConfig] = None,
                     params=None) -> State:
    """{"params", "opt"}: ``params`` (fresh from ``model.init(generator)``
    when None) made trainable, and the optimizer state of
    ``model.cfg.optimizer``."""
    if params is None:
        params = model.init(generator)
    opt_init, _ = optim.make_optimizer(model.cfg.optimizer, opt_cfg)
    return {"params": trainable(params), "opt": opt_init(params)}


def value_and_grad(model: Model, params, batch
                   ) -> Tuple[torch.Tensor, Metrics, Any]:
    """(loss, metrics, grads) of ``model.loss`` at ``params``, remat on as
    in the reference's train step (detached; grads in the params' tree,
    each in its param's dtype)."""
    loss, metrics = model.loss(params, batch, remat=True)
    flat = optim.leaves(params)
    gs = iter(torch.autograd.grad(loss, flat, materialize_grads=True))
    grads = optim.tree_map(lambda p: next(gs), params)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _split(batch, accum: int, i: int):
    """Microbatch ``i`` of ``accum``: rows ``i*B/accum`` onward of every
    batch tensor (the reference's reshape to [accum, B/accum, ...])."""
    def part(t):
        n = t.shape[0] // accum
        return t[i * n:(i + 1) * n]
    return {k: part(t) for k, t in batch.items()}


def make_train_step(model: Model, opt_cfg: Optional[optim.OptConfig] = None
                    ) -> Callable[[State, Dict[str, torch.Tensor]],
                                  Tuple[State, Metrics]]:
    """``train_step(state, batch) -> (state, metrics)``; the state is
    updated in place and returned.

    With ``cfg.grad_accum > 1`` the batch is split into that many
    microbatches, run one after another; their grads accumulate as
    ``acc + (g / accum).to(accum_dtype)`` (the reference's order), and
    the loss and metrics are the microbatches' means."""
    _, opt_update = optim.make_optimizer(model.cfg.optimizer, opt_cfg)
    accum = max(1, model.cfg.grad_accum)
    adt = torch_dtype(model.cfg.accum_dtype)

    def train_step(state: State, batch) -> Tuple[State, Metrics]:
        params = state["params"]
        if accum == 1:
            loss, metrics, grads = value_and_grad(model, params, batch)
        else:
            grads, losses, mets = None, [], []
            for i in range(accum):
                l, met, g = value_and_grad(model, params,
                                           _split(batch, accum, i))
                with torch.no_grad():
                    part = optim.tree_map(lambda t: (t / accum).to(adt), g)
                    grads = part if grads is None else optim.tree_map(
                        torch.add, grads, part)
                del g, part
                losses.append(l)
                mets.append(met)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        gnorm = opt_update(params, grads, state["opt"])
        return state, {**metrics, "loss": loss, "grad_norm": gnorm}

    return train_step


def make_eval_step(model: Model) -> Callable[[Any, Dict[str, torch.Tensor]],
                                             Metrics]:
    """``eval_step(params, batch) -> {"loss", "ce", "aux"}``, under
    ``torch.no_grad`` and without remat; a ``use_kernels=True`` model runs
    its kernels here."""
    @torch.no_grad()
    def eval_step(params, batch) -> Metrics:
        loss, metrics = model.loss(params, batch, remat=False)
        return {"loss": loss, **metrics}
    return eval_step
