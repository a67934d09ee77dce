"""Parameter / optimizer-state / input partition specs (port of the
reference package's ``launch/sharding.py``).

Weight sharding rules (by leaf name within the params tree, whose keys
are the reference's):

* TP over ``model`` on head / d_ff / expert / vocab dims.
* Training additionally FSDP-shards the complementary dim over ``data``
  (ZeRO: optimizer state inherits the spec -> per-rank state = total/256).
* MoE expert weights are FSDP-sharded even for serving (480B would not fit
  TP-only); each layer gathers them over ``data`` before its experts run.

:func:`distribute` places a tree of tensors as DTensors by a spec tree.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models.partition import AxisInfo, P, place, placements

# leaves sharded [*, fsdp, mp] (input-projection-like: last dim is TP)
_IN_PROJ = {"wq", "wk", "wv", "w_up", "w_gate", "cm_wk", "wx", "wgate",
            "cm_wr", "wg", "wr"}
# leaves sharded [*, mp, fsdp] (output-projection-like: first matrix dim TP)
_OUT_PROJ = {"wo", "w_down", "cm_wv"}
# small per-channel (R- or D-sized) leaves sharded on the channel dim
_CHANNEL_MP = {"lam", "wi_a", "wi_b", "wr_a", "wr_b", "conv_b"}


def _is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map_with_path(fn, tree, *rest, path=(), is_leaf=None):
    """``fn(path, leaf, *rest_leaves)`` over a nested dict, ``path`` the
    tuple of keys down to the leaf."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,), is_leaf=is_leaf)
                for k in tree}
    return fn(path, tree, *rest)


def _leaf_spec(keys, leaf, cfg: ModelConfig, ax: AxisInfo, *,
               fsdp: Optional[Any]) -> P:
    name = keys[-1] if keys else ""
    mp = ax.model
    nd = leaf.ndim
    moe_fsdp = ax.data

    if name in ("embed", "head"):       # head: an untied output table
        return P(mp, fsdp)
    if "moe" in keys:
        if name == "router":
            return P(*([None] * nd))  # replicated (each rank reads it whole)
        if name == "s":               # int8 scales [n, E, F]
            return P(None, mp, None)
        # [n, E, D, F] / [n, E, F, D] (or int8 "q"): experts over model,
        # dim2 FSDP'd
        return P(None, mp, moe_fsdp, None)
    if name in _IN_PROJ and nd >= 2:
        return P(*([None] * (nd - 2)), fsdp, mp)
    if name in _OUT_PROJ and nd >= 2:
        return P(*([None] * (nd - 2)), mp, fsdp)
    if name in ("tm_w1", "dw1") and nd >= 2:  # [*, D, lora]
        return P(*([None] * (nd - 2)), fsdp, None)
    if name in ("tm_w2", "dw2", "conv_w"):    # [..., last dim model-sharded]
        return P(*([None] * (nd - 1)), mp)
    if name == "u" and nd >= 2:               # [*, H, hd]
        return P(*([None] * (nd - 2)), mp, None)
    if name in ("gn_scale", "gn_bias"):       # [*, D] head-major channels
        return P(*([None] * (nd - 1)), mp)
    if name in _CHANNEL_MP:                   # [*, R]
        return P(*([None] * (nd - 1)), mp)
    return P(*([None] * nd))                  # norms, gates, mus: replicated


def param_pspecs(params, cfg: ModelConfig, ax: AxisInfo, *,
                 mode: str = "train"):
    """Spec tree matching ``params``.  mode: train (TP+FSDP) | serve (TP).
    FSDP uses the full data tuple (('pod','data') on the multi-pod mesh)."""
    fsdp = ax.data if mode == "train" else None
    return tree_map_with_path(
        lambda path, leaf: _leaf_spec(path, leaf, cfg, ax, fsdp=fsdp), params)


def opt_state_pspecs(params, param_specs, opt_name: str):
    """Spec tree for the optimizer state of ``make_optimizer(opt_name)``."""
    if opt_name == "adamw":
        return {"m": param_specs, "v": param_specs, "step": P()}
    if opt_name == "adafactor":
        from repro_torch.training.optim import _factored

        def v_spec(_, p, s):
            parts = list(s) + [None] * (p.ndim - len(s))
            if _factored(p):
                return {"vr": P(*parts[:-1]),
                        "vc": P(*(parts[:-2] + parts[-1:]))}
            return {"v": P(*parts)}

        return {"v": tree_map_with_path(v_spec, params, param_specs),
                "step": P()}
    raise ValueError(opt_name)


def state_pspecs(state, cfg: ModelConfig, ax: AxisInfo):
    pspecs = param_pspecs(state["params"], cfg, ax, mode="train")
    return {"params": pspecs,
            "opt": opt_state_pspecs(state["params"], pspecs, cfg.optimizer)}


def batch_pspecs(cfg: ModelConfig, ax: AxisInfo, shape: InputShape):
    """Input batch specs for the given input shape."""
    b = ax.batch  # None when batch unshardable (long_500k)
    if shape.kind == "train":
        specs = {"tokens": P(b, None), "labels": P(b, None)}
    elif shape.kind == "prefill":
        specs = {"tokens": P(b, None)}
    else:
        specs = {"tokens": P(b, None), "pos": P(b)}
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        specs["media"] = P(b, None, None)
    if cfg.family == "audio" and shape.kind in ("train", "prefill"):
        specs["frames"] = P(b, None, None)
    return specs


def to_shardings(mesh, spec_tree):
    """The DTensor placements of every spec in ``spec_tree``."""
    return tree_map_with_path(lambda _, s: placements(mesh, s), spec_tree,
                              is_leaf=_is_spec)


def distribute(tree, mesh, spec_tree):
    """``tree``'s tensors, which every rank holds whole, as DTensors on
    ``mesh`` placed by ``spec_tree``: each rank keeps a view of its own
    shard (:func:`~repro_torch.models.partition.place`: no copy, no
    collective; a dim the mesh axes do not divide raises).  A meta tensor
    gives a meta DTensor: nothing is allocated."""
    return tree_map_with_path(lambda _, t, s: place(t, mesh, s), tree,
                              spec_tree)
