"""Weights drawn from the seed, on the device, by the benchmark's own rules.

The tree (key paths, shapes, dtypes) is the one the served model declares;
the values come from this module alone: one draw per leaf of the
layer-stacked tree (a few large calls), in the type the leaf is served in,
from a ``torch.Generator`` on the device.  A configuration's file gives a
rule for every leaf by its key path:

* ``["normal", std]``: normal(0, std);
* ``["fan_in", gain, axis]``: normal(0, gain / sqrt(shape[axis]));
* ``["uniform", lo, hi]``: uniform in [lo, hi);
* ``["const", value]``.

The program and the reference are handed the same tensors."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch


def flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(``a/b/c`` key path, leaf) pairs, keys sorted at every level."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in flatten(tree[k],
                                                          prefix + (k,))]
    return [("/".join(prefix), tree)]


def unflatten(pairs) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def draw(meta_tree, rules: Dict[str, list], seed: int,
         device: torch.device) -> Dict[str, Any]:
    """The weights for ``meta_tree`` (a tree of meta tensors) by
    ``rules``; every leaf needs a rule and every rule a leaf."""
    leaves = flatten(meta_tree)
    paths = [p for p, _ in leaves]
    missing = [p for p in paths if p not in rules]
    unused = sorted(set(rules) - set(paths))
    if missing or unused:
        raise ValueError(f"weight rules: no rule for {missing}, no leaf for "
                         f"{unused}")
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for path, meta in leaves:
        rule = rules[path]
        t = torch.empty(meta.shape, dtype=meta.dtype, device=device)
        kind = rule[0]
        if kind == "normal":
            t.normal_(0.0, float(rule[1]), generator=g)
        elif kind == "fan_in":
            std = float(rule[1]) / float(meta.shape[int(rule[2])]) ** 0.5
            t.normal_(0.0, std, generator=g)
        elif kind == "uniform":
            t.uniform_(float(rule[1]), float(rule[2]), generator=g)
        elif kind == "const":
            t.fill_(float(rule[1]))
        else:
            raise ValueError(f"{path}: unknown rule {rule!r}")
        out.append((path, t))
    return unflatten(out)


def count(tree) -> int:
    """Parameters in the tree (every element of every leaf)."""
    return sum(t.numel() for _, t in flatten(tree))
