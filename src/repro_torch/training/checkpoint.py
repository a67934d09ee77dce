"""Checkpoints: a flat-key ``.npz`` of the whole state tree (port of the
reference package's ``training/checkpoint.py``, in its file format).

``<dir>/step_<n>.npz`` holds one array per leaf, keyed by the leaf's
path joined with ``/`` (``#i`` for a sequence index), plus a
``__meta__`` JSON string of each key's dtype; bf16 leaves are stored as
their ``uint16`` bits.  ``<dir>/LATEST`` names the newest step.  Both
files are written under a temporary name and renamed, so a crashed save
never corrupts the latest checkpoint.  A file written by either package
restores in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_SEP = "/"


def _items(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree`` order: sorted dict keys, ``#i``
    for sequence indices."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _items(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in _items(t, prefix + (f"#{i}",))]
    return [(_SEP.join(prefix), tree)]


def _rebuild(like, leaves_by_key: Dict[str, Any],
             prefix: Tuple[str, ...] = ()):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves_by_key, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(t, leaves_by_key, prefix + (f"#{i}",))
                          for i, t in enumerate(like))
    return leaves_by_key[_SEP.join(prefix)]


def save(path: str, state, step: int) -> str:
    """Write ``state`` (a nested dict of tensors) as ``step_{step}.npz``
    and point ``LATEST`` at it.  Returns the file's path."""
    os.makedirs(path, exist_ok=True)
    arrays, meta = {}, {}
    for k, t in _items(state):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            arrays[k] = t.view(torch.int16).cpu().numpy().view(np.uint16)
            meta[k] = "bfloat16"
        else:
            arrays[k] = t.cpu().numpy()
            meta[k] = str(arrays[k].dtype)
    fname = os.path.join(path, f"step_{step}.npz")
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, fname)
    latest = os.path.join(path, "LATEST")
    with open(latest + ".tmp", "w") as f:
        f.write(str(step))
    os.replace(latest + ".tmp", latest)
    return fname


def latest_step(path: str) -> int:
    with open(os.path.join(path, "LATEST")) as f:
        return int(f.read().strip())


def restore(path: str, like, step: int = -1):
    """The checkpoint of ``step`` (the latest when negative), in the
    structure of ``like`` (a template tree): each leaf in its stored
    dtype, on the device of ``like``'s leaf at the same key."""
    if step < 0:
        step = latest_step(path)
    out = {}
    with np.load(os.path.join(path, f"step_{step}.npz"),
                 allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        for k, t in _items(like):
            a = data[k]
            if meta[k] == "bfloat16":
                v = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                v = torch.from_numpy(a)
            out[k] = v.to(t.device)
    return _rebuild(like, out)
