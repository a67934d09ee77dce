"""Bridge from the reference package's parameter pytree to the port.

``params_from_numpy(tree, device, dtype)`` takes the nested dict of numpy
arrays that ``jax.tree.map(np.asarray, params)`` yields and returns the
same nesting of tensors, keeping the layer-stacked layout (``blocks/<i>/
...`` leaves carry the stacked block axis first).  bf16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses; they go
through float32, which holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int32": torch.int32, "int8": torch.int8,
    "bool": torch.bool,
}


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / numpy dtype / torch dtype -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(np.dtype(name)) if not isinstance(name, str)
                   else name]


def tensor_from_numpy(a, device: torch.device,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    arr = np.asarray(a)
    src_dtype = torch.bfloat16 if arr.dtype.name == "bfloat16" else None
    if src_dtype is not None:
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, order="C", copy=True))
    return t.to(device=device, dtype=dtype or src_dtype or t.dtype)


def check_param_shapes(params: Dict[str, Any], model) -> None:
    """Raise unless ``params`` has the tree and the leaf shapes of
    ``model``'s own parameters (built on the meta device at the model's
    mesh axes: heads padded and replicated to its model axis, as the
    reference's ``build_model(cfg, ax)`` makes them)."""
    from repro_torch.models.registry import build_model
    want = build_model(model.cfg, "meta", model.ax,
                       long_context=model.long_context).init()

    def walk(got, ref, path):
        if isinstance(ref, dict):
            keys = sorted(got) if isinstance(got, dict) else got
            if keys != sorted(ref):
                raise ValueError(f"params at {path or '/'}: keys {keys!r} "
                                 f"!= {sorted(ref)}")
            for k in ref:
                walk(got[k], ref[k], f"{path}/{k}")
        elif tuple(got.shape) != tuple(ref.shape):
            raise ValueError(f"params at {path}: shape {tuple(got.shape)} "
                             f"!= the model's {tuple(ref.shape)}")

    walk(params, want, "")


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                      dtype=None, *, model=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.
    ``dtype`` (optional) casts every floating leaf; integer leaves keep
    their type.  With ``model`` every leaf's shape is checked against the
    model's at its mesh's model axis (:func:`check_param_shapes`): the
    reference's params of a mesh-built model carry padded heads."""
    if model is not None:
        check_param_shapes(tree, model)
    dev = resolve_device(device)
    want = torch_dtype(dtype) if dtype is not None else None

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = tensor_from_numpy(x, dev)
        if want is not None and t.is_floating_point():
            t = t.to(want)
        return t

    return conv(tree)
