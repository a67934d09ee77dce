"""Model facade and plan-operator glue (port of the reference package's
``models/registry.py``: the dense, ssm (rwkv6) and hybrid
(recurrentgemma) families).

``build_model(cfg, device=None)`` returns a :class:`Model` with
``init(generator)``, ``logits``, ``prefill``, ``init_cache`` and
``decode_step``.  ``model_stage_op(model, params, stage)`` wraps one
serving stage as a ``ModelOp`` for the dataflow.

Row-wise column contracts (per table row), as in the reference:

* ``prefill`` — tokens [S] i32            -> (tok [] i32, pos [] i32,
                                             *cache leaves)
* ``decode``  — (tok, pos, *cache leaves) -> same shape: one greedy
                                             decode step advances them

The cache rides the table as per-row columns, one per cache leaf in the
order of ``jax.tree_util.tree_flatten`` (sorted keys at every level of
the nesting: ``k0``, ``pos0``, ``v0`` for the dense family; ``blocks/0/
conv``, ``blocks/0/h``, ..., ``rest/...`` for recurrentgemma), so column
``c{i}`` is the reference's leaf ``i``.  Columns are batch-leading, so a
prefill -> decode -> decode chain fuses into one device-resident chain.

Native batching: the reference gives each stage a ``custom_vmap`` rule so
a vmapped chain runs the whole row batch through the model at once.  The
port attaches the natively batched callable to the stage function as
``__batched__``; a batched lowered chain calls it once on the stacked
rows, while a per-row call adds ``B=1``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.models import rglru, rwkv6, transformer

_FAMILY_MODULES = {"dense": transformer, "ssm": rwkv6, "hybrid": rglru}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    @property
    def mod(self):
        return _FAMILY_MODULES[self.cfg.family]

    # -- params ------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None):
        return self.mod.init_params(self.cfg, generator, self.device)

    # -- forward -------------------------------------------------------------
    def logits(self, params, batch):
        return self.mod.forward(params, batch["tokens"], self.cfg)

    # -- serving -------------------------------------------------------------
    def prefill(self, params, batch, cache_len: int):
        logits, cache = self.mod.forward(params, batch["tokens"], self.cfg,
                                         build_cache=True,
                                         cache_len=cache_len)
        return logits[:, -1:], cache

    def init_cache(self, batch: int, cache_len: int,
                   device: DeviceLike = None):
        return self.mod.init_cache(self.cfg, batch, cache_len,
                                   device=device or self.device)

    def decode_step(self, params, tokens, pos, cache):
        return self.mod.decode_step(params, tokens, pos, cache, self.cfg)


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """The model on ``device`` (the CUDA device unless the caller names
    another; raises without a card)."""
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (have "
            f"{sorted(_FAMILY_MODULES)})")
    return Model(cfg=cfg, device=resolve_device(device))


# ---------------------------------------------------------------------------
# plan-operator glue: model stages as first-class dataflow ops (ModelOp)
# ---------------------------------------------------------------------------

def _stage_fn(fname: str, argnames, batched, ret_arity: int):
    """Explicit-positional-arg row-wise wrapper (``fn_signature`` reads
    ``__code__``) with torch.Tensor annotations: adds ``B=1`` around
    ``batched`` and carries it as ``__batched__``."""
    fname = "".join(c if c.isalnum() or c == "_" else "_" for c in fname)
    if not fname or fname[0].isdigit():
        fname = f"m_{fname}"

    def per_row(*cols):
        out = batched(*[c[None] for c in cols])
        return tuple(o[0] for o in out) if ret_arity > 1 else out[0]

    src = (f"def {fname}({', '.join(argnames)}):\n"
           f"    return _inner({', '.join(argnames)})")
    ns: Dict[str, Any] = {"_inner": per_row}
    exec(src, ns)                                        # noqa: S102
    f = ns[fname]
    ann: Dict[str, Any] = {a: torch.Tensor for a in argnames}
    ann["return"] = (torch.Tensor if ret_arity == 1
                     else Tuple[tuple([torch.Tensor] * ret_arity)])
    f.__annotations__ = ann
    f.__batched__ = batched
    return f


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    """(key path, leaf) pairs of a nested dict in ``tree_flatten`` order:
    sorted keys at every level."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _unflatten(paths, leaves):
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _cache_layout(model: Model, cache_len: int):
    """(leaf key paths, per-leaf batch axis, per-leaf meta tensor at B=1),
    in ``tree_flatten`` order.  The batch axis of each leaf is found by
    diffing its shape at B=1 and B=2 (meta tensors: nothing is
    allocated)."""
    l1 = _flatten(model.init_cache(1, cache_len, device="meta"))
    l2 = _flatten(model.init_cache(2, cache_len, device="meta"))
    axes = []
    for (path, a), (_, b) in zip(l1, l2):
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                if x != y]
        if len(diff) != 1:
            raise ValueError(f"cannot identify batch axis of cache leaf "
                             f"{'/'.join(path)} {tuple(a.shape)}")
        axes.append(diff[0])
    return [p for p, _ in l1], axes, [a for _, a in l1]


def _timing_hook(batched, arg_maker, *, runs: int = 3, warmup: int = 1):
    """Per-bucket cost hook: measure the natively batched stage at batch
    size ``b``.  Feeds ``profiling.profiler.seed_from_model_ops`` ->
    ``OpLatencyCurve`` buckets.  Each timed call ends in a synchronise of
    the devices holding its outputs (a CUDA call returns at launch);
    ``out_bytes`` is ``numel x element_size`` over the output columns
    (the stage returns a flat tuple of tensors).  Building the hook
    measures nothing: only calling it does."""
    import statistics
    import time

    def hook(b: int) -> Dict[str, Any]:
        args = arg_maker(b)
        out = None
        for _ in range(warmup):
            out = batched(*args)
            synchronize(out)
        ts = []
        for _ in range(runs):
            t0 = time.perf_counter()
            out = batched(*args)
            synchronize(out)
            ts.append(time.perf_counter() - t0)
        mean = sum(ts) / len(ts)
        cv = (statistics.stdev(ts) / mean) if len(ts) > 1 and mean > 0 \
            else 0.0
        ob = int(sum(x.numel() * x.element_size() for x in out))
        return {"mean_s": mean, "p99_s": max(ts), "cv": cv,
                "runs": len(ts), "out_bytes": ob}

    return hook


def model_stage_op(model: Model, params, stage: str, *,
                   model_name: str = "model", seq_len: int = 32,
                   cache_len: int = 64, measure: bool = True,
                   runs: int = 3):
    """Build a ``ModelOp`` for one serving stage of ``model`` (see module
    comment for the row-wise column contracts).  ``seq_len``/``cache_len``
    fix the token/cache geometry (the cost hook measures at exactly these
    shapes; the op itself serves any row shape the flow feeds it).
    ``measure=False`` skips attaching the timing cost hook."""
    from repro_torch.core import operators as ops

    paths, batch_axes, _ = _cache_layout(model, cache_len)
    state_names = ["tok", "pos"] + [f"c{i}" for i in range(len(paths))]

    def _split(cache):
        """native cache -> batch-leading leaf columns (views)"""
        return [torch.movedim(leaf, ax, 0)
                for (_, leaf), ax in zip(_flatten(cache), batch_axes)]

    def _join(leaves):
        """batch-leading leaf columns -> native cache (views)"""
        return _unflatten(paths, [torch.movedim(l, 0, ax)
                                  for l, ax in zip(leaves, batch_axes)])

    if stage == "prefill":
        def batched(tokens):
            logits, cache = model.prefill(params, {"tokens": tokens},
                                          cache_len)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            pos = torch.full(tokens.shape[:1], tokens.shape[1],
                             dtype=torch.int32, device=tokens.device)
            return (tok, pos, *_split(cache))

        fn = _stage_fn(f"{model_name}_prefill", ("tokens",), batched,
                       2 + len(paths))

        def arg_maker(b):
            return (torch.zeros((b, seq_len), dtype=torch.int32,
                                device=model.device),)
    elif stage == "decode":
        def batched(tok, pos, *leaves):
            logits, new_cache = model.decode_step(params, tok[:, None], pos,
                                                  _join(leaves))
            ntok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return (ntok, pos + 1, *_split(new_cache))

        fn = _stage_fn(f"{model_name}_decode", tuple(state_names), batched,
                       2 + len(paths))

        def arg_maker(b):
            zeros = torch.zeros((b,), dtype=torch.int32, device=model.device)
            return (zeros, zeros.clone(),
                    *_split(model.init_cache(b, cache_len)))
    else:
        raise ValueError(f"unknown stage {stage!r} (prefill | decode)")
    hook = _timing_hook(batched, arg_maker, runs=runs) if measure else None
    return ops.ModelOp(fn=fn, names=list(state_names),
                       model_name=model_name, stage=stage, cost_hook=hook)


def stage_input_specs(model: Model, stage: str, *, seq_len: int = 32,
                      cache_len: int = 64) -> Dict[str, torch.Tensor]:
    """Row-level input column specs for one serving stage, as meta tensors
    (shape + dtype, no storage): ``prefill`` consumes a token column;
    ``decode`` consumes the batch-leading cache-state columns
    ``tok``/``pos``/``c{i}``."""
    i32 = torch.int32
    if stage == "prefill":
        return {"tokens": torch.empty((seq_len,), dtype=i32, device="meta")}
    if stage != "decode":
        raise ValueError(f"unknown stage {stage!r} (prefill | decode)")
    _, axes, leaves = _cache_layout(model, cache_len)
    specs = {"tok": torch.empty((), dtype=i32, device="meta"),
             "pos": torch.empty((), dtype=i32, device="meta")}
    for i, (leaf, ax) in enumerate(zip(leaves, axes)):
        specs[f"c{i}"] = leaf.select(ax, 0)
    return specs
