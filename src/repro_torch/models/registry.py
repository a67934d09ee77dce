"""Model facade and plan-operator glue (port of the reference package's
``models/registry.py``: all six families — dense (with gemma2), moe
(arctic, llama4), vlm (llama-3.2-vision), audio (whisper), ssm (rwkv6)
and hybrid (recurrentgemma)).

``build_model(cfg, device=None, ax=None, long_context=False,
moe_dispatch="all_to_all")`` returns a :class:`Model` with
``init(generator)``, ``loss`` (the training loss, differentiable),
``logits``, ``prefill``, ``init_cache``, ``cache_pspecs``,
``decode_step`` and ``input_specs(shape)``.
``model_stage_op(model, params, stage)`` wraps one serving stage as a
``ModelOp`` for the dataflow.  ``batch`` is a dict: {"tokens",
"labels"? (training), "media"? (vlm stub patch embeddings [B, M, D]),
"frames"? (audio stub frame embeddings [B, encoder_seq, D])}.

The serving entry points (``logits``, ``prefill`` and the families'
``decode_step``) run under ``torch.no_grad`` and record no graph,
whatever the params' ``requires_grad``; ``loss`` runs in the caller's
grad mode.

Row-wise column contracts (per table row), as in the reference:

* ``logits``  — tokens [S] i32            -> next-token logits [V]
* ``prefill`` — tokens [S] i32            -> (tok [] i32, pos [] i32,
                                             *cache leaves)
* ``decode``  — (tok, pos, *cache leaves) -> same shape: one greedy
                                             decode step advances them

The stages take no media and no frames: a vlm serves media through
``ServingEngine.generate`` (``serving/engine.py``), and its ``logits``
stage runs the text path alone; its ``prefill`` stage returns the
reference's columns: the prefill without media builds no ``ck``/``cv``
leaves, so the op yields two cache columns fewer than its names (ROADMAP
§3: reference behaviour the port copies).  whisper's stages run its
encoder over zero frames, as the reference's do; ``generate`` takes
frames.

The cache rides the table as per-row columns, one per cache leaf in the
order of ``jax.tree_util.tree_flatten`` (sorted keys at every level of
the nesting: ``k0``, ``pos0``, ``v0`` for the dense and moe families;
``ck``, ``cv``, ``k``, ``pos``, ``v`` for whisper; ``blocks/0/
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
from repro_torch.configs.shapes import InputShape
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.interop import torch_dtype
from repro_torch.models import rglru, rwkv6, transformer, whisper
from repro_torch.models.partition import (AxisInfo, P, all_gather,
                                          is_dtensor, place, unplace)

_FAMILY_MODULES = {"dense": transformer, "moe": transformer,
                   "vlm": transformer, "ssm": rwkv6, "hybrid": rglru,
                   "audio": whisper}
#: families whose module takes ``long_context`` (the reference's own set)
_LONG_CONTEXT = ("dense", "moe", "vlm")


def _nll_sums(logits, labels, ignore_id: int = -1):
    """(summed next-token loss, count) over the labels that are not
    ``ignore_id``."""
    logz = torch.logsumexp(logits, dim=-1)
    mask = labels != ignore_id
    # an ignored label gathers row 0; the mask drops it
    gold = torch.gather(logits, -1, torch.where(mask, labels, 0).long()[
        ..., None])[..., 0]
    maskf = mask.float()
    return ((logz - gold) * maskf).sum(), maskf.sum()


def cross_entropy(logits, labels, *, ignore_id: int = -1):
    """Mean next-token loss over the labels that are not ``ignore_id``.
    logits: [B, S, V] (f32); labels: [B, S] int.  Logits that are a
    DTensor (rows split over the mesh, the vocabulary whole) are reduced
    on each rank's own rows, and the sums added over the ranks that hold
    different rows: DTensor's own rule for the gather would replicate
    the logits."""
    if not is_dtensor(logits):
        nll, n = _nll_sums(logits, labels, ignore_id)
    else:
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        pl = tuple(logits.placements)
        if any(isinstance(p, Shard) and p.dim == 2 for p in pl):
            raise ValueError(f"logits split over the vocabulary: {pl}")
        labels = labels.redistribute(logits.device_mesh, pl)
        summed = tuple(Partial() if isinstance(p, Shard) else Replicate()
                       for p in pl)
        nll, n = local_map(
            lambda lg, lb: _nll_sums(lg, lb, ignore_id),
            out_placements=(summed, summed), in_placements=(pl, pl),
            device_mesh=logits.device_mesh)(logits, labels)
    return nll / torch.clamp_min(n, 1.0)


def last_position(logits):
    """``logits[:, -1:]``.  Logits whose sequence is split over a mesh
    dim (a DTensor) give each rank's last row to that dim's group and
    keep the last rank's: DTensor's own slice would gather every row of
    [B, S, V] first."""
    if not is_dtensor(logits):
        return logits[:, -1:]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = list(logits.placements)
    seq = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == 1]
    if not seq:
        return logits[:, -1:]
    mesh = logits.device_mesh
    local = logits.to_local()[:, -1:]
    for i in seq:
        local = all_gather(local, mesh.get_group(i), dim=1)[:, -1:]
        pl[i] = Replicate()
    B, _, V = logits.shape
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=(B, 1, V),
                              stride=(V, V, 1))


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    ax: Optional[AxisInfo] = None
    long_context: bool = False
    moe_dispatch: str = "all_to_all"

    @property
    def mod(self):
        return _FAMILY_MODULES[self.cfg.family]

    def _kw(self) -> Dict[str, Any]:
        kw: Dict[str, Any] = {"ax": self.ax}
        if self.cfg.family in _LONG_CONTEXT:
            kw["long_context"] = self.long_context
        return kw

    def _step_kw(self) -> Dict[str, Any]:
        kw = self._kw()
        if self.cfg.family in _LONG_CONTEXT:
            kw["moe_dispatch"] = self.moe_dispatch
        return kw

    def _fwd_kw(self, batch) -> Dict[str, Any]:
        kw = self._step_kw()
        if self.cfg.family == "vlm":
            kw["media"] = batch.get("media")
        if self.cfg.family == "audio":
            kw["frames"] = batch.get("frames")
        return kw

    # -- params ------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None):
        return self.mod.init_params(self.cfg, generator, self.device,
                                    **self._kw())

    # -- training loss --------------------------------------------------------
    def loss(self, params, batch, *, remat: bool = True):
        """(loss, {"ce", "aux"}): ``ce + router_aux_loss_coef * aux``,
        where ``aux`` is the MoE layers' summed load-balance loss (zero
        for the other families).  ``labels`` default to the tokens
        shifted left, with -1 (ignored) at the end; ``remat`` checkpoints
        each block under ``cfg.remat_policy``."""
        logits, aux = self.mod.forward(params, batch["tokens"], self.cfg,
                                       remat=remat, with_aux=True,
                                       **self._fwd_kw(batch))
        labels = batch.get("labels")
        if labels is None:
            tokens = batch["tokens"]
            labels = torch.cat([tokens[:, 1:],
                                torch.full_like(tokens[:, :1], -1)], dim=1)
        ce = cross_entropy(logits, labels)
        total = ce + self.cfg.router_aux_loss_coef * aux
        return total, {"ce": ce, "aux": aux}

    # -- serving -------------------------------------------------------------
    @torch.no_grad()
    def logits(self, params, batch):
        """Logits [B, S, V] alone (the serving ``logits`` stage)."""
        return self.mod.forward(params, batch["tokens"], self.cfg,
                                **self._fwd_kw(batch))

    @torch.no_grad()
    def prefill(self, params, batch, cache_len: int):
        logits, cache = self.mod.forward(params, batch["tokens"], self.cfg,
                                         build_cache=True,
                                         cache_len=cache_len,
                                         **self._fwd_kw(batch))
        return last_position(logits), cache

    def init_cache(self, batch: int, cache_len: int,
                   device: DeviceLike = None):
        return self.mod.init_cache(self.cfg, batch, cache_len,
                                   device=device or self.device,
                                   **self._kw())

    # -- a mesh's edges -----------------------------------------------------
    def placed(self, tree):
        """Under a mesh, plain batch-leading inputs that every rank holds
        whole (a dict) as DTensors, batch over data (views: nothing is
        copied); without one, ``tree`` as it is."""
        if self.ax is None:
            return tree
        return {k: place(t, self.ax.mesh,
                         P(self.ax.batch, *([None] * (t.dim() - 1))))
                for k, t in tree.items()}

    def placed_cache(self, cache):
        """:meth:`placed` for a decode cache, by :meth:`cache_pspecs`."""
        if self.ax is None:
            return cache
        from repro_torch.launch.sharding import distribute
        return distribute(cache, self.ax.mesh, self.cache_pspecs())

    def cache_pspecs(self):
        """Partition specs of :meth:`init_cache`'s tree under ``ax``."""
        kw = self._kw()
        return self.mod.cache_pspecs(self.cfg, kw.pop("ax"), **kw)

    def decode_step(self, params, tokens, pos, cache):
        return self.mod.decode_step(params, tokens, pos, cache, self.cfg,
                                    **self._step_kw())

    # -- dry-run specs ---------------------------------------------------------
    def input_specs(self, shape: InputShape) -> Dict[str, Any]:
        """Meta tensors (shape and dtype, no storage) for every model input
        of the given shape, as the reference's ``ShapeDtypeStruct``s."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            specs = {"tokens": meta((B, S), i32)}
            if shape.kind == "train":
                specs["labels"] = meta((B, S), i32)
            if cfg.family == "vlm":
                specs["media"] = meta((B, cfg.num_media_tokens, cfg.d_model),
                                      torch_dtype(cfg.dtype))
            if cfg.family == "audio":
                specs["frames"] = meta((B, cfg.encoder_seq, cfg.d_model),
                                       torch_dtype(cfg.dtype))
            return specs
        # decode: one token + cache of length S
        return {"tokens": meta((B, 1), i32), "pos": meta((B,), i32),
                "cache": self.init_cache(B, S, device="meta")}


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                ax: Optional[AxisInfo] = None, *, long_context: bool = False,
                moe_dispatch: str = "all_to_all") -> Model:
    """The model on ``device`` (the CUDA device unless the caller names
    another; raises without a card).  ``ax`` (a mesh's axes) pads the
    heads to its model axis, as the reference does; the caller places
    params, inputs and cache as DTensors by ``launch.sharding``'s specs.
    ``moe_dispatch`` picks the expert-parallel exchange (``all_to_all``
    or ``allgather``) where the model axis has several ranks."""
    if cfg.family not in _FAMILY_MODULES:
        raise ValueError(f"unknown family {cfg.family!r} (have "
                         f"{sorted(_FAMILY_MODULES)})")
    if moe_dispatch not in ("all_to_all", "allgather"):
        raise ValueError(f"unknown moe_dispatch {moe_dispatch!r}")
    return Model(cfg=cfg, device=resolve_device(device), ax=ax,
                 long_context=long_context, moe_dispatch=moe_dispatch)


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
    (the stage returns one tensor or a flat tuple of them).  Building the
    hook measures nothing: only calling it does."""
    import statistics
    import time

    def call(args):
        out = batched(*args)
        out = out if isinstance(out, tuple) else (out,)
        synchronize(out)
        return out

    def hook(b: int) -> Dict[str, Any]:
        args = arg_maker(b)
        out = None
        for _ in range(warmup):
            out = call(args)
        ts = []
        for _ in range(runs):
            t0 = time.perf_counter()
            out = call(args)
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

    def whole(tree):
        """A stage's outputs as plain tensors of the whole batch (the
        table's columns), whatever the mesh split."""
        if isinstance(tree, dict):
            return {k: whole(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(whole(v) for v in tree)
        return unplace(tree)

    if stage == "logits":
        def batched(tokens):
            return whole(model.logits(params, model.placed(
                {"tokens": tokens})))[:, -1]

        fn = _stage_fn(f"{model_name}_logits", ("tokens",), batched, 1)
        names = ["logits"]

        def arg_maker(b):
            return (torch.zeros((b, seq_len), dtype=torch.int32,
                                device=model.device),)
    elif stage == "prefill":
        def batched(tokens):
            logits, cache = whole(model.prefill(
                params, model.placed({"tokens": tokens}), cache_len))
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            pos = torch.full(tokens.shape[:1], tokens.shape[1],
                             dtype=torch.int32, device=tokens.device)
            return (tok, pos, *_split(cache))

        fn = _stage_fn(f"{model_name}_prefill", ("tokens",), batched,
                       2 + len(paths))
        names = list(state_names)

        def arg_maker(b):
            return (torch.zeros((b, seq_len), dtype=torch.int32,
                                device=model.device),)
    elif stage == "decode":
        def batched(tok, pos, *leaves):
            step = model.placed({"tok": tok[:, None], "pos": pos})
            logits, new_cache = whole(model.decode_step(
                params, step["tok"], step["pos"],
                model.placed_cache(_join(leaves))))
            ntok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return (ntok, pos + 1, *_split(new_cache))

        fn = _stage_fn(f"{model_name}_decode", tuple(state_names), batched,
                       2 + len(paths))
        names = list(state_names)

        def arg_maker(b):
            zeros = torch.zeros((b,), dtype=torch.int32, device=model.device)
            return (zeros, zeros.clone(),
                    *_split(model.init_cache(b, cache_len)))
    else:
        raise ValueError(f"unknown stage {stage!r} "
                         "(logits | prefill | decode)")
    hook = _timing_hook(batched, arg_maker, runs=runs) if measure else None
    return ops.ModelOp(fn=fn, names=names,
                       model_name=model_name, stage=stage, cost_hook=hook)


def stage_input_specs(model: Model, stage: str, *, seq_len: int = 32,
                      cache_len: int = 64) -> Dict[str, torch.Tensor]:
    """Row-level input column specs for one serving stage, as meta tensors
    (shape + dtype, no storage): ``logits``/``prefill`` consume a token
    column; ``decode`` consumes the batch-leading cache-state columns
    ``tok``/``pos``/``c{i}``."""
    i32 = torch.int32
    if stage in ("logits", "prefill"):
        return {"tokens": torch.empty((seq_len,), dtype=i32, device="meta")}
    if stage != "decode":
        raise ValueError(f"unknown stage {stage!r} "
                         "(logits | prefill | decode)")
    _, axes, leaves = _cache_layout(model, cache_len)
    specs = {"tok": torch.empty((), dtype=i32, device="meta"),
             "pos": torch.empty((), dtype=i32, device="meta")}
    for i, (leaf, ax) in enumerate(zip(leaves, axes)):
        specs[f"c{i}"] = leaf.select(ax, 0)
    return specs
