"""Multi-host dry-run on one process (port of the reference package's
``launch/dryrun.py``): trace one train, prefill or decode step of every
(arch x shape x mesh) combination for one rank of the production mesh,
with every parameter, optimizer state, input and cache a DTensor of fake
local shards placed by ``launch.sharding``'s spec trees, and emit its
memory, collectives and roofline terms as JSON.

The reference forces 512 host devices before JAX starts and lets XLA
compile the global program; here the ``fake`` process group (256 or 512
ranks, no peers: every collective returns at once) is started before
anything else, and the step runs eagerly on rank 0's shards under
``FakeTensorMode``.  Nothing is allocated on any device and CUDA is never
initialised: that is the tool's function, not a fallback.  The step is
the plain path (``use_kernels=False``), as the reference compiles it
with ``use_pallas=False``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape decode_32k --multipod --out results/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --batch-archs all
Options: --moe-dispatch {all_to_all,allgather}  --remat {nothing,dots}
         --no-seq-shard --rs-outputs --barrier  (perf-iteration knobs)

The result keeps the reference's keys where they mean something here:
``memory.argument_bytes`` (the rank's shards of the step's inputs, exact),
``output_bytes`` (its outputs; ``alias_bytes`` the part that updates an
input in place), ``peak_est_bytes`` (the peak of live tensor bytes that
``MemTracker`` counts over the traced step: inputs, activations, grads,
temporaries; not an allocator's reserve) and ``hbm_per_chip`` (the
H100's 80 GB); ``collectives`` (output bytes of each c10d op the rank
issues, and their total); ``roofline_counted`` (the counted roofline of
the traced rank, the counterpart of the reference's ``roofline_hlo``);
``roofline`` (``flops.estimate``'s arithmetic with the counted
collective bytes) and ``analytic``.  XLA's compile time, temp buffers
and HLO-parsed collectives have no counterpart.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.shapes import LONG_CONTEXT_OK, InputShape
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_axis_info, make_mesh
from repro_torch.models.partition import (axis_sizes, check_divisible,
                                          placements)

#: (shape, axis names) of the two production meshes
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def should_skip(arch: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return "full-attention arch: long_500k skipped (DESIGN.md §5)"
    return None


def fake_world(world: int) -> None:
    """Start (or restart at another size) the ``fake`` process group of
    ``world`` ranks, this process rank 0.  Collectives on it return at
    once; no peer exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    _fake_alltoall()


def _fake_alltoall() -> None:
    """DTensor moves a shard from one tensor dim to another with an
    all-to-all, except on a mesh of device type ``cpu``, where it
    gathers the whole dim and keeps a chunk (gloo has no all-to-all).
    The fake group stands for the card's NCCL, so the dry-run takes the
    all-to-all: the gathered copy would inflate the rank's peak and its
    collective bytes by the model axis's size."""
    from torch.distributed.tensor import placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None or getattr(orig, "_fake_group", False) or not hasattr(
            torch.ops._dtensor, "shard_dim_alltoall"):
        return                   # another torch: its own path stands

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        import torch.distributed._functional_collectives as funcol
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))

    shard_dim_alltoall._fake_group = True
    pt.shard_dim_alltoall = shard_dim_alltoall


def _mem_tracker():
    """A ``MemTracker`` over the rank's local tensors: it declines a
    DTensor's op and sees the ops that op runs on the shards, so the
    temporaries of a redistribution count too, and it skips the
    global-shape fake ops of DTensor's shape derivation."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.roofline.analysis import _wraps, in_propagation

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _wraps(args, kwargs):
                return NotImplemented
            if in_propagation():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def _local_shape(shape, spec, sizes) -> Tuple[int, ...]:
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else
                  (() if entry is None else (entry,))):
            out[d] //= sizes[a]
    return tuple(out)


def _placed(meta_tree, mesh, spec_tree, *, requires_grad: bool = False):
    """DTensors of rank 0's shards of ``meta_tree`` placed by
    ``spec_tree``: each local shard is made empty inside the active fake
    mode, so nothing is allocated."""
    from torch.distributed.tensor import DTensor
    sizes = axis_sizes(mesh)

    def place(_, t, s):
        check_divisible(t.shape, s, mesh)
        local = torch.empty(_local_shape(t.shape, s, sizes), dtype=t.dtype)
        d = DTensor.from_local(local, mesh, placements(mesh, s),
                               run_check=False, shape=t.shape,
                               stride=t.stride())
        return d.requires_grad_(True) if requires_grad else d

    return sh.tree_map_with_path(place, meta_tree, spec_tree)


def _tree_bytes(tree) -> int:
    """Bytes of the local shards among ``tree``'s leaves."""
    from repro_torch.models.partition import local
    return sum(local(t).numel() * local(t).element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _apply_knobs(cfg, *, remat, kv_quant, expert_quant, bf16_boundary,
                 grad_accum, seq_shard, rs_outputs, causal_skip):
    kw: Dict[str, Any] = {"use_kernels": False}
    if remat:
        kw["remat_policy"] = remat
    if kv_quant:
        kw["kv_quant"] = True
    if expert_quant:
        kw["expert_quant"] = True
    if bf16_boundary:
        kw["bf16_boundary"] = True
    if grad_accum is not None:
        kw["grad_accum"] = grad_accum
    if not seq_shard:
        kw["seq_shard"] = False
    if rs_outputs:
        kw["rs_outputs"] = True
    if causal_skip:
        kw["causal_skip"] = True
    return dataclasses.replace(cfg, **kw)


def build_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
                 moe_dispatch: str = "all_to_all",
                 remat: Optional[str] = None, kv_quant: bool = False,
                 expert_quant: bool = False, bf16_boundary: bool = False,
                 grad_accum: Optional[int] = None, seq_shard: bool = True,
                 rs_outputs: bool = False, causal_skip: bool = False,
                 cfg=None, shape: Optional[InputShape] = None,
                 mesh_shape: Optional[Tuple[Tuple[int, ...],
                                            Tuple[str, ...]]] = None
                 ) -> Dict[str, Any]:
    """Trace one step of ``arch`` at ``shape_name`` on one rank of the
    production mesh (2x16x16 with ``multi_pod``).  ``cfg``, ``shape`` and
    ``mesh_shape`` (shape, axis names) override the config, the input
    shape and the mesh (the tests trace tiny models on small meshes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models.registry import build_model
    from repro_torch.roofline import analysis, flops as flops_lib, hw
    from repro_torch.training import optim, train_step as ts_lib

    cfg = _apply_knobs(cfg or get_config(arch), remat=remat,
                       kv_quant=kv_quant, expert_quant=expert_quant,
                       bf16_boundary=bf16_boundary, grad_accum=grad_accum,
                       seq_shard=seq_shard, rs_outputs=rs_outputs,
                       causal_skip=causal_skip)
    shape = shape or SHAPES[shape_name]
    dims, names = mesh_shape or PRODUCTION[multi_pod]
    chips = math.prod(dims)
    fake_world(chips)
    mesh = make_mesh(dims, names, device_type="cpu")
    mp = axis_sizes(mesh)["model"]
    long_context = shape_name == "long_500k"
    shard_batch = shape.global_batch % (chips // mp) == 0
    ax = make_axis_info(mesh, shard_batch=shard_batch)
    kw = dict(long_context=long_context, moe_dispatch=moe_dispatch)
    model = build_model(cfg, "cpu", ax, **kw)
    meta = build_model(cfg, "meta", ax, **kw)
    meta_params = meta.init()
    serve_mode = "serve" if cfg.num_experts == 0 else "train"
    B, S = shape.global_batch, shape.seq_len

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake, implicit_replication():
        if shape.kind == "train":
            pspecs = sh.param_pspecs(meta_params, cfg, ax, mode="train")
            opt_init, _ = optim.make_optimizer(cfg.optimizer)
            state = {
                "params": _placed(meta_params, mesh, pspecs,
                                  requires_grad=True),
                "opt": _placed(opt_init(meta_params), mesh,
                               sh.opt_state_pspecs(meta_params, pspecs,
                                                   cfg.optimizer))}
            batch = _placed(model.input_specs(shape), mesh,
                            sh.batch_pspecs(cfg, ax, shape))
            step = ts_lib.make_train_step(model)
            args, grad = (state, batch), True
            alias = _tree_bytes(state)         # updated in place
        else:
            params = _placed(meta_params, mesh, sh.param_pspecs(
                meta_params, cfg, ax, mode=serve_mode))
            specs = model.input_specs(shape)
            bspecs = sh.batch_pspecs(cfg, ax, shape)
            grad = False
            if shape.kind == "prefill":
                batch = _placed(specs, mesh, bspecs)

                def step(params, batch):
                    return model.prefill(params, batch, cache_len=S)
                args, alias = (params, batch), 0
            else:
                cache = _placed(specs["cache"], mesh, model.cache_pspecs())
                tok = _placed({"tokens": specs["tokens"],
                               "pos": specs["pos"]}, mesh, bspecs)

                def step(params, tokens, pos, cache):
                    return model.decode_step(params, tokens, pos, cache)
                args = (params, tok["tokens"], tok["pos"], cache)
                # the reference donates the cache; the port's step
                # writes a copy, so none of its output aliases an input
                alias = 0
        argument_bytes = _tree_bytes(args)
        out: Dict[str, Any] = {}

        def traced(*a):
            out["value"] = step(*a)

        t0 = time.time()
        mem = _mem_tracker()
        mem.track_external(*[t for t in torch.utils._pytree.tree_leaves(args)
                             if isinstance(t, torch.Tensor)])
        counts = analysis.run_counted(traced, *args, fake_mode=fake,
                                      grad=grad, modes=(mem,))
        trace_s = time.time() - t0
        output_bytes = _tree_bytes(out["value"])
        peak = sum(v.get("Total", 0) for v in
                   mem.get_tracker_snapshot("peak").values())

    tokens = B * (S if shape.kind != "decode" else 1)
    n_active = cfg.active_param_count()
    model_flops = float((6 if shape.kind == "train" else 2) * n_active
                        * tokens)
    roof = analysis.Roofline(flops=counts.flops, hbm_bytes=counts.hbm_bytes,
                             coll_bytes=counts.coll_bytes,
                             model_flops=model_flops, chips=chips)
    est = flops_lib.estimate(cfg, shape, chips=chips, mp=mp,
                             long_context=long_context,
                             moe_dispatch=moe_dispatch)
    roof_analytic = analysis.Roofline(
        flops=est.step_flops / chips, hbm_bytes=est.hbm_bytes_per_chip,
        coll_bytes=counts.coll_bytes, model_flops=est.model_flops,
        chips=chips)
    return {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(d) for d in dims),
        "chips": chips,
        "kind": shape.kind,
        "moe_dispatch": moe_dispatch,
        "remat": cfg.remat_policy,
        "kv_quant": cfg.kv_quant,
        "bf16_boundary": cfg.bf16_boundary,
        "grad_accum": cfg.grad_accum,
        "trace_s": trace_s,
        "tokens_per_step": tokens,
        "params": cfg.param_count(), "active_params": n_active,
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": output_bytes,
            "alias_bytes": alias,
            "peak_est_bytes": peak,
            "peak_source": "MemTracker under FakeTensorMode (live tensor "
                           "bytes of the traced rank)",
            "hbm_per_chip": hw.HBM_BYTES,
        },
        "collectives": {**counts.coll_by_op, "total": counts.coll_bytes},
        "roofline_counted": roof.to_dict(),
        "roofline": roof_analytic.to_dict(),
        "analytic": est.to_dict(),
        "cuda_initialized": torch.cuda.is_initialized(),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    p.add_argument("--shape", default=None, choices=list(SHAPES))
    p.add_argument("--batch-archs", default=None,
                   help="comma-list or 'all': run arch x shape x mesh matrix")
    p.add_argument("--batch-shapes", default="all")
    p.add_argument("--meshes", default="both",
                   choices=["single", "multi", "both"])
    p.add_argument("--multipod", action="store_true")
    p.add_argument("--moe-dispatch", default="all_to_all",
                   choices=["all_to_all", "allgather"])
    p.add_argument("--remat", default=None, choices=["nothing", "dots",
                                                     "everything"])
    p.add_argument("--kv-quant", action="store_true")
    p.add_argument("--expert-quant", action="store_true")
    p.add_argument("--barrier", action="store_true", dest="bf16_boundary")
    p.add_argument("--grad-accum", type=int, default=None)
    p.add_argument("--no-seq-shard", action="store_false", dest="seq_shard")
    p.add_argument("--rs-outputs", action="store_true")
    p.add_argument("--causal-skip", action="store_true")
    p.add_argument("--tag", default=None, help="suffix for the output JSON")
    p.add_argument("--out", default=None, help="directory for the JSON")
    args = p.parse_args(argv)
    # the fake group first, before any mesh is asked for
    fake_world(512 if args.multipod or args.batch_archs else 256)

    if args.batch_archs:
        archs = (list(ARCH_IDS) if args.batch_archs == "all"
                 else args.batch_archs.split(","))
        shapes = (list(SHAPES) if args.batch_shapes == "all"
                  else args.batch_shapes.split(","))
        meshes = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.meshes]
        failed = run_batch(archs, shapes, meshes,
                           args.out or "results/dryrun",
                           moe_dispatch=args.moe_dispatch)
        return 1 if failed else 0
    if args.arch is None or args.shape is None:
        p.error("--arch and --shape (or --batch-archs)")

    skip = should_skip(args.arch, args.shape)
    if skip:
        result = {"arch": args.arch, "shape": args.shape,
                  "mesh": "2x16x16" if args.multipod else "16x16",
                  "skipped": skip}
    else:
        result = build_dryrun(args.arch, args.shape, multi_pod=args.multipod,
                              moe_dispatch=args.moe_dispatch,
                              remat=args.remat, kv_quant=args.kv_quant,
                              expert_quant=args.expert_quant,
                              bf16_boundary=args.bf16_boundary,
                              grad_accum=args.grad_accum,
                              seq_shard=args.seq_shard,
                              rs_outputs=args.rs_outputs,
                              causal_skip=args.causal_skip)
    print(json.dumps(result, indent=2))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"{args.arch}__{args.shape}__{result['mesh']}"
        if args.moe_dispatch != "all_to_all":
            tag += f"__{args.moe_dispatch}"
        if args.remat:
            tag += f"__remat-{args.remat}"
        if args.tag:
            tag += f"__{args.tag}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(result, f, indent=2)
    return 0


def run_batch(archs, shapes, meshes, out_dir: str, *,
              moe_dispatch: str = "all_to_all",
              skip_existing: bool = True) -> int:
    """Run many combos in one process.  One JSON per combo; a failure is
    recorded in its JSON and counted (the return value), not fatal."""
    os.makedirs(out_dir, exist_ok=True)
    failed = 0
    for arch in archs:
        for shape in shapes:
            for multi_pod in meshes:
                mesh_tag = "2x16x16" if multi_pod else "16x16"
                tag = f"{arch}__{shape}__{mesh_tag}"
                path = os.path.join(out_dir, tag + ".json")
                if skip_existing and os.path.exists(path):
                    print("skip (exists):", tag, flush=True)
                    continue
                skip = should_skip(arch, shape)
                t0 = time.time()
                if skip:
                    result = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                              "skipped": skip}
                else:
                    try:
                        result = build_dryrun(arch, shape,
                                              multi_pod=multi_pod,
                                              moe_dispatch=moe_dispatch)
                    except Exception as e:             # recorded, counted
                        import traceback
                        failed += 1
                        result = {"arch": arch, "shape": shape,
                                  "mesh": mesh_tag, "error": str(e)[:2000],
                                  "traceback":
                                  traceback.format_exc()[-4000:]}
                result["wall_s"] = time.time() - t0
                with open(path, "w") as f:
                    json.dump(result, f, indent=2)
                status = ("SKIP" if "skipped" in result else
                          "FAIL" if "error" in result else "ok  ")
                print(f"{status} {tag} ({result['wall_s']:.1f}s)",
                      flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main())
