"""Real-time video analysis pipeline (paper §5.2 Video Streams) on the
port's compiled serving path (port of ``examples/video_pipeline.py``).

    frames -> detector (a registry VLM's ``logits`` stage as a ``ModelOp``)
           -> {people head, vehicles head} in parallel (each a fused,
              batched GPU chain)
           -> union -> groupby(label) -> count

The detector is a real model wrapped as a first-class plan operator
(``model_stage_op``), so the SLO controller plans against its *measured*
cost curve; the classifier heads are two-step GPU chains the compiler
fuses and lowers to one batched call per batch.  ``arch``/``tiny`` pick
the detector: the reference runs the tiny llama-3.2-vision config; on
the card the same pipeline serves the full-width model.  Frames are 16
tokens each; the detector's ``logits`` stage takes no media (as in the
reference).

  PYTHONPATH=src python -m repro_torch.examples.video_pipeline \
      [--full] [--frames N]
"""
import argparse
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_tiny_config
from repro_torch.core.compiler import compile_flow
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.models.registry import model_stage_op
from repro_torch.profiling.controller import SLOController
from repro_torch.profiling.profiler import profile_plan, seed_from_model_ops
from repro_torch.runtime import NetModel, Runtime

ARCH = "llama-3.2-vision-11b"
SEQ = 16
#: the paper's per-frame budget for real-time video
BUDGET_MS = 1000.0


def detector_config(arch: str = ARCH, tiny: bool = True):
    """The detector's config, with the attention kernels on (on the CPU
    their wrappers run the plain versions)."""
    cfg = get_tiny_config(arch) if tiny else get_config(arch)
    return dataclasses.replace(cfg, use_kernels=True)


def head_weights(vocab: int, device: DeviceLike = None, seed: int = 1):
    """The people and vehicle heads' weights [vocab, 8] f32, drawn from a
    seeded generator (scaled by 0.1, as the reference draws them)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(0.1 * torch.randn((vocab, 8), generator=g, device=dev)
                 for _ in range(2))


def build_flow(*, arch: str = ARCH, tiny: bool = True,
               device: DeviceLike = None, params=None, heads=None):
    """The video Dataflow (detector ModelOp + two classifier heads).
    ``params`` (the detector's) and ``heads`` ((w_people, w_vehicle)) are
    drawn from seeded generators on ``device`` when not given."""
    dev = resolve_device(device)
    cfg = detector_config(arch, tiny)
    detector = build_model(cfg, device=dev)
    if params is None:
        params = detector.init(torch.Generator(device=dev).manual_seed(0))
    det_op = model_stage_op(detector, params, "logits",
                            model_name="detector", seq_len=SEQ)
    v = cfg.vocab_size
    w_people, w_vehicle = heads if heads is not None else head_weights(
        v, dev)

    def people_proj(det: torch.Tensor) -> torch.Tensor:
        return det.float() @ w_people

    def vehicle_proj(det: torch.Tensor) -> torch.Tensor:
        return det.float() @ w_vehicle

    def score(h: torch.Tensor) -> torch.Tensor:
        return torch.softmax(h, dim=-1)

    def label_people(s: torch.Tensor) -> Tuple[str, float]:
        return f"person-{int(torch.argmax(s)) % 3}", float(torch.max(s))

    def label_vehicle(s: torch.Tensor) -> Tuple[str, float]:
        return f"vehicle-{int(torch.argmax(s)) % 3}", float(torch.max(s))

    def gate(tokens: torch.Tensor) -> torch.Tensor:
        return torch.clamp(tokens, 0, v - 1)

    fl = Dataflow([("tokens", torch.Tensor)])
    # gate fuses with the detector ModelOp into one lowered chain, so the
    # detector serves a batch as one batched call of the model
    det = fl.map(gate, names=["tokens"], gpu=True).apply_op(det_op,
                                                            gpu=True)
    pa = det.map(people_proj, names=["h"], gpu=True).map(
        score, names=["s"], gpu=True)
    pb = det.map(vehicle_proj, names=["h"], gpu=True).map(
        score, names=["s"], gpu=True)
    la = pa.map(label_people, names=["label", "conf"])
    lb = pb.map(label_vehicle, names=["label", "conf"])
    fl.output = la.union(lb).groupby("label").agg("count", "label")
    return fl


def build(rt, *, name="video", **flow_kw):
    """Compile the pipeline onto ``rt``; returns the deployed flow."""
    return compile_flow(build_flow(device=rt.device, **flow_kw), rt,
                        fusion=True, name=name)


def frame(rng, device: DeviceLike = "cpu", v: int = 500):
    """One frame: ``SEQ`` tokens below ``v`` from the numpy ``rng`` (the
    reference's draw), as a row on ``device``."""
    return (torch.as_tensor(rng.integers(0, v, SEQ), dtype=torch.int32,
                            device=device),)


def check_flows():
    """Static-verifier hook (``python -m repro_torch.check``): the tiny
    detector, built on the CPU (verification runs nothing)."""
    rng = np.random.default_rng(0)
    return [{"name": "video", "flow": build_flow(device="cpu"),
             "compile": {"fusion": True},
             "sample": Table([("tokens", torch.Tensor)], [frame(rng)])}]


def run(frames: int = 4, *, arch: str = ARCH, tiny: bool = True,
        device: DeviceLike = None, params=None, heads=None,
        controller: bool = True, hang_timeout_s: float = 5.0,
        verbose: bool = False):
    """Headless run on ``device`` (the card unless the caller names
    another); returns a metrics dict with each frame's label counts."""
    dev = resolve_device(device)
    rt = Runtime(n_cpu=4, n_gpu=1, net=NetModel(scale=0.0),
                 hang_timeout_s=hang_timeout_s, device=dev)
    try:
        dep = build(rt, arch=arch, tiny=tiny, params=params, heads=heads)
        rng = np.random.default_rng(0)
        profile = None
        if controller:
            # build the controller's model BEFORE traffic (so the tick
            # sees a fresh arrival window): ModelOp-measured curves for
            # the detector chain, a quick sweep for everything else
            profile = seed_from_model_ops(dep.plan, batch_sizes=(1, 2, 4))
            sample = Table([("tokens", torch.Tensor)], [frame(rng, dev)])
            swept = profile_plan(dep.plan, sample, batch_sizes=(1, 2),
                                 runs=1, warmup=1)
            for k, c in swept.curves.items():
                profile.curves.setdefault(k, c)
        lats, counts = [], []
        for i in range(frames):
            t0 = time.perf_counter()
            out = dep.execute(Table([("tokens", torch.Tensor)],
                                    [frame(rng, dev)])).result(60)
            lats.append(time.perf_counter() - t0)
            counts.append(out.to_dicts())
            if verbose:
                print(f"frame {i}: {counts[-1]} ({lats[-1] * 1e3:.1f} ms)")
        med = sorted(lats)[len(lats) // 2]
        result = {"frames": frames, "median_ms": med * 1e3,
                  "p99_ms": max(lats) * 1e3, "frame_ms": [t * 1e3
                                                          for t in lats],
                  "labels_per_frame": len(counts[-1]), "counts": counts}
        if controller:
            ctl = SLOController(rt, dep, slo_p99_s=0.5, profile=profile,
                                replan_cooldown_s=1e9)
            ev = ctl.tick()
            result["controller"] = ev.kind
            result["controller_detail"] = ev.detail
            if verbose:
                print(f"controller tick: {ev.kind} {ev.detail}")
        return result
    finally:
        rt.stop()


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--full", action="store_true",
                    help="the detector at full width (default: tiny)")
    ap.add_argument("--frames", type=int, default=6)
    args = ap.parse_args(argv)
    r = run(frames=args.frames, arch=args.arch, tiny=not args.full,
            verbose=True)
    rt_ok = r["median_ms"] < BUDGET_MS
    print(f"median {r['median_ms']:.1f} ms -> "
          f"{'REAL-TIME (<1s/frame)' if rt_ok else 'over budget'}")


if __name__ == "__main__":
    main()
