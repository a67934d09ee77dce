"""Model cascade (paper §3.2 Fig 3 / §5.2 image cascade) on the port's
compiled serving path (port of ``examples/image_cascade.py``).

A cheap model (yi-9b) answers first; low-confidence rows escalate to a
larger model (granite-34b, at a sharp temperature); a left join merges
both paths.  The escalation branch is a GPU ``filter -> map`` chain the
compiler fuses and lowers to one ``BatchedJittedFuse`` with the filter
evaluated as a mask column inside the batched call (masked rows compact
only at the device->host boundary), so the branch decision costs no
extra dispatch.

Each forward closure carries a natively batched form (``__batched__``):
a batched chain calls the model once on the stacked rows, with its
attention kernels launched by that call, where ``torch.func.vmap`` could
not batch a kernel launch.

    PYTHONPATH=src python -m repro_torch.examples.image_cascade [--full]
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
from repro_torch.runtime import NetModel, Runtime

THRESHOLD = 0.5
SEQ = 16
#: (arch, seed, temperature) of the two stages
SIMPLE = ("yi-9b", 0, 1.0)
COMPLEX = ("granite-34b", 1, 0.05)       # sharp


def stage_config(arch: str, tiny: bool = True,
                 num_layers: Optional[int] = None):
    """A stage's config with the attention kernels on (on the CPU their
    wrappers run the plain versions); ``num_layers`` cuts the depth."""
    cfg = get_tiny_config(arch) if tiny else get_config(arch)
    cfg = dataclasses.replace(cfg, use_kernels=True)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return cfg


def _forward(arch, seed, temp, *, tiny: bool = True,
             device: DeviceLike = None, params=None,
             num_layers: Optional[int] = None):
    """Per-row forward closure (tokens [S] -> class probs [V]) over a
    built registry model, with its batch form ([B, S] -> [B, V]) as
    ``__batched__``.  ``params`` are drawn from ``seed`` on the device
    when not given."""
    dev = resolve_device(device)
    cfg = stage_config(arch, tiny, num_layers)
    model = build_model(cfg, device=dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))

    def probs_batched(tokens):
        logits = model.logits(params, {"tokens": tokens})
        return torch.softmax(logits[:, -1].float() / temp, dim=-1)

    def probs(tokens):
        return probs_batched(tokens[None])[0]

    probs.__batched__ = probs_batched
    return probs, cfg.vocab_size


def _batched(fn, forward, pick):
    """Give the row-wise step ``fn`` the batch form ``pick(forward's batch
    form)`` when ``forward`` has one; a plain closure is left to
    ``torch.func.vmap``."""
    native = getattr(forward, "__batched__", None)
    if native is not None:
        fn.__batched__ = lambda tokens, *rest: pick(tokens, native(tokens))
    return fn


def _top(p):
    return torch.argmax(p, dim=-1).to(torch.int32), torch.max(p, dim=-1)[0]


def build_flow(simple_fwd, complex_fwd, v):
    """The cascade Dataflow over the given per-row forward closures."""
    def gate(tokens: torch.Tensor) -> torch.Tensor:
        return torch.clamp(tokens, 0, v - 1)

    def simple(tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return (tokens, *_top(simple_fwd(tokens)))

    def low_confidence(tokens: torch.Tensor, idx: torch.Tensor,
                       conf: torch.Tensor) -> bool:
        return conf < THRESHOLD

    def complex_model(tokens: torch.Tensor, idx: torch.Tensor,
                      conf: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _top(complex_fwd(tokens))

    def lab_simple(tokens: torch.Tensor, idx: torch.Tensor,
                   conf: torch.Tensor) -> Tuple[str, float]:
        return f"class{int(idx)}", float(conf)

    def lab_complex(cidx: torch.Tensor,
                    cconf: torch.Tensor) -> Tuple[str, float]:
        return f"class{int(cidx)}", float(cconf)

    def best(label: str, conf: float, clabel: str,
             cconf: float) -> Tuple[str, float]:
        if clabel is not None and cconf > conf:
            return clabel, cconf
        return label, conf

    _batched(simple, simple_fwd, lambda toks, p: (toks, *_top(p)))
    _batched(complex_model, complex_fwd, lambda toks, p: _top(p))

    fl = Dataflow([("tokens", torch.Tensor)])
    s = fl.map(gate, names=["tokens"], gpu=True).map(
        simple, names=["tokens", "idx", "conf"], gpu=True)
    c = s.filter(low_confidence, gpu=True).map(
        complex_model, names=["cidx", "cconf"], gpu=True)
    slab = s.map(lab_simple, names=["label", "conf"])
    clab = c.map(lab_complex, names=["clabel", "cconf"])
    fl.output = slab.join(clab, how="left").map(best,
                                                names=["label", "conf"])
    return fl


def build(rt, *, name="cascade", tiny: bool = True, params=None,
          complex_layers: Optional[int] = None):
    """Compile the cascade onto ``rt`` (its device); ``params`` maps an
    arch to its weights (drawn from the stage's seed when absent) and
    ``complex_layers`` cuts the complex stage's depth."""
    params = params or {}
    simple_fwd, v = _forward(*SIMPLE, tiny=tiny, device=rt.device,
                             params=params.get(SIMPLE[0]))
    complex_fwd, _ = _forward(*COMPLEX, tiny=tiny, device=rt.device,
                              params=params.get(COMPLEX[0]),
                              num_layers=complex_layers)
    return compile_flow(build_flow(simple_fwd, complex_fwd, v), rt,
                        fusion=True, name=name)


def escalation_chain(dep):
    """The lowered escalation chain (the one whose steps hold the filter)
    of a deployed cascade."""
    from repro_torch.core.lowering import BatchedJittedFuse
    from repro_torch.core import operators as ops

    (chain,) = [o.op for o in dep.plan.ops
                if isinstance(o.op, BatchedJittedFuse)
                and any(isinstance(m, ops.Filter) for m in o.op.ops)]
    return chain


def draw_images(n: int, device: DeviceLike = "cpu"):
    """``n`` images of ``SEQ`` tokens below 500 from seed 0 (the
    reference's draw), each a row on ``device``."""
    rng = np.random.default_rng(0)
    return [torch.as_tensor(rng.integers(0, 500, SEQ), dtype=torch.int32,
                            device=device) for _ in range(n)]


def check_flows():
    """Static-verifier hook (``python -m repro_torch.check``): one tiny
    model on the CPU stands in for both cascade stages — the flow shape
    is identical."""
    fwd, v = _forward(*SIMPLE, device="cpu")
    toks = torch.zeros((SEQ,), dtype=torch.int32)
    return [{"name": "cascade", "flow": build_flow(fwd, fwd, v),
             "compile": {"fusion": True},
             "sample": Table([("tokens", torch.Tensor)], [(toks,)])}]


def run(images: int = 6, *, tiny: bool = True, device: DeviceLike = None,
        per_request: int = 1, params=None,
        complex_layers: Optional[int] = None, hang_timeout_s: float = 5.0,
        verbose: bool = False):
    """Headless run on ``device`` (the card unless the caller names
    another): ``images`` images, ``per_request`` rows to a request (1, as
    the reference sends them, takes the per-row path; more take the
    batched path).  Returns a metrics dict: confident answers
    (``escalated``, the reference's name for that count), labels and
    confs in image order, the median request ms and the escalation
    chain's dispatch counters."""
    dev = resolve_device(device)
    rt = Runtime(n_cpu=4, n_gpu=1, net=NetModel(scale=0.0),
                 hang_timeout_s=hang_timeout_s, device=dev)
    try:
        dep = build(rt, tiny=tiny, params=params,
                    complex_layers=complex_layers)
        rows = draw_images(images, dev)
        escalated, labels, confs, lats = 0, [], [], []
        for i in range(0, images, per_request):
            part = rows[i:i + per_request]
            t0 = time.perf_counter()
            out = dep.execute(Table([("tokens", torch.Tensor)],
                                    [(t,) for t in part])).result(600)
            lats.append(time.perf_counter() - t0)
            # rows keep their ids through the flow; ids count up in order
            for r in sorted(out.rows, key=lambda r: r.row_id):
                label, conf = r.values
                labels.append(label)
                confs.append(conf)
                escalated += conf >= THRESHOLD
            if verbose:
                print(f"img{i}..{i + len(part) - 1}: {labels[-len(part):]} "
                      f"conf={confs[-len(part):]} ({lats[-1] * 1e3:.1f} ms)")
        chain = escalation_chain(dep)
        return {"images": images, "escalated": int(escalated),
                "labels": labels, "confs": confs,
                "median_ms": sorted(lats)[len(lats) // 2] * 1e3,
                "batch_dispatches": chain.batch_dispatches,
                "row_dispatches": chain.row_dispatches,
                "vmap_fallback": chain._vmap_fallback,
                "fallback": chain._fallback}
    finally:
        rt.stop()


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="both stages at full width (default: tiny)")
    ap.add_argument("--images", type=int, default=6)
    args = ap.parse_args(argv)
    r = run(args.images, tiny=not args.full, hang_timeout_s=120.0,
            verbose=True)
    print(f"cascade: {r['escalated']}/{r['images']} answered confidently; "
          f"threshold={THRESHOLD}, median {r['median_ms']:.1f} ms")


if __name__ == "__main__":
    main()
