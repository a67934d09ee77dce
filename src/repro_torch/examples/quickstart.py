"""Quickstart: the paper's Figure-1 ensemble (port of
``examples/quickstart.py``).

An input is preprocessed, scored by three zoo models in parallel (yi-9b,
glm4-9b and gemma2-9b; each takes the softmax of its last position), and
the most confident prediction wins — deployed on the serverless runtime
with operator fusion enabled.  The models run on the card with their
attention kernels on, tiny by default or at full width.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--full]
"""
import argparse
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_tiny_config
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.runtime import NetModel, Runtime

#: (arch, seed) of the three ensemble members
MODELS = (("yi-9b", 0), ("glm4-9b", 1), ("gemma2-9b", 2))
URLS = ("img://cat.jpg", "img://dog.jpg")


def model_config(arch: str, tiny: bool = True):
    """An ensemble member's config, with the attention kernels on (on the
    CPU their wrappers run the plain versions)."""
    cfg = get_tiny_config(arch) if tiny else get_config(arch)
    return dataclasses.replace(cfg, use_kernels=True)


def load_model(arch: str, seed: int, *, tiny: bool = True,
               device: DeviceLike = None, params=None):
    """The member's predict closure (tokens -> (label, conf)) on
    ``device``; ``params`` are drawn from ``seed`` on the device when not
    given."""
    dev = resolve_device(device)
    model = build_model(model_config(arch, tiny), device=dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def forward(tokens: torch.Tensor) -> torch.Tensor:
        logits = model.logits(params, {"tokens": tokens})
        return torch.softmax(logits[:, -1], dim=-1)

    def predict(tokens: np.ndarray) -> Tuple[str, float]:
        probs = forward(torch.as_tensor(tokens, device=dev)[None])[0]
        return (f"{arch}:class{int(torch.argmax(probs))}",
                float(torch.max(probs)))

    return predict


def preproc(url: str) -> np.ndarray:
    return (np.frombuffer(url.encode()[:16].ljust(16), np.uint8)
            .astype(np.int32) % 500)


def build_flow(models):
    """The Figure-1 ensemble dataflow over the given predict closures."""
    fl = Dataflow([("url", str)])
    img = fl.map(preproc, names=["tokens"])
    preds = [img.map(m, names=["label", "conf"]) for m in models]
    fl.output = preds[0].union(*preds[1:]).agg("max", "conf")
    return fl


def check_flows():
    """Static-verifier hook (``python -m repro_torch.check``): lint the
    real flow shape; one tiny model on the CPU stands in for all three
    ensemble heads."""
    m = load_model("yi-9b", 0, device="cpu")
    return [{"name": "quickstart", "flow": build_flow([m, m, m]),
             "compile": {"fusion": True},
             "sample": Table([("url", str)], [("img://cat.jpg",)])}]


def run(*, tiny: bool = True, device: DeviceLike = None, params=None,
        verbose: bool = False):
    """Headless run on ``device`` (the card unless the caller names
    another) on ``URLS``.  ``params`` maps an arch to its weights (drawn
    from its seed when absent).  Returns per url the flow's answer
    (``{"group", "max"}``: the ensemble's aggregate keeps only the
    winning confidence, as in the reference) and the ms it took."""
    dev = resolve_device(device)
    params = params or {}
    fl = build_flow([load_model(arch, seed, tiny=tiny, device=dev,
                                params=params.get(arch))
                     for arch, seed in MODELS])
    rt = Runtime(n_cpu=4, net=NetModel(scale=0.0), hang_timeout_s=60.0,
                 device=dev)
    try:
        fl.deploy(rt, fusion=True)
        out = {"answers": [], "ms": []}
        for url in URLS:
            t0 = time.perf_counter()
            result = fl.execute(Table([("url", str)], [(url,)])).result(600)
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["answers"].append(result.to_dicts()[0])
            if verbose:
                print(url, "->", out["answers"][-1],
                      f"({out['ms'][-1]:.1f} ms)")
        return out
    finally:
        rt.stop()


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="the members at full width (default: tiny)")
    args = ap.parse_args(argv)
    run(tiny=not args.full, verbose=True)


if __name__ == "__main__":
    main()
