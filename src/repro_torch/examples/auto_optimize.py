"""Automated optimization selection (paper §7 'Future Work', implemented;
port of ``examples/auto_optimize.py``).

The planner profiles the pipeline on a sample request (per-operator latency
mean/CV + payload sizes) and chooses fusion / competitive execution /
locality automatically — no manual optimization flags.  The request's
payload is a tensor on the runtime's device.

  PYTHONPATH=src python -m repro_torch.examples.auto_optimize [--device cpu]
"""
from __future__ import annotations

import argparse
import random
import time

import torch

from repro_torch.core.dataflow import Dataflow
from repro_torch.core.planner import auto_deploy
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime import NetModel, Runtime


def build_flow():
    rng = random.Random(0)

    def preproc(x: torch.Tensor) -> torch.Tensor:
        return x * 2.0                       # cheap, big payload -> fuse

    def jittery_model(x: torch.Tensor) -> tuple[float, float]:
        time.sleep(rng.choice([0.002, 0.002, 0.04]))   # heavy tail
        return float(x.mean()), 0.9

    def postproc(mean: float, conf: float) -> str:
        return f"label-{int(mean * 10) % 5}"

    fl = Dataflow([("x", torch.Tensor)])
    fl.output = (fl.map(preproc, names=["x"])
                 .map(jittery_model, names=["mean", "conf"])
                 .map(postproc, names=["label"]))
    return fl


def check_flows():
    """Static-verifier hook (``python -m repro_torch.check``): lint under
    the planner's richest flag set (fusion on)."""
    return [{"name": "auto-optimize", "flow": build_flow(),
             "compile": {"fusion": True},
             "sample": Table([("x", torch.Tensor)], [(torch.ones(1024),)])}]


def run(*, device: DeviceLike = None, runs: int = 6, requests: int = 10):
    """Plan, deploy and serve ``requests`` one at a time on ``device``
    (the CUDA device unless named).  Returns the planner's ``Plan``, the
    last answer and the per-request latencies in seconds."""
    dev = resolve_device(device)
    rt = Runtime(n_cpu=8, net=NetModel(), device=dev)
    try:
        fl = build_flow()
        sample = Table([("x", torch.Tensor)],
                       [(torch.ones(64 * 1024, device=dev),)])
        deployed, plan = auto_deploy(fl, rt, sample, runs=runs)
        lats, out = [], None
        for _ in range(requests):
            t0 = time.perf_counter()
            out = deployed.execute(sample).result(timeout=30)
            lats.append(time.perf_counter() - t0)
        return plan, out.to_dicts()[0], lats
    finally:
        rt.stop()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the payload lives (default: the CUDA device)")
    args = ap.parse_args()
    plan, answer, lats = run(device=args.device)
    print("planner decisions:")
    for note in plan.notes:
        print("  -", note)
    print("  flags:", plan.flags)
    lats.sort()
    print(f"result: {answer}")
    print(f"median {lats[len(lats)//2]*1e3:.1f} ms / "
          f"p90 {lats[int(len(lats)*0.9)]*1e3:.1f} ms over {len(lats)} "
          f"requests")


if __name__ == "__main__":
    main()
