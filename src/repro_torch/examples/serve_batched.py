"""End-to-end serving example (port of ``examples/serve_batched.py``): a
zoo model served with batched requests through the full stack —
Cloudflow dataflow -> serverless runtime with the batching executor ->
``ServingEngine`` (prefill + greedy decode with a KV cache) on the card.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        [--full] [--requests 12]
"""
import argparse
import time
from typing import Optional

import numpy as np

from repro_torch.core.table import Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.serve import build_flow
from repro_torch.runtime import NetModel, Runtime

MAX_BATCH, BATCH_WAIT_MS = 8, 20.0


def check_flows():
    """Static-verifier hook (``python -m repro_torch.check``): the tiny
    model, built on the CPU (verification runs nothing)."""
    flow, _engine = build_flow("yi-9b", max_new_tokens=2, batching=True,
                               device="cpu")
    return [{"name": "serve-batched", "flow": flow,
             "compile": {"fusion": False},
             "sample": Table([("text", str)], [("request 0",)])}]


def run(requests: int = 12, *, arch: str = "yi-9b", tiny: bool = True,
        device: DeviceLike = None, params=None, new_tokens: int = 8,
        hang_timeout_s: float = 5.0, verbose: bool = False):
    """Headless run on ``device`` (the card unless the caller names
    another): ``requests`` requests submitted at once, answered through
    the batching runtime.  Returns a dict with each request's completion,
    req/s, each request's latency (p50/p99) and the batch sizes the
    runtime cut."""
    dev = resolve_device(device)
    flow, _engine = build_flow(arch, max_new_tokens=new_tokens,
                               batching=True, tiny=tiny, device=dev,
                               params=params)
    rt = Runtime(n_cpu=2, net=NetModel(scale=0.0), max_batch=MAX_BATCH,
                 batch_wait_ms=BATCH_WAIT_MS, hang_timeout_s=hang_timeout_s,
                 device=dev)
    try:
        flow.deploy(rt, fusion=False)
        done = [0.0] * requests
        t0 = time.perf_counter()
        futs = []
        for i in range(requests):
            f = flow.execute(Table([("text", str)], [(f"request {i}",)]))
            f.add_done_callback(
                lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
            futs.append(f)
        completions = [f.result(timeout=600).to_dicts()[0]["completion"]
                       for f in futs]
        wall = time.perf_counter() - t0
        # a future's callbacks run after its waiters wake: wait for them
        deadline = time.perf_counter() + 60.0
        while not all(done) and time.perf_counter() < deadline:
            time.sleep(0.001)
        lat_ms = np.array(done) * 1e3 - t0 * 1e3
        sizes = [s for b in rt._batchers.values() for s in b.batch_sizes]
        if verbose:
            for i, c in enumerate(completions):
                print(f"req {i:2d} -> {c}")
        return {"requests": requests, "completions": completions,
                "wall_s": wall, "req_per_s": requests / wall,
                "p50_ms": float(np.percentile(lat_ms, 50)),
                "p99_ms": float(np.percentile(lat_ms, 99)),
                "batch_sizes": sizes,
                "wedges": rt.pool.fault_counts["wedge"]}
    finally:
        rt.stop()


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="yi-9b")
    p.add_argument("--full", action="store_true",
                   help="the full-width config (default: tiny)")
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--new-tokens", type=int, default=8)
    args = p.parse_args(argv)
    r = run(args.requests, arch=args.arch, tiny=not args.full,
            new_tokens=args.new_tokens, hang_timeout_s=120.0, verbose=True)
    print(f"{r['requests']} generations ({args.new_tokens} tokens each) "
          f"in {r['wall_s']:.2f}s = {r['req_per_s']:.2f} req/s; p50 "
          f"{r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms; batch sizes: "
          f"{r['batch_sizes']}")


if __name__ == "__main__":
    main()
