"""Recommender pipeline (paper §5.2, Facebook-style) on the port (port of
``examples/recommender.py``): request -> category from recent clicks ->
KVS lookup of the (large) product-category matrix -> top-1 scoring.

The category matrices live in the runtime's KVS as tensors on the
runtime's device (the card unless the caller names another), and each
request's scores are one product of its category matrix with the user's
vector there.  With ``fusion=True, locality=True`` the lookup is fused
into the scoring op and the scheduler dispatches each request to an
executor that caches its category (dynamic dispatch on the resolved ref);
without them every stage is its own function and the lookup lands on
whichever executor is free.

  PYTHONPATH=src python -m repro_torch.examples.recommender
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.dataflow import Dataflow
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime import NetModel, Runtime

N_CATEGORIES = 8
PRODUCTS = 4096
DIM = 64
USERS = 16


def user_vector(user: int) -> np.ndarray:
    """The user's vector: the reference example's draw."""
    return np.random.default_rng(user).random(DIM)


def category_matrix() -> np.ndarray:
    """The product-category matrix every category holds (the reference
    example's draw, float64, 2 MiB)."""
    return np.random.default_rng(0).random((PRODUCTS, DIM))


def build_flow():
    def categorize(user: int, clicks: int) -> tuple[int, str]:
        return user, f"cat{clicks % N_CATEGORIES}"

    def score(user: int, cat: str, lookup) -> tuple[int, float]:
        uvec = torch.from_numpy(user_vector(user)).to(lookup.device)
        scores = lookup @ uvec
        top = int(torch.argmax(scores))
        return top, float(scores[top])

    fl = Dataflow([("user", int), ("clicks", int)])
    lk = fl.map(categorize, names=["user", "cat"]).lookup("cat", column=True)
    fl.output = lk.map(score, names=["product", "score"])
    return fl


def requests(users: int = USERS):
    return [Table([("user", int), ("clicks", int)], [(u, u * 7)])
            for u in range(users)]


def numpy_scores(users: int = USERS):
    """(product, score) per user, computed in numpy: what the flow must
    answer."""
    cat = category_matrix()
    out = []
    for u in range(users):
        scores = cat @ user_vector(u)
        top = int(np.argmax(scores))
        out.append((top, float(scores[top])))
    return out


def check_flows():
    """Static-verifier hook (``python -m repro_torch.check``): lint both
    the optimized (fusion + locality) and per-stage deployments."""
    sample = Table([("user", int), ("clicks", int)], [(1, 7)])
    return [{"name": "recommender", "flow": build_flow(),
             "compile": {"fusion": True, "locality": True},
             "sample": sample},
            {"name": "recommender-unopt", "flow": build_flow(),
             "compile": {}, "sample": sample}]


def lookup_executors(dep, traces):
    """Per kept trace, in arrival order: (the category the request looked
    up, the executor that ran the op holding its lookup)."""
    (node,) = [n for n in dep.dag.nodes.values()
               if n.locality_ref_column is not None
               or "lookup" in n.name]
    out = []
    for tr in sorted(traces, key=lambda t: t.trace_id):
        (ex,) = [s for s in tr.spans if s.name == f"exec@{node.name}"]
        out.append(ex.attrs["executor"])
    return out


def run(optimized: bool, *, device: DeviceLike = None,
        users: int = USERS, net: Optional[NetModel] = None):
    """Serve ``users`` requests twice (the first pass warms the caches)
    through the flow compiled with ``fusion=locality=optimized`` on a
    four-worker CPU-class runtime whose KVS holds the category matrices
    on ``device``.  Returns a dict: the median latency of the second pass
    (s), each answer of the second pass as (product, score), and per
    request of that pass its category, the executor that ran its lookup
    and the executors caching the category at dispatch."""
    from repro_torch.obs.trace import Tracer

    dev = resolve_device(device)
    rt = Runtime(n_cpu=4, device=dev, tracer=Tracer(sample_rate=1.0),
                 net=net or NetModel(latency_s=0.5e-3, bandwidth=1e9))
    try:
        cat = torch.from_numpy(category_matrix()).to(dev)
        for i in range(N_CATEGORIES):
            rt.kvs.put(f"cat{i}", cat, charge=False)
        dep = build_flow().deploy(rt, fusion=optimized, locality=optimized,
                                  name="recommender" + (
                                      "-opt" if optimized else ""))
        reqs = requests(users)
        for t in reqs:   # warm caches
            dep.execute(t).result(60)
        rt.tracer.clear()
        lats, answers, cached = [], [], []
        for u, t in enumerate(reqs):
            key = f"cat{(u * 7) % N_CATEGORIES}"
            cached.append((key, rt.kvs.cached_where(key)))
            t0 = time.perf_counter()
            out = dep.execute(t).result(60)
            lats.append(time.perf_counter() - t0)
            answers.append(tuple(out.rows[0].values))
        ran_on = lookup_executors(dep, rt.tracer.kept(dep.dag.name))
        return {"median_s": sorted(lats)[len(lats) // 2],
                "answers": answers,
                "dispatch": [(k, ex, where) for (k, where), ex
                             in zip(cached, ran_on)]}
    finally:
        rt.stop()


def main():
    naive = run(optimized=False)
    opt = run(optimized=True)
    want = numpy_scores()
    for name, r in (("naive", naive), ("fusion+dispatch", opt)):
        ok = all(a[0] == w[0] and abs(a[1] - w[1]) <= 1e-9 * abs(w[1])
                 for a, w in zip(r["answers"], want))
        local = sum(ex in where for _k, ex, where in r["dispatch"])
        print(f"{name:>16}: median {r['median_s'] * 1e3:7.2f} ms, answers "
              f"{'match' if ok else 'DIFFER FROM'} numpy, lookups on a "
              f"caching executor {local}/{len(r['dispatch'])}")


if __name__ == "__main__":
    main()
