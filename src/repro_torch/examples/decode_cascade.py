"""Transformer prefill -> decode cascade on the port's compiled serving path
(port of ``examples/decode_cascade.py``).

A transformer's serving stages become plan operators
(``model_stage_op``): ``prefill`` turns a prompt row into greedy-decode
state (next token, position, per-row KV cache columns) and each
``decode`` step advances it.  The compiler fuses the whole cascade into
ONE device-resident batched chain: the KV cache never leaves the device
between steps, and a batch of prompts runs each fused step as one
batched call of the model (one kernel launch per attention site and
layer with ``use_kernels``).

  PYTHONPATH=src python -m repro_torch.examples.decode_cascade \
      [--arch yi-9b | rwkv6-1.6b | recurrentgemma-2b | ...] [--requests N]

The model is the arch's tiny config at f32; rwkv6 and recurrentgemma run
their recurrences through the ``wkv6`` and ``rglru_scan`` kernels.  With
``--requests N`` the stages carry the ``batching`` hint and N one-prompt
requests are submitted at once: the runtime's batcher merges them into
batched dispatches, and the run prints each request's tokens (held to
the unfused loop on that prompt alone), the batch sizes the tracer saw
and the requests per second.

``build(..., competitive=k)`` compiles the cascade as k competitive
replicas raced by a wait-any node, ``build(..., verify=True,
verify_input=...)`` runs the static verifier first, and ``check_flows``
is the hook ``python -m repro_torch.check`` lints.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCH_IDS, get_tiny_config
from repro_torch.core import operators as ops
from repro_torch.core.compiler import compile_flow
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.table import Table
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.registry import model_stage_op
from repro_torch.runtime import NetModel, Runtime

ARCH = "yi-9b"
SEQ = 16
CACHE = 32
STEPS = 4


def build_ops(model, params, *, seq_len=SEQ, cache_len=CACHE, name=ARCH,
              measure=True):
    """(prefill op, decode op).  The decode op is ONE instance reused at
    every cascade position, so recompiles share step function identity
    (stable chain signatures -> zero re-traces).  With ``measure`` each
    op carries the cost hook that times its stage at ``seq_len`` tokens
    and ``cache_len`` slots (``seed_from_model_ops`` calls it)."""
    pre = model_stage_op(model, params, "prefill", model_name=name,
                         seq_len=seq_len, cache_len=cache_len,
                         measure=measure)
    dec = model_stage_op(model, params, "decode", model_name=name,
                         seq_len=seq_len, cache_len=cache_len,
                         measure=measure)
    return pre, dec


def build_flow(pre, dec, *, steps=STEPS, batching=False, competitive=0):
    """``batching=True`` puts the request-batching hint on every stage:
    the runtime then merges concurrent requests into one dispatch.

    ``competitive=k`` (k >= 2) builds the cascade as ONE op, a ``Fuse`` of
    the stages, carrying ``competitive_replicas=k``: ``CompetitivePass``
    (which runs before fusion) then replicates the whole chain k times,
    each replica lowers to its own batched chain fed from the host (so
    the runtime places each on any GPU worker), and an ``anyof`` on the
    CPU takes the first to finish."""
    fl = Dataflow([("tokens", torch.Tensor)])
    if competitive >= 2:
        chain = ops.Fuse([pre] + [dec] * steps)
        fl.output = fl.apply_op(chain, gpu=True, batching=batching,
                                competitive_replicas=competitive)
        return fl
    node = fl.apply_op(pre, gpu=True, batching=batching)
    for _ in range(steps):
        node = node.apply_op(dec, gpu=True, batching=batching)
    fl.output = node
    return fl


def build(rt, pre, dec, *, steps=STEPS, name="decode-cascade",
          batching=False, competitive=0, verify=None, verify_input=None,
          verify_budget_bytes=None):
    """Compile the cascade with fusion on ``rt`` (competitive execution
    on when ``competitive`` >= 2).  ``verify``/``verify_input``/
    ``verify_budget_bytes`` run the static verifier before anything is
    registered (``compile_flow``)."""
    return compile_flow(build_flow(pre, dec, steps=steps, batching=batching,
                                   competitive=competitive), rt,
                        fusion=True, competitive_exec=competitive >= 2,
                        verify=verify, verify_input=verify_input,
                        verify_budget_bytes=verify_budget_bytes, name=name)


def check_flows():
    """Static-verifier hook (``python -m repro_torch.check``): the tiny
    f32 cascade with the kernels on, plain and competitive, built on the
    CPU (verification runs nothing, so it needs no card)."""
    from repro_torch.models.registry import stage_input_specs
    cfg = dataclasses.replace(get_tiny_config(ARCH), dtype="float32",
                              use_kernels=True)
    model = build_model(cfg, device="cpu")
    pre, dec = build_ops(model, model.init(torch.Generator().manual_seed(0)))
    specs = stage_input_specs(model, "prefill", seq_len=SEQ,
                              cache_len=CACHE)
    return [{"name": "decode-cascade", "flow": build_flow(pre, dec),
             "compile": {"fusion": True}, "input_specs": specs},
            {"name": "decode-cascade-competitive",
             "flow": build_flow(pre, dec, competitive=2),
             "compile": {"fusion": True, "competitive_exec": True},
             "input_specs": specs}]


def reference_decode(model, params, toks, *, steps=STEPS, cache_len=CACHE):
    """Plain model loop (the unfused oracle): greedy tokens after
    prefill + ``steps`` decode steps."""
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    pos = torch.full(toks.shape[:1], toks.shape[1], dtype=torch.int32,
                     device=toks.device)
    for _ in range(steps):
        lg, cache = model.decode_step(params, tok[:, None], pos, cache)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
        pos = pos + 1
    return [int(x) for x in tok]


def run(prompts: int = 3, *, arch: str = ARCH, steps: int = STEPS,
        verbose: bool = False):
    """Headless run on the card with the kernels on; returns a metrics
    dict."""
    dev = resolve_device(None)
    cfg = dataclasses.replace(get_tiny_config(arch), dtype="float32",
                              use_kernels=True)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rt = Runtime(n_cpu=2, n_gpu=1, net=NetModel(scale=0.0), device=dev)
    try:
        pre, dec = build_ops(model, params, name=arch)
        dep = build(rt, pre, dec, steps=steps)
        toks = torch.randint(0, cfg.vocab_size, (prompts, SEQ),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.int32)
        table = Table([("tokens", torch.Tensor)],
                      [(toks[i],) for i in range(prompts)])
        lats, out = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            out = dep.execute(table).result(600)
            lats.append(time.perf_counter() - t0)
        got = [int(r.values[0]) for r in out.rows]
        want = reference_decode(model, params, toks.to(dev), steps=steps)
        if verbose:
            print(dep.explain())
            print(f"fused cascade tokens:  {got}")
            print(f"reference loop tokens: {want}")
            print(f"latency on {dev}: first {lats[0] * 1e3:.1f} ms, "
                  f"steady {min(lats) * 1e3:.1f} ms")
        return {"prompts": prompts, "steps": steps,
                "tokens_match": got == want,
                "first_ms": lats[0] * 1e3, "steady_ms": min(lats) * 1e3}
    finally:
        rt.stop()


def serve_requests(dep, toks):
    """Submit one request per prompt row of ``toks`` at once to the
    deployed cascade ``dep``; returns (greedy tokens per request, the
    sizes of the batches that served them, requests per second).  The
    sizes come from the batch spans of the runtime's tracer, recorded
    before any member's result is delivered."""
    tables = [Table([("tokens", torch.Tensor)], [(toks[i],)])
              for i in range(len(toks))]
    t0 = time.perf_counter()
    futs = [dep.execute(t) for t in tables]
    outs = [f.result(600) for f in futs]
    rps = len(outs) / (time.perf_counter() - t0)
    sizes = [s.attrs["size"] for s in dep.runtime.tracer.batch_spans()
             if s.attrs.get("dag") == dep.dag.name and s.t0 >= t0]
    return [int(o.rows[0].values[0]) for o in outs], sizes, rps


def run_requests(requests: int, *, arch: str = ARCH, steps: int = STEPS):
    """``requests`` one-prompt requests at once through the batching
    cascade of ``arch``'s tiny f32 config, kernels on; each request's
    tokens are held to the unfused loop on its prompt alone.  Returns a
    metrics dict."""
    dev = resolve_device(None)
    cfg = dataclasses.replace(get_tiny_config(arch), dtype="float32",
                              use_kernels=True)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rt = Runtime(n_cpu=1, n_gpu=1, net=NetModel(scale=0.0),
                 batch_wait_ms=20.0, device=dev)
    try:
        pre, dec = build_ops(model, params, name=arch)
        dep = build(rt, pre, dec, steps=steps, name="decode-requests",
                    batching=True)
        toks = torch.randint(0, cfg.vocab_size, (requests, SEQ),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.int32)
        got, sizes, rps = serve_requests(dep, toks)
    finally:
        rt.stop()
    want = [reference_decode(model, params, toks[i:i + 1].to(dev),
                             steps=steps)[0] for i in range(requests)]
    return {"tokens": got, "reference": want, "batch_sizes": sizes,
            "req_per_s": rps, "tokens_match": got == want}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH, choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=0,
                    help="submit N one-prompt requests at once through "
                         "the batching cascade")
    args = ap.parse_args()
    if args.requests:
        r = run_requests(args.requests, arch=args.arch)
        for i, tok in enumerate(r["tokens"]):
            print(f"request {i}: token {tok} (unfused loop "
                  f"{r['reference'][i]})")
        print(f"batch sizes: {r['batch_sizes']}")
        print(f"{r['req_per_s']:.2f} requests/s")
    else:
        r = run(arch=args.arch, verbose=True)
    print("PARITY OK" if r["tokens_match"] else "PARITY FAILED")


if __name__ == "__main__":
    main()
