#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each passes or the script exits non-zero; nothing is caught and
ignored):

1. Device: the card's name and power limit.
2. Build: the four CUDA kernels from ``src/repro_torch/csrc`` with nvcc
   for sm_90a (one nvcc per source, started together).
3. Kernels: each kernel against its plain PyTorch version at its path's
   shapes, in bf16 and f32 inputs, plus its time, the plain version's
   time, one PyTorch call's time where one computes the same function
   (``scaled_dot_product_attention`` for the attention kernels, timed
   only; none for the recurrences) and the least time the card could
   take (the bound).  For all four kernels (and SDPA) also the device
   work alone (``device_ms``, see ``time_ms``) and the host time per
   call.  yi-9b: H=32, K=4, hd=128; decode B=4 over a
   1024-slot ring cache with empty -1 slots, flash B=4, S=256.  rwkv6-
   1.6b: wkv6 at r/k/v/w [4, 256, 32, 64].  recurrentgemma-2b:
   rglru_scan at [4, 256, 2560].  Asserts that flash ran its tensor-core
   (``wgmma``) instance in bf16 and its SIMT instance in f32, that the
   recurrences ran their split instances at their f32 path shapes (wkv6:
   tiles of 4 x 4 of S, 16 lanes a column group, cp.async staging;
   rglru_scan: clusters of 2 blocks of 4 warps along T, staged), and
   prints decode's split count.
4. Paths: yi-9b (48 layers), rwkv6-1.6b (24) and recurrentgemma-2b (26)
   at full width and depth in bf16 with ``use_kernels=True``, random
   weights from a seeded generator, each a prefill + 8 decode
   ``ModelOp`` cascade through ``Dataflow`` -> ``compile_flow`` ->
   ``Runtime`` on the card, answering 4 prompts of 256 tokens (cache
   1024) three times, with every launch counter set to 0 just before and
   read just after.  Checks: each kernel's launches against the chain's
   dispatch counters (and 0 for the kernels off the path), zero
   re-traces on the repeat calls, fused tokens equal to the unfused loop,
   and, on the same params at full depth, the kernel path against the
   plain path: the kernels launched as the path needs them (none on the
   plain side), the recurrent state leaves of the prefill caches compared
   in f32, and the logits (prefill and first decode) within rel 0.05;
   rwkv6 amplifies last-bit differences with depth, so its full-depth
   gap is held to twice the plain path's own gap under a last-bit change
   of its f32 weights, and the 0.05 bar to 4 layers (see ``PATHS``);
   recurrentgemma's decay is about 0 under the reference's init, so it
   is held to the bar again with ``lam`` negated (see ``_negate_lam``).
   Then float32 at reduced depth (yi-9b and rwkv6 4 layers,
   recurrentgemma 6): the kernel path's greedy tokens equal the plain
   path's.
5. Serving: the serving runtime (request batching, admission and
   deadlines, fault tolerance, tracing) answering concurrent requests of
   phase 4's bf16 48-layer yi-9b model and params (prompts of 256
   tokens, cache 1024, 8 decode steps) on ``Runtime(n_gpu=2,
   max_batch=8, batch_wait_ms=50)`` with every trace kept, in five parts
   (see ``phase_serving``): 16 requests at once with ``batching=True``
   (tokens held to the unfused loop over each request's own batch,
   padded as the chain pads; kernel launches per batch, not per
   request) against the same 16 one request per dispatch, then both
   again on one GPU worker (measured beside the two); a
   ``[prefill, decode]`` batched chain whose DeviceTable is demuxed on
   the card for 7 pinned decode steps per request; a rate-limited gate
   shedding typed ``Overloaded`` and a deadline expiring typed in a
   queue without launching; a crash and a transient fault recovered; and
   every request's trace, its attribution and a Perfetto export under
   ``build/``.  The detector's ``hang_timeout_s`` is set above phase 4's
   measured first call, and no run that injects no hang shows a wedge.
6. Compile: the compile-time half of the system on phase 4's bf16
   48-layer yi-9b model and params (see ``phase_compile``).  The static
   verifier passes the cascade (``compile_flow(fusion=True, verify=True)``
   with a sample request) with zero errors, its launch-rule check (CF103)
   having checked both attention kernels at yi-9b's shapes, while the
   card's allocated bytes and every launch counter stay where they were;
   the CF301 footprint of the largest bucket is printed beside the growth
   of the peak allocation over the first warm at that bucket, and a
   budget below the footprint is refused (CF301) before anything runs.
   A flash step whose head_dim breaks the CUDA rule is refused by CF103
   and, compiled unverified, raises ``KernelError`` on the card; one that
   keeps the rule passes and launches.  Competitive execution: the
   cascade as two replicas on two GPU workers under a hang fault (8
   requests, one at a time) against the same 8 without replicas, tokens
   equal to the unfused loop, no wedge, p50/p99 of both and the races
   each replica won.  Locality: the recommender with ``fusion=
   locality=True`` answers as numpy does and runs every lookup on an
   executor caching its key; medians of it and the naive flow.  Then
   ``python -m repro_torch.check src/repro_torch/examples`` exits 0.
7. The last line: ``{"ok": true, "device": {...}}``; before it a
   ``kernels`` JSON line and the nvidia-smi line.

Exits non-zero with no result when CUDA is unavailable or the port's
package is missing.
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

SEED = 0
H100_BYTES_PER_S = 3.35e12           # HBM3, NVIDIA data sheet (SXM)
H100_FLOPS = {"bfloat16": 989e12,    # dense tensor-core peak
              "float32": 67e12}      # f32 outside the tensor cores
BF16_REL, F32_REL = 0.05, 1e-4       # the reference's kernel bars
SPIN_CYCLES = 500_000                # ~0.3 ms at the H100's clocks
KERNELS = ("decode_attention", "flash_attention", "wkv6", "rglru_scan")
#: per path: arch, depth of the f32 token check, depth at which the bf16
#: logits of the kernel path are held to the 0.05 bar (None: full).
#: Random-weight rwkv6 amplifies last-bit differences layer by layer (the
#: reference package's own model does too: tests/test_torch_recurrent.py,
#: ``test_rwkv6_depth_amplifies_a_last_bit_change``), so its bar applies
#: at 4 layers, and at full depth its gap is held to twice the plain
#: path's own gap when its f32 weights are scaled by 1 + 2^-20.
PATHS = (("yi-9b", 4, None), ("rwkv6-1.6b", 4, 4),
         ("recurrentgemma-2b", 6, None))
CONTROL_FACTOR = 2.0
STEPS, PROMPTS, SEQ, CACHE = 8, 4, 256, 1024
#: the wedge detector's limit for phase 4's runtimes: far above any call
#: seen there (yi-9b's first call, the slowest, took 1.3-1.9 s); phase 5
#: sets its own from phase 4's measured first call
PATH_HANG_TIMEOUT_S = 60.0
SERVE_REQUESTS, SERVE_BATCH, SERVE_WAIT_MS = 16, 8, 50.0
#: phase 6: requests of the competitive burst, replicas, the hang fault
COMPETE_REQUESTS, COMPETE_REPLICAS = 8, 2
HANG_RATE, HANG_S = 0.25, 2.0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)
    print(f"  ok: {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def time_ms(torch, fn, iters=30, warmup=3, flush=None, spin=False):
    """Mean time of ``fn`` in ms over ``iters`` launches, each timed with
    CUDA events after ``flush`` evicted the L2 cache (the main path meets
    every layer's cache and weights cold).  The events bracket what the
    card sees of one call: its kernels, and any gap while the host is
    still enqueueing them (the kernel table's ``ms`` since it began).
    With ``spin`` the device first spins for ``SPIN_CYCLES``, so the host
    has enqueued all of ``fn``'s kernels when the start event fires: the
    events then bracket the device's work only (``device_ms``)."""
    for _ in range(warmup):
        fn()
    total = 0.0
    events = []
    for _ in range(iters):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    for start, end in events:
        total += start.elapsed_time(end)
    return total / iters


def spans(torch, fn, lib, flush):
    """``fn``'s and the library call ``lib``'s times under both spans of
    :func:`time_ms` and their host time per call (:func:`host_ms`);
    ``lib`` None (no PyTorch call computes the function) times none."""
    out = {"ms": time_ms(torch, fn, flush=flush),
           "device_ms": time_ms(torch, fn, flush=flush, spin=True),
           "library_ms": None, "host": (host_ms(torch, fn), None)}
    if lib is not None:
        out.update(library_ms=time_ms(torch, lib, flush=flush),
                   library_device_ms=time_ms(torch, lib, flush=flush,
                                             spin=True),
                   host=(out["host"][0], host_ms(torch, lib)))
    return out


def host_ms(torch, fn, iters=30):
    """Mean host time of one call of ``fn`` in ms: what it costs the
    host to check the inputs and enqueue the work, with the device left
    to catch up after the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def phase_kernels(torch, dev, flush):
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    B, H, K, hd = 4, 32, 4, 128
    results = {}

    # -- decode attention over a [B, W, K, hd] ring cache ------------------
    W = 1024
    filled = [W, 700, 300, 5]
    kpos = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    for b, n in enumerate(filled):
        kpos[b, :n] = torch.arange(n, dtype=torch.int32, device=dev)
    qpos = torch.tensor([n - 1 for n in filled], dtype=torch.int32,
                        device=dev)
    for dtype, bar in ((torch.float32, F32_REL), (torch.bfloat16, BF16_REL)):
        q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
        kc = torch.randn((B, W, K, hd), generator=g, device=dev).to(
            dtype).transpose(1, 2)
        vc = torch.randn((B, W, K, hd), generator=g, device=dev).to(
            dtype).transpose(1, 2)
        got = kops.decode_attention(q, kc, vc, kpos, qpos)
        want = decode_attention_plain(q, kc, vc, kpos, qpos)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        abs_err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()) and err < bar,
              f"decode_attention {dtype}: rel err {err} < {bar} "
              f"(max abs {abs_err})")
        splits = kops.decode_attention.last_splits
        print(f"  decode_attention {dtype}: {splits} splits of the "
              f"{W}-slot ring per (b, kv head), {B * K * splits} blocks",
              flush=True)
        if dtype != torch.bfloat16:
            continue
        valid = int(((kpos >= 0) & (kpos <= qpos[:, None])).sum())
        el = q.element_size()
        nbytes = (q.numel() * el * 2            # q read, out written
                  + 2 * valid * K * hd * el     # the K and V rows needed
                  + valid * 4 + B * 4)          # positions needed
        flops = 2 * 2 * valid * H * hd          # q.k and p.v per head
        qs = q[:, :, None]                                # [B,H,1,hd]
        mask = ((kpos >= 0) & (kpos <= qpos[:, None]))[:, None, None, :]
        results["decode_attention"] = {
            "name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:88",
            "max_abs_err": abs_err,
            "plain_ms": time_ms(torch, lambda: decode_attention_plain(
                q, kc, vc, kpos, qpos), flush=flush),
            **_bound(nbytes, flops, "bfloat16"),
            **spans(torch, lambda: kops.decode_attention(
                q, kc, vc, kpos, qpos),
                lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, attn_mask=mask, enable_gqa=True), flush),
            "instance": f"split-S x{splits}",
        }

    # -- flash attention, the prefill ----------------------------------------
    S = 256
    for dtype, bar in ((torch.float32, F32_REL), (torch.bfloat16, BF16_REL)):
        q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev).to(
            dtype).transpose(1, 2) for n in (H, K, K))   # model's views
        got = kops.flash_attention(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        abs_err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()) and err < bar,
              f"flash_attention {dtype}: rel err {err} < {bar} "
              f"(max abs {abs_err})")
        instance = kops.flash_attention.last_instance
        want_instance = "wgmma" if dtype == torch.bfloat16 else "simt"
        check(instance == want_instance, f"flash_attention {dtype} at "
              f"yi-9b's prefill shape ran the {instance} instance")
        if dtype != torch.bfloat16:
            continue
        el = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * el
        pairs = B * H * S * (S + 1) // 2        # causal (q, k) pairs
        flops = 2 * 2 * pairs * hd              # q.k and p.v
        results["flash_attention"] = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:95",
            "max_abs_err": abs_err,
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(
                q, k, v), flush=flush),
            **_bound(nbytes, flops, "bfloat16"),
            **spans(torch, lambda: kops.flash_attention(q, k, v),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True), flush),
        }
        # the instance of the timed launches (the choice depends only on
        # dtype and head_dim, so the last one stands for all)
        results["flash_attention"]["instance"] = \
            kops.flash_attention.last_instance
    results.update(phase_recurrent_kernels(torch, dev, g, flush))
    for r in results.values():
        lib = r["library_ms"]
        print(f"  {r['name']}"
              f"{' (' + r['instance'] + ')' if 'instance' in r else ''}: "
              f"kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
        lib_dev, lib_host = "", ""
        if lib is not None:
            lib_dev = f", library {r['library_device_ms']:.4f} ms"
            lib_host = f", library {r['host'][1]:.4f} ms"
        print(f"    device work only: kernel {r['device_ms']:.4f} ms"
              f"{lib_dev}; host time per call: kernel {r['host'][0]:.4f} "
              f"ms{lib_host}", flush=True)
    return results


def _bound(nbytes, flops, peak):
    bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_FLOPS[peak] * 1e3
    return {"bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations"}


def phase_recurrent_kernels(torch, dev, g, flush):
    """wkv6 (rwkv6-1.6b prefill) and rglru_scan (recurrentgemma-2b
    prefill) against their plain versions.  No single PyTorch call
    computes either recurrence, so ``library_ms`` is null."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.rglru_scan import rglru_scan_plain
    from repro_torch.kernels.wkv6 import wkv6_plain

    results = {}
    # -- wkv6 at r/k/v/w [B, T, H, hd], f32 u, with the final state ----------
    B, T, H, hd = PROMPTS, SEQ, 32, 64
    u = torch.rand((H, hd), generator=g, device=dev) - 0.5
    for dtype, bar in ((torch.float32, F32_REL), (torch.bfloat16, BF16_REL)):
        r, k, v = (0.3 * torch.randn((B, T, H, hd), generator=g,
                                     device=dev) for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn((B, T, H, hd), generator=g,
                                             device=dev) - 0.5))
        r, k, v, w = (t.to(dtype) for t in (r, k, v, w))
        y, S = kops.wkv6(r, k, v, w, u, return_state=True)
        want_y, want_S = wkv6_plain(r, k, v, w, u, return_state=True)
        torch.cuda.synchronize()
        err = max(rel_err(y, want_y), rel_err(S, want_S))
        abs_err = float(max((y - want_y).abs().max(),
                            (S - want_S).abs().max()))
        check(bool(torch.isfinite(y).all() and torch.isfinite(S).all())
              and err < bar,
              f"wkv6 {dtype}: rel err {err} < {bar} (max abs {abs_err})")
        if dtype != torch.float32:     # the path feeds it f32
            continue
        instance = kops.wkv6.last_instance
        check(instance == "16 lanes of 4 rows x 4 columns, cp.async "
              "staging",
              f"wkv6 at rwkv6-1.6b's prefill shape ran {instance!r}")
        el = r.element_size()
        nbytes = (4 * r.numel() * el + u.numel() * 4     # r, k, v, w, u
                  + y.numel() * 4 + S.numel() * 4)       # y, final S
        # per (i, j) and step: r.S (FMA, 2), k*v (1), w*S + kv (FMA, 2);
        # q = r*u*k and its sum are per i (3 hd), v*sum(q) per j (2 hd)
        flops = B * T * H * (5 * hd * hd + 5 * hd)
        results["wkv6"] = {
            "name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:59",
            "max_abs_err": abs_err,
            "plain_ms": time_ms(torch, lambda: wkv6_plain(
                r, k, v, w, u, return_state=True), iters=3, flush=flush),
            **_bound(nbytes, flops, "float32"),
            **spans(torch, lambda: kops.wkv6(
                r, k, v, w, u, return_state=True), None, flush),
            "instance": instance,
        }

    # -- rglru_scan at a, x [B, T, R], zero initial state ------------------
    R = 2560
    for dtype, bar in ((torch.float32, F32_REL), (torch.bfloat16, BF16_REL)):
        a = torch.sigmoid(torch.randn((B, T, R), generator=g, device=dev)
                          + 3.0).to(dtype)
        x = (0.3 * torch.randn((B, T, R), generator=g, device=dev)).to(dtype)
        got = kops.rglru_scan(a, x)
        want = rglru_scan_plain(a, x)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        abs_err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and err < bar,
              f"rglru_scan {dtype}: rel err {err} < {bar} "
              f"(max abs {abs_err})")
        if dtype != torch.float32:     # the path feeds it f32
            continue
        instance = kops.rglru_scan.last_instance
        check(instance == "cluster 2 x 4 warps, staged",
              f"rglru_scan at recurrentgemma-2b's prefill shape ran "
              f"{instance!r}")
        nbytes = 2 * a.numel() * a.element_size() + got.numel() * 4
        flops = 2 * a.numel()
        results["rglru_scan"] = {
            "name": "rglru_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan.py:51",
            "max_abs_err": abs_err,
            "plain_ms": time_ms(torch, lambda: rglru_scan_plain(a, x),
                                iters=5, flush=flush),
            **_bound(nbytes, flops, "float32"),
            **spans(torch, lambda: kops.rglru_scan(a, x), None, flush),
            "instance": instance,
        }
    return results


def serve(torch, dev, cfg, calls=3):
    """Compile the cascade for ``cfg`` on a card Runtime and answer the
    same ``PROMPTS`` x ``SEQ`` batch ``calls`` times, with every kernel's
    launch counter set to 0 just before.  Returns (model, params, tokens,
    greedy tokens, per-call latencies, per-call re-traces, the chain's
    (batched, per-row) dispatches, launches).  Nothing returned holds the
    chain, whose steps close over the params."""
    from repro_torch.core.lowering import EXECUTABLE_CACHE
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model

    prompts, seq, cache_len, steps = PROMPTS, SEQ, CACHE, STEPS
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    toks = torch.randint(0, cfg.vocab_size, (prompts, seq),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 1))
    table = Table([("tokens", torch.Tensor)],
                  [(toks[i],) for i in range(prompts)])
    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0),
                    hang_timeout_s=PATH_HANG_TIMEOUT_S, device=dev)
    try:
        pre, dec = dc.build_ops(model, params, cache_len=cache_len,
                                name=cfg.name)
        dep = dc.build(rt, pre, dec, steps=steps, name=f"smoke-{cfg.name}")
        chain = dep.plan.ops[-1].op
        print(dep.explain(), flush=True)
        lats, retraces, out = [], [], None
        for name in KERNELS:
            getattr(kops, name).launches = 0
        for _ in range(calls):
            tr0 = EXECUTABLE_CACHE.traces()
            t0 = time.perf_counter()
            out = dep.execute(table).result(600)
            lats.append(time.perf_counter() - t0)
            retraces.append(EXECUTABLE_CACHE.traces() - tr0)
        launches = {name: getattr(kops, name).launches for name in KERNELS}
        dispatches = (chain.batch_dispatches, chain.row_dispatches)
        check(rt.pool.fault_counts["wedge"] == 0,
              f"no wedge detected ({rt.pool.fault_counts})")
    finally:
        rt.stop()
    got = [int(r.values[0]) for r in out.rows]
    return (model, params, toks.to(dev), got, lats, retraces, dispatches,
            launches)


def expected_launches(cfg, prefills, steps):
    """Launches of each kernel over ``prefills`` dispatches of the
    cascade: the dense path runs flash attention per layer and prefill
    and decode attention per layer and step; rwkv6 runs wkv6 per layer
    and prefill; recurrentgemma runs rglru_scan per recurrent layer and
    prefill (its local attention stays plain, as in the reference)."""
    from repro_torch.models import rglru

    want = dict.fromkeys(KERNELS, 0)
    L = cfg.num_layers
    if cfg.family == "dense":
        want["flash_attention"] = L * prefills
        want["decode_attention"] = L * steps * prefills
    elif cfg.family == "ssm":
        want["wkv6"] = L * prefills
    else:
        want["rglru_scan"] = rglru.layer_types(cfg).count("rec") * prefills
    return want


def phase_path(torch, dev, arch, f32_layers, logits_layers, keep=False):
    """Serve ``arch`` at full width and depth in bf16 through the kernels
    and check it; then at f32 and ``f32_layers`` layers check the kernel
    path's greedy tokens against the plain path's.  The kernel path's
    logits are held to the plain path's within 0.05 at full depth, or at
    ``logits_layers`` where that is set, and then at full depth to the
    plain path's own gap under a last-bit change.  Returns the bf16 run's
    launches and, with ``keep``, (its model, params, first-call latency
    in s) for the serving phase, else None."""
    from repro_torch.configs import get_config
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.examples.depth_gap import nudge_f32
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), use_kernels=True)
    L = cfg.num_layers
    print(f"-- {cfg.name}: {L} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.family}, {cfg.dtype}",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    model, params, toks, got, lats, retraces, dispatches, launches = serve(
        torch, dev, cfg)
    nparams = sum(t.numel() for t in _leaves(params))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  weights: {nparams} params, "
          f"{sum(t.numel() * t.element_size() for t in _leaves(params))}"
          f" bytes; peak device memory {peak} bytes, {peak - held} above "
          f"the {held} bytes held before this path", flush=True)
    runs = sum(dispatches)
    print(f"  chain dispatches: {dispatches[0]} batched, {dispatches[1]} "
          f"per-row; launches {launches}", flush=True)
    want = expected_launches(cfg, runs, STEPS)
    check(runs > 0 and launches == want,
          f"launches {launches} == {want} for {runs} prefill dispatches "
          f"x {STEPS} decode steps")
    check(retraces[1:] == [0, 0], f"re-traces per call {retraces}")
    check(len(got) == PROMPTS and all(0 <= t < cfg.vocab_size for t in got),
          f"{PROMPTS} greedy tokens in range: {got}")
    ref = dc.reference_decode(model, params, toks, steps=STEPS,
                              cache_len=CACHE)
    check(got == ref, f"fused cascade tokens == unfused loop {ref}")
    print(f"  {cfg.dtype} {L}-layer {cfg.name} latency: first "
          f"{lats[0] * 1e3} ms, steady {min(lats) * 1e3} ms ({PROMPTS} "
          f"prompts x {SEQ} tokens, {STEPS} decode steps)", flush=True)

    # kernel path vs plain path, same params, on the card
    e_pre, e_dec = kernel_vs_plain(torch, dev, cfg, params, toks)
    print(f"  {L}-layer logits rel err, kernel path vs plain path: "
          f"prefill {e_pre}, first decode {e_dec}", flush=True)
    if logits_layers is None:
        check(max(e_pre, e_dec) < BF16_REL,
              f"{L}-layer logits rel err {max(e_pre, e_dec)} < 0.05")
    else:
        # the model amplifies the last-bit differences of any two correct
        # runs with depth: hold the full depth to the plain path's own gap
        # under a last-bit change, and the bar where depth does not rule
        plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                            device=dev)
        control = rel_err(*(plain.prefill(p, {"tokens": toks}, CACHE)[0]
                            for p in (nudge_f32(params), params)))
        del plain
        check(0 < control and e_pre <= CONTROL_FACTOR * control,
              f"{L}-layer prefill logits rel err {e_pre} <= "
              f"{CONTROL_FACTOR} x {control}, the plain path's own gap "
              f"with its f32 weights scaled by 1 + 2^-20")
        cut = dataclasses.replace(cfg, num_layers=min(logits_layers, L))
        e_cut = max(kernel_vs_plain(torch, dev, cut, params, toks))
        check(e_cut < BF16_REL, f"{cut.num_layers}-layer logits rel err "
              f"{e_cut} < 0.05 (prefill and first decode)")
    if cfg.family == "hybrid":
        # the reference's init gives a = sigmoid(-lam)^4 < 3e-8, so a*h
        # is below half an ulp of x and h_t = x_t on both paths to the
        # last bit; with lam negated (a = sigmoid(lam)^4 in (0.949,
        # 0.9995), the range the reference's comment names) the
        # recurrence carries state and the paths' roundings differ
        e_live = max(kernel_vs_plain(torch, dev, cfg, _negate_lam(params),
                                     toks))
        check(e_live < BF16_REL, f"{L}-layer logits rel err {e_live} < 0.05 "
              "with lam negated (prefill and first decode)")
    served = (model, params, lats[0]) if keep else None
    del model, params
    _release(torch)

    # float32 at reduced depth, full width: greedy tokens must be identical
    cfg32 = dataclasses.replace(cfg, num_layers=f32_layers, dtype="float32")
    model, params, toks, got32, lats32, retraces32, _, _ = serve(
        torch, dev, cfg32)
    plain32 = build_model(dataclasses.replace(cfg32, use_kernels=False),
                          device=dev)
    ref32 = dc.reference_decode(plain32, params, toks, steps=STEPS,
                                cache_len=CACHE)
    check(got32 == ref32, f"f32 {f32_layers}-layer kernel-path tokens "
          f"{got32} == plain-path tokens {ref32}")
    check(retraces32[1:] == [0, 0], f"f32 re-traces per call {retraces32}")
    print(f"  f32 {f32_layers}-layer latency: first {lats32[0] * 1e3} ms, "
          f"steady {min(lats32) * 1e3} ms", flush=True)
    del model, params, plain32
    _release(torch)
    return launches, served


# -- phase 5: the serving runtime on full-width yi-9b ------------------------

def _launches():
    from repro_torch.kernels import ops as kops

    return {name: getattr(kops, name).launches for name in KERNELS}


def _zero_launches():
    from repro_torch.kernels import ops as kops

    for name in KERNELS:
        getattr(kops, name).launches = 0


def _burst(dep, toks, idx, **call_kw):
    """Submit one request per prompt row in ``idx`` at once.  Returns
    (futures, submit times, done times, call_dag times), all on the host
    clock; a done time is taken in the future's callback."""
    import torch

    from repro_torch.core.table import Table

    futs, t_sub, t_call = [], [], []
    done = [None] * len(idx)
    for j, i in enumerate(idx):
        table = Table([("tokens", torch.Tensor)], [(toks[i],)])
        t0 = time.perf_counter()
        f = dep.runtime.call_dag(dep.dag.name, table, **call_kw)
        t_call.append(time.perf_counter() - t0)
        t_sub.append(t0)

        def note(_f, j=j):
            done[j] = time.perf_counter()
        f.add_done_callback(note)
        futs.append(f)
    return futs, t_sub, done, t_call


def _wait_for(cond, what):
    deadline = time.perf_counter() + 60.0
    while not cond():
        if time.perf_counter() > deadline:
            raise SmokeFailure(f"timed out waiting: {what}")
        time.sleep(0.001)


def _tokens(futs):
    return [int(f.result(600).rows[0].values[0]) for f in futs]


def _traces(tracer, dag, n):
    """The ``n`` kept traces of ``dag`` in arrival order (trace ids count
    up as ``call_dag`` is called).  A trace is finished in the future's
    own callback, which may still be running when ``result()`` returns:
    wait for it."""
    _wait_for(lambda: len(tracer.kept(dag)) >= n,
              f"{n} traces of {dag} finished")
    traces = sorted(tracer.kept(dag), key=lambda t: t.trace_id)
    if len(traces) != n:
        raise SmokeFailure(f"{len(traces)} kept traces of {dag}, not {n}")
    return traces


def _batches(tracer, traces, node):
    """How the burst was cut, read from the tracer: [(batch id, member
    request indices in batch order)], in dispatch order, each checked
    against its batch span's size.  The batcher keeps arrival order
    within a batch (no member carries a deadline, so no EDF reorder)."""
    groups = {}
    for i, tr in enumerate(traces):
        (ex,) = [s for s in tr.spans if s.name == f"exec@{node}"]
        if ex.link is None:
            raise SmokeFailure(f"request {i}'s exec@ span links to no "
                               "batch")
        groups.setdefault(ex.link, []).append(i)
    spans = {s.link: s for s in tracer.batch_spans(set(groups))}
    out = sorted(groups.items(), key=lambda kv: spans[kv[0]].t0)
    for bid, members in out:
        if spans[bid].attrs["size"] != len(members):
            raise SmokeFailure(f"batch {bid} size {spans[bid].attrs['size']}"
                               f" != its {len(members)} members")
    return out


def _padded(torch, rows):
    """The rows as the chain runs them: row 0 repeated up to the row
    count's bucket (``DeviceTable.from_columns`` and ``take`` pad so)."""
    from repro_torch.core.lowering import bucket_rows

    k = rows.shape[0]
    b = bucket_rows(k)
    return torch.cat([rows, rows[:1].expand(b - k, -1)]) if b > k else rows


def _batch_oracle(torch, model, params, toks, members):
    """The unfused loop over one batch's rows in batch order, padded as
    the chain pads, so every GEMM has the chain's shape (in bf16, tokens
    are held only to an oracle of the same shapes)."""
    from repro_torch.examples import decode_cascade as dc

    rows = _padded(torch, toks[members].to(model.device))
    return dc.reference_decode(model, params, rows, steps=STEPS,
                               cache_len=CACHE)[:len(members)]


def _check_batched_tokens(torch, model, params, toks, idx, got, batches,
                          what):
    for bid, members in batches:
        want = _batch_oracle(torch, model, params, toks,
                             [idx[m] for m in members])
        have = [got[m] for m in members]
        if have != want:
            raise SmokeFailure(f"{what}: batch {bid} tokens {have} != the "
                               f"unfused loop's over its padded rows {want}")
    check(True, f"{what}: every request's tokens == the unfused loop over "
          f"its own batch, padded as the chain pads "
          f"({[len(m) for _, m in batches]} requests per batch)")


def _stats(t_sub, done, n_launch, wall):
    import numpy as np

    lat = np.array([d - s for s, d in zip(t_sub, done)])
    p50, p99 = np.percentile(lat, [50, 99])
    return {"req_per_s": len(lat) / wall, "p50_ms": float(p50) * 1e3,
            "p99_ms": float(p99) * 1e3,
            "launches_per_request": n_launch / len(lat)}


def _serve_burst(dep, toks, idx):
    """One measured burst with the launch counters zeroed just before:
    (tokens, stats, launches, the chain's (batched, per-row) dispatch
    counts before and after, submit times, done times)."""
    chain = dep.plan.ops[-1].op
    d0 = (chain.batch_dispatches, chain.row_dispatches)
    _zero_launches()
    t0 = time.perf_counter()
    futs, t_sub, done, _ = _burst(dep, toks, idx)
    got = _tokens(futs)
    # the last done-callback may still be running
    _wait_for(lambda: None not in done, "done callbacks")
    wall = max(done) - t0
    launches = _launches()
    d1 = (chain.batch_dispatches, chain.row_dispatches)
    stats = _stats(t_sub, done, launches["flash_attention"], wall)
    return got, stats, launches, (d0, d1), t_sub, done


def _serve_modes(torch, rt, model, params, toks, alone):
    """Part 1 on ``rt``: the burst of ``SERVE_REQUESTS`` one-prompt
    requests through a cascade with the ``batching`` hint (tokens held to
    the unfused loop over each request's own batch, launches per batch),
    then the same requests one per dispatch (tokens held to ``alone``,
    the unfused loop on each prompt alone).  Each burst is measured after
    a warm-up.  Returns (the batched deployment, the numbers, its burst's
    traces, submit times, done times)."""
    from repro_torch.examples import decode_cascade as dc

    L = model.cfg.num_layers
    everyone = list(range(SERVE_REQUESTS))
    pre, dec = dc.build_ops(model, params, cache_len=CACHE,
                            name=model.cfg.name)
    dep = dc.build(rt, pre, dec, steps=STEPS, name="serve-batched",
                   batching=True)
    node = dep.function_names[0]
    _tokens(_burst(dep, toks, everyone)[0])              # warm the shapes
    rt.tracer.clear()
    got, b_stats, launches, (d0, d1), t_sub, done = _serve_burst(
        dep, toks, everyone)
    traces = _traces(rt.tracer, dep.dag.name, SERVE_REQUESTS)
    batches = _batches(rt.tracer, traces, node)
    sizes = [len(m) for _, m in batches]
    nb = len(batches)
    check(sum(sizes) == SERVE_REQUESTS and max(sizes) > 1,
          f"batch sizes {sizes} sum to {SERVE_REQUESTS}, one holds more "
          f"than one request")
    check(d1[0] - d0[0] + d1[1] - d0[1] == nb
          and d1[0] - d0[0] == sum(1 for k in sizes if k > 1),
          f"the chain dispatched once per batch: {d1[0] - d0[0]} batched "
          f"+ {d1[1] - d0[1]} per-row (batches of one) == {nb} batches")
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention=L * nb, decode_attention=L * STEPS * nb)
    check(launches == want, f"launches over the burst {launches} == {L} x "
          f"{nb} batches (flash), {L} x {STEPS} x {nb} (decode): per "
          f"batch, not per request")
    _check_batched_tokens(torch, model, params, toks, everyone, got,
                          batches, "batched burst")

    pre_u, dec_u = dc.build_ops(model, params, cache_len=CACHE,
                                name=model.cfg.name)
    dep_u = dc.build(rt, pre_u, dec_u, steps=STEPS, name="serve-unbatched",
                     batching=False)
    _tokens(_burst(dep_u, toks, [0])[0])                  # warm
    got_u, u_stats, launches_u, _, _, _ = _serve_burst(
        dep_u, toks, everyone)
    check(launches_u["flash_attention"] == L * SERVE_REQUESTS
          and launches_u["decode_attention"] == L * STEPS * SERVE_REQUESTS,
          f"one request per dispatch: launches {launches_u}")
    check(got_u == alone, "unbatched tokens == the unfused loop on each "
          "prompt alone")
    # service time per dispatch, as the executor measured it (exec_s of
    # each exec@ span; a batch's members share one)
    b_stats["exec_s"] = [
        next(s for s in traces[m[0]].spans if s.name == f"exec@{node}")
        .attrs["exec_s"] for _, m in batches]
    u_node = dep_u.function_names[0]
    u_stats["exec_s"] = sorted(
        next(s for s in tr.spans if s.name == f"exec@{u_node}")
        .attrs["exec_s"] for tr in _traces(
            rt.tracer, dep_u.dag.name, SERVE_REQUESTS + 1)[1:])
    stats = {"gpu_workers": len(rt.pool.by_class("gpu")),
             "requests": SERVE_REQUESTS, "batch_sizes": sizes,
             "batched": b_stats, "unbatched": u_stats}
    return dep, stats, traces, t_sub, done


def phase_serving(torch, dev, model, params, first_s, smi):
    """Phase 5 (see the module docstring), on phase 4's yi-9b model and
    params.  Parts: 1 batched against one request per dispatch, on two
    GPU workers and again on one; 5 tracing of part 1's requests; 2 the
    device-resident demux; 3 admission and deadlines; 4 faults."""
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.obs.trace import Tracer

    toks = torch.randint(0, model.cfg.vocab_size, (SERVE_REQUESTS, SEQ),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 2))
    # the wedge detector: far above the slowest call this card showed (a
    # batch of 8 holds twice phase 4's rows; two batches share the card)
    hang = max(30.0, 20.0 * first_s)

    def runtime(n_gpu):
        return dc.Runtime(n_cpu=1, n_gpu=n_gpu, net=dc.NetModel(scale=0.0),
                          max_batch=SERVE_BATCH,
                          batch_wait_ms=SERVE_WAIT_MS, hang_timeout_s=hang,
                          tracer=Tracer(sample_rate=1.0), device=dev)

    rt = runtime(2)
    print(f"  Runtime(n_gpu=2, max_batch={SERVE_BATCH}, batch_wait_ms="
          f"{SERVE_WAIT_MS}, hang_timeout_s={hang}): phase 4's first "
          f"call took {first_s} s", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    try:
        # part 1: batched against one request per dispatch
        alone = [dc.reference_decode(model, params, toks[i:i + 1].to(dev),
                                     steps=STEPS, cache_len=CACHE)[0]
                 for i in range(SERVE_REQUESTS)]
        dep, stats, traces, t_sub, done = _serve_modes(
            torch, rt, model, params, toks, alone)
        print(f"  serving: {json.dumps(dict(card=smi, **stats))}",
              flush=True)
        # the same on one GPU worker: does the second host thread help?
        rt1 = runtime(1)
        try:
            stats1 = _serve_modes(torch, rt1, model, params, toks, alone)[1]
            check(rt1.pool.fault_counts["wedge"] == 0,
                  f"no wedge on one worker ({rt1.pool.fault_counts})")
        finally:
            rt1.stop()
        print(f"  serving on one GPU worker: "
              f"{json.dumps(dict(card=smi, **stats1))}", flush=True)
        _part_tracing(dep, traces, t_sub, done)
        _part_demux(torch, dev, rt, model, params, toks)
        _part_admission(torch, rt, dep, model, params, toks)
        _part_faults(torch, rt, dep, model, params, toks)
        check(rt.pool.fault_counts["wedge"] == 0,
              f"no wedge in the serving phase ({rt.pool.fault_counts})")
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"  peak device memory {peak} bytes ({peak - held} above the "
              f"{held} held before the phase)", flush=True)
    finally:
        rt.stop()


def _part_tracing(dep, traces, t_sub, done):
    """Part 5, on part 1's batched burst: every request's kept trace has
    the spans admission, queue@, exec@ (linked to its batch), demux@ in
    order, and its attributed components cover at least 90% of its
    latency as the caller measured it; the traces go to a Perfetto file
    under ``build/``."""
    from repro_torch.obs import attribute, export_chrome

    node = dep.function_names[0]
    names = ["admission", f"queue@{node}", f"exec@{node}", f"demux@{node}"]
    for i, tr in enumerate(traces):
        got_names = [s.name for s in tr.spans]
        if got_names != names:
            raise SmokeFailure(f"request {i} spans {got_names} != {names}")
        total = sum(b.total_s for b in attribute([tr]).nodes.values())
        lat = done[i] - t_sub[i]
        if total < 0.9 * lat:
            raise SmokeFailure(f"request {i}: attributed {total} s < 90% "
                               f"of its measured {lat} s")
    check(True, f"{len(traces)} kept traces, spans admission, queue@, "
          f"exec@ (linked to its batch), demux@ of the chain in order; "
          f"components >= 90% of each request's measured latency")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    path = os.path.join(HERE, "build", "serving_trace.json")
    n_ev = export_chrome(dep.runtime.tracer, path, dag=dep.dag.name)
    print(f"  Perfetto trace: {n_ev} events in {path}", flush=True)
    print(attribute(traces).table(), flush=True)


def _part_demux(torch, dev, rt, model, params, toks):
    """Part 2: 4 requests through ``[prefill, decode]`` merged across
    requests, then 7 decode steps per request pinned to the producer's
    worker; tokens held to the split plain loop, the parts crossing the
    edge are DeviceTables on the card, and no copy crosses it."""
    from repro_torch.examples import decode_cascade as dc

    L = model.cfg.num_layers
    pre, dec_b = dc.build_ops(model, params, cache_len=CACHE,
                              name=model.cfg.name)
    _, dec = dc.build_ops(model, params, cache_len=CACHE,
                          name=model.cfg.name)
    dep = _split_deploy(rt, pre, dec_b, dec)
    n1, n2 = dep.function_names
    node2 = dep.dag.nodes[n2]
    check(dep.dag.nodes[n1].emits_device and not node2.batching,
          "split cascade: the batching [prefill, decode] chain emits a "
          "DeviceTable to the 7-step chain")
    seen = []
    inner = node2.fn

    def spy(tables, ctx):
        dt = getattr(tables[0], "device", None)
        seen.append((type(tables[0]).__name__, getattr(dt, "type", dt)))
        return inner(tables, ctx)

    node2.fn = spy
    four = list(range(4))
    rt.tracer.clear()
    _zero_launches()
    got = _tokens(_burst(dep, toks, four)[0])
    launches = _launches()
    traces = _traces(rt.tracer, dep.dag.name, 4)
    batches = _batches(rt.tracer, traces, n1)
    nb = len(batches)
    for bid, members in batches:
        want = _split_oracle(torch, model, params, toks, members)
        check([got[m] for m in members] == want,
              f"split batch {bid}: tokens == prefill + 1 step over the "
              f"padded batch, then 7 steps per row from its slice {want}")
    check(launches["flash_attention"] == L * nb
          and launches["decode_attention"] == L * (nb + (STEPS - 1) * 4),
          f"split launches {launches}: {nb} batched prefills and steps, "
          f"then {STEPS - 1} steps per request")
    check(seen == [("DeviceTable", dev.type)] * 4,
          f"the parts handed to the 7-step chain are DeviceTables on the "
          f"card: {seen}")
    for i, tr in enumerate(traces):
        e1, e2 = (next(s for s in tr.spans if s.name == f"exec@{n}")
                  for n in (n1, n2))
        c1, c2 = e1.attrs.get("copies", {}), e2.attrs.get("copies", {})
        if "gathers" in c1 or "stacks" in c2 or \
                e1.attrs["executor"] != e2.attrs["executor"]:
            raise SmokeFailure(
                f"request {i}: first node copies {c1} (want no "
                f"device->host), second {c2} (want no host->device), "
                f"executors {e1.attrs['executor']} and "
                f"{e2.attrs['executor']} (want one)")
    ex1, ex2 = ([next(s for s in tr.spans if s.name == f"exec@{n}")
                 .attrs.get("exec_s") for tr in traces] for n in (n1, n2))
    check(True, "no device->host copy at the demuxed edge; each part ran "
          "on its producer's worker")
    print(f"  device-resident edge: first node exec_s {ex1} (closes at "
          f"launch), second node exec_s {ex2} (holds the device time)",
          flush=True)


def _part_admission(torch, rt, dep, model, params, toks):
    """Part 3: a rate-limited gate admits the first 4 of a burst of 12
    and sheds 8 typed in under 5 ms each; then, with the gate cleared, a
    lone request whose deadline is far below one batch's time, sent
    while both GPU workers are busy, expires typed in a queue and its
    batch never launches."""
    from repro_torch.serving import (AdmissionController, ClassPolicy,
                                     DeadlineExceeded, Overloaded)

    L = model.cfg.num_layers
    name, node = dep.dag.name, dep.function_names[0]
    tracer = rt.tracer
    rt.set_admission(name, AdmissionController(classes={
        "interactive": ClassPolicy("interactive", priority=2, rate=1.0,
                                   burst=4)}))
    shed0 = len(rt.metrics_snapshot().get(f"dag/{name}/shed_t", []))
    tracer.clear()
    twelve = list(range(12))
    t_b = time.perf_counter()
    futs, _, _, t_call = _burst(dep, toks, twelve)
    t_b = time.perf_counter() - t_b
    ok, shed = [], []
    for j, f in enumerate(futs):
        e = f.exception(600)
        if e is None:
            ok.append(j)
        elif isinstance(e, Overloaded) and e.reason == "rate_limit" \
                and not isinstance(e, DeadlineExceeded):
            shed.append(j)
        else:
            raise e
    check(t_b < 1.0 and ok == [0, 1, 2, 3] and shed == twelve[4:],
          f"12 requests in {t_b} s: the first 4 admitted, 8 shed typed "
          f"(Overloaded, rate_limit)")
    check(max(t_call[j] for j in shed) < 5e-3,
          f"each shed call_dag returned in < 5 ms (max "
          f"{max(t_call[j] for j in shed)} s)")
    n_shed = len(rt.metrics_snapshot().get(f"dag/{name}/shed_t", []))
    check(n_shed - shed0 == 8, f"dag/{name}/shed_t counts 8")
    got = _tokens([futs[j] for j in ok])
    admitted = [t for t in _traces(tracer, name, 12) if not t.shed]
    _check_batched_tokens(torch, model, params, toks, ok, got,
                          _batches(tracer, admitted, node),
                          "admitted requests")
    rt.set_admission(name, None)

    chain = dep.plan.ops[-1].op
    c0 = chain.batch_dispatches + chain.row_dispatches
    exp0 = len(rt.metrics_snapshot().get(f"dag/{name}/expired_t", []))
    batch_s = float(min(s.duration_s for s in tracer.batch_spans()))
    tracer.clear()
    _zero_launches()
    fill, _, _, _ = _burst(dep, toks, list(range(SERVE_REQUESTS)))
    gpus = rt.pool.by_class("gpu")
    _wait_for(lambda: len(gpus) == 2 and all(e.busy for e in gpus),
              "both GPU workers busy with the filler burst")
    budget = batch_s / 20.0
    late, _, _, _ = _burst(dep, toks, [0], deadline_s=budget)
    err = late[0].exception(600)
    check(isinstance(err, DeadlineExceeded),
          f"a lone request with deadline_s={budget} (a batch takes "
          f"{batch_s} s) behind two busy workers fails typed: {err!r}")
    _tokens(fill)
    traces = _traces(tracer, name, SERVE_REQUESTS + 1)
    nb = len(_batches(tracer, traces[:SERVE_REQUESTS], node))
    ran = chain.batch_dispatches + chain.row_dispatches - c0
    launches = _launches()
    check(ran == nb and launches["flash_attention"] == L * nb
          and launches["decode_attention"] == L * STEPS * nb,
          f"its batch never launched: {ran} dispatches, launches "
          f"{launches} == the filler's {nb} batches")
    n_exp = len(rt.metrics_snapshot().get(f"dag/{name}/expired_t", []))
    check(n_exp - exp0 == 1, f"dag/{name}/expired_t counts 1; its spans "
          f"{[s.kind for s in traces[-1].spans]}")


def _part_faults(torch, rt, dep, model, params, toks):
    """Part 4: a crash of a GPU worker (detected, requeued, replaced) and
    then a transient fault (retried once), each on a burst of 8 requests
    whose tokens stay held to the same-shape oracle."""
    from repro_torch.serving import FaultPlan

    name, node = dep.dag.name, dep.function_names[0]
    eight = list(range(8))
    fc0 = dict(rt.pool.fault_counts)
    rt.set_fault_plan(FaultPlan(seed=7).crash(rate=1.0, limit=1,
                                              classes=("gpu",)))
    rt.tracer.clear()
    got = _tokens(_burst(dep, toks, eight)[0])
    rt.set_fault_plan(None)
    fc = {k: rt.pool.fault_counts[k] - fc0[k] for k in fc0}
    check(fc["crash"] == 1 and fc["requeued"] >= 1 and fc["replaced"] == 1
          and fc["wedge"] == 0,
          f"a crash of a GPU worker detected, requeued and replaced: {fc}")
    _check_batched_tokens(torch, model, params, toks, eight, got,
                          _batches(rt.tracer, _traces(rt.tracer, name, 8),
                                   node), "crash recovery")
    r0 = len(rt.metrics_snapshot().get(f"dag/{name}/retry_t", []))
    rt.set_fault_plan(FaultPlan(seed=7).transient(rate=1.0, limit=1))
    rt.tracer.clear()
    got = _tokens(_burst(dep, toks, eight)[0])
    rt.set_fault_plan(None)
    n_retry = len(rt.metrics_snapshot().get(f"dag/{name}/retry_t", []))
    check(n_retry - r0 == 1, f"a transient fault retried once "
          f"(dag/{name}/retry_t +{n_retry - r0})")
    _check_batched_tokens(torch, model, params, toks, eight, got,
                          _batches(rt.tracer, _traces(rt.tracer, name, 8),
                                   node), "transient recovery")


def _split_deploy(rt, pre, dec_batched, dec):
    """``[prefill, decode]`` with the batching hint (one chain, merged
    across requests), then ``STEPS - 1`` decode steps without it:
    ``FuseChainsPass`` splits the chain at the change of hint, so the
    first chain's DeviceTable is demuxed on the card and each request's
    steps run pinned to the producer's worker.  The hint lives on the op,
    so the batched decode step is an op instance of its own."""
    import torch

    from repro_torch.core.compiler import compile_flow
    from repro_torch.core.dataflow import Dataflow

    fl = Dataflow([("tokens", torch.Tensor)])
    node = fl.apply_op(pre, gpu=True, batching=True).apply_op(
        dec_batched, gpu=True, batching=True)
    for _ in range(STEPS - 1):
        node = node.apply_op(dec, gpu=True)
    fl.output = node
    return compile_flow(fl, rt, fusion=True, name="serve-split")


def _split_oracle(torch, model, params, toks, members):
    """The split cascade's plain loop: prefill and one step over the
    batch's rows padded as the chain pads, then ``STEPS - 1`` steps per
    row from that row's slice of the cache (``take`` hands each request
    its own one-row cache)."""
    from repro_torch.models import registry

    rows = _padded(torch, toks[members].to(model.device))
    logits, cache = model.prefill(params, {"tokens": rows}, CACHE)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    pos = torch.full((rows.shape[0],), SEQ, dtype=torch.int32,
                     device=rows.device)
    lg, cache = model.decode_step(params, tok[:, None], pos, cache)
    tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
    pos = pos + 1
    paths, axes, _ = registry._cache_layout(model, CACHE)
    out = []
    for p in range(len(members)):
        idx = torch.tensor([p], device=rows.device)
        c = registry._unflatten(paths, [
            leaf.index_select(ax, idx) for (_, leaf), ax
            in zip(registry._flatten(cache), axes)])
        t, q = tok[p:p + 1], pos[p:p + 1]
        for _ in range(STEPS - 1):
            lg, c = model.decode_step(params, t[:, None], q, c)
            t = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
            q = q + 1
        out.append(int(t[0]))
    return out


# -- phase 6: the compile-time half on full-width yi-9b ----------------------

def phase_compile(torch, dev, model, params, first_s, smi):
    """Phase 6 (see the module docstring), on phase 4's yi-9b model and
    params.  Parts: the verifier at full width; the verifier against the
    card's KernelError; competitive execution under a hang fault;
    locality; the linter over the port's examples."""
    hang = max(30.0, 20.0 * first_s)
    out = {"card": smi}
    out["verify"] = _part_verify(torch, dev, model, params, hang)
    _part_launch_rules(torch, dev)
    out["competitive"] = _part_competitive(torch, dev, model, params, hang)
    out["locality"] = _part_locality(torch, dev)
    _part_check_cli()
    print(f"  compile: {json.dumps(out)}", flush=True)


def _sample(torch, toks, i):
    from repro_torch.core.table import Table

    return Table([("tokens", torch.Tensor)], [(toks[i],)])


def _part_verify(torch, dev, model, params, hang):
    """The cascade compiled with ``verify=True`` and a sample request:
    zero errors, CF103 run on both attention kernels at yi-9b's shapes,
    nothing allocated and nothing launched across the compile; the CF301
    footprint of the largest bucket beside the growth of the peak
    allocation over the first warm at that bucket; a budget below the
    footprint refused with CF301 before anything runs."""
    from repro_torch.analysis import VerificationError
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc

    toks = torch.randint(0, model.cfg.vocab_size, (64, SEQ),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 3))
    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0),
                    hang_timeout_s=hang, device=dev)
    try:
        pre, dec = dc.build_ops(model, params, cache_len=CACHE,
                                name=model.cfg.name)
        budget = torch.cuda.mem_get_info(dev)[0]
        gc.collect()     # no earlier garbage may be freed inside the compile
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        _zero_launches()
        t0 = time.perf_counter()
        dep = dc.build(rt, pre, dec, steps=STEPS, name="verified",
                       verify=True, verify_input=_sample(torch, toks, 0),
                       verify_budget_bytes=budget)
        verify_s = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        rep = dep.verification
        check(rep.ok and not rep.errors(),
              f"verify at full width: {len(rep.errors())} errors, "
              f"{len(rep.warnings())} warnings in {verify_s} s\n"
              f"{rep.table()}")
        check(torch.cuda.memory_allocated(dev) == held
              and _launches() == dict.fromkeys(KERNELS, 0),
              f"the verified compile allocated nothing on the card "
              f"({torch.cuda.memory_allocated(dev)} == {held} bytes) and "
              f"launched nothing ({_launches()})")
        H, K, hd = (model.cfg.num_heads, model.cfg.num_kv_heads,
                    model.cfg.head_dim)
        want = {("flash_attention", (1, H, SEQ, hd)),
                ("decode_attention", (1, H, hd))}
        seen = {(k, shapes[0]) for _op, k, shapes in rep.kernel_checks}
        check(want <= seen, f"CF103 checked both attention kernels at "
              f"yi-9b's shapes: {sorted(seen)}")
        (op_id, (peak, per_row, cap)), = rep.footprint.items()
        rows = [(toks[i],) for i in range(cap)]
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        res = dep.execute(Table([("tokens", torch.Tensor)], rows)).result(
            600)
        warm_s = time.perf_counter() - t0
        grew = torch.cuda.max_memory_allocated(dev) - held
        got = [int(r.values[0]) for r in res.rows]
        check(len(got) == cap
              and all(0 <= t < model.cfg.vocab_size for t in got),
              f"the first warm at bucket {cap}: {cap} tokens in range "
              f"in {warm_s} s")
        print(f"  CF301 static footprint at bucket {cap}: {peak} bytes "
              f"({per_row} a row); peak allocation grew {grew} bytes over "
              f"the first warm at that bucket", flush=True)
        gc.collect()
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        _zero_launches()
        t0 = time.perf_counter()
        try:
            dc.build(rt, pre, dec, steps=STEPS, name="over-budget",
                     verify=True, verify_input=_sample(torch, toks, 0),
                     verify_budget_bytes=peak - 1)
            raise SmokeFailure("a budget below the footprint compiled")
        except VerificationError as e:
            codes = sorted({d.code for d in e.report.errors()})
        reject_s = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        check(codes == ["CF301"] and "over-budget" not in rt.dags
              and torch.cuda.memory_allocated(dev) == held
              and _launches() == dict.fromkeys(KERNELS, 0),
              f"budget {peak - 1} bytes (the footprint less one) refused "
              f"with {codes} in {reject_s} s: not registered, nothing "
              f"allocated, nothing launched")
        return {"verify_s": verify_s, "reject_s": reject_s,
                "footprint_bytes": peak, "bucket": cap,
                "bytes_per_row": per_row, "warm_peak_growth_bytes": grew,
                "warm_s": warm_s, "budget_bytes": budget,
                "kernels_checked": sorted(seen)}
    finally:
        rt.stop()


def _flash_flow(torch):
    from repro_torch.core.dataflow import Dataflow
    from repro_torch.kernels import ops as kops

    def scale(o: torch.Tensor) -> torch.Tensor:
        return o * 2

    fl = Dataflow([("q", torch.Tensor), ("k", torch.Tensor),
                   ("v", torch.Tensor)])
    fl.output = fl.map(kops.kernel_step("flash_attention", causal=True),
                       names=["o"], gpu=True).map(scale, names=["o"],
                                                  gpu=True)
    return fl


def _part_launch_rules(torch, dev):
    """The verifier agrees with the card: a flash step at head_dim 12
    (the CUDA kernel needs a multiple of 8) is refused by CF103, and
    compiled unverified it raises KernelError at its first call; at
    yi-9b's head_dim 128 it passes and launches."""
    from repro_torch.analysis import VerificationError
    from repro_torch.core.compiler import compile_flow
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.kernels.build import KernelError

    def sample(hd):
        g = torch.Generator().manual_seed(SEED + 4)
        t = torch.randn(32, SEQ, hd, generator=g).to(torch.bfloat16)
        return Table([("q", torch.Tensor), ("k", torch.Tensor),
                      ("v", torch.Tensor)], [(t, t, t), (t, t, t)])

    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0),
                    device=dev)
    try:
        try:
            compile_flow(_flash_flow(torch), rt, fusion=True, verify=True,
                         verify_input=sample(12), name="hd12")
            raise SmokeFailure("CF103 passed head_dim 12")
        except VerificationError as e:
            codes = sorted({d.code for d in e.report.errors()})
        check(codes == ["CF103"], f"head_dim 12 refused by the verifier "
              f"with {codes}")
        dep = compile_flow(_flash_flow(torch), rt, fusion=True,
                           name="hd12-unverified")
        _zero_launches()
        err = dep.execute(sample(12)).exception(600)
        check(isinstance(err, KernelError) and _launches()[
            "flash_attention"] == 0,
              f"compiled unverified, the card refuses it: {err!r}")
        dep = compile_flow(_flash_flow(torch), rt, fusion=True, verify=True,
                           verify_input=sample(128), name="hd128")
        out = dep.execute(sample(128)).result(600)
        torch.cuda.synchronize(dev)
        check(dep.verification.ok and _launches()["flash_attention"] == 1
              and len(out.rows) == 2,
              "head_dim 128 verified clean and launched once for its "
              "2-row batch")
    finally:
        rt.stop()


def _part_competitive(torch, dev, model, params, hang):
    """The cascade as ``COMPETE_REPLICAS`` replicas racing on two GPU
    workers under a hang fault on the GPU class, against the same
    requests without replicas: tokens equal the unfused loop on each
    prompt alone, no wedge; p50/p99 of both modes and the races each
    replica won (no gain asserted: the replicas share one card)."""
    import numpy as np

    from repro_torch.analysis import analyze, device_edge_info
    from repro_torch.core.lowering import BatchedJittedFuse
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import FaultPlan

    n = COMPETE_REQUESTS
    toks = torch.randint(0, model.cfg.vocab_size, (n, SEQ),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 5))
    alone = [dc.reference_decode(model, params, toks[i:i + 1].to(dev),
                                 steps=STEPS, cache_len=CACHE)[0]
             for i in range(n)]
    rt = dc.Runtime(n_cpu=1, n_gpu=2, net=dc.NetModel(scale=0.0),
                    hang_timeout_s=hang, tracer=Tracer(sample_rate=1.0),
                    device=dev)
    try:
        pre, dec = dc.build_ops(model, params, cache_len=CACHE,
                                name=model.cfg.name)
        comp = dc.build(rt, pre, dec, steps=STEPS, name="competitive",
                        competitive=COMPETE_REPLICAS)
        plan = comp.plan
        anyof = plan.op(plan.output_id)
        reps = [plan.op(i) for i in anyof.inputs]
        check(len(plan.ops) == COMPETE_REPLICAS + 1 and anyof.wait_any
              and anyof.placement == "cpu"
              and len(reps) == COMPETE_REPLICAS
              and all(isinstance(r.op, BatchedJittedFuse)
                      and r.placement == "gpu" for r in reps),
              f"CompetitivePass: {COMPETE_REPLICAS} lowered copies on "
              f"gpu and one anyof on cpu")
        info = device_edge_info(plan)
        fanout = {o.op_id: sum(o.op_id in c.inputs for c in plan.ops)
                  for o in plan.ops}
        donating = {i for i, (_e, d) in info.items() if d and fanout[i] > 1}
        cf201 = {d.op_id for d in analyze(plan).by_code("CF201")}
        check(donating == cf201 == set() and not any(
            e for e, _d in info.values()),
              f"no fan-out edge donates and no replica emits to the card "
              f"(device_edge_info {info}; CF201 {sorted(cf201)})")
        plain = dc.build(rt, pre, dec, steps=STEPS, name="no-replicas")
        for dep in (comp, plain):                           # warm
            dep.execute(_sample(torch, toks, 0)).result(600)
        stats = {}
        for mode, dep in (("competitive", comp), ("no_replicas", plain)):
            inj = rt.set_fault_plan(FaultPlan(seed=SEED + 6).hang(
                rate=HANG_RATE, hang_s=HANG_S, classes=("gpu",)))
            rt.tracer.clear()
            lats, got = [], []
            for i in range(n):
                t0 = time.perf_counter()
                res = dep.execute(_sample(torch, toks, i)).result(600)
                lats.append(time.perf_counter() - t0)
                got.append(int(res.rows[0].values[0]))
            rt.set_fault_plan(None)
            check(got == alone, f"{mode}: tokens under the hang fault == "
                  f"the unfused loop on each prompt alone {alone}")
            p50, p99 = np.percentile(np.array(lats) * 1e3, [50, 99])
            stats[mode] = {"p50_ms": float(p50), "p99_ms": float(p99),
                           "hangs": inj.counts["hang"]}
            if mode == "competitive":
                stats[mode].update(_races(rt.tracer, comp, n))
        # the losers still running must not be taken for wedges
        _wait_for(lambda: all(not e.busy for e in rt.pool.by_class("gpu")),
                  "the GPU workers idle")
        check(rt.pool.fault_counts["wedge"] == 0,
              f"no wedge ({rt.pool.fault_counts})")
        return stats
    finally:
        rt.stop()


def _races(tracer, dep, n):
    """Per replica node: how many of the ``n`` requests it won (its
    ``exec@`` span closed first; a loser's span closes after the request
    finished, and its trace may no longer take it) and the executor of
    each win."""
    names = list(dep.dag.nodes[dep.dag.output].deps)
    won = {nm: [] for nm in names}
    for tr in _traces(tracer, dep.dag.name, n):
        first = min((s for s in tr.spans if s.name.startswith("exec@")
                     and s.name[len("exec@"):] in won),
                    key=lambda s: s.t1)
        won[first.name[len("exec@"):]].append(first.attrs.get("executor"))
    return {"won": [len(w) for w in won.values()],
            "won_on": list(won.values())}


def _part_locality(torch, dev):
    """The port's recommender on the card: the category matrices are
    tensors on the card in the KVS; with ``fusion=locality=True`` the
    answers equal numpy's and every lookup after the warm-up runs on an
    executor caching its key; the naive flow's answers too.  Medians of
    both (host clock, one request at a time)."""
    from repro_torch.examples import recommender as rec

    want = rec.numpy_scores()
    out = {}
    for mode, optimized in (("naive", False), ("optimized", True)):
        r = rec.run(optimized, device=dev)
        ok = all(a[0] == w[0] and abs(a[1] - w[1]) <= 1e-9 * abs(w[1])
                 for a, w in zip(r["answers"], want))
        check(ok and len(r["answers"]) == len(want),
              f"recommender {mode}: {len(want)} answers == numpy's "
              f"(product, score) for the same users")
        local = sum(ex in where for _k, ex, where in r["dispatch"])
        out[mode] = {"median_ms": r["median_s"] * 1e3,
                     "lookups_on_a_caching_executor": local}
    check(out["optimized"]["lookups_on_a_caching_executor"] == len(want),
          f"every optimized lookup ran on an executor caching its key "
          f"(naive: {out['naive']['lookups_on_a_caching_executor']} of "
          f"{len(want)})")
    return out


def _part_check_cli():
    """``python -m repro_torch.check src/repro_torch/examples`` exits 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.check",
         os.path.join("src", "repro_torch", "examples")],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    last = (res.stdout.strip().splitlines() or [""])[-1]
    check(res.returncode == 0, f"python -m repro_torch.check "
          f"src/repro_torch/examples exits {res.returncode}: {last}"
          + ("" if res.returncode == 0 else f"\n{res.stdout}{res.stderr}"))


def kernel_vs_plain(torch, dev, cfg, params, toks):
    """Logits rel err of the kernel path against the plain path on the
    same params and prompts: (prefill, first decode step).  Checks that
    the kernel side launched the kernels its path needs and the plain side
    none, and prints how far the prefill caches' f32 leaves (the
    recurrent states) of the two sides are apart."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model, registry

    model = build_model(cfg, device=dev)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=dev)
    nxt = pos = None
    out = {}
    for side, m in (("plain", plain), ("kernel", model)):
        for name in KERNELS:
            getattr(kops, name).launches = 0
        logits, cache = m.prefill(params, {"tokens": toks}, CACHE)
        if nxt is None:
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            pos = torch.full((PROMPTS,), SEQ, dtype=torch.int32, device=dev)
        step, _ = m.decode_step(params, nxt, pos, cache)
        launches = {name: getattr(kops, name).launches for name in KERNELS}
        out[side] = (logits, cache, step, launches)
    want = expected_launches(cfg, 1, 1)
    check(out["kernel"][3] == want
          and out["plain"][3] == dict.fromkeys(KERNELS, 0),
          f"{cfg.num_layers} layers, one prefill and one decode step: "
          f"kernel side launches {out['kernel'][3]} == {want}, plain side "
          f"none")
    leaves = zip(registry._flatten(out["kernel"][1]),
                 registry._flatten(out["plain"][1]))
    for (name, ck), (_, cp) in leaves:
        if ck.dtype == torch.float32:
            diff = (ck - cp).abs()
            print(f"  prefill cache {name} (f32 {tuple(ck.shape)}), kernel "
                  f"vs plain: max abs diff {float(diff.max())}, "
                  f"{int((diff > 0).sum())} of {diff.numel()} values differ;"
                  f" [0] max abs diff {float(diff[0].max())}", flush=True)
    return (rel_err(out["kernel"][0], out["plain"][0]),
            rel_err(out["kernel"][2], out["plain"][2]))


def _negate_lam(tree):
    """recurrentgemma params with every RG-LRU ``lam`` negated."""
    if not isinstance(tree, dict):
        return tree
    return {k: -v if k == "lam" else _negate_lam(v) for k, v in tree.items()}


def _release(torch):
    """Free a path's weights: the process-wide executable cache holds the
    chain's step functions, and they close over the params."""
    from repro_torch.core.lowering import EXECUTABLE_CACHE

    EXECUTABLE_CACHE.clear()
    gc.collect()                 # chains and closures form cycles
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # the port first: without it (a checkout missing src/) fail before
    # printing anything
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    print("== device", flush=True)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"  {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}", flush=True)

    print("== build", flush=True)
    t0 = time.perf_counter()
    secs = build.build(verbose=True)   # ptxas: registers, smem, spills
    print(f"  built {secs} in {time.perf_counter() - t0:.1f} s", flush=True)

    print("== kernels", flush=True)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernels = phase_kernels(torch, dev, flush=scratch.zero_)
    del scratch

    print("== paths", flush=True)
    served = {}
    for arch, f32_layers, logits_layers in PATHS:
        _release(torch)          # nothing of the last path stays allocated
        # each kernel's launches come from the run of the path it is on
        launches, kept = phase_path(torch, dev, arch, f32_layers,
                                    logits_layers, keep=arch == "yi-9b")
        if kept is not None:
            served[arch] = kept  # phase 5 serves yi-9b's weights
        for name, n in launches.items():
            if n:
                kernels[name]["launches"] = n

    print("== serving", flush=True)
    _release(torch)
    yi = served.pop("yi-9b")
    phase_serving(torch, dev, *yi, smi=smi)
    _release(torch)

    print("== compile", flush=True)
    phase_compile(torch, dev, *yi, smi=smi)
    del yi
    _release(torch)
    keys = ["name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"]
    extra = ["device_ms", "library_device_ms", "instance"]
    line = {"kernels": [{k: kernels[n][k] for k in keys + extra
                         if k in kernels[n]} for n in KERNELS]}
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
