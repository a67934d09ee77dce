#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each passes or the script exits non-zero; nothing is caught and
ignored):

1. Device: the card's name and power limit.
2. Build: both CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, started together).
3. Kernels: each kernel against its plain PyTorch version at the main
   path's shapes (yi-9b: H=32, K=4, hd=128; decode B=4 over a 1024-slot
   ring cache with empty -1 slots, flash B=4, S=256), in bf16 and f32,
   plus its time, the plain version's time, one PyTorch call's time
   (``scaled_dot_product_attention``, timed only) and the least time the
   card could take (the bound).
4. Path: full-width 48-layer yi-9b in bf16 with ``use_kernels=True``,
   random weights from a seeded generator, a prefill + 8 decode
   ``ModelOp`` cascade through ``Dataflow`` -> ``compile_flow`` ->
   ``Runtime`` on the card, answering 4 prompts of 256 tokens (cache 1024)
   three times.  Checks: kernel launch counts against the chain's
   dispatch counters, zero re-traces on the repeat calls, fused tokens
   equal to the unfused loop, and kernel-path logits within rel 0.05 of
   the plain path.  Then float32 at 4 layers (full width): the kernel
   path's greedy tokens equal the plain path's.
5. The last line: ``{"ok": true, "device": {...}}``; before it a
   ``kernels`` JSON line and the nvidia-smi line.

Exits non-zero with no result when CUDA is unavailable or the port's
package is missing.
"""
import dataclasses
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


def time_ms(torch, fn, iters=30, warmup=3, flush=None):
    """Mean device time of ``fn`` in ms over ``iters`` launches, each
    timed with CUDA events after ``flush`` evicted the L2 cache (the main
    path meets every layer's cache and weights cold)."""
    for _ in range(warmup):
        fn()
    total = 0.0
    events = []
    for _ in range(iters):
        if flush is not None:
            flush()
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
        if dtype != torch.bfloat16:
            continue
        valid = int(((kpos >= 0) & (kpos <= qpos[:, None])).sum())
        el = q.element_size()
        nbytes = (q.numel() * el * 2            # q read, out written
                  + 2 * valid * K * hd * el     # the K and V rows needed
                  + valid * 4 + B * 4)          # positions needed
        flops = 2 * 2 * valid * H * hd          # q.k and p.v per head
        bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
        bound_ops = flops / H100_FLOPS["bfloat16"] * 1e3
        qs = q[:, :, None]                                # [B,H,1,hd]
        mask = ((kpos >= 0) & (kpos <= qpos[:, None]))[:, None, None, :]
        results["decode_attention"] = {
            "name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:88",
            "max_abs_err": abs_err,
            "ms": time_ms(torch, lambda: kops.decode_attention(
                q, kc, vc, kpos, qpos), flush=flush),
            "plain_ms": time_ms(torch, lambda: decode_attention_plain(
                q, kc, vc, kpos, qpos), flush=flush),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, attn_mask=mask, enable_gqa=True),
                flush=flush),
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
        if dtype != torch.bfloat16:
            continue
        el = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * el
        pairs = B * H * S * (S + 1) // 2        # causal (q, k) pairs
        flops = 2 * 2 * pairs * hd              # q.k and p.v
        bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
        bound_ops = flops / H100_FLOPS["bfloat16"] * 1e3
        results["flash_attention"] = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:95",
            "max_abs_err": abs_err,
            "ms": time_ms(torch, lambda: kops.flash_attention(q, k, v),
                          flush=flush),
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(
                q, k, v), flush=flush),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), flush=flush),
        }
    for r in results.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
    return results


def serve(torch, dev, cfg, *, prompts, seq, cache_len, steps, calls=3):
    """Compile the cascade for ``cfg`` on a card Runtime and answer the
    same ``prompts`` x ``seq`` batch ``calls`` times.  Returns
    (model, params, tokens, per-call latencies, per-call re-traces,
    chain, launches)."""
    from repro_torch.core.lowering import EXECUTABLE_CACHE
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model

    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    toks = torch.randint(0, cfg.vocab_size, (prompts, seq),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 1))
    table = Table([("tokens", torch.Tensor)],
                  [(toks[i],) for i in range(prompts)])
    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0),
                    device=dev)
    try:
        pre, dec = dc.build_ops(model, params, cache_len=cache_len,
                                name=cfg.name)
        dep = dc.build(rt, pre, dec, steps=steps, name=f"smoke-{cfg.name}")
        chain = dep.plan.ops[-1].op
        print(dep.explain(), flush=True)
        lats, retraces, out = [], [], None
        kops.flash_attention.launches = 0
        kops.decode_attention.launches = 0
        for _ in range(calls):
            tr0 = EXECUTABLE_CACHE.traces()
            t0 = time.perf_counter()
            out = dep.execute(table).result(600)
            lats.append(time.perf_counter() - t0)
            retraces.append(EXECUTABLE_CACHE.traces() - tr0)
        launches = {"flash_attention": kops.flash_attention.launches,
                    "decode_attention": kops.decode_attention.launches}
    finally:
        rt.stop()
    got = [int(r.values[0]) for r in out.rows]
    return model, params, toks.to(dev), got, lats, retraces, chain, launches


def phase_path(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.models import build_model

    steps, prompts, seq, cache_len = 8, 4, 256, 1024
    cfg = dataclasses.replace(get_config("yi-9b"), use_kernels=True)
    L = cfg.num_layers
    print(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}", flush=True)
    model, params, toks, got, lats, retraces, chain, launches = serve(
        torch, dev, cfg, prompts=prompts, seq=seq, cache_len=cache_len,
        steps=steps)
    nparams = sum(t.numel() for t in _leaves(params))
    print(f"  weights: {nparams} params, "
          f"{sum(t.numel() * t.element_size() for t in _leaves(params))}"
          f" bytes; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
    runs = chain.batch_dispatches + chain.row_dispatches
    print(f"  chain dispatches: {chain.batch_dispatches} batched, "
          f"{chain.row_dispatches} per-row; launches {launches}", flush=True)
    check(launches["flash_attention"] == L * runs and runs > 0,
          f"flash launches {launches['flash_attention']} == {L} x {runs} "
          "prefill dispatches")
    check(launches["decode_attention"] == L * steps * runs,
          f"decode launches {launches['decode_attention']} == {L} x "
          f"{steps * runs} decode-step dispatches")
    check(retraces[1:] == [0, 0], f"re-traces per call {retraces}")
    check(len(got) == prompts and all(0 <= t < cfg.vocab_size for t in got),
          f"{prompts} greedy tokens in range: {got}")
    ref = dc.reference_decode(model, params, toks, steps=steps,
                              cache_len=cache_len)
    check(got == ref, f"fused cascade tokens == unfused loop {ref}")
    print(f"  bf16 {L}-layer latency: first {lats[0] * 1e3} ms, steady "
          f"{min(lats) * 1e3} ms ({prompts} prompts x {seq} tokens, "
          f"{steps} decode steps)", flush=True)

    # kernel path vs plain path, same params, on the card
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=dev)
    lk, ck = model.prefill(params, {"tokens": toks}, cache_len)
    lp, cp = plain.prefill(params, {"tokens": toks}, cache_len)
    e_pre = rel_err(lk, lp)
    check(e_pre < BF16_REL, f"first-prefill logits rel err {e_pre} < 0.05")
    nxt = torch.argmax(lp[:, -1], dim=-1).to(torch.int32)[:, None]
    pos = torch.full((prompts,), seq, dtype=torch.int32, device=dev)
    dk, _ = model.decode_step(params, nxt, pos, ck)
    dp, _ = plain.decode_step(params, nxt, pos, cp)
    e_dec = rel_err(dk, dp)
    check(e_dec < BF16_REL, f"first-decode logits rel err {e_dec} < 0.05")
    del model, plain, params, ck, cp
    torch.cuda.empty_cache()

    # float32, 4 layers at full width: greedy tokens must be identical
    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    model, params, toks, got32, lats32, retraces32, _, _ = serve(
        torch, dev, cfg32, prompts=prompts, seq=seq, cache_len=cache_len,
        steps=steps)
    plain32 = build_model(dataclasses.replace(cfg32, use_kernels=False),
                          device=dev)
    ref32 = dc.reference_decode(plain32, params, toks, steps=steps,
                                cache_len=cache_len)
    check(got32 == ref32, f"f32 4-layer kernel-path tokens {got32} == "
          f"plain-path tokens {ref32}")
    check(retraces32[1:] == [0, 0], f"f32 re-traces per call {retraces32}")
    print(f"  f32 4-layer latency: first {lats32[0] * 1e3} ms, steady "
          f"{min(lats32) * 1e3} ms", flush=True)
    return launches


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

    print("== path", flush=True)
    launches = phase_path(torch, dev)

    for name, n in launches.items():
        kernels[name]["launches"] = n
    keys = ["name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"]
    line = {"kernels": [{k: kernels[n][k] for k in keys}
                        for n in ("decode_attention", "flash_attention")]}
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
