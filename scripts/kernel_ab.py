#!/usr/bin/env python3
"""Time the port's recurrence and attention kernels of checkouts on one
card.

    python3 scripts/kernel_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (for example
an unpacked ``git archive`` of the parent commit beside this one).  The
runs go in the order given, each in its own process that builds that
checkout's ``wkv6``, ``rglru_scan``, ``decode_attention`` and
``flash_attention`` from its ``src/repro_torch/csrc`` and times them at
their served shapes (rwkv6-1.6b: r/k/v/w [4, 256, 32, 64] f32 with the
final state; recurrentgemma-2b: a/x [4, 256, 2560] f32; yi-9b decode: q
[4, 32, 128] bf16 over a 1024-slot ring cache of 4 kv heads, as
``chip_smoke.py`` fills it; gemma2-9b flash: [1, 16, 8192, 256] bf16,
K 8, causal, softcap 50, scale 1/16, at a local layer (window 4096) and
a global one, and f32 at [1, 16, 4160, 256] with the window, the shape
of ``chip_smoke.py``'s f32 ring check; each with the instance the
checkout picks), with this checkout's ``chip_smoke.time_ms`` and
``host_ms``:
``ms`` (CUDA events around each call, L2 flushed before it),
``device_ms`` (the device spun first, so the events bracket its work
alone) and the host time per call.  Each run also holds the kernels to
that checkout's plain versions.  One JSON line per run; the card's name
and power limit first.
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def inputs(torch, cs, dev):
    """The served shapes of the three kernels, from ``chip_smoke.SEED``."""
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    B, T, H, hd, R = cs.PROMPTS, cs.SEQ, 32, 64, 2560
    u = torch.rand((H, hd), generator=g, device=dev) - 0.5
    r, k, v = (0.3 * torch.randn((B, T, H, hd), generator=g, device=dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, T, H, hd), generator=g,
                                         device=dev) - 0.5))
    a = torch.sigmoid(torch.randn((B, T, R), generator=g, device=dev) + 3.0)
    x = 0.3 * torch.randn((B, T, R), generator=g, device=dev)
    # yi-9b decode: 32 query heads over 4 kv heads of 128, a ring of
    # 1024 slots filled as chip_smoke.py's phase 3 fills it
    Hq, K, hq, W = 32, 4, 128, 1024
    filled = [W, 700, 300, 5]
    kpos = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    for i, n in enumerate(filled):
        kpos[i, :n] = torch.arange(n, dtype=torch.int32, device=dev)
    qpos = torch.tensor([n - 1 for n in filled], dtype=torch.int32,
                        device=dev)
    q = torch.randn((B, Hq, hq), generator=g, device=dev).bfloat16()
    kc, vc = (torch.randn((B, W, K, hq), generator=g,
                          device=dev).bfloat16().transpose(1, 2)
              for _ in range(2))
    return (r, k, v, w, u), (a, x), (q, kc, vc, kpos, qpos)


def flash_inputs(torch, cs, dev):
    """gemma2-9b's flash calls: (name, q, k, v, keywords), bf16 at the
    8192-token prompt's local and global layers and f32 at the ring
    check's 4160 tokens, from ``chip_smoke.SEED``."""
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    out = []
    for name, S, dtype, window in (
            ("flash_attention[gemma2-9b]", 8192, torch.bfloat16, 4096),
            ("flash_attention[gemma2-9b global]", 8192, torch.bfloat16, 0),
            ("flash_attention[gemma2-9b f32]", 4160, torch.float32, 4096)):
        q, k, v = (torch.randn((1, S, n, 256), generator=g, device=dev).to(
            dtype).transpose(1, 2) for n in (16, 8, 8))
        out.append((name, q, k, v, dict(causal=True, window=window,
                                         softcap=50.0, scale=1.0 / 16)))
    return out


def timed(torch, cs, kernel, plain, flush, bar, iters=30):
    """Check ``kernel`` against ``plain`` (relative error under ``bar``),
    then its spans over ``iters`` calls each."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(cs.rel_err(gt, wt) for gt, wt in zip(got, want))
    assert err < bar, err
    return {"rel_err": err,
            "ms": cs.time_ms(torch, kernel, iters=iters, flush=flush),
            "device_ms": cs.time_ms(torch, kernel, iters=iters, flush=flush,
                                    spin=True),
            "host_ms": cs.host_ms(torch, kernel, iters)}


def run_one(tree):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # timing helpers of this tree
    import torch

    src = os.path.join(os.path.abspath(tree), "src")
    sys.path.insert(0, src)
    from repro_torch.kernels import build, ops as kops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rglru_scan import rglru_scan_plain
    from repro_torch.kernels.wkv6 import wkv6_plain
    assert os.path.dirname(build.__file__).startswith(src), build.__file__

    dev = torch.device("cuda")
    build.build(["wkv6", "rglru_scan", "decode_attention",
                 "flash_attention"])
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    (r, k, v, w, u), (a, x), dec = inputs(torch, cs, dev)
    calls = {
        "wkv6": (lambda: kops.wkv6(r, k, v, w, u, return_state=True),
                 lambda: wkv6_plain(r, k, v, w, u, return_state=True),
                 cs.F32_REL),
        "rglru_scan": (lambda: kops.rglru_scan(a, x),
                       lambda: rglru_scan_plain(a, x), cs.F32_REL),
        "decode_attention": (lambda: kops.decode_attention(*dec),
                             lambda: decode_attention_plain(*dec),
                             cs.BF16_REL),
    }
    out = {"tree": tree}
    for name, (kernel, plain, bar) in calls.items():
        out[name] = timed(torch, cs, kernel, plain, flush, bar)
        out[name]["instance"] = getattr(getattr(kops, name),
                                        "last_instance", None)
    # gemma2's flash calls take up to a quarter second on the SIMT
    # instance: fewer calls each
    for name, q, k, v, kw in flash_inputs(torch, cs, dev):
        bar = cs.BF16_REL if q.dtype == torch.bfloat16 else cs.F32_REL
        out[name] = timed(
            torch, cs, lambda: kops.flash_attention(q, k, v, **kw),
            lambda: flash_attention_plain(q, k, v, **kw), flush, bar,
            iters=5)
        out[name]["instance"] = kops.flash_attention.last_instance
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--one"]:
        run_one(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    print(cs.nvidia_smi_line(), flush=True)
    for tree in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
