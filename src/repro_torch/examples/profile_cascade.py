"""Where the time of one served cascade request goes, on the card.

Builds the same full-width bf16 cascade as ``chip_smoke.py`` for one arch
(yi-9b unless ``--arch`` names another; full depth, prefill + 8 decode
steps, 4 prompts x 256 tokens unless ``--prompts`` says how many, cache
1024, ``use_kernels=True``), warms it up, then serves one request under
``torch.profiler`` and prints: the host wall time of the request, the
device time summed per kernel name (top rows, then every row of the
port's own kernels), the device busy share of the request's wall time,
and the number of kernel launches.  One prompt takes the chain's
per-row path (a request served one per dispatch), which keeps its output
on the device; more take one batched dispatch (a batch the runtime's
batcher merged), which copies every cache column to the host at the
chain's output.

    PYTHONPATH=src python -m repro_torch.examples.profile_cascade \
        [--arch yi-9b | rwkv6-1.6b | recurrentgemma-2b] [--prompts N]

Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.table import Table
from repro_torch.examples import decode_cascade as dc
from repro_torch.models import build_model

STEPS = 8     # decode steps per request, as in chip_smoke.py
TOP = 12      # kernel names printed
#: name fragments of the port's hand-written kernels (csrc/*.cu)
PORT_KERNELS = ("flash_wgmma_kernel", "flash_pingpong_kernel",
                "flash_attention_kernel",
                "decode_split_kernel", "decode_combine_kernel",
                "wkv6", "rglru_scan")


def _merged_busy_us(intervals):
    """Union length of [start, end) device intervals (us)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", choices=ARCH_IDS)
    ap.add_argument("--prompts", type=int, default=4,
                    help="rows of the request (1: the per-row path)")
    ap.add_argument("--trace", default="",
                    help="also write a Chrome trace to this path")
    args = ap.parse_args(argv)

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(args.arch), use_kernels=True)
    prompts, seq, cache_len = args.prompts, 256, 1024
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (prompts, seq),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    table = Table([("tokens", torch.Tensor)],
                  [(toks[i],) for i in range(prompts)])
    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0),
                    device=dev)
    try:
        pre, dec = dc.build_ops(model, params, cache_len=cache_len,
                                name=cfg.name)
        dep = dc.build(rt, pre, dec, steps=STEPS, name="profile")
        for _ in range(2):                      # warm-up
            dep.execute(table).result(600)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            dep.execute(table).result(600)
            wall_s = time.perf_counter() - t0
    finally:
        rt.stop()

    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name = {}
    for e in events:
        d = per_name.setdefault(e.name, [0.0, 0])
        d[0] += e.device_time
        d[1] += 1
    dev_us = sum(v[0] for v in per_name.values())
    busy_us = _merged_busy_us(
        [(e.time_range.start, e.time_range.end) for e in events])
    rows = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    print(f"device: {torch.cuda.get_device_name(0)}; {cfg.name}, "
          f"{prompts} prompts")
    print(f"request wall {wall_s * 1e3} ms; device kernel time "
          f"{dev_us / 1e3} ms (summed), busy {busy_us / 1e3} ms "
          f"(union) = {busy_us / 1e3 / (wall_s * 1e3)} of wall; "
          f"{len(events)} device events")
    for name, (us, n) in rows[:TOP]:
        print(f"  {us / 1e3:10.3f} ms  {us / max(dev_us, 1e-9):6.1%}  "
              f"x{n:<6d} {name[:90]}")
    # the port's own kernels (csrc/), whatever their rank
    ours = [(name, v) for name, v in rows if any(
        k in name for k in PORT_KERNELS)]
    for name, (us, n) in ours:
        print(f"  port kernel {us / 1e3:10.3f} ms  x{n:<6d} {name[:70]}")
    print(json.dumps({"prompts": prompts, "wall_ms": wall_s * 1e3,
                      "device_ms": dev_us / 1e3,
                      "busy_ms": busy_us / 1e3,
                      "busy_share": busy_us / 1e3 / (wall_s * 1e3),
                      "device_events": len(events),
                      "top": [{"name": n, "ms": v[0] / 1e3, "count": v[1]}
                              for n, v in rows[:TOP]],
                      "port_kernels": [{"name": n, "ms": v[0] / 1e3,
                                        "count": v[1]} for n, v in ours]}))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
