#!/usr/bin/env python3
"""Run phase 7 of ``chip_smoke.py`` ("plan": profile, propose, the
admission estimator, the SLO controller, a blue/green replan, a canary
drill and the planner) alone, on freshly initialised full-width bf16
48-layer yi-9b weights, without phases 3-6.

    python3 scripts/plan_phase.py [--rate R] [--p99-ms P] [--first-s F]

Phase 7 takes phase 5's one-worker batched req/s and p99 and phase 4's
first-call latency from the earlier phases; here they are arguments
(defaults: the numbers of ``PERF.md`` §5, one GPU worker).  Needs one
CUDA card; builds the kernels first.
"""
import argparse
import dataclasses
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, os.pardir))
sys.path.insert(0, os.path.join(HERE, os.pardir, "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=7.958,
                    help="phase 5's batched req/s on one GPU worker")
    ap.add_argument("--p99-ms", type=float, default=2009.8,
                    help="phase 5's batched p99 on one GPU worker")
    ap.add_argument("--first-s", type=float, default=1.42,
                    help="phase 4's first-call latency (sets the wedge "
                         "detector's limit)")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        print("plan_phase: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    build.build(verbose=False)
    cfg = dataclasses.replace(get_config("yi-9b"), use_kernels=True)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(cs.SEED))
    t0 = time.perf_counter()
    cs.phase_plan(torch, dev, model, params, args.first_s,
                  served={"batched": {"req_per_s": args.rate,
                                      "p99_ms": args.p99_ms}}, smi=smi)
    print(f"phase 7 took {time.perf_counter() - t0} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
