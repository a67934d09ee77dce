"""Readings for the limit of the correctness check, on the card: for each
seed, the cell's own set-up and a short window at the cell's own load,
then the check on the program's answers and on its control, the plain
reference computed with float8 operands in the program's place (the gap
of the token float8 puts first, at each position of the same prompts and
served tokens).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 15

One JSON line a seed: the widest gap of the program's served tokens
(``gap``) and of the control's (``control_gap``)."""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    import torch
    from perfbench.lib import cells, harness

    res = cells.resolve(args.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        s = harness.setup(res, seed, dev)
        try:
            w = harness.measure(s, args.seconds, seed)
        finally:
            s.system.stop()
        params = s.system.params
        del s.system
        gc.collect()
        torch.cuda.empty_cache()
        t_check = time.perf_counter()
        v = harness.judge(harness.Setup(res, seed, dev, None), w, params,
                          quant="fp8")
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "gap": v["checks"]["logit_gap"]["value"],
            "control_gap": v["control_gap"],
            "pos_errors": v["checks"]["pos_errors"]["value"],
            "failed": v["checks"]["failed"]["value"],
            "sampled": v["sampled"],
            "check_s": time.perf_counter() - t_check,
            "seed_s": time.perf_counter() - t}), flush=True)
        del params, w
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
