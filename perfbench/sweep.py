"""Find a cell's knee: the highest offered rate at which the backlog does
not grow.  One process, one set-up, then an open-loop window at each rate
(from the cell's mix, its rate replaced), each followed by the drain.

    python3 perfbench/sweep.py --workload <cell> --rates 0.6,0.9,1.2 \\
        --seconds 25 --seed <n>

For each rate one JSON line: requests sent, those not complete when the
window closed (the backlog), the median latency of the first and the last
third of the requests in arrival order (growing when the backlog grows),
p50 and p95."""
import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    import torch
    from perfbench.lib import cells, harness
    from perfbench.lib.stats import percentile

    res = cells.resolve(args.workload)
    s = harness.setup(res, args.seed, torch.device("cuda", 0))
    harness.log(f"set-up {time.perf_counter() - T_START:.3f} s")
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            w = harness.measure(s, args.seconds, args.seed + 1 + i,
                                rate=rate)
            close = w.t0 + w.seconds
            lat = [r.latency for r in w.records]
            third = max(1, len(lat) // 3)
            print(json.dumps({
                "workload": args.workload, "rate": rate,
                "sent": len(w.records),
                "backlog_at_close": sum(1 for r in w.records
                                        if r.done is None or r.done > close),
                "failed": sum(1 for r in w.records if r.error is not None),
                "first_third_p50_ms": percentile(lat[:third], 50) * 1e3,
                "last_third_p50_ms": percentile(lat[-third:], 50) * 1e3,
                "p50_ms": percentile(lat, 50) * 1e3,
                "p95_ms": percentile(lat, 95) * 1e3}), flush=True)
    finally:
        s.system.stop()


if __name__ == "__main__":
    main()
