"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic
mix and metrics are found by name from ``BENCHMARK.json``.  The last line
of standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number the correctness check compared beside its limit;
the same numbers end standard error.  Exits non-zero with no result
without enough CUDA devices, or when a module of the JAX reproduction is
loaded after set-up or at exit (once the metrics and the check are
done, just before the result would be printed).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (this package) and the program; not this folder,
# whose subfolders would shadow top-level module names
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(ROOT / "build" / sub)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from perfbench.lib import cells, harness

    res = cells.resolve(args.workload)
    need = res["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"perfbench: cell {args.workload} needs {need} CUDA "
              f"device(s), {have} found", file=sys.stderr)
        return 2
    harness.log(f"card: {card_line()}; torch {torch.__version__}")
    out = harness.run(res, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START, guard=harness.clean)
    return harness.emit(out)


if __name__ == "__main__":
    sys.exit(main())
