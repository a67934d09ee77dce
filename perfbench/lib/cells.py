"""Find a cell's pieces by name.  ``BENCHMARK.json`` names each cell's
configuration and traffic mix, and each metric; the files are

* ``perfbench/configs/<config name>.json`` (the ``file`` of its entry),
* ``perfbench/traffic/<traffic>.json``,
* ``perfbench/metrics/<metric name>.py``: a reader with ``UNIT``,
  ``MOVES`` (per-layer metrics) and ``read(ctx)``.

A cell reports the end-to-end metrics whose ``workloads`` list it (or that
have none) and, in a traced run, the per-layer metrics whose
``workloads`` list it (or, without the key, that move an end-to-end
metric it reports)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]


def benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def reader(name: str, root: Path = ROOT):
    """The reader module of metric ``name``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict, cell: str, e2e: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e if "moves" in metric else True


def resolve(name: str, root: Path = ROOT) -> Dict:
    """Everything a run of cell ``name`` needs: the cell entry, its
    configuration and mix (parsed), and its metrics' entries."""
    b = benchmark(root)
    cells = {w["name"]: w for w in b["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in b["configs"]}
    entry = configs[cell["config"]]
    with open(root / entry["file"]) as f:
        cfg = json.load(f)
    with open(root / "perfbench" / "traffic" / f"{cell['traffic']}.json") \
            as f:
        mix = json.load(f)
    e2e = [m for m in b["end_to_end"] if _applies(m, name, [])]
    names = [m["name"] for m in e2e]
    layer = [m for m in b["per_layer"] if _applies(m, name, names)]
    return {"cell": cell, "config_entry": entry, "config": cfg, "mix": mix,
            "end_to_end": e2e, "per_layer": layer}
