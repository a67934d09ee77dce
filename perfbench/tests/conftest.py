"""Shared pieces of the benchmark's own tests.  They run on the CPU at tiny
sizes (``python -m pytest perfbench/tests`` from the repo root); what needs
the card carries the ``cuda`` marker and skips without one."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

torch = pytest.importorskip("torch")

#: the tiny shapes of each configuration's family (every width cut; the
#: structure of the weight tree and of the cache kept)
TINY = {
    "dense": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                  head_dim=32, d_ff=384, vocab_size=512),
}


def resolve(config: str, traffic: str = "poisson"):
    """A run's pieces for a configuration and a mix named by their files,
    whether or not ``BENCHMARK.json`` has their cell, with the benchmark's
    end-to-end metrics."""
    import json
    from perfbench.lib import cells
    with open(ROOT / "perfbench" / "configs" / f"{config}.json") as f:
        cfg = json.load(f)
    with open(ROOT / "perfbench" / "traffic" / f"{traffic}.json") as f:
        mix = json.load(f)
    return {"cell": {"name": f"{config}.{traffic}", "config": config,
                     "traffic": traffic, "chips": 1},
            "config": cfg, "mix": mix,
            "end_to_end": cells.benchmark()["end_to_end"], "per_layer": []}


#: every configuration file, cell or not
CONFIGS = ["yi-9b"]


#: every traffic mix file
MIXES = sorted(p.stem for p in (ROOT / "perfbench" / "traffic").glob(
    "*.json"))


def tiny(config: str, traffic: str = "poisson", *, dtype="float32",
         limit=1e-3, load=8.0, prompt_len=16, steps=4, sample=8):
    """Configuration ``config`` under mix ``traffic`` (an open loop at
    ``load`` requests a second), cut to a tiny model on the CPU."""
    res = copy.deepcopy(resolve(config, traffic))
    cfg = res["config"]
    cfg["model"].update(TINY[cfg["model"]["family"]], dtype=dtype)
    cfg["serving"]["cache_len"] = 64
    if res["mix"]["loop"] == "open":
        cfg["knee_req_per_s"] = load / res["mix"]["load_of_knee"]
    cfg["check"].update(gap_limit=limit, sample=sample)
    res["mix"].update(prompt_len=prompt_len, decode_steps=steps)
    return res


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
