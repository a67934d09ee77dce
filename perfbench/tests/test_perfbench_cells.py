"""``BENCHMARK.json`` and the files it names: every cell resolves to a
configuration, a mix and a reader for each of its metrics, and the file
keeps to the benchmark's contract."""
import json
import math
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    texts = ([c[k] for c in b["configs"] for k in ("why", "source")]
             + [w["why"] for w in b["workloads"]]
             + [m["layer"] for m in b["per_layer"]])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts + b["command"])
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_seconds_fits_the_check():
    b = bench()
    T = b["run_seconds"]
    cells = 24
    assert 1 <= T <= 51
    assert (2 + 14 * cells) * (T + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves(cell):
    from perfbench.lib import cells, system, weights
    res = cells.resolve(cell)
    assert res["cell"]["chips"] in (1, 4)
    cfg, mix = res["config"], res["mix"]
    assert cfg["name"] == res["cell"]["config"]
    assert res["config_entry"]["file"].startswith("perfbench/configs/")
    assert mix["loop"] in ("open", "closed")
    for m in res["end_to_end"] + res["per_layer"]:
        r = cells.reader(m["name"])
        assert r.UNIT == m["unit"]
        if m in res["per_layer"]:
            assert r.MOVES == m["moves"]
    assert {m["name"] for m in res["end_to_end"]} >= {"setup_s"}
    assert len(res["end_to_end"]) >= 2 and res["per_layer"]
    # every leaf of the served tree has a weight rule, and no rule more
    paths = {p for p, _ in weights.flatten(system.meta_tree(cfg))}
    assert paths == set(cfg["weights"])
    assert isinstance(cfg["knee_req_per_s"], float)
    assert math.isfinite(cfg["check"]["gap_limit"])


def test_every_metric_has_a_reader_and_every_config_file_its_rules():
    """The files a cell would need exist for every metric named, and every
    configuration file (with a cell or not) gives each leaf of its served
    tree a weight rule."""
    from conftest import CONFIGS, resolve
    from perfbench.lib import system, weights
    b = bench()
    names = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    files = {p.stem for p in (ROOT / "perfbench" / "metrics").glob("*.py")}
    assert names <= files
    assert {p.stem for p in (ROOT / "perfbench" / "configs").glob(
        "*.json")} == set(CONFIGS)
    for c in CONFIGS:
        cfg = resolve(c)["config"]
        paths = {p for p, _ in weights.flatten(system.meta_tree(cfg))}
        assert paths == set(cfg["weights"])
