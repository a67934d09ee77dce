"""The whole run, the card's look aside, on tiny configurations on the CPU:
``correct`` holds for the program as it is and falls when the timed path
is broken underneath, once for each fault a serving cell can have:

* a decode step that returns its state unchanged;
* half of a batch left out, the rest given the mean of the computed rows;
* a token altered where it is produced (the prefill's);
* answers handed to the wrong requests (a batch's rows reversed).

(The exchange between chips has no fault to plant: no cell spans chips.)
"""
import time

import pytest
import torch

from conftest import CONFIGS, MIXES, tiny
from perfbench.lib import harness



def _state_unchanged(real):
    def decode_step(self, params, tokens, pos, cache):
        logits, _ = real(self, params, tokens, pos, cache)
        return logits, {k: v.clone() for k, v in cache.items()}
    return decode_step


def _half_batch(real):
    def decode_step(self, params, tokens, pos, cache):
        B = tokens.shape[0]
        if B < 2:
            return real(self, params, tokens, pos, cache)
        h = B // 2
        # cache leaves are stacked over layers: the batch is dim 1
        part = {k: v[:, :h] for k, v in cache.items()}
        lg, new = real(self, params, tokens[:h], pos[:h], part)
        lg = torch.cat([lg, lg.mean(0, keepdim=True).expand(B - h, -1, -1)])
        out = {k: torch.cat([new[k], cache[k][:, h:]], 1) for k in cache}
        return lg, out
    return decode_step


def _token_altered(real):
    def prefill(self, params, batch, cache_len):
        logits, cache = real(self, params, batch, cache_len)
        return logits.roll(1, dims=-1), cache
    return prefill


def _rows_reversed(real):
    def prefill(self, params, batch, cache_len):
        lg, cache = real(self, params, batch, cache_len)
        return lg.flip(0), {k: v.flip(1) for k, v in cache.items()}
    return prefill


FAULTS = {"state_unchanged": ("decode_step", _state_unchanged),
          "half_batch": ("decode_step", _half_batch),
          "token_altered": ("prefill", _token_altered),
          "rows_reversed": ("prefill", _rows_reversed)}


def _run(config, traffic):
    # an open loop in a dense burst, so that batches of several rows form
    res = tiny(config, traffic, load=60.0, sample=64)
    return harness.run(res, 2 ** 31 + 77, 0.5, False, torch.device("cpu"),
                       time.perf_counter())


@pytest.mark.parametrize("traffic", MIXES)
@pytest.mark.parametrize("config", CONFIGS)
def test_sound_run_is_correct(config, traffic):
    out = _run(config, traffic)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 12
    assert set(out["metrics"]) == {"throughput", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("traffic", MIXES)
@pytest.mark.parametrize("config", CONFIGS)
def test_fault_is_caught(config, traffic, fault, monkeypatch):
    from repro_torch.models.registry import Model
    name, make = FAULTS[fault]
    monkeypatch.setattr(Model, name, make(getattr(Model, name)))
    out = _run(config, traffic)
    assert not out["correct"], out["checks"]


def test_closed_loop_of_one_client():
    """A closed-loop mix (the next request once the last is answered)
    runs through the same harness: one request in flight at a time."""
    res = tiny("yi-9b", "closed6", sample=4)
    res["mix"]["clients"] = 1
    out = harness.run(res, 5, 0.5, False, torch.device("cpu"),
                      time.perf_counter())
    assert out["correct"] and out["attempted"] >= 2 and out["failed"] == 0


def test_traced_run_reports_per_layer_metrics():
    """``--trace 1`` drives the same run under the profiler and reports
    the per-layer metrics it finds (on the CPU the device ones read an
    empty device) with the window's busy and traced seconds."""
    from perfbench.lib import cells
    res = tiny("yi-9b", sample=4)
    res["per_layer"] = cells.resolve("yi9b-poisson")["per_layer"]
    out = harness.run(res, 3, 2.0, True, torch.device("cpu"),
                      time.perf_counter())
    assert out["correct"]
    assert {"batch_rows", "dispatch_ms", "step_mfu"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    assert list(out)[-1] == "checks"
