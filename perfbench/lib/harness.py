"""One run of a cell: set-up, the measured window, the check, the metrics.

``run.py`` drives it for the benchmark; ``sweep.py`` and ``calibrate.py``
reuse its steps on the card; the tests drive it on the CPU at tiny sizes.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from perfbench.lib import cells, check, profile, system, traffic, weights
from perfbench.lib.guard import clean
from perfbench.lib import window as win
from perfbench.lib.context import Context
from perfbench.lib.profile import Dispatch

#: the traced part of a traced run's window: PROFILE_S seconds (or half
#: the window if shorter) from the profiler's first marker.  Starting it
#: stalls the process for some seconds, so it begins PROFILE_LEAD_S early
#: and the traced part ends near the window's close; the span metrics are
#: read from the dispatches that ended before it began.  (A profiler
#: started and stopped once in set-up starts fast later, but its second
#: session lost every kernel in some runs.)
PROFILE_S = 8.0
PROFILE_LEAD_S = 6.0
#: how long after the window's close an answer may still come
DRAIN_S = 60.0
#: the seed stream of the warm-up's prompts, apart from the window's
WARM_SEED = 0x3A3A3A


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Setup:
    res: Dict                  # cells.resolve()
    seed: int
    device: torch.device
    system: system.System
    tracer: object = None

    @property
    def cfg(self) -> Dict:
        return self.res["config"]

    @property
    def mix(self) -> Dict:
        return self.res["mix"]


def rate_of(cfg: Dict, mix: Dict) -> float:
    return mix["load_of_knee"] * cfg["knee_req_per_s"]


def setup(res: Dict, seed: int, device: torch.device, *,
          trace: bool = False, params=None) -> Setup:
    """Weights from the seed, the deployment, and every batch bucket the
    traffic can fill run twice through the deployment itself."""
    tracer = None
    if trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer(sample_rate=1.0, capacity=1 << 17,
                        batch_capacity=1 << 17)
    cfg, mix = res["config"], res["mix"]
    t = time.perf_counter()
    if params is None:
        params = weights.draw(system.meta_tree(cfg), cfg["weights"], seed,
                              device)
        sync(device)
    log(f"weights drawn in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    s = Setup(res, seed, device, system.build(cfg, mix, seed, device,
                                              tracer=tracer, params=params),
              tracer)
    log(f"deployment compiled in {time.perf_counter() - t:.3f} s")
    try:
        warm(s)
    except BaseException:
        s.system.stop()
        raise
    return s


def warm(s: Setup) -> None:
    """Submit each bucket's worth of requests at once (the batcher merges
    them into one dispatch of that bucket), twice, for every prompt
    length of the mix, and wait for the answers."""
    from repro_torch.core.table import Table
    vocab = s.cfg["model"]["vocab_size"]
    for rnd in range(2):
        for L in traffic.distinct_lengths(s.mix["prompt_len"]):
            for b in s.cfg["serving"]["buckets"]:
                t = time.perf_counter()
                ps = traffic.prompts([L] * b, vocab, WARM_SEED + b)
                futs = [s.system.deployment.execute(
                    Table([("tokens", torch.Tensor)], [(p,)])) for p in ps]
                for f in futs:
                    int(f.result(600).rows[0].values[0])
                log(f"warm round {rnd} length {L} bucket {b}: "
                    f"{time.perf_counter() - t:.3f} s")


class GcPauses:
    """How long each of Python's full (generation 2) garbage collections
    took while it is open: a pause of every thread of the process."""

    def __init__(self):
        self.seconds: List[float] = []
        self._t = 0.0
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.seconds.append(time.perf_counter() - self._t)

    def close(self):
        gc.callbacks.remove(self._on)


@dataclasses.dataclass
class Window:
    t0: float
    seconds: float
    records: List[win.Record]
    prompts: List[torch.Tensor]
    #: (profiler, host time its start began, of its marker, of its stop)
    profile_raw: Optional[tuple] = None


def measure(s: Setup, seconds: float, seed: int, *,
            rate: Optional[float] = None, trace: bool = False) -> Window:
    """The measured window: the mix's requests from ``seed`` (an open loop
    at ``rate``, the cell's own by default), then up to DRAIN_S for the
    last answers.  With ``trace`` the device trace covers a steady part
    of the window."""
    cfg, mix = s.cfg, s.mix
    vocab = cfg["model"]["vocab_size"]
    observe = win.observer(cfg["check"]["observe"],
                           traffic.distinct_lengths(mix["prompt_len"])[-1],
                           mix["decode_steps"])
    col = win.Collector(observe, s.device.type == "cuda")
    if s.tracer is not None:
        s.tracer.clear()
    out: Dict[str, object] = {}
    if mix["loop"] == "open":
        r = rate if rate is not None else rate_of(cfg, mix)
        n = traffic.request_count(mix, r, seconds)
        due = traffic.open_arrivals(n, seconds, seed)
        lengths = traffic.prompt_lengths(mix["prompt_len"], n, seed)
        prompts = traffic.prompts(lengths, vocab, seed)
        log(f"open loop: {n} requests at {r:.4f} req/s over {seconds} s")
        t0 = time.perf_counter() + 0.05

        def gen():
            out["recs"] = win.open_loop(s.system.deployment, prompts, due,
                                        t0, col)
    elif mix["loop"] == "closed":
        lengths = traffic.prompt_lengths(mix["prompt_len"], 1 << 14, seed)
        g = torch.Generator().manual_seed(seed)
        prompts = []

        def next_prompt(i):
            p = torch.randint(0, vocab, (lengths[i % len(lengths)],),
                              dtype=torch.int32, generator=g)
            prompts.append(p)
            return p
        t0 = time.perf_counter() + 0.05

        def gen():
            out["recs"] = win.closed_loop(s.system.deployment, next_prompt,
                                          mix["clients"], t0, seconds, col)
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    pauses = GcPauses()
    th = threading.Thread(target=gen, daemon=True)
    th.start()
    raw = None
    if trace:
        dur = min(PROFILE_S, seconds * 0.5)
        begin = max(t0 + 0.2 * seconds, t0 + seconds - dur - PROFILE_LEAD_S)
        time.sleep(max(0.0, begin - time.perf_counter()))
        t_begin = time.perf_counter()
        prof, t_mark = profile.start()
        log(f"profiler started in {t_mark - t_begin:.3f} s")
        time.sleep(max(0.0, t_mark + dur - time.perf_counter()))
        t_stop = time.perf_counter()
        profile.stop(prof)
        raw = (prof, t_begin, t_mark, t_stop)
    th.join()
    recs = out["recs"]
    missing = win.wait_all(recs, t0 + seconds + DRAIN_S)
    col.close()
    pauses.close()
    log(f"full garbage collections in the window: {len(pauses.seconds)}, "
        f"{sum(pauses.seconds) * 1e3:.1f} ms in all, the longest "
        f"{max(pauses.seconds, default=0.0) * 1e3:.1f} ms")
    if missing:
        log(f"{missing} requests had no answer {DRAIN_S} s after the close")
    log("latencies ms, in arrival order: " + " ".join(
        f"{r.latency * 1e3:.0f}" for r in recs))
    late = [r.sent - r.due for r in recs if r.sent is not None]
    if late:
        log(f"generator lateness: mean {sum(late) / len(late) * 1e3:.3f} "
            f"ms, max {max(late) * 1e3:.3f} ms over {len(late)} requests")
    return Window(t0, seconds, recs, prompts, raw)


def dispatches(s: Setup):
    """(the chain's dispatches in host-clock order, each request's
    (queue_s, exec_s, end of its dispatch)) from the kept traces of the
    window."""
    node = s.system.node
    groups: Dict[int, list] = {}
    per_req = []
    for tr in s.tracer.kept(s.system.deployment.dag.name):
        for sp in tr.spans:
            if sp.name == f"exec@{node}" and "exec_s" in sp.attrs:
                groups.setdefault(sp.link, []).append(sp)
                q = sp.attrs.get("queue_s", 0.0)
                per_req.append((q, sp.attrs["exec_s"],
                                sp.t0 + q + sp.attrs["exec_s"]))
    buckets = {b.link: b.attrs.get("bucket") for b in
               s.tracer.batch_spans(set(groups))}
    out = []
    for link, sps in groups.items():
        sp = sps[0]
        start = sp.t0 + sp.attrs.get("queue_s", 0.0)
        rows = sp.attrs.get("batch", len(sps))
        out.append(Dispatch(start, start + sp.attrs["exec_s"], rows,
                            buckets.get(link) or rows, sp.attrs["exec_s"],
                            sp.attrs.get("queue_s", 0.0)))
    out.sort(key=lambda d: d.start)
    return out, per_req


def judge(s: Setup, w: Window, params, quant: Optional[str] = None
          ) -> Dict[str, object]:
    """The correctness check (``lib/check.py``) over a sample drawn from
    the seed of the requests that completed (with one of the longest
    prompts in it), and the numbers compared beside their limits."""
    cfg, mix = s.cfg, s.mix
    steps = mix["decode_steps"]
    ok = [r for r in w.records if r.error is None and r.done is not None
          and r.observed is not None]
    failed = len(w.records) - len(ok)
    idx = traffic.sample(len(ok), cfg["check"]["sample"], s.seed)
    if ok:
        longest = max(range(len(ok)), key=lambda i: len(w.prompts[ok[i].idx]))
        if longest not in idx:
            idx = sorted(idx[:-1] + [longest])
    picked = [ok[i] for i in idx]
    limit = cfg["check"]["gap_limit"]
    gap, ctl = 0.0, None
    by_len: Dict[int, list] = {}
    for r in picked:
        by_len.setdefault(len(w.prompts[r.idx]), []).append(r)
    for L, rs in sorted(by_len.items()):
        prompts = torch.stack([w.prompts[r.idx] for r in rs]).to(s.device)
        j = check.judge(cfg, params, prompts,
                        torch.tensor([r.tok for r in rs]),
                        torch.stack([r.observed for r in rs]), steps, limit,
                        quant=quant)
        gap = max(gap, j["gap"])
        log(f"gaps of the sampled requests of length {L}, widest first: "
            + " ".join(f"{g:.4f}" for g in sorted(
                j["gaps"].tolist(), reverse=True)[:8]))
        if quant is not None:
            ctl = max(ctl or 0.0, j["control_gap"])
    pos_err = sum(1 for r in ok
                  if r.pos != len(w.prompts[r.idx]) + steps)
    checks = {"logit_gap": {"value": gap, "limit": limit},
              "pos_errors": {"value": pos_err, "limit": 0},
              "failed": {"value": failed, "limit": 0}}
    out = {"checks": checks, "sampled": len(picked),
           "correct": bool(picked) and all(
               c["value"] <= c["limit"] for c in checks.values())}
    if ctl is not None:
        out["control_gap"] = ctl
    return out


def run(res: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        guard: Callable[[str], bool] = lambda where: True
        ) -> Optional[Dict]:
    """One run of the cell ``res`` (``cells.resolve``): returns the result
    line's object, or None where ``guard`` refused the run."""
    s = setup(res, seed, device, trace=trace)
    try:
        if not guard("after set-up"):
            return None
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s")
        w = measure(s, seconds, seed, trace=trace)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        disp, per_req = dispatches(s) if trace else ([], [])
    finally:
        s.system.stop()
    params = s.system.params
    n_params = weights.count(params)
    del s.system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx = Context(res["config"], res["mix"],
                  traffic.distinct_lengths(res["mix"]["prompt_len"])[-1],
                  n_params, w.t0, seconds, setup_s, w.records, disp, per_req)
    dev: Dict[str, object] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak)}
    result: Dict[str, object] = {}
    if trace:
        prof, t_begin, t_mark, t_stop = w.profile_raw
        ctx.dispatches = [d for d in disp if d.end < t_begin]
        ctx.request_spans = [r for r in per_req if r[2] < t_begin]
        ctx.traced_from = t_begin
        t = time.perf_counter()
        ctx.profile = profile.reduce(prof, t_mark, (t_mark, t_stop), disp)
        del prof
        p = ctx.profile
        log(f"trace reduced in {time.perf_counter() - t:.3f} s: "
            f"{len(p.kernels)} kernels, {len(p.copies)} copies, "
            f"{p.launches} launches, {len(p.dispatches)} dispatches, "
            f"{sum(k.dispatch is None for k in p.kernels)} kernels tied to "
            f"none")
        dev["busy_s"] = p.busy_s()
        dev["window_s"] = p.window_s
        result["breakdown"] = profile.breakdown(p)
        wanted = res["per_layer"]
    else:
        wanted = res["end_to_end"]
    metrics = {}
    for m in wanted:
        v = cells.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    verdict = judge(Setup(res, seed, device, None), w, params)
    checks = verdict["checks"]
    out = {"correct": verdict["correct"], "attempted": len(w.records),
           "failed": checks["failed"]["value"], "metrics": metrics,
           "device": dev}
    out.update(result)
    out["checks"] = checks
    return out


def emit(out: Optional[Dict]) -> int:
    """Print a run's result as the last line of standard output, each
    number compared beside its limit ending standard error; the exit
    code.  Nothing is printed where the run was refused or where a module
    of the JAX reproduction is loaded now, after the metrics' readers and
    the check have run."""
    if out is None or not clean("at exit"):
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
