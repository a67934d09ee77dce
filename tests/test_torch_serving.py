"""The port's plain serving and observability modules against the
reference package's, on the same inputs: histogram quantiles and window
rates, fault draws, retry delays, token-bucket and admission decisions on
one fake clock, metric-key strings, Chrome export and attribution of the
same scripted traces, and the Batcher's results and close/drain
behaviour.  Every comparison is exact: these modules do no arithmetic
that the two packages could order differently.
"""
import dataclasses
import random
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.obs as r_obs  # noqa: E402
import repro.serving.admission as r_adm  # noqa: E402
import repro.serving.batcher as r_bat  # noqa: E402
import repro.serving.faults as r_flt  # noqa: E402
import repro.serving.retry as r_rty  # noqa: E402
import repro_torch.obs as t_obs  # noqa: E402
import repro_torch.serving.admission as t_adm  # noqa: E402
import repro_torch.serving.batcher as t_bat  # noqa: E402
import repro_torch.serving.faults as t_flt  # noqa: E402
import repro_torch.serving.retry as t_rty  # noqa: E402
from repro.core import lowering as r_low  # noqa: E402
from repro_torch.core import lowering as t_low  # noqa: E402

PAIRS = {"reference": (r_obs, r_adm, r_bat, r_flt, r_rty, r_low),
         "port": (t_obs, t_adm, t_bat, t_flt, t_rty, t_low)}


def _both(fn):
    """``fn(obs, adm, bat, flt, rty, low)`` on each package; asserts the
    two results are equal and returns the port's."""
    got = {k: fn(*mods) for k, mods in PAIRS.items()}
    assert got["port"] == got["reference"]
    return got["port"]


# -- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["lognormal", "uniform", "constant"])
def test_histogram_quantiles_and_merge_match(dist):
    rng = np.random.default_rng(3)
    vals = {"lognormal": rng.lognormal(-6, 2, 2000),
            "uniform": rng.uniform(1e-7, 200.0, 2000),
            "constant": np.full(50, 0.0125)}[dist].tolist()

    def run(obs, *_):
        a, b = obs.Histogram(), obs.Histogram()
        for i, v in enumerate(vals):
            (a if i % 3 else b).record(v)
        merged = a.snapshot().merge(b.snapshot())
        ps = (0, 1, 50, 90, 99, 99.9, 100)
        return ([a.percentile(p) for p in ps],
                [merged.percentile(p) for p in ps],
                merged.summary(), a.mean, merged.counts)

    qs = _both(run)[1]
    assert qs == sorted(qs)


def test_windowed_counter_counts_and_rates_match():
    stamps = np.sort(np.random.default_rng(5).uniform(0, 30, 3000)).tolist()

    def run(obs, *_):
        c = obs.WindowedCounter(slot_s=0.25, horizon_s=10.0)
        for t in stamps:
            c.note(t)
        return [(c.count(w, now), c.rate(w, now))
                for now in (5.0, 17.3, 30.0) for w in (0.5, 1.0, 7.5)]

    _both(run)


# -- fault injection and retry ------------------------------------------------

def test_fault_injector_draws_match_per_executor():
    ids = [("cpu-exec-0", "cpu"), ("gpu-exec-1", "gpu"),
           ("gpu-exec-2", "gpu"), ("cpu-rsvd-exec-3", "cpu")]

    def run(_o, _a, _b, flt, *_):
        plan = (flt.FaultPlan(seed=7)
                .crash(rate=0.05, limit=3, classes=("gpu",))
                .hang(rate=0.1, hang_s=0.3)
                .transient(rate=0.2, limit=25))
        inj = flt.FaultInjector(plan)
        seq = []
        for k in range(400):
            eid, cls = ids[(k * 7) % len(ids)]
            spec = inj.draw(eid, cls)
            seq.append(None if spec is None else
                       (spec.kind, spec.hang_s, spec.classes))
        return seq, inj.snapshot(), str(inj.transient_error("gpu-exec-1"))

    seq, counts, _ = _both(run)
    assert counts["crash"] == 3 and counts["transient"] == 25


def test_retry_policy_delays_match():
    errors = ["TransientFault", "ExecutorLost", "Permanent",
              "ConnectionError", "ValueError"]

    def run(_o, _a, _b, _f, rty, *_):
        def err(name):
            return getattr(rty, name, None) or {
                "ConnectionError": ConnectionError,
                "ValueError": ValueError}[name]
        rng = random.Random(11)
        out = []
        for pol in (rty.RetryPolicy(), rty.RetryPolicy(
                max_attempts=5, base_s=0.01, multiplier=3.0, cap_s=0.2,
                jitter=0.0)):
            for attempt in range(5):
                for name in errors:
                    for deadline in (None, 100.02, 100.001):
                        out.append(pol.next_delay(
                            attempt, err(name)("e"), 100.0,
                            deadline_t=deadline, rng=rng))
        return out

    delays = _both(run)
    assert any(d is not None for d in delays)
    assert any(d is None for d in delays)


# -- admission on one fake clock ----------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for m in (r_adm, t_adm):
        monkeypatch.setattr(m, "_mono", c)
    return c


def _decision(d):
    return (d.action, d.klass, d.reason, d.estimate_s, d.deadline_s,
            None if d.degrade is None else dataclasses.asdict(d.degrade))


def test_token_bucket_decisions_match(clock):
    gaps = np.random.default_rng(2).exponential(0.08, 300).tolist()

    def run(_o, adm, *_):
        clock.t = 1000.0
        tb = adm.TokenBucket(rate=10.0, burst=3)
        out = []
        for g in gaps:
            clock.t += g
            out.append(tb.try_take())
        return out

    got = _both(run)
    assert 0 < sum(got) < len(got)


def test_admission_decisions_match(clock):
    """Rate limits, the queue-depth penalty (no estimator: depth times
    ``queue_cost_s`` or the 1 ms floor), degrade-not-shed, unknown
    classes and hedge offers, on a scripted arrival sequence."""
    rng = np.random.default_rng(9)
    script = [(float(rng.exponential(0.02)),
               ["interactive", "batch", "best_effort", "mystery",
                None][int(rng.integers(5))],
               [None, 0.5, 0.004, 0.0005][int(rng.integers(4))],
               int(rng.integers(0, 12)), bool(rng.integers(0, 6) == 0))
              for _ in range(400)]

    def run(_o, adm, _b, _f, _r, low):
        clock.t = 1000.0
        depth = [0]
        classes = adm.default_classes()
        classes["batch"] = adm.ClassPolicy("batch", priority=1, rate=4.0,
                                           burst=3)
        classes["best_effort"] = adm.ClassPolicy(
            "best_effort", priority=0, rate=6.0, burst=2,
            degrade=low.DegradePolicy(bucket_cap=4))
        gates = [adm.AdmissionController(classes=dict(classes),
                                         queue_depth_fn=lambda: depth[0]),
                 adm.AdmissionController(queue_depth_fn=lambda: depth[0],
                                         queue_cost_s=0.0003)]
        out = []
        for gap, klass, deadline, d, hedge in script:
            clock.t += gap
            depth[0] = d
            for g in gates:
                if hedge:
                    out.append(g.note_hedge(klass, deadline_s=deadline))
                else:
                    out.append(_decision(g.admit(klass, deadline)))
        return out, [sorted(g.snapshot().items()) for g in gates]

    out, _ = _both(run)
    actions = {o[0] for o in out if isinstance(o, tuple)}
    reasons = {o[2] for o in out if isinstance(o, tuple)}
    assert actions == {"admit", "degrade", "shed"}
    assert {"ok", "rate_limit", "queue_depth"} <= reasons


def test_admission_with_plan_and_profile_is_not_ported():
    """The estimator gate needs profiling/ (ROADMAP §4.3): the port
    refuses a plan + profile instead of admitting everything."""
    with pytest.raises(NotImplementedError, match="4.3"):
        t_adm.AdmissionController(plan=object(), profile=object())
    gate = t_adm.AdmissionController(plan=object())
    with pytest.raises(NotImplementedError, match="4.3"):
        gate.update(profile=object())
    # one of the two alone is what the reference runs without a model
    assert gate.admit("interactive", 0.1).action == "admit"


# -- metric keys --------------------------------------------------------------

def test_metric_key_strings_match():
    def run(obs, *_):
        k = obs.keys
        out = [k.DAG_SERIES, k.BATCH_SERIES, k.ADMISSION_SERIES,
               k.GATE_EVENTS, k.FAULT_KINDS, k.FAULT_REQUEUED,
               k.REPLAN_ROLLBACK]
        out += [k.dag("d/x", s) for s in k.DAG_SERIES]
        for dag in ("", "cascade"):
            p = k.batch_prefix(dag, "cascade/0:vjit[a,b]")
            out += [p] + [k.batch(p, s) for s in k.BATCH_SERIES]
        out += [k.admission("d", "batch", s) for s in k.ADMISSION_SERIES]
        out += [k.gate_counter("best_effort", e) for e in k.GATE_EVENTS]
        out += [k.fault(f) for f in k.FAULT_KINDS]
        probes = ["dag/a/latency_s", "dag/a/b/hedge_t", "dag/a/nope",
                  "batch/n/size", "batch/d/n/expired_t",
                  "admission/d/k/shed_t", "admission/d/k/x/shed_t",
                  "faults/crash_t", "faults/hang_t", "faults/requeued_t",
                  "replan/rollback", "other"]
        out += [k.known_key(p) for p in probes]
        for bad in (lambda: k.dag("d", "nope"),
                    lambda: k.batch("p", "nope"),
                    lambda: k.admission("d", "k", "nope"),
                    lambda: k.gate_counter("k", "nope"),
                    lambda: k.fault("hang")):
            with pytest.raises(ValueError):
                bad()
        return out

    _both(run)


# -- traces: Chrome export and attribution ------------------------------------

def _scripted_traces(obs):
    """The same traces on each package's Tracer: a batched pair sharing
    one batch span, a retried request, a hedged one, a shed one, and a
    control-plane event.  Trace ids are pinned (each package counts its
    own)."""
    tr = obs.Tracer(sample_rate=1.0)
    n = "d/0:vjit[f]"
    specs = [
        (10.0, 10.9, None, [("admission", 10.0, 10.0, None, {}),
                            (f"queue@{n}", 10.0, 10.2, None,
                             {"batch_size": 2}),
                            (f"exec@{n}", 10.2, 10.8, 7,
                             {"queue_s": 0.1, "exec_s": 0.4}),
                            (f"demux@{n}", 10.8, 10.85, None, {"rows": 1})]),
        (10.1, 10.9, 0.5, [("admission", 10.1, 10.1, None, {}),
                           (f"queue@{n}", 10.1, 10.2, None, {}),
                           (f"exec@{n}", 10.2, 10.8, 7,
                            {"queue_s": 0.1, "exec_s": 0.4,
                             "copies": {"stacks": 1}}),
                           (f"demux@{n}", 10.8, 10.9, None, {})]),
        (11.0, 12.0, 0.2, [("admission", 11.0, 11.001, None, {}),
                           (f"requeue@{n}", 11.3, 11.3, None,
                            {"executor": "gpu-exec-2"}),
                           (f"retry@{n}", 11.4, 11.4, None,
                            {"attempt": 1}),
                           (f"exec@{n}", 11.001, 11.9, None,
                            {"queue_s": 0.05, "exec_s": 0.3,
                             "executors": ("a", "b")})]),
        (12.0, 12.5, None, [(f"hedge_launch@{n}", 12.1, 12.1, None, {}),
                            (f"cancelled@{n}", 12.4, 12.4, None, {}),
                            (f"exec@{n}", 12.0, 12.45, None,
                             {"queue_s": 0.0, "exec_s": 0.2})]),
        (13.0, 13.0, None, [("admission", 13.0, 13.0, None,
                             {"action": "shed", "obj": object})]),
    ]
    traces = []
    for i, (t0, t1, deadline, spans) in enumerate(specs):
        t = tr.start("d", "interactive", t0)
        t.trace_id = 100 + i
        t.deadline_s = deadline
        for name, a, b, link, attrs in spans:
            t.span(name, a, b, link=link, **attrs)
        if i == 3:
            t.hedged = True
        t.finish(shed=i == 4, shed_reason="rate_limit" if i == 4 else None,
                 slo_miss=i == 2)
        t.t1 = t1
        traces.append(t)
    batches = [tr.record_batch(n, 10.2, 10.8, 7, size=2, bucket=2)]
    control = [tr.control_event("scale@f", 10.5, action="replica_add"),
               tr.control_event("replan@d", 11.0, 11.5, phase="swap")]
    return tr, traces, batches, control


def test_chrome_events_and_attribution_match(tmp_path):
    def run(obs, *_):
        tr, traces, batches, control = _scripted_traces(obs)
        events = obs.to_chrome_events(traces, batches, control)
        path = tmp_path / f"trace-{obs.__name__}.json"
        n = obs.export_chrome(tr, str(path))
        att = obs.attribute(traces)
        miss = obs.attribute(traces, slo_only=True)
        return (events, n, att.to_dict(), miss.to_dict(), att.table(),
                [t.to_dict() for t in traces])

    events, n, att, *_ = _both(run)
    assert n == len(events) and att["dominant"] is not None


# -- the Batcher --------------------------------------------------------------

def _batcher_run(bat):
    """One deterministic script: the first batch holds the flush thread
    while the rest queue (some past their deadline, some out of
    deadline order), then a second hold during which ``close()`` drains
    the queue.  Returns what every item, the batch fn and ``on_drop``
    saw."""
    gate, entered = threading.Event(), threading.Event()
    seen, dropped = [], []

    def fn(args):
        seen.append(list(args))
        if args[0] in ("a0", "b0"):
            entered.set()
            assert gate.wait(10)
        if "boom" in args:
            raise ValueError("boom in batch")
        return [f"{a}!" for a in args]

    b = bat.Batcher(fn, max_batch=3, max_wait_ms=5.0, adaptive_wait=False,
                    on_drop=lambda a, e: dropped.append(
                        (a, type(e).__name__)))
    now = time.perf_counter()
    first = b.submit("a0")
    assert entered.wait(10)
    items = [first]
    for name, dl in [("late1", now - 1), ("x3", now + 300),
                     ("x1", now + 100), ("x2", now + 200),
                     ("late2", now - 2), ("boom", None), ("y", None),
                     ("z", now + 50)]:
        items.append(b.submit(name, deadline_t=dl))
    entered.clear()
    gate.set()
    for it in items:
        assert it.event.wait(10)
    # second phase: hold the flush thread, queue more, close meanwhile
    gate.clear()
    hold = b.submit("b0")
    assert entered.wait(10)
    queued = [b.submit(f"q{i}") for i in range(4)]
    closer = threading.Thread(target=b.close)
    closer.start()
    while not b._stop:
        time.sleep(0.001)
    gate.set()
    closer.join(10)
    assert not closer.is_alive() and hold.event.wait(10)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("after")

    def outcome(it):
        if it.error is not None:
            return (it.args, type(it.error).__name__, str(it.error))
        return (it.args, it.result)

    return ([outcome(i) for i in items + [hold] + queued], seen, dropped,
            b.expired, b.reorders, b.batch_sizes, b.pending(),
            b.quiescent(), b.q.empty())


def test_batcher_results_and_close_drain_match():
    got = _both(lambda _o, _a, bat, *_: _batcher_run(bat))
    outcomes, seen, dropped, expired = got[:4]
    assert expired == 2 and len(dropped) == 2 + 4
    assert seen[1] == ["x1", "x3"]               # EDF within the batch


@pytest.mark.parametrize("cut", ["before_dispatch", "call_timeout"])
def test_batcher_expiry_and_call_timeout_match(cut):
    """``call`` with a deadline already passed fails typed before
    dispatch; a ``call`` whose batch outlasts its timeout claims the
    item, and the accepted-minus-completed count returns to zero."""
    def run(_o, _a, bat, *_):
        release = threading.Event()

        def fn(args):
            if cut == "call_timeout":
                release.wait(10)
            return [a * 2 for a in args]

        b = bat.Batcher(fn, max_batch=4, max_wait_ms=1.0)
        try:
            if cut == "before_dispatch":
                err = None
                try:
                    b.call(3, deadline_t=time.perf_counter() - 1)
                except Exception as e:
                    err = (type(e).__name__, str(e))
                return err, b.expired, b.call(4), b.pending()
            with pytest.raises(TimeoutError):
                b.call(3, timeout=0.05)
            release.set()
            out = b.call(5)
            return out, b.pending(), b.quiescent()
        finally:
            release.set()
            b.close()

    _both(run)
