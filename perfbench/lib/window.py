"""Drive a deployment with a mix's requests and record when each answer is
complete.

A request is complete when its answer is on the host or, where the
program hands back device tensors, when the device has finished the work
queued for it: the future's callback records a CUDA event at that point
of the stream, and a timing thread waits for the events in order and
reads the host clock as each completes.  A second thread then reads what
the benchmark keeps of each answer (the served token and position, and
the slice the correctness check reads, a few KB) and drops the rest, so
answers do not pile up in memory.  Neither thread blocks the program's
own threads.

Latency is taken from when a request was due, not when it was sent, so a
late generator adds to the latency it measures; the lateness is reported
apart."""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import torch


@dataclasses.dataclass
class Record:
    idx: int
    due: float                       # absolute, host clock
    sent: Optional[float] = None
    done: Optional[float] = None
    error: Optional[str] = None
    tok: Optional[int] = None
    pos: Optional[int] = None
    observed: Optional[torch.Tensor] = None
    finished: threading.Event = dataclasses.field(
        default_factory=threading.Event)     # set once read

    @property
    def latency(self) -> float:
        if self.error is not None or self.done is None:
            return float("inf")
        return self.done - self.due


def observer(spec: Dict, prompt_len: int, steps: int) -> Callable:
    """What the check reads of an answer, by the configuration's
    ``check.observe``: layer ``layer``'s cache slots of the decode steps'
    inputs (positions prompt_len .. prompt_len+steps-1) in column
    ``column`` (kind ``values``, a KV cache)."""
    if spec["kind"] != "values":
        raise ValueError(f"unknown observe kind {spec['kind']!r}")
    col = 2 + int(spec["column"].lstrip("c"))
    layer = spec["layer"]

    def read(values):
        v = values[col][layer, prompt_len:prompt_len + steps]
        return v.reshape(steps, -1)
    return read


class Collector:
    """Completion times and kept answers (see the module docstring)."""

    def __init__(self, observe: Callable, cuda: bool):
        self.observe = observe
        self.cuda = cuda
        self._timing: "queue.Queue" = queue.Queue()
        self._reading: "queue.Queue" = queue.Queue()
        self._threads = [threading.Thread(target=self._time_loop,
                                          daemon=True),
                         threading.Thread(target=self._read_loop,
                                          daemon=True)]
        for t in self._threads:
            t.start()

    def on_done(self, rec: Record, fut) -> None:
        """The future's callback, on the program's thread."""
        ev = None
        if self.cuda:
            # a blocking event: the timing thread sleeps until it completes
            # instead of spinning on a core the program's threads need
            ev = torch.cuda.Event(blocking=True)
            ev.record()
        else:
            rec.done = time.perf_counter()
        self._timing.put((rec, fut, ev))

    def _time_loop(self):
        while True:
            item = self._timing.get()
            if item is None:
                self._reading.put(None)
                return
            rec, fut, ev = item
            if ev is not None:
                ev.synchronize()        # sleeps, with the GIL released
                rec.done = time.perf_counter()
            self._reading.put((rec, fut))

    def _read_loop(self):
        while True:
            item = self._reading.get()
            if item is None:
                return
            rec, fut = item
            try:
                row = fut.result().rows[0]
                rec.tok = int(row.values[0])
                rec.pos = int(row.values[1])
                rec.observed = self.observe(row.values).to("cpu",
                                                           copy=True)
            except BaseException as e:        # the request failed
                rec.error = f"{type(e).__name__}: {e}"
            del fut, item
            rec.finished.set()

    def close(self):
        self._timing.put(None)
        for t in self._threads:
            t.join(timeout=60)


def submit(deployment, prompt: torch.Tensor, rec: Record,
           collector: Collector) -> None:
    from repro_torch.core.table import Table
    table = Table([("tokens", torch.Tensor)], [(prompt,)])
    rec.sent = time.perf_counter()
    try:
        fut = deployment.execute(table)
    except BaseException as e:
        rec.error = f"{type(e).__name__}: {e}"
        rec.finished.set()
        return
    fut.add_done_callback(lambda f, r=rec: collector.on_done(r, f))


def open_loop(deployment, prompts: List[torch.Tensor], due: List[float],
              t0: float, collector: Collector) -> List[Record]:
    """Send request i at ``t0 + due[i]`` whatever came back before."""
    recs = [Record(i, t0 + d) for i, d in enumerate(due)]
    for rec, p in zip(recs, prompts):
        wait = rec.due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        submit(deployment, p, rec, collector)
    return recs


def closed_loop(deployment, next_prompt: Callable[[int], torch.Tensor],
                clients: int, t0: float, seconds: float,
                collector: Collector) -> List[Record]:
    """``clients`` callers, each sending its next request once its last
    answer is complete, until ``t0 + seconds``; a request is due when it
    is sent."""
    recs: List[Record] = []
    lock = threading.Lock()

    def client():
        while time.perf_counter() < t0 + seconds:
            with lock:
                rec = Record(len(recs), time.perf_counter())
                recs.append(rec)
                prompt = next_prompt(rec.idx)
            submit(deployment, prompt, rec, collector)
            rec.finished.wait()

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return recs


def wait_all(recs: List[Record], deadline: float) -> int:
    """Wait until every record is read or ``deadline`` passes; returns how
    many never completed."""
    missing = 0
    for rec in recs:
        if not rec.finished.wait(max(0.0, deadline - time.perf_counter())):
            missing += 1
    return missing
