"""The traced run's device trace: ``torch.profiler`` over a steady part of
the window, on the card and on every host thread, reduced to what the
per-layer readers and the ``breakdown`` need.

Times are moved onto the host clock of the runtime's spans by a marker
event recorded at a known host time.  Each kernel and copy is tied to the
host call that launched it (the CUDA runtime or driver call with the same
correlation id), and through its time to the chain dispatch whose
execution made that call, so a kernel that runs after its dispatch has
returned (a per-row dispatch returns at launch) is still counted for it.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: host calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
MARK = "perfbench.mark"


@dataclasses.dataclass
class Dispatch:
    """One execution of the chain, from the runtime's spans: its host
    interval on the executor, the requests it served and its padded row
    count."""
    start: float
    end: float
    rows: int
    bucket: int
    exec_s: float
    queue_s: float


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    dispatch: Optional[int]      # index into Profile.dispatches

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Profile:
    start: float                 # the traced window, host clock
    stop: float
    kernels: List[DeviceOp]
    copies: List[DeviceOp]       # memcpy and memset
    launches: int                # kernel launch calls on the host
    host_names: List[str]        # host-side ops and runtime calls
    host_start: np.ndarray
    host_end: np.ndarray
    dispatches: List[Dispatch]   # those that began inside the window

    @property
    def window_s(self) -> float:
        return self.stop - self.start

    def busy(self) -> List[Tuple[float, float]]:
        """The union of kernel and copy intervals inside the window."""
        ivs = sorted((max(o.start, self.start), min(o.end, self.stop))
                     for o in self.kernels + self.copies
                     if o.end > self.start and o.start < self.stop)
        out: List[Tuple[float, float]] = []
        for a, b in ivs:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> List[Tuple[float, float]]:
        edges = [self.start] + [x for iv in self.busy() for x in iv] + [
            self.stop]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def gap_name(self, a: float, b: float) -> str:
        """The host op or runtime call that overlapped [a, b] longest (the
        shortest such when several cover it alike)."""
        if not len(self.host_start):
            return "host: nothing traced"
        ov = np.minimum(self.host_end, b) - np.maximum(self.host_start, a)
        if ov.max() <= 0:
            return "host: nothing traced"
        best = ov.max()
        cand = np.nonzero(ov >= best * 0.999)[0]
        i = cand[np.argmin((self.host_end - self.host_start)[cand])]
        return self.host_names[i]


def start():
    """Start the profiler on the card and every host thread; returns
    (profiler, host time of the marker)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   **kw)
    prof.__enter__()
    t_mark = time.perf_counter()
    with record_function(MARK):
        pass
    return prof, t_mark


def stop(prof) -> None:
    prof.__exit__(None, None, None)


def reduce(prof, t_mark: float, window: Tuple[float, float],
           dispatches: Sequence[Dispatch]) -> Profile:
    """Reduce a stopped profiler's events (see the module docstring);
    ``dispatches`` are the chain's dispatches in host-clock order."""
    events = prof.profiler.kineto_results.events()
    offset = None
    for e in events:
        if e.name() == MARK:
            offset = e.start_ns() * 1e-9 - t_mark
            break
    if offset is None:
        raise RuntimeError("the profiler recorded no marker event")
    inside = [d for d in dispatches if window[0] <= d.start < window[1]]
    d_start = [d.start for d in inside]

    def which(t: float) -> Optional[int]:
        i = bisect.bisect_right(d_start, t) - 1
        if i >= 0 and t <= inside[i].end:
            return i
        return None

    launch_at: Dict[int, float] = {}
    host: List[Tuple[str, float, float]] = []
    dev: List[Tuple[str, float, float, int]] = []
    n_launch = 0
    for e in events:
        t0 = e.start_ns() * 1e-9 - offset
        t1 = t0 + e.duration_ns() * 1e-9
        if str(e.device_type()).endswith("CUDA"):
            dev.append((e.name(), t0, t1, e.correlation_id()))
            continue
        name = e.name()
        if name == MARK:
            continue
        if name in LAUNCH_CALLS:
            n_launch += 1
        if name.startswith("cu"):
            launch_at[e.correlation_id()] = t0
        host.append((name, t0, t1))
    kernels, copies = [], []
    for name, t0, t1, corr in dev:
        at = launch_at.get(corr)
        op = DeviceOp(name, t0, t1, which(at) if at is not None else None)
        (copies if name.startswith(("Memcpy", "Memset")) else
         kernels).append(op)
    return Profile(window[0], window[1], kernels, copies, n_launch,
                   [h[0] for h in host],
                   np.array([h[1] for h in host], dtype=np.float64),
                   np.array([h[2] for h in host], dtype=np.float64),
                   list(inside))


def breakdown(p: Profile, top: int = 10) -> Dict[str, list]:
    """The device ops that took most time in the window, and its longest
    idle gaps, each named by what the host was doing."""
    by: Dict[str, float] = {}
    for o in p.kernels + p.copies:
        by[o.name] = by.get(o.name, 0.0) + o.seconds
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(p.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[p.gap_name(a, b)[:200], b - a]
                          for a, b in gaps]}
