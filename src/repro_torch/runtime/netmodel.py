"""Network cost model for the single-host runtime simulation.

The container is one machine, so inter-executor and executor<->KVS transfers
are *modeled*: each transfer sleeps latency + nbytes/bandwidth.  Benchmarks
state this explicitly (DESIGN.md §2).  ``scale=0`` disables all simulated
delays (unit tests).
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any

import numpy as np


@dataclasses.dataclass
class NetModel:
    latency_s: float = 0.5e-3          # per-hop latency (same-AZ RPC)
    bandwidth: float = 1.0e9           # bytes/s (8 Gbit NIC-ish)
    invoke_overhead_s: float = 1.0e-3  # per function invocation (FaaS RPC)
    scale: float = 1.0                 # 0 disables simulation

    def transfer_time(self, nbytes: int) -> float:
        return self.scale * (self.latency_s + nbytes / self.bandwidth)

    def charge(self, nbytes: int) -> float:
        t = self.transfer_time(nbytes)
        if t > 0:
            time.sleep(t)
        return t

    def charge_invoke(self) -> float:
        t = self.scale * self.invoke_overhead_s
        if t > 0:
            time.sleep(t)
        return t


def nbytes(obj: Any) -> int:
    """Estimate payload size of an intermediate result."""
    if obj is None:
        return 0
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if isinstance(obj, str):
        return len(obj.encode())
    if isinstance(obj, (int, float, bool)):
        return 8
    if isinstance(obj, dict):
        return sum(nbytes(k) + nbytes(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple, set)):
        return sum(nbytes(v) for v in obj)
    if hasattr(obj, "rows") and hasattr(obj, "schema"):   # Table
        return sum(nbytes(r.values) for r in obj.rows) + 64
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    return sys.getsizeof(obj)
