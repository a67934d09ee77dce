"""What a metric's reader is handed: the run's requests and, in a traced
run, the chain's dispatches and requests as the runtime's spans record
them and the device trace of the traced part of the window."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from perfbench.lib.profile import Dispatch, Profile
from perfbench.lib.window import Record


@dataclasses.dataclass
class Context:
    cfg: Dict                    # the configuration's file
    mix: Dict                    # the traffic mix's file
    prompt_len: int              # the mix's (single) prompt length
    n_params: int                # parameters of the served weights
    t0: float                    # the window's start, host clock
    seconds: float               # the window's length
    setup_s: float               # process start to the first request
    records: List[Record]        # every request of the window
    #: the chain's dispatches, and each request's (queue_s, exec_s, end)
    #: at the chain, that ended before the traced part of the window
    dispatches: List[Dispatch] = dataclasses.field(default_factory=list)
    request_spans: List[tuple] = dataclasses.field(default_factory=list)
    profile: Optional[Profile] = None
    #: host time at which the profiler began to start (traced runs)
    traced_from: Optional[float] = None

    @property
    def steps(self) -> int:
        return self.mix["decode_steps"]

    @property
    def model(self) -> Dict:
        return self.cfg["model"]

    def tokens_per_request(self) -> int:
        """Tokens a request runs through the model: its prompt and the
        tokens fed to its decode steps."""
        return self.prompt_len + self.steps

    def untraced_latencies(self) -> List[float]:
        """Latencies of every request of an untraced run; in a traced one,
        of the requests due at least 5 s before the profiler started (a
        request due later may wait behind work the profiler slows)."""
        if self.traced_from is None:
            return [r.latency for r in self.records]
        return [r.latency for r in self.records
                if r.due < self.traced_from - 5.0]

    def requests_done_in_profile(self) -> int:
        p = self.profile
        return sum(1 for r in self.records if r.done is not None
                   and r.error is None and p.start <= r.done < p.stop)
