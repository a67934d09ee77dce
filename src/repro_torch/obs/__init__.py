"""Observability of the port: so far only THE clock for rate-window
timestamps (:mod:`repro_torch.obs.clock`).  Tracing, histograms and
attribution are not ported yet."""
from repro_torch.obs.clock import now

__all__ = ["now"]
