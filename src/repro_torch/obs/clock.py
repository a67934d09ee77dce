"""The one clock for rate-window timestamps.

Every ``*_t`` metric series (arrival, shed, fault, retry, ... timestamps)
is windowed by readers against ``now() - window_s``.  That only works if
the WRITER and the READER use the same clock: a series recorded with
wall-clock ``time.time()`` (epoch seconds, steppable by NTP) windowed
against a ``time.monotonic()``/``perf_counter`` anchor is off by ~50
years and reads as permanently empty — rates silently stick at zero.

``now()`` is the process-wide monotonic timestamp every rate-window
writer and reader must use.  It is ``time.perf_counter`` (monotonic,
highest available resolution); the indirection exists so the choice is
made exactly once and the audit is a grep for ``time.time()`` /
``perf_counter()`` in metric paths.
"""
from __future__ import annotations

import time

#: seconds on the process-wide monotonic clock.  NOT epoch time: values
#: are only comparable within one process, which is all a rate window
#: ever compares.
now = time.perf_counter
