"""The one traffic generator.  A mix is a data file under
``perfbench/traffic/`` whose parameters this module reads:

* ``loop``: ``"open"`` (independent users send on a schedule, whatever the
  system does) or ``"closed"`` (``clients`` callers, each sending its next
  request when its last one has come back);
* ``load_of_knee``: for an open loop, the offered rate as a share of the
  configuration's measured knee (``knee_req_per_s`` in its file);
* ``prompt_len``: an int, or ``{"values": [...], "shares": [...]}``;
* ``decode_steps``: the decode stages each request runs after its prefill.

Every seed gets the same work in another order: the same number of
requests, the same multiset of prompt lengths and, for an open loop, the
same multiset of gaps between arrivals (the quantiles of the exponential
distribution, so the arrivals are Poisson-like), shuffled by the seed.
Runs of different seeds then differ by the order of the work, not by its
amount (the last request is due at the same time, after the largest gap,
whatever the order).
Token ids are drawn uniformly from the vocabulary."""
from __future__ import annotations

import math
import random
from typing import Dict, List, Sequence

import torch


def request_count(mix: Dict, rate: float, seconds: float) -> int:
    """Requests an open loop sends in ``seconds`` at ``rate``."""
    if mix["loop"] != "open":
        raise ValueError("only an open loop has a fixed request count")
    return max(2, round(rate * seconds))


def open_arrivals(n: int, seconds: float, seed: int) -> List[float]:
    """``n`` due times in [0, seconds): the first at 0, the last at
    ``seconds * (n - 1) / n``, the ``n - 1`` gaps between them the
    midpoint quantiles of an exponential distribution, scaled to that
    span and shuffled by ``seed``, except the largest, which comes last:
    whatever queue the order builds drains before the last request, so
    the time to the last answer does not hang on where the order puts a
    cluster of arrivals."""
    if n < 2:
        raise ValueError("an open loop needs at least two requests")
    m = n - 1
    gaps = [-math.log(1.0 - (i + 0.5) / m) for i in range(m)]
    scale = seconds * (n - 1) / n / sum(gaps)
    gaps = [g * scale for g in gaps]        # ascending
    last = gaps.pop()
    random.Random(seed).shuffle(gaps)
    gaps.append(last)
    due, t = [0.0], 0.0
    for g in gaps:
        t += g
        due.append(t)
    return due


def prompt_lengths(spec, n: int, seed: int) -> List[int]:
    """``n`` prompt lengths from ``spec`` (an int, or values with shares:
    the counts are the shares of ``n`` rounded, the last value taking what
    rounding leaves), in an order shuffled by ``seed``."""
    if isinstance(spec, int):
        return [spec] * n
    values, shares = spec["values"], spec["shares"]
    if len(values) != len(shares) or abs(sum(shares) - 1.0) > 1e-9:
        raise ValueError(f"bad prompt length spec {spec!r}")
    out: List[int] = []
    for v, s in zip(values[:-1], shares[:-1]):
        out += [int(v)] * round(s * n)
    out += [int(values[-1])] * (n - len(out))
    random.Random(seed ^ 0x5A5A).shuffle(out)
    return out


def distinct_lengths(spec) -> List[int]:
    return [spec] if isinstance(spec, int) else sorted(set(spec["values"]))


def prompts(lengths: Sequence[int], vocab: int, seed: int
            ) -> List[torch.Tensor]:
    """One int32 prompt per length, ids uniform in [0, vocab), drawn on
    the host from ``seed`` (a prompt is a few hundred ids; the host's
    generator gives the same ids on every machine)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, vocab, (L,), dtype=torch.int32, generator=g)
            for L in lengths]


def sample(n: int, k: int, seed: int) -> List[int]:
    """``k`` request indices of ``n`` (all of them when ``k >= n``),
    drawn from ``seed``, sorted."""
    if k >= n:
        return list(range(n))
    return sorted(random.Random(seed ^ 0xC0FFEE).sample(range(n), k))
