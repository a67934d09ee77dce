"""A parallel prefix scan over one dim (port of ``jax.lax.associative_scan``).

The recursion is JAX's: combine adjacent pairs, scan the half-length
sequence, then fill in the even positions, with JAX's odd/even length
cases; so an elementwise ``fn`` gives JAX's results bit for bit when
JAX runs op by op (under ``jax.jit`` XLA may fuse a product and a sum
into one FMA, a last-bit difference).  Torch ops only (strided slices,
``torch.cat``, ``torch.stack``): it reads no value and branches on no
data, so it runs unchanged on CPU and CUDA tensors, under
``FakeTensorMode`` and under autograd, and issues O(log T) ops for a
sequence of length T.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

Elems = Tuple[torch.Tensor, ...]


def _slice(t: torch.Tensor, dim: int, start, stop=None, step=1):
    idx = [slice(None)] * t.dim()
    idx[dim] = slice(start, stop, step)
    return t[tuple(idx)]


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int):
    """[e0, o0, e1, o1, ...] along ``dim``; ``even`` may be one longer."""
    n = odd.shape[dim]
    pairs = torch.stack([_slice(even, dim, 0, n), odd], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat([out, _slice(even, dim, n)], dim=dim)
    return out


def associative_scan(fn: Callable[[Elems, Elems], Elems],
                     elems: Sequence[torch.Tensor], dim: int = 0) -> Elems:
    """Inclusive scan of ``fn`` over ``dim`` of every tensor in ``elems``
    (all of one length along ``dim``).  ``fn(earlier, later)`` takes and
    returns tuples like ``elems`` and must be associative."""
    elems = tuple(elems)
    dim = dim % elems[0].dim()

    def scan(elems: Elems) -> Elems:
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        reduced = fn(tuple(_slice(e, dim, 0, -1, 2) for e in elems),
                     tuple(_slice(e, dim, 1, None, 2) for e in elems))
        odd = scan(tuple(reduced))
        if n % 2 == 0:
            even = fn(tuple(_slice(e, dim, 0, -1) for e in odd),
                      tuple(_slice(e, dim, 2, None, 2) for e in elems))
        else:
            even = fn(odd, tuple(_slice(e, dim, 2, None, 2) for e in elems))
        even = [torch.cat([_slice(e, dim, 0, 1), r], dim=dim)
                for e, r in zip(elems, even)]
        return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))

    return scan(elems)
