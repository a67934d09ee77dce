"""The import guard: no module of the JAX reproduction may be loaded in a
benchmark run.  Names are compared by their top-level package (the part
before the first dot), whole: ``repro_torch`` begins with ``repro`` and is
allowed."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The top-level names among ``names`` that are forbidden, sorted."""
    return sorted({n.split(".", 1)[0] for n in names}
                  & FORBIDDEN)


def clean(where: str) -> bool:
    """False, with the forbidden modules named on standard error, where
    any is loaded in this process now."""
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"perfbench: {where}, modules of the JAX reproduction are "
              f"loaded: {bad}", file=sys.stderr, flush=True)
        return False
    return True
