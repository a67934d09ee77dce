"""Assigned input shapes (public-pool assignment; see system DESIGN.md §5)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# Architectures allowed to run long_500k (sub-quadratic serving path);
# everything else is skipped with a DESIGN.md §5 note.
LONG_CONTEXT_OK = {"rwkv6-1.6b", "recurrentgemma-2b", "gemma2-9b"}
