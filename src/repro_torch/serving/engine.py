"""Serving engine: prefill/decode with KV-cache management (port of the
reference package's ``serving/engine.py``).

This is the "black-box model operator" that Cloudflow dataflows wrap: a
``ServingEngine`` exposes ``generate`` (prefill + N decode steps) and the
``prefill``/``decode`` primitives.  Batching across requests is handled
one level up by the runtime's batching executor (paper §4: Batching) via
``repro_torch.serving.batcher``.

The reference jits its two primitives; PyTorch runs eagerly, so here they
call the model under ``torch.no_grad``.  Sampling draws from an explicit
``torch.Generator``: its numbers are not ``jax.random``'s, so only greedy
generation matches the reference token for token.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.registry import Model, build_model


@dataclasses.dataclass
class ServingEngine:
    model: Model
    cache_len: int = 256

    # --- public -----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch: Dict[str, Any],
                cache_len: Optional[int] = None):
        return self.model.prefill(params, batch,
                                  cache_len=cache_len or self.cache_len)

    @torch.no_grad()
    def decode(self, params, tokens, pos, cache):
        return self.model.decode_step(params, tokens, pos, cache)

    def generate(self, params, batch: Dict[str, Any], max_new_tokens: int,
                 *, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Greedy generation, or sampled at ``temperature`` > 0 when a
        ``generator`` is given.  ``batch["tokens"]`` [B, S] (and, for a
        vlm, ``batch["media"]`` [B, M, D]; for whisper,
        ``batch["frames"]`` [B, encoder_seq, D]) lie on the model's
        device; the prefill gets the whole batch.  Returns the new
        tokens, [B, max_new_tokens]."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache_len = max(self.cache_len, S + max_new_tokens)
        logits, cache = self.prefill(params, batch, cache_len=cache_len)
        out = []
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        for i in range(max_new_tokens):
            out.append(cur.cpu().numpy())
            pos = torch.full((B,), S + i, dtype=torch.int32,
                             device=tokens.device)
            logits, cache = self.decode(params, cur, pos, cache)
            if temperature > 0.0 and generator is not None:
                probs = torch.softmax(logits[:, -1].float() / temperature,
                                      dim=-1)
                cur = torch.multinomial(probs, 1, generator=generator).to(
                    torch.int32)
            else:
                cur = torch.argmax(logits[:, -1], dim=-1).to(
                    torch.int32)[:, None]
        return np.concatenate(out, axis=1)


def make_engine(cfg: ModelConfig, *, cache_len: int = 256,
                device: DeviceLike = None,
                long_context: bool = False) -> ServingEngine:
    """An engine for ``cfg`` on ``device`` (the CUDA device unless the
    caller names another)."""
    return ServingEngine(build_model(cfg, device, long_context=long_context),
                         cache_len=cache_len)
