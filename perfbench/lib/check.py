"""Whether the timed path's answers are right.

Each request runs a prefill and ``steps`` greedy decode steps, so it
serves ``steps + 1`` tokens: the prefill's (position 0) and one a step.
Its answer holds the last token and the per-row KV cache, from which the
benchmark reads the served tokens back: layer 0's value vectors at the
slots the decode steps wrote are the value projections of the tokens fed
in (tokens 0 .. steps-1); each is identified as the vocabulary entry
whose projection lies nearest.  With the last token, every served token
is seen.

The plain float32 reference is then run over each sampled prompt and its
served tokens, and the number compared is the widest gap by which a
served token's reference logit lies below the reference's best at that
position (greedy decoding serves the best, up to rounding).

The control, the reference in float8 (``quant="fp8"``), is read the same
way: at each position of the same prompts and tokens, the gap of the
token float8 puts first."""
from __future__ import annotations

import importlib
from typing import Dict, Optional, Tuple

import torch

from perfbench.reference.common import f32_matmuls, mm, rmsnorm


def features(params: Dict, cfg: Dict, observe: Dict) -> torch.Tensor:
    """[V, F]: what each vocabulary entry looks like in the observed
    column (f32, from the served weights)."""
    if observe["kind"] != "values":
        raise ValueError(f"unknown observe kind {observe['kind']!r}")
    emb = params["embed"][:cfg["model"]["vocab_size"]]
    layer = observe["layer"]
    lp = params["blocks"]["0"]
    with f32_matmuls():
        h = rmsnorm(emb, lp["ln1"]["scale"][layer])
        return mm(h, lp["attn"]["wv"][layer])


def nearest(table: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Index of the row of ``table`` [V, F] nearest each row of ``obs``
    [M, F] (squared Euclidean distance)."""
    obs = obs.float().to(table.device)
    with f32_matmuls():
        d = (table * table).sum(1)[None] - 2.0 * obs @ table.T
    return d.argmin(dim=1)


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """best logit minus the token's, per row."""
    return logits.max(-1).values - logits.gather(
        -1, tokens.long()[..., None])[..., 0]


def teacher_forced(ref, params, cfg, prompts, served, quant=None,
                   block: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """All served tokens seen: prompts [N, S], served [N, steps+1].
    Returns (gaps [N, steps+1] of the served tokens, gaps of the tokens
    ``quant`` puts first, under float32) — the second only with quant."""
    N, S = prompts.shape
    n = served.shape[1]
    pos = list(range(S - 1, S - 1 + n))
    out, ctl = [], []
    for i in range(0, N, block):
        seq = torch.cat([prompts[i:i + block], served[i:i + block, :-1]], 1)
        lg = ref.logits_at(params, cfg, seq, pos)
        out.append(_gaps(lg, served[i:i + block]))
        if quant is not None:
            lq = ref.logits_at(params, cfg, seq, pos, quant=quant)
            ctl.append(_gaps(lg, lq.argmax(-1)))
            del lq
        del lg
    return torch.cat(out), (torch.cat(ctl) if quant is not None else None)


def judge(cfg: Dict, params: Dict, prompts: torch.Tensor,
          tok_last: torch.Tensor, observed: torch.Tensor, steps: int,
          limit: float, quant: Optional[str] = None) -> Dict[str, object]:
    """The check over the sampled requests: prompts [N, S] (on the
    device the reference runs on), their last served tokens [N] and the
    observed slices [N, k, F].  Returns ``gap`` (the widest over the
    sample), per-request ``gaps``, the served tokens as judged, and with
    ``quant`` the control's widest ``control_gap``."""
    ref = importlib.import_module(
        f"perfbench.reference.{cfg['check']['reference']}")
    observe = cfg["check"]["observe"]
    table = features(params, cfg, observe)
    N, k, F = observed.shape
    ids = nearest(table, observed.reshape(N * k, F)).reshape(N, k)
    del table
    dev = prompts.device
    tok_last = tok_last.to(dev).long()
    served = torch.cat([ids.to(dev), tok_last[:, None]], 1)
    gaps, ctl = teacher_forced(ref, params, cfg["model"], prompts, served,
                               quant=quant)
    out: Dict[str, object] = {"gaps": gaps.max(1).values, "served": served}
    out["gap"] = float(out["gaps"].max())
    if ctl is not None:
        out["control_gap"] = float(ctl.max())
    return out
