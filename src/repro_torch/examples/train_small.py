"""End-to-end training driver (port of the reference package's
``examples/train_small.py``): train a small llama-style model on the
synthetic-motif LM task and assert that the loss drops well below where
it started.  Exercises the data pipeline -> train step (remat, grad
clip) -> AdamW -> checkpoint -> restore.

    PYTHONPATH=src python -m repro_torch.examples.train_small --steps 200 \
        [--device cpu] [--ckpt-dir DIR]

The defaults are the reference's (yi-9b's architecture at 4 layers of
d_model 256, vocab 2048); pass ``--d-model 768 --layers 12`` for about
100M params.  The checkpoint goes to ``--ckpt-dir`` (default
``$TMPDIR/repro_train_small``, the reference's place).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import build_model
from repro_torch.training import checkpoint, optim
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.train_step import init_train_state, make_train_step


def run(*, steps: int = 200, d_model: int = 256, layers: int = 4,
        batch_size: int = 8, seq_len: int = 64, vocab: int = 2048,
        lr: float = 3e-3, device: DeviceLike = None, ckpt_dir: str = ""):
    """Train, checkpoint at step ``steps // 2`` and restore it into the
    final state's structure.  Returns (losses, state, restored, cfg)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(
        get_config("yi-9b"), name="yi-small", num_layers=layers,
        d_model=d_model, num_heads=max(4, d_model // 64), num_kv_heads=2,
        head_dim=64, d_ff=d_model * 3, vocab_size=vocab)
    model = build_model(cfg, dev)
    print(f"model: {cfg.name} {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.num_layers}L d{cfg.d_model})")
    opt = optim.OptConfig(lr=lr, warmup_steps=30)
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), opt)
    step_fn = make_train_step(model, opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=seq_len, batch_size=batch_size,
                                  seed=0, num_motifs=16))
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_train_small")
    losses = []
    t0 = time.time()
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch().items()}
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        if i % 20 == 0 or i == steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"({(time.time() - t0) / (i + 1):.2f} s/step)")
        if i == steps // 2:
            checkpoint.save(ckpt_dir, state, i)
    restored = checkpoint.restore(ckpt_dir, state)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(uniform floor {math.log(cfg.vocab_size):.2f})")
    return losses, state, restored, ckpt_dir


def main(argv: Optional[List[str]] = None) -> List[float]:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--vocab", type=int, default=2048)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--ckpt-dir", default="")
    args = p.parse_args(argv)
    losses, state, restored, ckpt_dir = run(
        steps=args.steps, d_model=args.d_model, layers=args.layers,
        batch_size=args.batch_size, seq_len=args.seq_len, vocab=args.vocab,
        lr=args.lr, device=args.device, ckpt_dir=args.ckpt_dir)
    pairs = zip(optim.leaves(state), optim.leaves(restored))
    if not all(a.shape == b.shape and a.dtype == b.dtype for a, b in pairs):
        raise AssertionError("the restored checkpoint's leaves differ in "
                             "shape or dtype")
    if not losses[-1] < losses[0] - 1.0:
        raise AssertionError(f"training did not learn: {losses[0]:.3f} -> "
                             f"{losses[-1]:.3f}")
    print("OK: model learned the synthetic distribution; checkpoint "
          f"round-trip at {ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
