"""Training launcher (port of the reference package's ``launch/train.py``):
train a zoo model on the synthetic-motif LM data with the config's
optimizer, on the card unless the caller names another device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --tiny \
        --steps 50 [--device cpu]

The vlm's ``media`` and whisper's ``frames`` are zeros, as in the
reference.  The model runs its plain composition (``use_kernels`` as the
config has it, False for every zoo config): the port's kernels have no
backward.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_tiny_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import torch_dtype
from repro_torch.models.registry import build_model
from repro_torch.training import checkpoint, optim
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.train_step import (State, init_train_state,
                                             make_train_step)


def run(arch: str, *, tiny: bool = True, steps: int = 50,
        batch_size: int = 8, seq_len: int = 64, lr: float = 1e-3,
        ckpt_dir: str = "", log_every: int = 10, seed: int = 0,
        device: DeviceLike = None) -> Tuple[List[float], State]:
    """Train ``steps`` steps; returns (per-step losses, final state)."""
    dev = resolve_device(device)
    cfg = get_tiny_config(arch) if tiny else get_config(arch)
    model = build_model(cfg, dev)
    opt_cfg = optim.OptConfig(name=cfg.optimizer, lr=lr, warmup_steps=20)
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(seed), opt_cfg)
    step_fn = make_train_step(model, opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                  batch_size=batch_size, seed=seed))
    extras = {}
    dtype = torch_dtype(cfg.dtype)
    if cfg.family == "vlm":
        extras["media"] = torch.zeros(
            (batch_size, cfg.num_media_tokens, cfg.d_model), dtype=dtype,
            device=dev)
    if cfg.family == "audio":
        extras["frames"] = torch.zeros(
            (batch_size, cfg.encoder_seq, cfg.d_model), dtype=dtype,
            device=dev)
    losses = []
    t0 = time.time()
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch().items()}
        batch.update(extras)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    if ckpt_dir:
        path = checkpoint.save(ckpt_dir, state, steps)
        print("saved", path)
    return losses, state


def main(argv: Optional[List[str]] = None) -> List[float]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    p.add_argument("--tiny", action="store_true", default=True)
    p.add_argument("--full", dest="tiny", action="store_false")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    losses, _ = run(args.arch, tiny=args.tiny, steps=args.steps,
                    batch_size=args.batch_size, seq_len=args.seq_len,
                    lr=args.lr, ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
