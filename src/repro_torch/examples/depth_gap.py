"""How the logits of the kernel path drift from the plain path with depth,
beside the plain path's own drift under a last-bit change of its weights.

For one arch at full width on the card (random weights from seed 0, 4
prompts x 256 tokens, cache 1024) and each depth of ``--depths`` (the
first layers of the same full-depth weights), prints the prefill logits'
relative error of

* the kernel path (``use_kernels=True``) against the plain path, and
* the plain path against itself with every float32 weight leaf scaled by
  1 + 2^-20 (:func:`nudge_f32`), the control: two correct runs that
  differ only in the last bits of their inputs,

in bfloat16 and float32.  Where the control grows with depth as fast as
the kernel's gap, the depth amplifies rounding; the kernel is then held to
the control, not to a fixed bar.

    PYTHONPATH=src python -m repro_torch.examples.depth_gap \
        [--arch rwkv6-1.6b] [--depths 1,2,4,8,16,24]

Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model

NUDGE = 1 + 2**-20


def nudge_f32(tree):
    """``tree`` with every float32 leaf scaled by 1 + 2^-20 (bf16 leaves,
    which such a change would round back, and integer leaves as they
    are)."""
    if isinstance(tree, dict):
        return {k: nudge_f32(v) for k, v in tree.items()}
    return tree * NUDGE if tree.dtype == torch.float32 else tree


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def gaps(cfg, params, toks, cache_len):
    """(kernel vs plain, plain vs nudged plain) prefill logits rel err of
    ``cfg`` on ``params``."""
    kern = build_model(dataclasses.replace(cfg, use_kernels=True),
                       device=toks.device)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=toks.device)
    batch = {"tokens": toks}
    base = plain.prefill(params, batch, cache_len)[0]
    return (rel_err(kern.prefill(params, batch, cache_len)[0], base),
            rel_err(plain.prefill(nudge_f32(params), batch, cache_len)[0],
                    base))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-1.6b", choices=ARCH_IDS)
    ap.add_argument("--depths", default="1,2,4,8,16,24")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    prompts, seq, cache_len = 4, 256, 1024
    toks = torch.randint(0, get_config(args.arch).vocab_size, (prompts, seq),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1)).to(dev)
    depths = [int(d) for d in args.depths.split(",")]
    for dtype in ("bfloat16", "float32"):
        full = dataclasses.replace(get_config(args.arch), dtype=dtype)
        params = build_model(full, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        for depth in depths:
            cut = dataclasses.replace(
                full, num_layers=min(depth, full.num_layers))
            kernel, control = gaps(cut, params, toks, cache_len)
            print(f"{args.arch} {dtype} {cut.num_layers} layers: kernel vs "
                  f"plain {kernel}, plain vs nudged plain {control}",
                  flush=True)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
