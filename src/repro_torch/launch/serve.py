"""Serving launcher: stand up a Cloudflow pipeline over a zoo model and
run batched requests through the serverless runtime (port of the
reference package's ``launch/serve.py``).

    text -> tokenize -> generate (``ServingEngine``: prefill + greedy
    decode, on a CPU executor with request batching) -> detok

``generate`` keeps the reference's placement (``gpu=False``): the
runtime's CPU executors call the engine, which runs the model on the
engine's device (the card unless the caller names the CPU).  A batch of
requests reaches ``generate`` one row at a time, as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.serve [--full] \
        [--arch yi-9b] [--requests 8] [--new-tokens 8]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_tiny_config
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import torch_dtype
from repro_torch.runtime.netmodel import NetModel
from repro_torch.runtime.runtime import Runtime
from repro_torch.serving.engine import ServingEngine, make_engine

#: prompt bytes per request (the reference's tokenizer pads or cuts to it)
PROMPT_LEN = 16


def serve_config(arch: str, tiny: bool = True):
    """The served config, with the attention kernels on (on the CPU their
    wrappers run the plain versions)."""
    cfg = get_tiny_config(arch) if tiny else get_config(arch)
    return dataclasses.replace(cfg, use_kernels=True)


def build_flow(arch: str, *, max_new_tokens: int = 8, batching: bool = True,
               tiny: bool = True, device: DeviceLike = None, params=None,
               cache_len: int = 128) -> Tuple[Dataflow, ServingEngine]:
    """The serving Dataflow and its engine on ``device``.  ``params`` (the
    model's) are drawn from a seeded generator on the device when not
    given."""
    dev = resolve_device(device)
    cfg = serve_config(arch, tiny)
    engine = make_engine(cfg, cache_len=cache_len, device=dev)
    if params is None:
        params = engine.model.init(
            torch.Generator(device=dev).manual_seed(0))
    dtype = torch_dtype(cfg.dtype)

    def tokenize(text: str) -> np.ndarray:
        toks = np.frombuffer(text.encode()[:PROMPT_LEN].ljust(PROMPT_LEN),
                             np.uint8)
        return toks.astype(np.int32) % cfg.vocab_size

    def generate(tokens: np.ndarray) -> np.ndarray:
        batch = {"tokens": torch.as_tensor(tokens, device=dev)[None]}
        if cfg.family == "vlm":
            batch["media"] = torch.zeros((1, cfg.num_media_tokens,
                                          cfg.d_model), dtype=dtype,
                                         device=dev)
        if cfg.family == "audio":
            batch["frames"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model),
                                          dtype=dtype, device=dev)
        return engine.generate(params, batch, max_new_tokens)[0]

    def detok(out: np.ndarray) -> str:
        return " ".join(str(int(t)) for t in out)

    flow = Dataflow([("text", str)])
    toks = flow.map(tokenize, names=["tokens"])
    gen = toks.map(generate, names=["out"], gpu=False, batching=batching)
    flow.output = gen.map(detok, names=["completion"])
    return flow, engine


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="yi-9b", choices=list(ARCH_IDS))
    p.add_argument("--full", action="store_true",
                   help="the full-width config (default: tiny)")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--new-tokens", type=int, default=8)
    args = p.parse_args(argv)
    dev = resolve_device()
    flow, _ = build_flow(args.arch, max_new_tokens=args.new_tokens,
                         tiny=not args.full, device=dev)
    # a full-width request can outlast the wedge detector's default 5 s
    rt = Runtime(n_cpu=2, net=NetModel(scale=0.0), hang_timeout_s=120.0,
                 device=dev)
    try:
        flow.deploy(rt, fusion=True)
        t0 = time.time()
        futs = [flow.execute(Table([("text", str)], [(f"request {i}",)]))
                for i in range(args.requests)]
        for i, f in enumerate(futs):
            r = f.result(timeout=600)
            print(f"req {i}: {r.to_dicts()[0]['completion']}")
        dt = time.time() - t0
        print(f"{args.requests} requests in {dt:.2f}s "
              f"({args.requests / dt:.1f} req/s) on "
              f"{torch.cuda.get_device_name(dev)}")
    finally:
        rt.stop()


if __name__ == "__main__":
    main()
