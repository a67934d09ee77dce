"""The system under test, built from the program's public APIs alone: one
prefill ``ModelOp`` and ``decode_steps`` applications of one decode
``ModelOp`` (``repro_torch.models.registry.model_stage_op``), each with
the ``gpu`` and ``batching`` hints, added by ``Dataflow.apply_op``;
``compile_flow(..., fusion=True)`` fuses them into one batched chain;
``repro_torch.runtime.Runtime`` serves it with the configuration's
``serving`` settings, and every request goes through the deployment's
``execute`` (``Runtime.call_dag``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from perfbench.lib import weights


@dataclasses.dataclass
class System:
    model_cfg: Any          # the program's ModelConfig
    params: Dict[str, Any]  # the weights the benchmark drew
    runtime: Any
    deployment: Any
    chain: Any              # the lowered chain (BatchedJittedFuse)
    node: str               # its runtime node name

    def stop(self) -> None:
        self.runtime.stop()


def model_config(cfg: Dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(source=cfg["source"], **cfg["model"])


def meta_tree(cfg: Dict):
    """The weight tree the served model declares, as meta tensors."""
    from repro_torch.models import build_model
    mcfg = model_config(cfg)
    return build_model(mcfg, device="meta").mod.init_params(mcfg, None,
                                                            "meta")


def build(cfg: Dict, mix: Dict, seed: int, device: torch.device,
          tracer=None, params: Optional[Dict[str, Any]] = None,
          name: str = "perfbench") -> System:
    from repro_torch.core.compiler import compile_flow
    from repro_torch.core.dataflow import Dataflow
    from repro_torch.models import build_model
    from repro_torch.models.registry import model_stage_op
    from repro_torch.runtime import NetModel, Runtime

    mcfg = model_config(cfg)
    model = build_model(mcfg, device=device)
    if params is None:
        params = weights.draw(meta_tree(cfg), cfg["weights"], seed, device)
    srv = cfg["serving"]
    kw = dict(model_name=mcfg.name, cache_len=srv["cache_len"],
              measure=False)
    pre = model_stage_op(model, params, "prefill", **kw)
    dec = model_stage_op(model, params, "decode", **kw)
    flow = Dataflow([("tokens", torch.Tensor)])
    node = flow.apply_op(pre, gpu=True, batching=True)
    for _ in range(mix["decode_steps"]):
        node = node.apply_op(dec, gpu=True, batching=True)
    flow.output = node
    rt_kw = {} if tracer is None else {"tracer": tracer}
    rt = Runtime(n_gpu=srv["n_gpu"], max_batch=srv["max_batch"],
                 batch_wait_ms=srv["batch_wait_ms"],
                 hang_timeout_s=srv["hang_timeout_s"],
                 net=NetModel(scale=0.0), device=device, **rt_kw)
    try:
        dep = compile_flow(flow, rt, fusion=True, name=name)
    except BaseException:
        rt.stop()
        raise
    chain = dep.plan.ops[-1].op
    return System(mcfg, params, rt, dep, chain, dep.function_names[0])
