"""The one choice between each kernel and its plain version for a decoder
layer's ops (``models/layer_ops.py``), on the CPU.

* The table: ``use_kernels`` x a mesh or none x rmsnorm or layernorm x
  ``kv_quant`` gives each field of the record its kernel wrapper or its
  plain version; without a mesh a decode step of tiny deepseek-moe-16b
  on fake tensors calls exactly the wrappers the record holds (the
  static verifier's walk: no kernel is built).
* The plain decode steps read the RoPE table that ``rope_table`` keeps:
  two steps build it once, with a ring in the model's dtype and with
  ``kv_quant``'s int8 ring.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.kernels import build, glue, moe as kmoe  # noqa: E402
from repro_torch.models import (build_model, layer_ops, layers,  # noqa: E402
                                 transformer)
from repro_torch.models.partition import AxisInfo  # noqa: E402

#: each field's (kernel wrapper, plain version)
FIELDS = {
    "add_norm": (glue.add_rmsnorm, glue.add_rmsnorm_plain),
    "rope": (glue.rope, glue.rope_plain),
    "ring_write": (layer_ops.ring_write, layer_ops.ring_write_plain),
    "gated_act": (glue.gated_act, glue.gated_act_plain),
    "attention": (layer_ops.flash_attention, layers.chunked_attention),
    "decode_attention": (layer_ops.decode_attention, layers.decode_attention),
    "moe_route": (kmoe.moe_route, kmoe.moe_route_plain),
    "moe_permute": (kmoe.moe_permute, kmoe.moe_permute_plain),
    "moe_act": (glue.gated_act, glue.gated_act_plain),
    "moe_combine": (kmoe.moe_combine, kmoe.moe_combine_plain),
}
#: the wrappers a decode step calls for each field that holds its kernel
DECODE_CALLS = {"add_norm": "add_rmsnorm", "ring_write": "rope_cache_write",
                "gated_act": "gated_act", "decode_attention":
                "decode_attention", "moe_route": "moe_route",
                "moe_permute": "moe_permute", "moe_act": "gated_act",
                "moe_combine": "moe_combine"}


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_the_table_gives_each_field_its_kernel_or_plain_version(
        use_kernels, mesh, norm, kv_quant):
    cfg = dataclasses.replace(get_tiny_config("deepseek-moe-16b"),
                              use_kernels=use_kernels, norm=norm,
                              kv_quant=kv_quant)
    ops = layer_ops.layer_ops(cfg, AxisInfo(mesh=None) if mesh else None)
    kernel = dict.fromkeys(("attention", "decode_attention"), use_kernels)
    kernel.update(dict.fromkeys(layer_ops.GLUE, use_kernels and not mesh
                                and norm == "rmsnorm" and not kv_quant))
    kernel.update(dict.fromkeys(layer_ops.MOE, use_kernels and not mesh))
    assert set(kernel) == set(FIELDS) == {
        f.name for f in dataclasses.fields(ops)}
    for name, (wrapper, plain) in FIELDS.items():
        want = wrapper if kernel[name] else plain
        if name == "ring_write" and kv_quant:
            want = layer_ops.ring_write_int8
        if name == "add_norm" and norm == "layernorm":
            want = layer_ops.add_layernorm_plain
        assert getattr(ops, name) is want, name
    if mesh:
        return
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 8)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
            build.abstract_calls() as calls:
        fake = {k: mode.from_tensor(v) for k, v in cache.items()}
        model.decode_step(params, torch.zeros((2, 1), dtype=torch.int32),
                          torch.full((2,), 3, dtype=torch.int32), fake)
    want = {w for f, w in DECODE_CALLS.items() if kernel[f]}
    assert {name for name, _ in calls} == want


@pytest.mark.parametrize("kv_quant", [False, True])
def test_two_plain_decode_steps_build_the_rope_table_once(monkeypatch,
                                                          kv_quant):
    builds = []
    frequencies = layers.rope_frequencies

    def counting(*args, **kwargs):
        builds.append(args)
        return frequencies(*args, **kwargs)

    monkeypatch.setattr(layers, "rope_frequencies", counting)
    monkeypatch.setattr(transformer, "_ROPE_TABLES", {})
    cfg = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32",
                              kv_quant=kv_quant)
    assert not cfg.use_kernels and cfg.num_layers > 1
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 8)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for p in (0, 1):
        _, cache = model.decode_step(params, tok, torch.full(
            (2,), p, dtype=torch.int32), cache)
    assert builds == [(cfg.head_dim, cfg.rope_theta)]
