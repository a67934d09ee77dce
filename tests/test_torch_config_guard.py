"""The port's transformer reads every config field the reference's
dense model reads.

For each field the reference's dense model reads (``kv_quant``,
``local_global_pattern``, ``post_norms`` and the MoE fields
``num_experts`` and ``moe_layer_period``), the reference's layout, cache
or parameter tree on tiny yi-9b changes when the field is set, and the
port's equals the reference's with the field set.  A config of a family
the transformer does not serve (ssm, hybrid, audio) raises
``NotImplementedError`` in ``block_layout``, ``init_cache`` and ``init``.
The reference side is shape-only (``jax.eval_shape``): nothing runs.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_tiny_config as jax_tiny  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402

#: (field overrides, what of the reference's model they change)
PORTED = [
    ({"kv_quant": True}, "cache"),
    ({"local_global_pattern": 2, "sliding_window": 4}, "layout"),
    ({"post_norms": True}, "params"),
    ({"num_experts": 4, "num_experts_per_tok": 2}, "layout"),
    ({"num_experts": 4, "num_experts_per_tok": 2, "moe_layer_period": 2},
     "layout"),
]


def _dtype(a):
    return str(a.dtype).split(".")[-1]


def _reference_view(cfg, what):
    if what == "layout":
        specs, n = jax_tf.block_layout(cfg)
        return [dataclasses.astuple(s) for s in specs], n
    if what == "cache":
        out = jax.eval_shape(lambda: jax_tf.init_cache(cfg, None, 2, 16))
    else:
        out = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: (s.shape, _dtype(s)), out)


def _port_view(cfg, what):
    if what == "layout":
        specs, n = transformer.block_layout(cfg)
        return [dataclasses.astuple(s) for s in specs], n
    if what == "cache":
        out = transformer.init_cache(cfg, 2, 16, device="meta")
    else:
        out = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
    return jax.tree.map(lambda t: (tuple(t.shape), _dtype(t)), out)


@pytest.mark.parametrize("fields,what", PORTED,
                         ids=["+".join(c[0]) for c in PORTED])
def test_port_matches_reference_where_field_is_set(fields, what):
    base = jax_tiny("yi-9b")
    changed = dataclasses.replace(base, **fields)
    assert _reference_view(changed, what) != _reference_view(base, what)

    cfg = dataclasses.replace(get_tiny_config("yi-9b"), **fields)
    assert _port_view(cfg, what) == _reference_view(changed, what)


@pytest.mark.parametrize("family", ["ssm", "hybrid", "audio"])
def test_transformer_refuses_other_families(family):
    cfg = dataclasses.replace(get_tiny_config("yi-9b"), family=family)
    with pytest.raises(NotImplementedError, match="not a transformer"):
        transformer.block_layout(cfg)
    with pytest.raises(NotImplementedError, match="not a transformer"):
        transformer.init_cache(cfg, 2, 16, device="meta")
    with pytest.raises(NotImplementedError, match="not a transformer"):
        transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


def test_default_fields_still_build():
    specs, n = transformer.block_layout(get_tiny_config("yi-9b"))
    assert [s.window for s in specs] == [0] and n > 0
