"""The port's dense transformer reads every config field the reference's
dense model reads, or refuses the config.

For each field the reference's dense model reads (``kv_quant``,
``local_global_pattern``, ``post_norms`` and the MoE fields), the
reference's layout, cache or parameter tree on tiny yi-9b changes when
the field is set.  Where the port reads the field, its layout, cache or
parameter tree equals the reference's with the field set; for the fields
it does not read yet (``transformer.UNPORTED_FIELDS``: MoE) it raises
``NotImplementedError`` in ``block_layout``, ``init_cache`` and ``init``
instead of serving the config as if the field were unset.  The reference
side is shape-only (``jax.eval_shape``): nothing runs.
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

#: (field overrides, what of the reference's model they change), for the
#: fields the port reads
PORTED = [
    ({"kv_quant": True}, "cache"),
    ({"local_global_pattern": 2, "sliding_window": 4}, "layout"),
    ({"post_norms": True}, "params"),
]
#: the same for the fields it refuses
CASES = [
    ({"num_experts": 4, "num_experts_per_tok": 2}, "layout"),
    ({"num_experts": 4, "num_experts_per_tok": 2, "moe_layer_period": 2},
     "layout"),
]


def _dtype(a):
    return str(a.dtype).split(".")[-1]


def _reference_view(cfg, what):
    if what == "layout":
        return jax_tf.block_layout(cfg)
    if what == "cache":
        out = jax.eval_shape(lambda: jax_tf.init_cache(cfg, None, 2, 16))
    else:
        out = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: (s.shape, _dtype(s)), out)


def _port_view(cfg, what):
    if what == "layout":
        specs, n = transformer.block_layout(cfg)
        return [(s.window, s.has_cross) for s in specs], n
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
    want = _reference_view(changed, what)
    if what == "layout":         # the port's LayerSpec has no MoE fields
        want = [(s.window, s.has_cross) for s in want[0]], want[1]
    assert _port_view(cfg, what) == want


@pytest.mark.parametrize("fields,what", CASES,
                         ids=["+".join(c[0]) for c in CASES])
def test_port_raises_where_reference_differs(fields, what):
    base = jax_tiny("yi-9b")
    changed = dataclasses.replace(base, **fields)
    assert _reference_view(changed, what) != _reference_view(base, what)

    cfg = dataclasses.replace(get_tiny_config("yi-9b"), **fields)
    with pytest.raises(NotImplementedError, match="not ported"):
        transformer.block_layout(cfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        transformer.init_cache(cfg, 2, 16, device="meta")
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))


def test_every_unported_field_is_covered():
    assert transformer.UNPORTED_FIELDS == {"num_experts": 0,
                                           "moe_layer_period": 1}
    covered = set().union(*(set(f) for f, _ in CASES))
    assert set(transformer.UNPORTED_FIELDS) <= covered


def test_default_fields_still_build():
    specs, n = transformer.block_layout(get_tiny_config("yi-9b"))
    assert [s.window for s in specs] == [0] and n > 0
