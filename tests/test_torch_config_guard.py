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

The four training fields change the train state or step: ``optimizer``
the optimizer-state tree, ``grad_accum`` and ``accum_dtype`` the
microbatches the loss sees and the type of the grads the optimizer gets,
``remat_policy`` the products recomputed in the backward pass.  Each
changes the port's state or step as it changes the reference's (the
reference traced with ``jax.eval_shape`` and ``jax.make_jaxpr``; the
port's tiny step runs).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_tiny_config as jax_tiny  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.training import optim as jax_optim  # noqa: E402
from repro.training import train_step as jax_ts  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.training import optim, train_step  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

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


# ---------------------------------------------------------------------------
# the training fields
# ---------------------------------------------------------------------------
#: (field overrides, what of the train state or step they change)
TRAINING = [
    ({"optimizer": "adafactor"}, "opt_state"),
    ({"grad_accum": 2}, "accumulation"),
    ({"grad_accum": 2, "accum_dtype": "bfloat16"}, "accumulation"),
    ({"remat_policy": "dots"}, "recompute"),
    ({"remat_policy": "everything"}, "recompute"),
]
TRAIN_B, TRAIN_S = 4, 16


def _recording(make_optimizer, seen):
    """``make_optimizer`` whose update notes the grads' dtypes."""
    def make(name, cfg=None):
        init, update = make_optimizer(name, cfg)

        def noted(params, grads, state):
            seen["grads"] |= {_dtype(g) for g in jax.tree.leaves(grads)}
            return update(params, grads, state)
        return init, noted
    return make


def _count_dots(jaxpr):
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == "dot_general"
        for p in eqn.params.values():
            for sub in p if isinstance(p, (list, tuple)) else [p]:
                if hasattr(sub, "eqns"):
                    n += _count_dots(sub)
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    n += _count_dots(sub.jaxpr)
    return n


class _CountProducts(TorchDispatchMode):
    """Counts matrix products (``mm``, ``addmm``, ``bmm``) while active."""

    OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default)

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.OPS
        return func(*args, **(kwargs or {}))


def _reference_train_view(cfg, what, monkeypatch):
    model = jax_build(cfg)
    batch = {"tokens": jax.ShapeDtypeStruct((TRAIN_B, TRAIN_S), jnp.int32)}
    if what == "opt_state":
        out = jax.eval_shape(lambda: jax_ts.init_train_state(
            model, jax.random.PRNGKey(0))["opt"])
        return jax.tree.map(lambda s: (s.shape, _dtype(s)), out)
    if what == "accumulation":
        seen = {"tokens": set(), "grads": set()}
        loss = model.loss

        def noted_loss(params, b, **kw):
            seen["tokens"].add(tuple(b["tokens"].shape))
            return loss(params, b, **kw)
        model.loss = noted_loss
        monkeypatch.setattr(jax_optim, "make_optimizer",
                            _recording(jax_optim.make_optimizer, seen))
        state = jax.eval_shape(lambda: jax_ts.init_train_state(
            model, jax.random.PRNGKey(0)))
        jax.eval_shape(jax_ts.make_train_step(model), state, batch)
        return seen
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    jaxpr = jax.make_jaxpr(jax.grad(lambda p, b: model.loss(
        p, b, remat=True)[0]))(params, batch)
    return _count_dots(jaxpr.jaxpr)


def _port_train_view(cfg, what, monkeypatch):
    model = build_model(cfg, device="cpu")
    state = train_step.init_train_state(model,
                                        torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((TRAIN_B, TRAIN_S), dtype=torch.int32)}
    if what == "opt_state":
        return jax.tree.map(lambda t: (tuple(t.shape), _dtype(t)),
                            state["opt"])
    if what == "accumulation":
        seen = {"tokens": set(), "grads": set()}
        loss = model.loss

        def noted_loss(params, b, **kw):
            seen["tokens"].add(tuple(b["tokens"].shape))
            return loss(params, b, **kw)
        model.loss = noted_loss
        monkeypatch.setattr(optim, "make_optimizer",
                            _recording(optim.make_optimizer, seen))
        train_step.make_train_step(model)(state, batch)
        return seen
    loss, _ = model.loss(state["params"], batch, remat=True)
    with _CountProducts() as counter:
        torch.autograd.grad(loss, optim.leaves(state["params"]))
    return counter.n


@pytest.mark.parametrize("fields,what", TRAINING,
                         ids=["+".join(c[0]) + "=" + "+".join(
                             str(v) for v in c[0].values())
                             for c in TRAINING])
def test_training_field_changes_port_as_reference(fields, what,
                                                  monkeypatch):
    base = dataclasses.replace(jax_tiny("yi-9b"), dtype="float32")
    changed = dataclasses.replace(base, **fields)
    ref_base = _reference_train_view(base, what, monkeypatch)
    ref_changed = _reference_train_view(changed, what, monkeypatch)
    assert ref_changed != ref_base

    tbase = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32")
    port_base = _port_train_view(tbase, what, monkeypatch)
    port_changed = _port_train_view(dataclasses.replace(tbase, **fields),
                                    what, monkeypatch)
    if what == "recompute":
        # the reference traces jnp products, the port counts aten calls:
        # the counts differ, the direction of the change must not
        assert (port_changed < port_base) == (ref_changed < ref_base)
        assert port_changed != port_base
    else:
        assert port_base == ref_base
        assert port_changed == ref_changed


# ---------------------------------------------------------------------------
# the mesh fields
# ---------------------------------------------------------------------------
#: (field overrides) the reference reads only under a mesh
MESH_FIELDS = [{"seq_shard": False}, {"rs_outputs": True},
               {"seq_shard": False, "rs_outputs": True}]


class _ShapeMesh:
    """A (data 2, model 4) mesh of shapes alone: the sharding sites run,
    nothing is placed."""
    shape = {"data": 2, "model": 4}
    axis_names = ("data", "model")


def _shard_sites(module, monkeypatch, run):
    """The axes of every ``shard`` call ``run()`` makes in ``module``, a
    one-name tuple read as the name (as a JAX ``PartitionSpec`` reads
    it)."""
    seen = []

    def record(ax, x, *axes):
        seen.append(tuple(a[0] if isinstance(a, tuple) and len(a) == 1
                          else a for a in axes))
        return x
    monkeypatch.setattr(module, "shard", record)
    run()
    return seen


def _reference_sites(cfg, monkeypatch):
    from repro.models.partition import AxisInfo as JaxAxisInfo
    ax = JaxAxisInfo(mesh=_ShapeMesh(), data=("data",), model="model")
    model = jax_build(cfg, ax)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    tokens = jax.ShapeDtypeStruct((4, 16), jnp.int32)
    return _shard_sites(jax_tf, monkeypatch, lambda: jax.eval_shape(
        lambda p, t: model.logits(p, {"tokens": t}, remat=False),
        params, tokens))


def _port_sites(cfg, monkeypatch):
    from repro_torch.models.partition import AxisInfo
    ax = AxisInfo(mesh=_ShapeMesh(), data=("data",), model="model")
    model = build_model(cfg, "cpu", ax)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((4, 16), dtype=torch.int32)
    return _shard_sites(transformer, monkeypatch, lambda: model.logits(
        params, {"tokens": tokens}))


@pytest.mark.parametrize("fields", MESH_FIELDS,
                         ids=["+".join(f"{k}={v}" for k, v in f.items())
                              for f in MESH_FIELDS])
def test_mesh_field_moves_shard_sites_as_reference(fields, monkeypatch):
    """Under a mesh ``seq_shard`` and ``rs_outputs`` change where the
    residual stream and the layer outputs are placed: the port's
    ``shard`` sites (axes, in order) equal the reference's with the
    field set and without."""
    # one layer: the reference's scan traces its block once, the port's
    # loop runs it once a layer
    base = dataclasses.replace(jax_tiny("yi-9b"), dtype="float32",
                               num_layers=1)
    changed = dataclasses.replace(base, **fields)
    want_base = _reference_sites(base, monkeypatch)
    want = _reference_sites(changed, monkeypatch)
    assert want != want_base

    tbase = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32",
                                num_layers=1)
    assert _port_sites(tbase, monkeypatch) == want_base
    assert _port_sites(dataclasses.replace(tbase, **fields),
                       monkeypatch) == want


def test_bf16_boundary_changes_no_value():
    """``bf16_boundary`` pins an XLA optimization barrier in the
    reference, which changes no value; the port has nothing to pin (see
    the comment in ``transformer.forward``).  With the field set, each
    package's logits equal its own without it, and the two packages
    agree."""
    import numpy as np
    from repro_torch.interop import params_from_numpy
    base = dataclasses.replace(jax_tiny("yi-9b"), dtype="float32")
    params = jax_build(base).init(jax.random.PRNGKey(0))
    tokens = np.arange(32, dtype=np.int32).reshape(2, 16) % 500
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    outs = {}
    for flag in (False, True):
        jcfg = dataclasses.replace(base, bf16_boundary=flag)
        outs["ref", flag] = np.asarray(jax_build(jcfg).logits(
            params, {"tokens": jnp.asarray(tokens)}, remat=False)[0])
        tcfg = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32",
                                   bf16_boundary=flag)
        outs["port", flag] = build_model(tcfg, "cpu").logits(
            tp, {"tokens": torch.from_numpy(tokens)}).numpy()
    for side in ("ref", "port"):
        np.testing.assert_array_equal(outs[side, True], outs[side, False])
    np.testing.assert_allclose(outs["port", True], outs["ref", True],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("factor", [8.0, 1.0, 0.5])
def test_capacity_factor_drops_as_reference(factor):
    """``capacity_factor`` sizes the expert-parallel path's buckets: one
    rank's dispatch (model axis 1, so no collective) drops the same
    (token, expert) pairs in both packages; a smaller factor drops
    more."""
    import numpy as np
    from repro.models import moe as jax_moe
    from repro_torch.models import moe
    cfg = dataclasses.replace(jax_tiny("arctic-480b"), dtype="float32",
                              capacity_factor=factor)
    tcfg = dataclasses.replace(get_tiny_config("arctic-480b"),
                               dtype="float32", capacity_factor=factor)
    p = jax.tree.map(lambda t: np.asarray(t[0]), jax_moe.moe_init(
        jax.random.PRNGKey(0), cfg, jnp.float32, 1))
    x = (np.random.default_rng(0).standard_normal((32, cfg.d_model))
         * 0.3).astype(np.float32)
    want, _ = jax_moe._dispatch_combine_local(
        jnp.asarray(x), p["router"], p["w_gate"], p["w_up"], p["w_down"],
        cfg=cfg, mp=1, mp_axis="model")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got, _ = moe._dispatch_combine_local(
        torch.from_numpy(x), tp["router"], tp["w_gate"], tp["w_up"],
        tp["w_down"], cfg=tcfg, mp=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    full, _ = moe._dispatch_combine_local(
        torch.from_numpy(x), tp["router"], tp["w_gate"], tp["w_up"],
        tp["w_down"], cfg=dataclasses.replace(tcfg, capacity_factor=8.0),
        mp=1)
    assert (factor == 8.0) == bool(torch.equal(got, full))
