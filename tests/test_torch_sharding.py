"""The port's spec trees and mesh-padded shapes equal the reference's.

For every arch on both production meshes — (data 16, model 16) and
(pod 2, data 16, model 16) — the port's ``param_pspecs`` (train and
serve), ``opt_state_pspecs`` (adamw and adafactor), ``state_pspecs``,
``batch_pspecs`` (every input shape) and ``Model.cache_pspecs`` equal the
reference's leaf by leaf, a JAX ``PartitionSpec`` compared as a tuple.
The parameter and cache shapes of the port's model built at the mesh's
model axis (on the meta device: nothing of full width is allocated)
equal the reference's ``jax.eval_shape``.  Both sides use shape-only
meshes: no device and no process group.  The tolerance is exact
equality.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import sharding as jax_sh  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.partition import AxisInfo as JaxAxisInfo  # noqa: E402
from repro.training import train_step as jax_ts  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.partition import AxisInfo, P  # noqa: E402
from repro_torch.models.registry import _flatten  # noqa: E402
from repro_torch.training import optim  # noqa: E402


class _Single:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class _Multi:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


MESHES = {"16x16": (_Single, ("data",)), "2x16x16": (_Multi, ("pod", "data"))}
KEY = jax.random.PRNGKey(0)


def _axes(mesh_name, shard_batch=True):
    mesh, data = MESHES[mesh_name]
    return (JaxAxisInfo(mesh=mesh(), data=data, model="model",
                        shard_batch=shard_batch),
            AxisInfo(mesh=mesh(), data=data, model="model",
                     shard_batch=shard_batch))


def _jax_leaves(tree):
    """(key path, leaf) in tree_flatten order; a P is a leaf."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(tuple(str(k.key) for k in path), leaf) for path, leaf in flat]


def _specs_equal(jtree, ttree):
    jl, tl = _jax_leaves(jtree), _flatten(ttree)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, js), (_, ts) in zip(jl, tl):
        assert isinstance(ts, P), (path, ts)
        assert tuple(ts) == tuple(js), (path, ts, js)


@functools.lru_cache(maxsize=None)
def _sides(arch, mesh_name):
    """(jax model, jax abstract params, port model, port meta params)."""
    jax_ax, ax = _axes(mesh_name)
    jm = jax_build(jax_config(arch), jax_ax)
    jp = jax.eval_shape(jm.init, KEY)
    tm = build_model(get_config(arch), "meta", ax)
    return jm, jp, tm, tm.init()


ARCH_MESH = [(a, m) for a in ARCH_IDS for m in MESHES]
IDS = [f"{a}-{m}" for a, m in ARCH_MESH]


@pytest.mark.parametrize("arch,mesh", ARCH_MESH, ids=IDS)
def test_param_shapes_at_model_axis(arch, mesh):
    _, jp, _, tp = _sides(arch, mesh)
    jl, tl = _jax_leaves(jp), _flatten(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
        assert t.device.type == "meta"


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch,mesh", ARCH_MESH, ids=IDS)
def test_param_pspecs(arch, mesh, mode):
    jm, jp, tm, tp = _sides(arch, mesh)
    _specs_equal(jax_sh.param_pspecs(jp, jm.cfg, jm.ax, mode=mode),
                 sh.param_pspecs(tp, tm.cfg, tm.ax, mode=mode))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch,mesh", ARCH_MESH, ids=IDS)
def test_opt_state_pspecs(arch, mesh, opt):
    jm, jp, tm, tp = _sides(arch, mesh)
    jspecs = jax_sh.param_pspecs(jp, jm.cfg, jm.ax, mode="train")
    tspecs = sh.param_pspecs(tp, tm.cfg, tm.ax, mode="train")
    _specs_equal(jax_sh.opt_state_pspecs(jp, jspecs, opt),
                 sh.opt_state_pspecs(tp, tspecs, opt))


@pytest.mark.parametrize("arch,mesh", ARCH_MESH, ids=IDS)
def test_state_pspecs(arch, mesh):
    jm, _, tm, tp = _sides(arch, mesh)
    jstate = jax.eval_shape(lambda k: jax_ts.init_train_state(jm, k), KEY)
    opt_init, _ = optim.make_optimizer(tm.cfg.optimizer)
    tstate = {"params": tp, "opt": opt_init(tp)}
    _specs_equal(jax_sh.state_pspecs(jstate, jm.cfg, jm.ax),
                 sh.state_pspecs(tstate, tm.cfg, tm.ax))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch,mesh", ARCH_MESH, ids=IDS)
def test_batch_pspecs(arch, mesh, shape):
    inp = SHAPES[shape]
    m, _ = MESHES[mesh]
    sizes = m.shape
    dp = sizes["data"] * sizes.get("pod", 1)
    jax_ax, ax = _axes(mesh, shard_batch=inp.global_batch % dp == 0)
    _specs_equal(jax_sh.batch_pspecs(jax_config(arch), jax_ax, inp),
                 sh.batch_pspecs(get_config(arch), ax, inp))


@pytest.mark.parametrize("arch,mesh", ARCH_MESH, ids=IDS)
def test_cache_pspecs_and_shapes(arch, mesh):
    jm, _, tm, _ = _sides(arch, mesh)
    _specs_equal(jm.cache_pspecs(), tm.cache_pspecs())
    want = jax.eval_shape(lambda: jm.init_cache(2, 64))
    got = tm.init_cache(2, 64, device="meta")
    jl, tl = _jax_leaves(want), _flatten(got)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path


def test_placements_major_axis_first_and_divisibility():
    """A dim split over ('pod', 'data') takes the mesh's order, the major
    axis first; the reverse order and an uneven split raise."""
    from repro_torch.models.partition import check_divisible, placements
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    assert placements(_Mesh(), P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(_Mesh(), P(None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements(_Mesh(), P(("data", "pod")))
    with pytest.raises(ValueError, match="divide"):
        check_divisible((48, 8), P(("pod", "data"), None), _Mesh())
    check_divisible((64, 32), P(("pod", "data"), "model"), _Multi())
