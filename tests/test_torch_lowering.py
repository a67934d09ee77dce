"""The port's lowering and device-resident tables on the CPU (port of the
contracts ``tests/test_batched_lowering.py`` and ``tests/test_table.py``
check for the reference): the batched chain matches the interpreted
chain, one dispatch per bucket, ragged batches split by shape, executable
-cache keys and re-traces, filter-as-mask, DeviceTable padding / take /
host boundary, and a device-resident edge between two lowered nodes of
one served flow.  Exact equality: both paths run the same f32 ops.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.core.ir import PhysicalPlan  # noqa: E402
from repro_torch.core.lowering import (EXECUTABLE_CACHE,  # noqa: E402
                                       BatchedJittedFuse, ChainProfile,
                                       ExecutableCache, bucket_rows,
                                       degraded_execution, DegradePolicy)
from repro_torch.core.passes import build_pipeline  # noqa: E402
from repro_torch.core.table import (HOST_COPIES, DeviceTable,  # noqa: E402
                                    Table)
from repro_torch.runtime import NetModel, Runtime  # noqa: E402


def _f1(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x * 1.01 + 0.1)


def _f2(x: torch.Tensor) -> torch.Tensor:
    return x * x - 0.5 * x


def _pos(x: torch.Tensor) -> bool:
    return x.sum() > 0


def _chain(*fns, filt=None):
    fl = Dataflow([("x", torch.Tensor)])
    node = fl.source
    for f in fns:
        node = node.map(f, names=["x"], gpu=True)
        if filt is not None and f is fns[0]:
            node = node.filter(filt, gpu=True)
    fl.output = node
    return fl


def _lower(fl, **kw):
    return build_pipeline(fusion=True, device="cpu", **kw).run(
        PhysicalPlan.from_dataflow(fl))


def _interp(fl):
    return build_pipeline(fusion=True, jit_fusion=False).run(
        PhysicalPlan.from_dataflow(fl))


def _table(rows):
    return Table([("x", torch.Tensor)], [(r,) for r in rows])


def _rows(t):
    return [np.asarray(r.values[0]) for r in t.rows]


def test_bucket_rows_pads_to_power_of_two():
    assert [bucket_rows(n) for n in (1, 2, 3, 5, 8, 9, 64, 65, 200)] == \
        [1, 2, 4, 8, 8, 16, 64, 128, 256]


def test_batched_matches_interpreted_and_dispatches_once_per_bucket():
    plan, ref = _lower(_chain(_f1, _f2)), _interp(_chain(_f1, _f2))
    op = plan.ops[0].op
    assert isinstance(op, BatchedJittedFuse) and plan.ops[0].batchable
    t = _table([torch.linspace(-2.0, 2.0, 33) * (i + 1) for i in range(5)])
    got, want = plan.execute_local(t), ref.execute_local(t)
    assert [r.row_id for r in got.rows] == [r.row_id for r in want.rows]
    for a, b in zip(_rows(got), _rows(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert op.batch_dispatches == 1 and op.rows_batched == 5   # bucket 8
    plan.execute_local(_table([torch.ones(33)] * 6))             # bucket 8
    assert op.batch_dispatches == 2
    # a singleton takes the per-row path
    plan.execute_local(_table([torch.ones(33)]))
    assert op.row_dispatches == 1 and op.batch_dispatches == 2
    assert len(plan.execute_local(Table([("x", torch.Tensor)]))) == 0


def test_ragged_batch_splits_into_shape_groups():
    plan = _lower(_chain(_f1, _f2))
    op = plan.ops[0].op
    t = _table([torch.ones(8), torch.ones(16), torch.ones(8) * 3,
                torch.ones(16) * 2])
    out = plan.execute_local(t)
    assert op.batch_dispatches == 2
    assert [r.values[0].shape for r in out.rows] == [(8,), (16,), (8,),
                                                     (16,)]
    for r_in, r_out in zip(t.rows, out.rows):
        np.testing.assert_allclose(np.asarray(r_out.values[0]),
                                   _f2(_f1(r_in.values[0])).numpy(),
                                   rtol=1e-6)


def test_executable_cache_keys_reuse_and_misses():
    EXECUTABLE_CACHE.clear()
    t = _table([torch.ones(12) * i for i in range(3)])
    _lower(_chain(_f1, _f2)).execute_local(t)                 # bucket 4
    s0 = EXECUTABLE_CACHE.stats()
    assert s0["misses"] == 1 and s0["traces"] == 1
    _lower(_chain(_f1, _f2)).execute_local(t)   # fresh plan, same fns
    s1 = EXECUTABLE_CACHE.stats()
    assert s1["traces"] == 1 and s1["hits"] == s0["hits"] + 1
    plan = _lower(_chain(_f1, _f2))
    plan.execute_local(_table([torch.ones(12)] * 5))          # bucket 8
    plan.execute_local(_table([torch.ones(12, dtype=torch.float64)] * 2))
    s2 = EXECUTABLE_CACHE.stats()
    assert s2["misses"] == 3 and s2["traces"] == 3 and s2["chains"] == 1
    cache = ExecutableCache(max_chains=2)
    for i in range(3):
        cache.executable((("map", lambda v, i=i: v + i),), [], ((2,),),
                         ("float32",))
    assert cache.stats()["chains"] == 2 and cache.stats()["evictions"] == 1


def test_filter_lowers_as_a_mask_column():
    fl = _chain(_f1, _f2, filt=_pos)
    plan, ref = _lower(fl), _interp(_chain(_f1, _f2, filt=_pos))
    rows = [torch.ones(4), -torch.ones(4) * 3, torch.ones(4) * 2]
    got, want = plan.execute_local(_table(rows)), \
        ref.execute_local(_table(rows))
    assert len(got) == len(want) == 2
    for a, b in zip(_rows(got), _rows(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert plan.ops[0].op.batch_dispatches == 1
    # device-resident in and out: the mask rides along, rows compact only
    # at the host boundary
    op = plan.ops[0].op
    dt = DeviceTable.from_columns([("x", torch.Tensor)], [rows], [7, 8, 9],
                                  [None] * 3, pad_to=4, device="cpu")
    out = op.apply_batched([dt], emit_device=True)
    assert isinstance(out, DeviceTable) and out.mask is not None
    assert out.cap == 4 and out.nrows == 3
    assert [r.row_id for r in out.to_table().rows] == [7, 9]


def test_device_table_pads_takes_and_gathers_once():
    g0, s0 = HOST_COPIES["gathers"], HOST_COPIES["stacks"]
    cols = [[np.full(3, i, np.float32) for i in range(5)],
            [np.int32(i) for i in range(5)]]
    dt = DeviceTable.from_columns([("a", torch.Tensor), ("b", int)], cols,
                                  list(range(5)), [None] * 5, pad_to=8,
                                  device="cpu")
    assert dt.cap == 8 and len(dt) == 5 and HOST_COPIES["stacks"] == s0 + 1
    part = dt.take([4, 1], pad_to=4)
    assert part.cap == 4 and part.row_ids == [4, 1]
    host = part.to_table()
    assert [float(r.values[0][0]) for r in host.rows] == [4.0, 1.0]
    assert [int(r.values[1]) for r in host.rows] == [4, 1]
    assert HOST_COPIES["gathers"] == g0 + 1


def test_router_prefers_measured_cheaper_path_and_probes():
    p = ChainProfile()
    assert not p.prefer_per_row(4, 4)              # unmeasured: batch
    p.note_per_row(1e-3)
    p.note_batched(4, 1.0)                         # first sample dropped
    p.note_batched(4, 1e-2)
    assert p.prefer_per_row(4, 4)                  # 4 ms < 10 ms
    decisions = [p.route_decision(4, 4) for _ in range(p.PROBE_EVERY)]
    assert decisions[-1] == (False, True)          # the batched probe
    plan = _lower(_chain(_f1, _f2))
    with degraded_execution(DegradePolicy()):
        plan.execute_local(_table([torch.ones(4)] * 3))
    assert plan.ops[0].op.row_dispatches == 3
    assert plan.ops[0].op.batch_dispatches == 0


def test_device_resident_edge_between_lowered_nodes():
    """A lowered chain whose consumers are all lowered chains emits a
    DeviceTable; the consumers run on the executor that produced it."""
    fl = Dataflow([("x", torch.Tensor)])
    a = fl.map(_f1, names=["x"], gpu=True).map(_f2, names=["x"], gpu=True)
    b = a.map(_f2, names=["x"], gpu=True).map(_f1, names=["x"], gpu=True)
    c = a.map(_f1, names=["x"], gpu=True).map(_f1, names=["x"], gpu=True)
    fl.output = b.join(c)
    rt = Runtime(n_cpu=1, n_gpu=2, net=NetModel(scale=0.0), device="cpu")
    try:
        dep = fl.deploy(rt, fusion=True, name="fanout")
        nodes = [n for n in dep.dag.nodes.values() if n.device_resident]
        assert len(nodes) == 3
        assert sum(n.emits_device for n in nodes) == 1
        xs = [torch.linspace(-1, 1, 6) * (i + 1) for i in range(3)]
        out = dep.execute(_table(xs)).result(60)
    finally:
        rt.stop()
    assert len(out) == 3
    for x, r in zip(xs, out.rows):
        mid = _f2(_f1(x))
        np.testing.assert_allclose(np.asarray(r.values[0]),
                                   _f1(_f2(mid)).numpy(), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(r.values[1]),
                                   _f1(_f1(mid)).numpy(), rtol=1e-6)
