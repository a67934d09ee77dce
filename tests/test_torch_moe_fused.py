"""The MoE layer's routing, placement and combine kernels
(``kernels/moe.py``) and ``moe_apply_grouped``'s use of the layer's
record (``models/layer_ops.py``), which chooses between them and the
eager composition.

On the CPU, where each wrapper runs its plain version:

* The plain versions composed (``moe_route``, ``moe_permute``, the three
  grouped products, ``moe_combine``) give ``moe_apply_grouped``'s eager
  output and aux loss bit for bit, and ``moe_route``'s weights and experts
  are ``moe._router``'s: tiny deepseek-moe, arctic and llama4 configs,
  both ``norm_topk_prob`` settings, T 1, 7 and 64, and a zero router
  whose ties go to the lowest experts.  ``pos`` is the stable order's
  inverse: each pair's row is its token's, and each expert's pairs lie
  between its ends in pair order.
* The kernels' own blocking, emulated: tiles of ``route_tile`` tokens,
  each tile's counts, the scan's bases and each pair's rank within its
  tile give the plain ``pos``; the tiles' probability sums give the aux
  loss.
* The path choice: ``use_kernels`` without a mesh gives the record the
  wrappers and the call goes through them (the fake walk records them);
  ``use_kernels`` off, or a mesh (whose route takes a ``mean``), gives
  the plain versions and calls none; CPU and fake tensors, any number of
  experts and choices, and inputs that require grad then run the eager
  composition; the counters ``.calls``, ``.pairs`` and ``.fused``.

On the card (marker ``cuda``; skipped without one): each kernel against
its plain version (the experts alike but at ties the float64 router
scores within rel 1e-5; the weights as close to the float64 router's as
the plain version's, within twice its gap or 2e-6; on the kernel's own
routes ``ends``, ``pos`` and the rows equal and the combine within one
bf16 step, or 8 f32 steps, at each row's largest magnitude; the layer
within one bf16 step, f32 rel 2e-6), the kernel path's launches,
``recorded_routes`` under it, and ``KernelError`` for what the kernels
do not take (float16, more than 256 experts or 8 choices, grad).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.kernels import build, glue, moe as kmoe  # noqa: E402
from repro_torch.models import layer_ops, moe  # noqa: E402
from repro_torch.models.partition import AxisInfo  # noqa: E402

ARCHS = ("deepseek-moe-16b", "arctic-480b", "llama4-maverick-400b-a17b")
TOKENS = (1, 7, 64)


def _cfg(arch, **over):
    return dataclasses.replace(get_tiny_config(arch), dtype="float32",
                               **over)


def _layer(cfg, device="cpu", dtype=torch.float32, zero_router=False,
           seed=0):
    p = moe.moe_init(cfg, dtype, 1, device=device,
                     generator=torch.Generator(device=device).manual_seed(
                         seed))
    lp = {k: v[0] for k, v in p.items()}
    if zero_router:
        lp["router"] = torch.zeros_like(lp["router"])
    return lp


def _hidden(cfg, T, device="cpu", dtype=torch.float32, seed=1):
    a = np.random.default_rng(seed).standard_normal((1, T, cfg.d_model))
    return torch.tensor(a, dtype=torch.float32, device=device).to(dtype)


def _composed(x, lp, cfg):
    """The layer as the wrappers compose it on the kernel path."""
    xf = x.reshape(-1, cfg.d_model)
    k = cfg.num_experts_per_tok
    r = kmoe.moe_route(xf, lp["router"], k, cfg.norm_topk_prob)
    rows, pos = kmoe.moe_permute(xf, r)
    up = moe._grouped(rows, lp["w_up"], r.ends)
    h = glue.gated_act(moe._grouped(rows, lp["w_gate"], r.ends), up,
                       cfg.act)
    out_rows = moe._grouped(h, lp["w_down"], r.ends)
    return kmoe.moe_combine(out_rows, r, pos).reshape(x.shape), r, rows, pos


# -- the plain versions against the eager path -------------------------------

@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("T", TOKENS)
@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_versions_compose_the_eager_layer(arch, renorm, T,
                                                zero_router):
    cfg = _cfg(arch, norm_topk_prob=renorm)
    lp = _layer(cfg, zero_router=zero_router)
    x = _hidden(cfg, T)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    got, r, rows, pos = _composed(x, lp, cfg)
    want, want_aux = moe.moe_apply_grouped(x, lp, cfg)
    assert torch.equal(got, want)
    assert torch.equal(r.aux, want_aux)
    top_w, top_i, aux = moe._router(x.reshape(-1, cfg.d_model),
                                    lp["router"], k, renorm=renorm)
    assert torch.equal(r.top_w, top_w) and torch.equal(r.top_i, top_i)
    assert torch.equal(r.aux, aux) and r.top_i.dtype == torch.int64
    if zero_router:   # every probability ties: the lowest experts win
        assert torch.equal(top_i, torch.arange(k).expand(T, k))
    # pos: the stable order's inverse
    xf = x.reshape(-1, cfg.d_model)
    assert pos.dtype == torch.int32 and tuple(pos.shape) == (T, k)
    assert sorted(pos.flatten().tolist()) == list(range(T * k))
    assert torch.equal(rows[pos.long()], xf[:, None].expand(T, k, -1))
    ends = [0] + r.ends.tolist()
    assert ends[-1] == T * k and r.ends.dtype == torch.int32
    for e in range(E):
        mine = [int(pos[t, j]) for t in range(T) for j in range(k)
                if int(top_i[t, j]) == e]
        assert mine == list(range(ends[e], ends[e + 1]))


def _emulated_placement(top_i, probs, E):
    """The kernels' blocking on the CPU: ``moe_route``'s tiles of
    ``route_tile(T)`` tokens with their counts and probability sums, the
    scan's ends, bases and aux loss (its runs of tiles as the kernel cuts
    them), and ``moe_permute``'s place for each pair: its tile's base for
    its expert plus its rank among the tile's earlier pairs."""
    T, k = top_i.shape
    tile = kmoe.route_tile(T)
    tiles = -(-T // tile)
    hist = torch.zeros((tiles, E), dtype=torch.int64)
    first = torch.zeros((tiles, E), dtype=torch.int64)
    psum = torch.zeros((tiles, E), dtype=torch.float32)
    for i in range(tiles):
        for t in range(i * tile, min(T, (i + 1) * tile)):
            psum[i] += probs[t]
            first[i, top_i[t, 0]] += 1
            for j in range(k):
                hist[i, top_i[t, j]] += 1
    runs = 1024 // E
    per = -(-tiles // runs)
    counts = hist.sum(0)
    ends = torch.cumsum(counts, 0)
    base = torch.cumsum(hist, 0) - hist + (ends - counts)
    ps = torch.zeros(E)
    for c in range(runs):
        part = torch.zeros(E)
        for i in range(c * per, min(tiles, (c + 1) * per)):
            part += psum[i]
        ps += part
    me, ce = ps / T, first.sum(0).float() / T
    aux = E * torch.sum(me * ce)
    pos = torch.empty((T, k), dtype=torch.int64)
    for i in range(tiles):
        pairs = top_i[i * tile:(i + 1) * tile].reshape(-1)
        for p, e in enumerate(pairs.tolist()):
            rank = int((pairs[:p] == e).sum())
            t, j = divmod(i * tile * k + p, k)
            pos[t, j] = base[i, e] + rank
    return ends, pos, aux


@pytest.mark.parametrize("T", (1, 4, 5, 7, 64))
@pytest.mark.parametrize("arch", ARCHS)
def test_tiled_placement_is_the_stable_sort(arch, T):
    cfg = _cfg(arch)
    lp = _layer(cfg)
    xf = _hidden(cfg, T).reshape(-1, cfg.d_model)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    r = kmoe.moe_route(xf, lp["router"], k, cfg.norm_topk_prob)
    _, pos = kmoe.moe_permute(xf, r)
    probs = torch.softmax(xf @ lp["router"], dim=-1)
    ends, got_pos, aux = _emulated_placement(r.top_i, probs, E)
    assert torch.equal(got_pos, pos.long())
    assert torch.equal(ends.to(torch.int32), r.ends)
    torch.testing.assert_close(aux, r.aux, rtol=1e-6, atol=0)


# -- the path choice ----------------------------------------------------------

#: the wrappers a call on the kernel path goes through, in their order
WRAPPERS = ["moe_route", "moe_permute", "gated_act", "moe_combine"]
#: a mesh, to ``layer_ops``, which reads no more than that one is given
MESH = AxisInfo(mesh=None)


def _counts():
    f = moe.moe_apply_grouped
    return f.calls, f.pairs, f.fused


def _fake_call(x, lp, cfg, **kw):
    """``moe_apply_grouped`` on fake tensors: its output's shape and the
    kernel wrappers it called (the static verifier's walk)."""
    with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
            build.abstract_calls() as calls:
        fx = mode.from_tensor(x)
        flp = {n: mode.from_tensor(t) for n, t in lp.items()}
        y, _ = moe.moe_apply_grouped(fx, flp, cfg, **kw)
    return tuple(y.shape), [name for name, _ in calls]


@pytest.mark.parametrize("case", ["kernels", "off", "mean"])
def test_use_kernels_without_a_mesh_takes_the_wrappers(case):
    """``use_kernels`` without a mesh gives the record's MoE fields the
    wrappers; without ``use_kernels``, or under a mesh (whose route takes
    a ``mean``), the plain versions, and no wrapper is called."""
    cfg = _cfg("deepseek-moe-16b", use_kernels=case != "off")
    ops = layer_ops.layer_ops(cfg, MESH if case == "mean" else None)
    assert [getattr(ops, f) for f in layer_ops.MOE] == (
        [kmoe.moe_route, kmoe.moe_permute, glue.gated_act, kmoe.moe_combine]
        if case == "kernels" else
        [kmoe.moe_route_plain, kmoe.moe_permute_plain, glue.gated_act_plain,
         kmoe.moe_combine_plain])
    kw = {"mean": lambda t: t} if case == "mean" else {}
    kw["ops"] = ops
    lp = _layer(cfg)
    x = _hidden(cfg, 3)
    shape, called = _fake_call(x, lp, cfg, **kw)
    assert shape == tuple(x.shape)
    assert called == (WRAPPERS if case == "kernels" else [])


@pytest.mark.parametrize("case", ["cpu", "fake", "grad", "mean",
                                  "experts", "choices", "off"])
def test_off_the_kernels_case_the_eager_path_runs(case):
    """Off the card every call runs the eager composition and launches
    nothing, whatever its experts and choices: the wrappers' limits are
    the kernels'.  CPU tensors that require grad are differentiated."""
    over = {"experts": dict(num_experts=260),
            "choices": dict(num_experts=12, num_experts_per_tok=9),
            "off": dict(use_kernels=False)}
    cfg = _cfg("deepseek-moe-16b", **{"use_kernels": True,
                                      **over.get(case, {})})
    lp = _layer(cfg)
    x = _hidden(cfg, 5)
    T, k = 5, cfg.num_experts_per_tok
    kw = ({"mean": lambda t: t, "ops": layer_ops.layer_ops(cfg, MESH)}
          if case == "mean" else {})
    before = _counts()
    launches = kmoe.moe_route.launches
    if case == "fake":
        shape, called = _fake_call(x, lp, cfg)
        assert shape == tuple(x.shape) and called == WRAPPERS
    else:
        if case == "grad":
            x = x.clone().requires_grad_(True)
        y, aux = moe.moe_apply_grouped(x, lp, cfg, **kw)
        want, want_aux = moe.moe_apply_reference(x.detach(), lp, cfg)
        torch.testing.assert_close(y.detach(), want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(aux.detach(), want_aux, atol=1e-6,
                                   rtol=1e-6)
        if case == "grad":
            y.sum().backward()
            assert x.grad is not None
    calls, pairs, fused = _counts()
    assert (calls - before[0], pairs - before[1], fused - before[2]) == \
        (1, T * k, 0)
    assert kmoe.moe_route.launches == launches


def test_plain_routes_carry_the_order_and_tiles_follow_the_tokens():
    cfg = _cfg("deepseek-moe-16b")
    lp = _layer(cfg)
    xf = _hidden(cfg, 3).reshape(-1, cfg.d_model)
    r = kmoe.moe_route(xf, lp["router"], cfg.num_experts_per_tok, False)
    assert r.work is None and r.order is not None
    assert kmoe.route_tile(1) == kmoe.route_tile(4) == 1
    assert kmoe.route_tile(5) == kmoe.route_tile(8192) == 8


# -- on the card --------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


#: (experts, choices, renormalised, d_model, expert width): deepseek-moe-
#: 16b's routing at a smaller width, arctic's and llama4's, experts not a
#: multiple of 4 (the router's scalar loads) and a width whose rows are
#: not whole 16-byte vectors (the scalar copies and combine)
CARD_CASES = [(64, 6, False, 256, 128), (128, 2, True, 256, 128),
              (128, 1, True, 256, 128), (6, 2, True, 96, 64),
              (16, 4, False, 100, 64)]


def _card_layer(dev, dtype, E, k, renorm, D, F, zero_router=False):
    cfg = dataclasses.replace(
        get_tiny_config("deepseek-moe-16b"), num_experts=E,
        num_experts_per_tok=k, norm_topk_prob=renorm, d_model=D,
        expert_d_ff=F, dtype=str(dtype).split(".")[-1], use_kernels=True)
    lp = _layer(cfg, device=dev, dtype=dtype, zero_router=zero_router)
    return cfg, lp


def _row_steps(got, want, dtype):
    """The largest gap between two [T, D] tensors in steps of ``dtype``
    (its last place), each row's step taken at its largest |want|: a sum
    of k terms taken in another f32 order moves a small element by as
    much as a large one."""
    scale = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    bits = 7 if dtype == torch.bfloat16 else 23
    step = torch.exp2(torch.floor(torch.log2(scale)) - bits)
    return float(((got.float() - want.float()).abs() / step).max())


def _f64_weights(xf, router, top_i, renorm):
    """The routing weights of the experts ``top_i`` computed in float64:
    the function both versions round to f32."""
    probs = torch.softmax(xf.double() @ router.double(), dim=-1)
    w = probs.gather(1, top_i)
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9) if renorm else w


def _max_rel(got, want):
    return float(((got.double() - want).abs() / want.abs()).max())


def _differ_only_at_near_ties(xf, router, got_i, want_i):
    """Whether two routings choose alike but where the float64 router
    scores the two choices within rel 1e-5 of each other: a tie that the
    f32 sums of either version may break either way."""
    probs = torch.softmax(xf.double() @ router.double(), dim=-1)
    differ = (got_i != want_i).any(-1)
    pg, pw = probs[differ].gather(1, got_i[differ]), probs[differ].gather(
        1, want_i[differ])
    return bool(((pg - pw).abs() <= 1e-5 * pw).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 7, 64, 1024])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernels_match_their_plain_versions_on_card(dev, case, T, dtype):
    E, k, renorm, D, F = case
    cfg, lp = _card_layer(dev, dtype, *case)
    xf = _hidden(cfg, T, dev, dtype, seed=T).reshape(-1, D)
    r = kmoe.moe_route(xf, lp["router"], k, renorm)
    want = kmoe.moe_route_plain(xf, lp["router"], k, renorm)
    torch.cuda.synchronize()
    assert _differ_only_at_near_ties(xf, lp["router"], r.top_i, want.top_i)
    # the weights against the float64 router's: as close as the plain
    # version's own f32 weights (its product, softmax and sums round too)
    exact = _f64_weights(xf, lp["router"], r.top_i, renorm)
    assert _max_rel(r.top_w, exact) <= max(
        2e-6, 2 * _max_rel(want.top_w,
                           _f64_weights(xf, lp["router"], want.top_i,
                                        renorm)))
    torch.testing.assert_close(r.aux, want.aux, rtol=1e-5, atol=0)
    # the placement and the combine on the kernel's own routes
    order, ends = kmoe.sort_pairs_plain(r.top_i, E)
    assert torch.equal(r.ends, ends)
    mine = r._replace(order=order, work=None)
    rows, pos = kmoe.moe_permute(xf, r)
    want_rows, want_pos = kmoe.moe_permute_plain(xf, mine)
    torch.cuda.synchronize()
    assert torch.equal(pos, want_pos) and torch.equal(rows, want_rows)
    out_rows = torch.randn(rows.shape, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               7)).to(dtype)
    y = kmoe.moe_combine(out_rows, r, pos)
    y_want = kmoe.moe_combine_plain(out_rows, mine, want_pos)
    torch.cuda.synchronize()
    assert _row_steps(y, y_want, dtype) <= (1 if dtype == torch.bfloat16
                                            else 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 64])
def test_zero_router_ties_pick_the_lowest_experts_on_card(dev, T, dtype):
    cfg, lp = _card_layer(dev, dtype, 64, 6, False, 256, 128,
                          zero_router=True)
    xf = _hidden(cfg, T, dev, dtype).reshape(-1, cfg.d_model)
    r = kmoe.moe_route(xf, lp["router"], 6, False)
    torch.cuda.synchronize()
    assert torch.equal(r.top_i.cpu(), torch.arange(6).expand(T, 6))
    assert torch.equal(r.top_w.cpu(), torch.full((T, 6), 1 / 64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES[:3])
def test_kernel_path_layer_within_one_bf16_step_on_card(dev, case, dtype):
    cfg, lp = _card_layer(dev, dtype, *case)
    eager = dataclasses.replace(cfg, use_kernels=False)
    for T in (1, 64):
        x = _hidden(cfg, T, dev, dtype, seed=T)
        before = _counts()
        names = ("moe_route", "moe_permute", "moe_combine")
        launched = [getattr(kmoe, n).launches for n in names]
        acts = glue.gated_act.launches
        with moe.recorded_routes() as routes:
            got, aux = moe.moe_apply_grouped(x, lp, cfg)
        want, want_aux = moe.moe_apply_grouped(x, lp, eager)
        torch.cuda.synchronize()
        calls, pairs, fused = _counts()
        assert (calls - before[0], fused - before[2]) == (2, 1)
        assert [getattr(kmoe, n).launches - m
                for n, m in zip(names, launched)] == [1, 1, 1]
        assert glue.gated_act.launches - acts == 1
        assert len(routes) == 1 and routes[0].shape == (T, case[1])
        flat = x.reshape(-1, cfg.d_model)
        assert torch.equal(routes[0], moe._router(flat, lp["router"],
                                                  case[1],
                                                  renorm=case[2])[1])
        if dtype == torch.float32:   # two routings, each within 1e-6
            rel = (got - want).abs().max() / want.abs().max()
            assert float(rel) <= 2e-6
        else:
            assert _row_steps(got.reshape(T, -1), want.reshape(T, -1),
                              dtype) <= 1
        torch.testing.assert_close(aux, want_aux, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_kernel_path_reads_nothing_back_on_card(dev):
    cfg, lp = _card_layer(dev, torch.bfloat16, 64, 6, False, 256, 128)
    x = _hidden(cfg, 64, dev, torch.bfloat16)
    moe.moe_apply_grouped(x, lp, cfg)                  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe.moe_apply_grouped(x, lp, cfg)
        moe.moe_apply_grouped(x[:, :1], lp, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float16", "experts", "choices", "grad"])
def test_the_card_refuses_what_the_kernels_cannot_take_on_card(dev, case):
    """On the card the kernel path raises where the kernels cannot go,
    as every kernel wrapper does: it never falls back to the eager
    composition."""
    shape = {"experts": (260, 2, True, 256, 128),
             "choices": (16, 9, False, 256, 128)}.get(
                 case, (64, 6, False, 256, 128))
    dtype = torch.float16 if case == "float16" else torch.bfloat16
    cfg, lp = _card_layer(dev, dtype, *shape)
    x = _hidden(cfg, 4, dev, dtype)
    if case == "grad":
        x.requires_grad_(True)
    before = _counts()
    with pytest.raises(build.KernelError):
        moe.moe_apply_grouped(x, lp, cfg)
    assert _counts() == before
