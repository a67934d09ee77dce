"""The port's plain recurrences without a Python step a token, on the CPU.

* ``models.scan.associative_scan`` against ``jax.lax.associative_scan``
  on RG-LRU's combine: equal bit for bit (the same recursion), on two
  dims, and differentiable like the sequential oracle.
* The plain recurrentgemma (``use_kernels=False``) against the
  reference's plain path (``use_pallas=False``) at f32, with the
  reference's init and with ``lam`` negated (a live recurrence).
* ``rwkv6.wkv_chunked`` against the reference model's ``wkv_scan`` (JAX)
  and the sequential ``ref.wkv6_state_ref``, at extreme decays, with and
  without a state, and with some decays exactly 0; its gradients against
  autograd through the sequential oracle.
* A guard for the trace: the aten ops one layer of each recurrent family
  dispatches under ``FakeTensorMode`` grow by at most a log factor from
  T = 64 to T = 1024 (a Python step a token grew them 16x).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_tiny_config as jax_tiny  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.rwkv6 import wkv_scan as jax_wkv_scan  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import build_model, registry, rglru  # noqa: E402
from repro_torch.models.rwkv6 import wkv_chunked  # noqa: E402
from repro_torch.models.scan import associative_scan  # noqa: E402

#: wkv_chunked against a sequential scan: max abs error over the larger
#: of 1 and the output's max |value| (measured: below 1e-6 at T <= 256)
WKV_REL = 4e-6
#: gradients: max abs error over the gradient's own max |value|
GRAD_REL = 1e-5
#: the plain recurrentgemma against the reference's, over each tensor's
#: max |value|: logits; prefill cache leaves.  The cache's ``conv`` leaf
#: (a product's output, no recurrence in it) already differs by 1.4e-6
#: with ``lam`` negated, as it did with the sequential loop: XLA and
#: torch sum the products in other orders.
RG_LOGITS_REL, RG_CACHE_REL = 1e-6, 2e-6
#: the op-count guard: count(T=1024) <= count(T=64) * log2(1024)/log2(64)
LOG_FACTOR = np.log2(1024) / np.log2(64)


def _rng(seed):
    return np.random.default_rng(seed)


def _rglru_combine_jax(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


# -- associative_scan --------------------------------------------------------

@pytest.mark.parametrize("dim", [1, 0])
@pytest.mark.parametrize("T", [1, 2, 7, 256])
def test_associative_scan_equals_jax_bit_for_bit(T, dim):
    shape = (3, T, 5) if dim == 1 else (T, 4, 6)
    a = _rng(T).uniform(0.9, 1.0, shape).astype(np.float32)
    x = _rng(T + 1).standard_normal(shape).astype(np.float32)
    ja, jh = jax.lax.associative_scan(
        _rglru_combine_jax, (jnp.asarray(a), jnp.asarray(x)), axis=dim)
    ta, th = associative_scan(rglru._combine,
                              (torch.from_numpy(a), torch.from_numpy(x)),
                              dim=dim)
    for got, want in ((th, jh), (ta, ja)):
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


def test_associative_scan_gradients_equal_the_sequential_oracle():
    a = torch.from_numpy(_rng(0).uniform(0.5, 1.0, (2, 37, 8))
                         .astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(_rng(1).standard_normal((2, 37, 8))
                         .astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(_rng(2).standard_normal((2, 37, 8))
                         .astype(np.float32))
    _, h = associative_scan(rglru._combine, (a, x), dim=1)
    got = torch.autograd.grad((h * g).sum(), (a, x))
    want = torch.autograd.grad((ref.rglru_scan_ref(a, x) * g).sum(), (a, x))
    for gg, ww in zip(got, want):
        err = float((gg - ww).abs().max() / ww.abs().max())
        assert err <= GRAD_REL, err


# -- recurrentgemma's plain path ---------------------------------------------

def _negate_lam(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: -v if k == "lam" else _negate_lam(v) for k, v in tree.items()}


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("negate", [False, True])
def test_plain_recurrentgemma_matches_reference_plain_path(negate):
    arch = "recurrentgemma-2b"
    jc = dataclasses.replace(jax_tiny(arch), dtype="float32",
                             use_pallas=False)
    tc = dataclasses.replace(get_tiny_config(arch), dtype="float32",
                             use_kernels=False)
    jm = jax_build(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    if negate:
        jp = _negate_lam(jp)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks = _rng(0).integers(0, jc.vocab_size, (2, 40), dtype=np.int32)
    jlg, jcache = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, 48))(
        jp, jnp.asarray(toks))
    tlg, tcache = build_model(tc, device="cpu").prefill(
        tp, {"tokens": torch.from_numpy(toks)}, 48)
    assert _rel(tlg.numpy(), jlg) <= RG_LOGITS_REL
    jl = jax.tree_util.tree_leaves(jcache)
    tl = registry._flatten(tcache)
    assert len(tl) == len(jl)
    for (name, got), want in zip(tl, jl):
        assert tuple(got.shape) == want.shape, name
        gap = _rel(got.float().numpy(), want)
        print(f"recurrentgemma lam negated={negate} cache {name}: rel {gap}")
        assert gap <= RG_CACHE_REL, name


# -- wkv_chunked --------------------------------------------------------------

#: log-decay ranges: steep (w down to 1.8e-35), moderate, within 1e-6 of 0
DECAYS = {"steep": (-80.0, -20.0), "moderate": (-5.0, -0.5),
          "near_one": (-1e-6, 0.0)}


def _wkv_inputs(T, decay, seed, *, zeros=False, B=2, H=3, hd=16):
    rng = _rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    lo, hi = DECAYS[decay]
    w = np.exp(rng.uniform(lo, hi, (B, T, H, hd))).astype(np.float32)
    if zeros:
        w[:, ::5, :, ::3] = 0.0
    u = rng.uniform(-0.5, 0.5, (H, hd)).astype(np.float32)
    S = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, S


def _scale_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


jax_wkv = jax.jit(jax_wkv_scan)


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("T", [1, 15, 16, 17, 100])
def test_wkv_chunked_matches_sequential_scans(T, decay, zeros):
    r, k, v, w, u, S = _wkv_inputs(T, decay, T, zeros=zeros)
    for state in (None, S):
        y, Sf = wkv_chunked(*(torch.from_numpy(t) for t in (r, k, v, w, u)),
                            None if state is None else torch.from_numpy(S))
        assert y.dtype == Sf.dtype == torch.float32
        assert tuple(y.shape) == r.shape and tuple(Sf.shape) == S.shape
        S0 = np.zeros_like(S) if state is None else S
        jy, jS = jax_wkv(*(jnp.asarray(t) for t in (r, k, v, w, u, S0)))
        oy, oS = ref.wkv6_state_ref(
            *(torch.from_numpy(t) for t in (r, k, v, w, u)),
            None if state is None else torch.from_numpy(S))
        for got, want in ((y, jy), (Sf, jS), (y, oy), (Sf, oS)):
            assert _scale_err(got, want) <= WKV_REL


@pytest.mark.parametrize("decay,zeros", [("moderate", False),
                                         ("moderate", True),
                                         ("steep", True),
                                         ("near_one", False)])
def test_wkv_chunked_gradients_equal_the_sequential_oracle(decay, zeros):
    T = 37
    arrays = _wkv_inputs(T, decay, 7, zeros=zeros, H=2, hd=8)
    ins = [torch.from_numpy(t).requires_grad_(True) for t in arrays]
    rng = _rng(8)
    gy = torch.from_numpy(rng.standard_normal(arrays[0].shape)
                          .astype(np.float32))
    gS = torch.from_numpy(rng.standard_normal(arrays[5].shape)
                          .astype(np.float32))

    def grads(fn):
        y, S = fn(*ins)
        return torch.autograd.grad((y * gy).sum() + (S * gS).sum(), ins)

    got, want = grads(wkv_chunked), grads(ref.wkv6_state_ref)
    for name, gg, ww in zip("rkvwuS", got, want):
        assert bool(torch.isfinite(gg).all()), name
        err = float((gg - ww).abs().max() / ww.abs().max())
        assert err <= GRAD_REL, (name, err)


# -- the trace guard ---------------------------------------------------------

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops_of_one_layer(arch, T, backward):
    """Aten ops of a one-layer tiny model's forward (and backward) on fake
    tensors: recurrentgemma's one layer is a recurrent one."""
    cfg = dataclasses.replace(get_tiny_config(arch), num_layers=1,
                              dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        fp = torch.utils._pytree.tree_map(
            lambda t: fake.from_tensor(t).requires_grad_(backward), params)
        tokens = torch.zeros((2, T), dtype=torch.int64)
        count = _CountOps()
        with count:
            logits = model.mod.forward(fp, tokens, cfg)
            if backward:
                logits.sum().backward()
    return count.n


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_traced_ops_grow_by_at_most_a_log_factor(arch, backward):
    short = _ops_of_one_layer(arch, 64, backward)
    long = _ops_of_one_layer(arch, 1024, backward)
    print(f"{arch} one layer, backward={backward}: {short} aten ops at "
          f"T 64, {long} at T 1024")
    assert short < long <= short * LOG_FACTOR, (short, long)
