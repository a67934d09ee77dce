"""The port's attention kernels on the CPU: their plain PyTorch versions
(what the wrappers run for CPU tensors) held to the reference package's
Pallas kernels in interpret mode and to its naive oracles, on the same
numpy inputs.  The sweep mirrors ``tests/test_kernels.py``.

Tolerances: f32 atol/rtol 1e-5 (both sides compute in f32, in different
orders); bf16 uses ``tol(bf16)`` of ``tests/test_kernels.py`` (2e-2):
both sides round inputs and outputs to bf16 at the same points.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import ops as kops, ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain)
from repro_torch.kernels.build import KernelError  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check_inputs as flash_check_inputs, flash_attention_plain,
    instance_for as flash_instance_for)

# the reference oracles, jitted: one compile per shape instead of one per
# primitive (same math)
jref_attention = jax.jit(jref.attention_ref, static_argnames=(
    "causal", "window", "softcap", "scale"))
jref_decode = jax.jit(jref.decode_attention_ref, static_argnames=(
    "window", "softcap", "scale"))

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _np(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(a, jdt, tdt):
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def tol(name):
    return 2e-2 if name == "bfloat16" else 1e-5


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("B,H,K,S,hd,bq,bk", [
    (2, 4, 2, 64, 32, 32, 32),      # GQA
    (1, 4, 1, 64, 64, 32, 16),      # MQA, uneven blocks
])
def test_flash_plain_matches_pallas_interpret(B, H, K, S, hd, bq, bk, name,
                                              jdt, tdt):
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_np((B, n, S, hd), i), jdt, tdt)
        for i, n in enumerate((H, K, K)))
    want = jops.flash_attention(jq, jk, jv, causal=True, block_q=bq,
                                block_k=bk, interpret=True)
    got = flash_attention_plain(tq, tk, tv, causal=True)
    assert got.dtype == tdt and got.shape == (B, H, S, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol(name),
                               rtol=tol(name))
    # the oracle agrees too
    np.testing.assert_allclose(
        _f32(tref.attention_ref(tq, tk, tv)),
        _f32(jref_attention(jq, jk, jv)), atol=tol(name), rtol=tol(name))


@pytest.mark.parametrize("window,softcap,causal", [
    (0, 0.0, False), (16, 0.0, True), (0, 30.0, True), (8, 50.0, True)])
def test_flash_plain_masks_match_pallas_interpret(window, softcap, causal):
    B, H, K, S, hd = 1, 2, 1, 64, 32
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_np((B, n, S, hd), 10 + i), jnp.float32, torch.float32)
        for i, n in enumerate((H, K, K)))
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                softcap=softcap, block_q=32, block_k=32,
                                interpret=True)
    got = kops.flash_attention(tq, tk, tv, causal=causal, window=window,
                               softcap=softcap)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,window", [(1, 0), (37, 0), (45, 16)])
def test_flash_plain_ragged_sequence_matches_oracle(S, window):
    """The port's kernel masks the ragged edge instead of asserting S
    divides the tile, so its plain version must hold at any S too."""
    B, H, K, hd = 2, 4, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_np((B, n, S, hd), 20 + i), jnp.float32, torch.float32)
        for i, n in enumerate((H, K, K)))
    got = flash_attention_plain(tq, tk, tv, window=window)
    want = jref_attention(jq, jk, jv, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("B,H,K,S,hd,bs", [
    (2, 4, 2, 256, 32, 64),    # GQA, several blocks
    (2, 4, 1, 128, 64, 128),   # MQA, single block
])
def test_decode_plain_matches_pallas_interpret(B, H, K, S, hd, bs, name,
                                               jdt, tdt):
    jq, tq = _both(_np((B, H, hd), 0), jdt, tdt)
    jk, tk = _both(_np((B, K, S, hd), 1), jdt, tdt)
    jv, tv = _both(_np((B, K, S, hd), 2), jdt, tdt)
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    qpos = np.full((B,), S - 1, np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(kpos),
                                 jnp.asarray(qpos), block_s=bs,
                                 interpret=True)
    got = decode_attention_plain(tq, tk, tv, torch.from_numpy(kpos),
                                 torch.from_numpy(qpos))
    assert got.dtype == tdt and got.shape == (B, H, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol(name),
                               rtol=tol(name))


def test_decode_plain_ring_buffer_masking_matches_pallas_interpret():
    """Partially-filled ring cache: empty slots (pos -1) must not attend;
    a sliding window narrows further."""
    B, H, K, S, hd = 1, 2, 2, 128, 32
    jq, tq = _both(_np((B, H, hd), 3), jnp.float32, torch.float32)
    jk, tk = _both(_np((B, K, S, hd), 4), jnp.float32, torch.float32)
    jv, tv = _both(_np((B, K, S, hd), 5), jnp.float32, torch.float32)
    kpos = np.where(np.arange(S) < 40, np.arange(S), -1)[None].astype(
        np.int32)
    qpos = np.full((B,), 39, np.int32)
    for window in (0, 8):
        want = jops.decode_attention(jq, jk, jv, jnp.asarray(kpos),
                                     jnp.asarray(qpos), window=window,
                                     block_s=64, interpret=True)
        got = kops.decode_attention(tq, tk, tv, torch.from_numpy(kpos),
                                    torch.from_numpy(qpos), window=window)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5,
                                   rtol=1e-5)


def test_decode_plain_all_empty_cache_is_mean_of_v():
    """A ring cache with every slot empty: the reference (masked logits
    at -1e30) returns the mean of V, not NaN."""
    B, H, K, S, hd = 2, 4, 2, 64, 32
    jq, tq = _both(_np((B, H, hd), 6), jnp.float32, torch.float32)
    jk, tk = _both(_np((B, K, S, hd), 7), jnp.float32, torch.float32)
    jv, tv = _both(_np((B, K, S, hd), 8), jnp.float32, torch.float32)
    kpos = np.full((B, S), -1, np.int32)
    qpos = np.zeros((B,), np.int32)
    got = decode_attention_plain(tq, tk, tv, torch.from_numpy(kpos),
                                 torch.from_numpy(qpos))
    assert torch.isfinite(got).all()
    want = jref_decode(jq, jk, jv, jnp.asarray(kpos), jnp.asarray(qpos))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)
    mean_v = tv.mean(dim=2).repeat_interleave(H // K, dim=1)
    np.testing.assert_allclose(_f32(got), _f32(mean_v), atol=1e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 20.0)])
def test_decode_ref_matches_reference_ref(window, softcap):
    B, H, K, S, hd = 3, 4, 2, 96, 32
    jq, tq = _both(_np((B, H, hd), 9), jnp.float32, torch.float32)
    jk, tk = _both(_np((B, K, S, hd), 10), jnp.float32, torch.float32)
    jv, tv = _both(_np((B, K, S, hd), 11), jnp.float32, torch.float32)
    kpos = np.where(np.arange(S) < 70, np.arange(S), -1)[None].repeat(
        B, 0).astype(np.int32)
    qpos = np.array([69, 50, 10], np.int32)
    got = tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(kpos),
                                    torch.from_numpy(qpos), window=window,
                                    softcap=softcap)
    want = jref_decode(jq, jk, jv, jnp.asarray(kpos),
                                     jnp.asarray(qpos), window=window,
                                     softcap=softcap)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)


def test_cpu_wrappers_run_plain_and_launch_nothing():
    q = torch.from_numpy(_np((1, 2, 16, 32), 0))
    f0 = kops.flash_attention.launches
    d0 = kops.decode_attention.launches
    out = kops.flash_attention(q, q[:, :1], q[:, :1])
    np.testing.assert_array_equal(
        out.numpy(), flash_attention_plain(q, q[:, :1], q[:, :1]).numpy())
    kpos = torch.arange(16, dtype=torch.int32)[None]
    kops.decode_attention(q[:, :, 0], q[:, :1], q[:, :1], kpos,
                          torch.tensor([15], dtype=torch.int32))
    assert kops.flash_attention.launches == f0
    assert kops.decode_attention.launches == d0


# -- the registry ------------------------------------------------------------

def test_kernel_step_memoized_with_twin_and_batched_forms():
    a = kops.kernel_step("flash_attention", causal=True, window=8)
    b = kops.kernel_step("flash_attention", window=8, causal=True)
    assert a is b
    assert kops.kernel_step("flash_attention", causal=False) is not a
    twin = kops.placed_twin(a)
    assert twin is a.__kernel_placed__
    assert twin.__kernel__ == a.__kernel__
    assert a.__annotations__["q"] is torch.Tensor
    with pytest.raises(ValueError):
        kops.kernel_step("flash_attention", block_q=128)  # no tile params
    with pytest.raises(ValueError):
        kops.kernel_step("wkv6", chunk=4)                  # no tile params
    # a bound trailing arg: memoized per bound identity, not a column
    u1, u2 = torch.zeros(2, 8), torch.zeros(2, 8)
    w1 = kops.kernel_step("wkv6", bound={"u": u1})
    assert kops.kernel_step("wkv6", bound={"u": u1}) is w1
    assert kops.kernel_step("wkv6", bound={"u": u2}) is not w1
    assert w1.__code__.co_varnames[:w1.__code__.co_argcount] == \
        ("r", "k", "v", "w")
    # per row the step adds B=1; the batched form takes the stacked rows
    q, k = torch.from_numpy(_np((3, 2, 8, 32), 1)), \
        torch.from_numpy(_np((3, 1, 8, 32), 2))
    rows = torch.stack([a(q[i], k[i], k[i]) for i in range(3)])
    np.testing.assert_allclose(a.__batched__(q, k, k).numpy(), rows.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(twin.__batched__(q, k, k).numpy(),
                               rows.numpy(), atol=1e-5, rtol=1e-5)


def _user_attn(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    return q      # stand-in body; the pattern tag is what matters


def test_register_pattern_resolves_twin():
    try:
        kops.register_pattern(_user_attn, "flash_attention", causal=True)
        call = kops.match_kernel(_user_attn)
        assert call is not None and call.kernel == "flash_attention"
        assert kops.placed_twin(_user_attn) is kops.placed_fn(call)
    finally:
        kops.KERNEL_PATTERNS.pop(_user_attn, None)


def test_tile_rules_state_the_cuda_constraints():
    flash = kops.KERNEL_REGISTRY["flash_attention"]
    dec = kops.KERNEL_REGISTRY["decode_attention"]
    # yi-9b shapes (batched and row-level) pass; S needs no divisibility
    assert flash.check_tiles({"q": (4, 32, 250, 128), "k": (4, 4, 250, 128)}
                             ) == []
    assert dec.check_tiles({"q": (32, 128), "k_cache": (4, 1000, 128)}) == []
    assert flash.check_tiles({"q": (2, 4, 16, 12), "k": (2, 2, 16, 12)})
    assert flash.check_tiles({"q": (2, 5, 16, 64), "k": (2, 2, 16, 64)})
    assert dec.check_tiles({"q": (4, 64, 48), "k_cache": (4, 2, 9, 48)})
    assert dec.check_tiles({"q": (4, 6, 64), "k_cache": (4, 4, 9, 64)})
    # any group size: granite-34b's 48 q heads on one kv head
    assert dec.check_tiles({"q": (4, 48, 128), "k_cache": (4, 1, 9, 128)}
                           ) == []


@pytest.mark.parametrize("dtype,hd,instance,ok", [
    (torch.bfloat16, 128, "wgmma", True),     # B*H on grid x
    (torch.bfloat16, 256, "pingpong", True),  # B*H on grid x
    (torch.bfloat16, 96, "simt", False),      # B*H on grid y
    (torch.float32, 128, "simt", False)])
def test_flash_grid_limit_follows_the_instance(dtype, hd, instance, ok):
    """The SIMT instance puts B*H on grid y (at most 65535); the
    tensor-core instance puts it on grid x and its query tiles on y, so
    it takes more heads.  The check picks the instance and the alignment
    once and returns them (zero-stride views: no memory)."""
    B, H, S = 1, 65536 + 64, 64
    q = torch.zeros((1, 1, 1, hd), dtype=dtype).expand(B, H, S, hd)
    k = torch.zeros((1, 1, 1, hd), dtype=dtype).expand(B, 1, S, hd)
    if ok:
        assert flash_check_inputs(q, k, k) == (instance, True)
    else:
        with pytest.raises(KernelError, match=f"{instance} instance's grid"):
            flash_check_inputs(q, k, k)
    small = q[:, :64]
    assert flash_check_inputs(small, k, k) == (instance, True)


@pytest.mark.parametrize("dtype,hd,instance", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "pingpong"), (torch.bfloat16, 96, "simt"),
    (torch.bfloat16, 192, "simt"), (torch.float32, 256, "simt"),
    (torch.float32, 128, "simt")])
def test_flash_instance_by_dtype_and_head_dim(dtype, hd, instance):
    """The instance is a function of dtype and head_dim alone: bf16 at 64
    and 128 on the 64-row tensor-core instance, at 256 on the ping-pong
    one, every f32 and every other bf16 head_dim on the SIMT one."""
    q = torch.zeros((1, 2, 8, hd), dtype=dtype)
    assert flash_instance_for(q) == instance
    assert flash_check_inputs(q, q[:, :1], q[:, :1]) == (instance, True)


@pytest.mark.parametrize("view", ["shifted", "wide_rows"])
@pytest.mark.parametrize("dtype,hd,instance", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "pingpong"), (torch.float32, 256, "simt")])
def test_flash_misaligned_views_by_instance(dtype, hd, instance, view):
    """The tensor-core instances read q, k and v through TMA: a view that
    starts one element in, or whose rows are 8 bytes apart from a
    multiple of 16, is refused with a message naming the instance (never
    sent to the SIMT instance).  The SIMT instance takes the same view
    with element loads (``aligned`` False)."""
    B, H, S = 1, 2, 16
    if view == "shifted":
        bad = torch.zeros(B * H * S * hd + 1, dtype=dtype)[1:].view(
            B, H, S, hd)
    else:
        bad = torch.zeros((B, H, S, hd + 8 // dtype.itemsize),
                          dtype=dtype)[..., :hd]
    good = torch.zeros((B, H, S, hd), dtype=dtype)
    if instance == "simt":
        assert flash_check_inputs(bad, good, good) == ("simt", False)
    else:
        with pytest.raises(KernelError, match=f"the {instance} instance "
                           "reads q, k and v through TMA"):
            flash_check_inputs(bad, good, good)
    assert flash_check_inputs(good, good, good) == (instance, True)
