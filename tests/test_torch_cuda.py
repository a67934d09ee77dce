"""The port's CUDA kernels on the card, held to their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 inputs 1e-4 absolute (the kernel and the plain version
sum in different orders); bf16 inputs compare rel max error < 0.05, the
reference package's bar for bf16 kernel paths.
"""
import dataclasses
import gc
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.build import KernelError  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain)
from repro_torch.kernels.rglru_scan import rglru_scan_plain  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_plain  # noqa: E402

from repro_torch.models import rglru  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dtype, dev, seed, scale=0.3):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.tensor(a, dtype=torch.float32, device=dev).to(dtype)


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        rel = (got - want).abs().max() / want.abs().max().clamp_min(1e-6)
        assert rel < 0.05, float(rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,hd,window,softcap,causal", [
    (2, 8, 2, 128, 64, 0, 0.0, True),
    (1, 4, 1, 100, 128, 0, 0.0, True),       # ragged S, MQA
    (2, 4, 2, 96, 32, 16, 0.0, True),        # window
    (1, 4, 4, 64, 64, 0, 30.0, True),        # softcap
    (1, 2, 1, 70, 64, 0, 0.0, False),        # non-causal, ragged
    (4, 32, 4, 256, 128, 0, 0.0, True),      # yi-9b prefill shape
])
def test_flash_kernel_matches_plain(dev, dtype, B, H, K, S, hd, window,
                                    softcap, causal):
    q = _rand((B, H, S, hd), dtype, dev, 0)
    k = _rand((B, K, S, hd), dtype, dev, 1)
    v = _rand((B, K, S, hd), dtype, dev, 2)
    n0 = kops.flash_attention.launches
    got = kops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    torch.cuda.synchronize()
    assert kops.flash_attention.launches == n0 + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views(dev, dtype):
    B, S, H, K, hd = 2, 48, 8, 2, 64
    q = _rand((B, S, H, hd), dtype, dev, 3).transpose(1, 2)
    k = _rand((B, S, K, hd), dtype, dev, 4).transpose(1, 2)
    v = _rand((B, S, K, hd), dtype, dev, 5).transpose(1, 2)
    got = kops.flash_attention(q, k, v)
    _close(got, flash_attention_plain(q, k, v), dtype)


def _ring(B, S, filled, dev):
    kpos = torch.full((B, S), -1, dtype=torch.int32)
    for b, n in enumerate(filled):
        kpos[b, :n] = torch.arange(n, dtype=torch.int32)
    qpos = torch.tensor([max(n - 1, 0) for n in filled], dtype=torch.int32)
    return kpos.to(dev), qpos.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,hd,window,softcap", [
    (2, 4, 2, 128, 64, 0, 0.0),
    (3, 8, 8, 100, 32, 0, 0.0),      # MHA, ragged S
    (2, 4, 1, 256, 128, 8, 0.0),     # MQA + window
    (1, 8, 2, 64, 256, 0, 50.0),     # hd 256 + softcap
    (4, 32, 4, 1024, 128, 0, 0.0),   # yi-9b decode shape
    (2, 48, 1, 1024, 128, 0, 0.0),   # granite-34b: G = 48, two passes
    (2, 80, 2, 100, 64, 16, 0.0),    # G = 40, ragged S + window
])
def test_decode_kernel_matches_plain(dev, dtype, B, H, K, S, hd, window,
                                     softcap):
    q = _rand((B, H, hd), dtype, dev, 0)
    # the model's native [B, W, K, hd] cache, handed over transposed
    kc = _rand((B, S, K, hd), dtype, dev, 1).transpose(1, 2)
    vc = _rand((B, S, K, hd), dtype, dev, 2).transpose(1, 2)
    filled = [S - 7 * b for b in range(B)]
    kpos, qpos = _ring(B, S, filled, dev)
    n0 = kops.decode_attention.launches
    got = kops.decode_attention(q, kc, vc, kpos, qpos, window=window,
                                softcap=softcap)
    torch.cuda.synchronize()
    assert kops.decode_attention.launches == n0 + 1
    want = decode_attention_plain(q, kc, vc, kpos, qpos, window=window,
                                  softcap=softcap)
    _close(got, want, dtype)


def test_decode_kernel_empty_cache_is_mean_of_v(dev):
    B, H, K, S, hd = 2, 4, 2, 64, 64
    q = _rand((B, H, hd), torch.float32, dev, 0)
    kc = _rand((B, K, S, hd), torch.float32, dev, 1)
    vc = _rand((B, K, S, hd), torch.float32, dev, 2)
    kpos = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    qpos = torch.zeros((B,), dtype=torch.int32, device=dev)
    got = kops.decode_attention(q, kc, vc, kpos, qpos)
    want = vc.mean(dim=2).repeat_interleave(H // K, dim=1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hd,instance", [(64, "wgmma"), (128, "wgmma"),
                                         (256, "simt")])
def test_flash_bf16_instance_by_head_dim(dev, hd, instance):
    B, H, K, S = 2, 4, 2, 192
    q = _rand((B, H, S, hd), torch.bfloat16, dev, 20)
    k = _rand((B, K, S, hd), torch.bfloat16, dev, 21)
    v = _rand((B, K, S, hd), torch.bfloat16, dev, 22)
    for window in (0, 70):
        got = kops.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        assert kops.flash_attention.last_instance == instance
        _close(got, flash_attention_plain(q, k, v, window=window),
               torch.bfloat16)


@pytest.mark.parametrize("dtype,instance", [(torch.bfloat16, "wgmma"),
                                            (torch.float32, "simt")])
def test_flash_yi9b_prefill_instance(dev, dtype, instance):
    """yi-9b's prefill ([B, S, H, hd] views, H=32, K=4, hd=128): bf16 on
    the tensor-core instance through TMA, f32 on the SIMT instance."""
    B, S, H, K, hd = 4, 256, 32, 4, 128
    q = _rand((B, S, H, hd), dtype, dev, 23).transpose(1, 2)
    k = _rand((B, S, K, hd), dtype, dev, 24).transpose(1, 2)
    v = _rand((B, S, K, hd), dtype, dev, 25).transpose(1, 2)
    n0 = kops.flash_attention.launches
    got = kops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kops.flash_attention.launches == n0 + 1
    assert kops.flash_attention.last_instance == instance
    _close(got, flash_attention_plain(q, k, v), dtype)


def test_flash_tensor_core_refuses_misaligned_views(dev):
    """TMA needs 16-byte-aligned bases and strides: a view that starts
    one element in, or whose row stride is not a multiple of 16 bytes,
    raises KernelError instead of launching."""
    B, H, S, hd = 1, 2, 64, 64
    flat = torch.zeros(B * H * S * hd + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(B, H, S, hd)
    good = _rand((B, H, S, hd), torch.bfloat16, dev, 26)
    with pytest.raises(KernelError):
        kops.flash_attention(shifted, good, good)
    wide = _rand((B, H, S, hd + 4), torch.bfloat16, dev, 27)[..., :hd]
    with pytest.raises(KernelError):                 # row stride 136 bytes
        kops.flash_attention(good, wide, good)
    # the SIMT instance takes a misaligned f32 view (element loads)
    flat32 = _rand((B * H * S * hd + 1,), torch.float32, dev, 28)
    q32 = flat32[1:].view(B, H, S, hd)
    got = kops.flash_attention(q32, good.float(), good.float())
    assert kops.flash_attention.last_instance == "simt"
    _close(got, flash_attention_plain(q32, good.float(), good.float()),
           torch.float32)


def test_flash_tensor_core_takes_more_than_65535_heads(dev):
    """B*H lies on grid x of the tensor-core instance, so more than 65535
    (b, head) pairs launch; every head here shares one kv head, so a
    slice of heads is held to the plain version."""
    B, H, S, hd = 1, 65536 + 64, 64, 64
    q = _rand((B, 64, S, hd), torch.bfloat16, dev, 29).repeat(
        1, H // 64, 1, 1)
    k = _rand((B, 1, S, hd), torch.bfloat16, dev, 30)
    v = _rand((B, 1, S, hd), torch.bfloat16, dev, 31)
    got = kops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kops.flash_attention.last_instance == "wgmma"
    for h0 in (0, 65536):
        _close(got[:, h0:h0 + 64],
               flash_attention_plain(q[:, h0:h0 + 64], k, v), torch.bfloat16)


def _ring_positions(B, W, filled, dev):
    """kpos/qpos of a ring that held positions 0..n-1 at slot pos % W."""
    kpos = torch.full((B, W), -1, dtype=torch.int32)
    for b, n in enumerate(filled):
        pos = torch.arange(n, dtype=torch.int32)
        kpos[b, pos % W] = pos
    qpos = torch.tensor([max(n - 1, 0) for n in filled], dtype=torch.int32)
    return kpos.to(dev), qpos.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("filled", [
    [264, 264, 257, 264],        # the served path: 264 of 1024 slots
    [1300, 1100, 2000, 700],     # three rings that wrapped
])
def test_decode_split_kernel_on_the_ring(dev, dtype, filled):
    B, H, K, W, hd = 4, 32, 4, 1024, 128
    q = _rand((B, H, hd), dtype, dev, 30)
    kc = _rand((B, W, K, hd), dtype, dev, 31).transpose(1, 2)
    vc = _rand((B, W, K, hd), dtype, dev, 32).transpose(1, 2)
    kpos, qpos = _ring_positions(B, W, filled, dev)
    got = kops.decode_attention(q, kc, vc, kpos, qpos)
    torch.cuda.synchronize()
    assert kops.decode_attention.last_splits == 32
    _close(got, decode_attention_plain(q, kc, vc, kpos, qpos), dtype)


def test_decode_window_without_valid_key_is_mean_of_v(dev):
    """Row 0's keys all lie outside the window, so it has no valid slot
    and nothing may be skipped: the reference averages V over all slots.
    Row 1 keeps valid keys, and its empty tiles are skipped."""
    B, H, K, W, hd = 2, 8, 2, 512, 64
    q = _rand((B, H, hd), torch.float32, dev, 33)
    kc = _rand((B, K, W, hd), torch.float32, dev, 34)
    vc = _rand((B, K, W, hd), torch.float32, dev, 35)
    kpos, _ = _ring_positions(B, W, [40, 300], dev)
    qpos = torch.tensor([400, 299], dtype=torch.int32, device=dev)
    got = kops.decode_attention(q, kc, vc, kpos, qpos, window=16)
    want = decode_attention_plain(q, kc, vc, kpos, qpos, window=16)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    mean_v = vc.mean(dim=2).repeat_interleave(H // K, dim=1)
    torch.testing.assert_close(got[0], mean_v[0], atol=1e-5, rtol=1e-5)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = _rand((1, 4, 16, 12), torch.float32, dev, 0)     # hd 12
    with pytest.raises(KernelError):
        kops.flash_attention(q, q, q)
    with pytest.raises(KernelError):                      # fp16
        kops.flash_attention(*(_rand((1, 2, 16, 64), torch.float16, dev, i)
                               for i in range(3)))
    qd = _rand((1, 4, 48), torch.float32, dev, 0)         # hd 48
    kc = _rand((1, 2, 16, 48), torch.float32, dev, 1)
    kpos, qpos = _ring(1, 16, [16], dev)
    with pytest.raises(KernelError):
        kops.decode_attention(qd, kc, kc, kpos, qpos)
    with pytest.raises(KernelError):                      # mixed devices
        kops.decode_attention(qd, kc.cpu(), kc, kpos, qpos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_cascade_on_card_uses_kernels(dev, dtype):
    """The compiled cascade with kernels on the card: the chain launches
    the kernels, and its greedy tokens equal the plain model loop's (f32:
    exactly; bf16: the first-step logits agree within rel 0.05)."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_tiny_config("yi-9b"), dtype=dtype,
                              use_kernels=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    plain = build_model(dataclasses.replace(cfg, use_kernels=False))
    toks = torch.randint(0, cfg.vocab_size, (3, dc.SEQ), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    lg_k, cache_k = model.prefill(params, {"tokens": toks.to(dev)},
                                  dc.CACHE)
    lg_p, _ = plain.prefill(params, {"tokens": toks.to(dev)}, dc.CACHE)
    rel = (lg_k - lg_p).abs().max() / lg_p.abs().max()
    assert rel < (1e-5 if dtype == "float32" else 0.05)
    if dtype != "float32":
        return
    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0))
    try:
        pre, dec = dc.build_ops(model, params)
        dep = dc.build(rt, pre, dec)
        table = dc.Table([("tokens", torch.Tensor)],
                         [(toks[i],) for i in range(3)])
        f0 = kops.flash_attention.launches
        d0 = kops.decode_attention.launches
        out = dep.execute(table).result(300)
        chain = dep.plan.ops[-1].op
        runs = chain.batch_dispatches + chain.row_dispatches
        assert kops.flash_attention.launches - f0 == cfg.num_layers * runs
        assert kops.decode_attention.launches - d0 == \
            cfg.num_layers * dc.STEPS * runs
        got = [int(r.values[0]) for r in out.rows]
        assert got == dc.reference_decode(plain, params, toks.to(dev))
    finally:
        rt.stop()


def _decay(shape, dtype, dev, seed):
    a = np.random.default_rng(seed).standard_normal(shape)
    a = 1.0 / (1.0 + np.exp(-a)) * 0.5 + 0.45          # in (0.45, 0.95)
    return torch.tensor(a, dtype=torch.float32, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd", [
    (1, 37, 3, 64),          # odd T (a ragged last chunk)
    (2, 5, 2, 32),
    (1, 20, 2, 100),         # head_dim not a power of two
    (1, 16, 2, 128),         # the largest head_dim
    (4, 256, 32, 64),        # rwkv6-1.6b prefill shape
])
def test_wkv6_kernel_matches_plain(dev, dtype, B, T, H, hd):
    r, k, v = (_rand((B, T, H, hd), dtype, dev, i) for i in range(3))
    w = _decay((B, T, H, hd), dtype, dev, 3)
    u = _rand((H, hd), torch.float32, dev, 4)
    n0 = kops.wkv6.launches
    y, S = kops.wkv6(r, k, v, w, u, return_state=True)
    y_only = kops.wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert kops.wkv6.launches == n0 + 2
    want_y, want_S = wkv6_plain(r, k, v, w, u, return_state=True)
    assert y.dtype == S.dtype == torch.float32
    _close(y, want_y, dtype)
    _close(S, want_S, dtype)
    torch.testing.assert_close(y_only, y, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,R", [
    (2, 37, 300),            # odd T and R
    (3, 1, 129),
    (4, 256, 2560),          # recurrentgemma-2b prefill shape
])
def test_rglru_scan_kernel_matches_plain(dev, dtype, with_h0, B, T, R):
    a = _decay((B, T, R), dtype, dev, 0)
    x = _rand((B, T, R), dtype, dev, 1)
    h0 = _rand((B, R), torch.float32, dev, 2) if with_h0 else None
    n0 = kops.rglru_scan.launches
    got = kops.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert kops.rglru_scan.launches == n0 + 1
    assert got.dtype == torch.float32
    _close(got, rglru_scan_plain(a, x, h0), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd", [
    (2, 1, 2, 64),           # T = 1: one ragged chunk
    (1, 1, 1, 128),
    (1, 9, 2, 32),           # 2 lanes per column, a ragged second chunk
    (1, 17, 3, 100),         # two column blocks, padded rows
    (2, 24, 2, 128),         # 8 lanes per column, three full chunks
])
def test_wkv6_kernel_at_the_split_boundaries(dev, dtype, B, T, H, hd):
    r, k, v = (_rand((B, T, H, hd), dtype, dev, 40 + i) for i in range(3))
    w = _decay((B, T, H, hd), dtype, dev, 43)
    u = _rand((H, hd), torch.float32, dev, 44)
    y, S = kops.wkv6(r, k, v, w, u, return_state=True)
    torch.cuda.synchronize()
    want_y, want_S = wkv6_plain(r, k, v, w, u, return_state=True)
    _close(y, want_y, dtype)
    _close(S, want_S, dtype)
    staging = "cp.async" if dtype == torch.float32 and hd % 4 == 0 \
        else "register"
    assert kops.wkv6.last_instance.endswith(f"{staging} staging")


def test_wkv6_misaligned_f32_rows_stage_through_registers(dev):
    B, T, H, hd = 1, 12, 2, 64
    n = B * T * H * hd
    flat = _rand((4 * n + 1,), torch.float32, dev, 45)
    r, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(B, T, H, hd)
               for i in range(3))
    w = _decay((B, T, H, hd), torch.float32, dev, 46)
    u = _rand((H, hd), torch.float32, dev, 47)
    y, S = kops.wkv6(r, k, v, w, u, return_state=True)
    torch.cuda.synchronize()
    assert kops.wkv6.last_instance == \
        "16 lanes of 4 rows x 4 columns, register staging"
    want_y, want_S = wkv6_plain(r, k, v, w, u, return_state=True)
    _close(y, want_y, torch.float32)
    _close(S, want_S, torch.float32)


def test_wkv6_rwkv6_prefill_instance(dev):
    """rwkv6-1.6b's prefill ([4, 256, 32, 64] f32): tiles of 4 rows by 4
    columns of S, 16 lanes per column group, chunks staged with
    cp.async."""
    B, T, H, hd = 4, 256, 32, 64
    r, k, v = (_rand((B, T, H, hd), torch.float32, dev, 48 + i)
               for i in range(3))
    w = _decay((B, T, H, hd), torch.float32, dev, 51)
    u = _rand((H, hd), torch.float32, dev, 52)
    n0 = kops.wkv6.launches
    y, S = kops.wkv6(r, k, v, w, u, return_state=True)
    torch.cuda.synchronize()
    assert kops.wkv6.launches == n0 + 1
    assert kops.wkv6.last_instance == \
        "16 lanes of 4 rows x 4 columns, cp.async staging"
    want_y, want_S = wkv6_plain(r, k, v, w, u, return_state=True)
    _close(y, want_y, torch.float32)
    _close(S, want_S, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,R", [
    (2, 1, 2560),
    (2, 7, 256),
    (2, 33, 512),            # 4 warps, a ragged last segment
    (1, 300, 2560),          # a cluster of 3 blocks along T
    (1, 2048, 256),          # a cluster of 8 blocks along T
    (1, 4100, 256),          # segments of 65 steps: two sweeps
    (2, 65, 301),            # R odd: a ragged last block of channels
])
def test_rglru_scan_kernel_at_the_split_boundaries(dev, dtype, with_h0, B,
                                                   T, R):
    a = _decay((B, T, R), dtype, dev, 53)
    x = _rand((B, T, R), dtype, dev, 54)
    h0 = _rand((B, R), torch.float32, dev, 55) if with_h0 else None
    n0 = kops.rglru_scan.launches
    got = kops.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert kops.rglru_scan.launches == n0 + 1
    _close(got, rglru_scan_plain(a, x, h0), dtype)
    assert kops.rglru_scan.last_instance.endswith(
        "two sweeps" if T > 2048 else "staged")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_view_offset_by_one_element(dev, dtype):
    """A view that starts one element in: the f32 staging's 4-byte
    copies and the bf16 element copies need no more than the element's
    alignment."""
    B, T, R = 2, 40, 256
    n = B * T * R
    a_flat = torch.empty(n + 1, dtype=dtype, device=dev)
    a_flat[1:] = _decay((n,), dtype, dev, 56)
    a = a_flat[1:].view(B, T, R)
    x = _rand((n + 1,), dtype, dev, 57)[1:].view(B, T, R)
    got = kops.rglru_scan(a, x)
    torch.cuda.synchronize()
    assert kops.rglru_scan.last_instance == "cluster 1 x 4 warps, staged"
    _close(got, rglru_scan_plain(a, x), dtype)


def test_rglru_scan_recurrentgemma_prefill_instance(dev):
    """recurrentgemma-2b's prefill ([4, 256, 2560] f32): clusters of 2
    blocks of 4 warps per 32 channels, 32 steps a warp staged in shared
    memory."""
    B, T, R = 4, 256, 2560
    a = _decay((B, T, R), torch.float32, dev, 58)
    x = _rand((B, T, R), torch.float32, dev, 59)
    n0 = kops.rglru_scan.launches
    got = kops.rglru_scan(a, x)
    torch.cuda.synchronize()
    assert kops.rglru_scan.launches == n0 + 1
    assert kops.rglru_scan.last_instance == \
        "cluster 2 x 4 warps, staged"
    _close(got, rglru_scan_plain(a, x), torch.float32)


def test_recurrent_kernels_refuse_what_they_do_not_take(dev):
    r = _rand((1, 4, 2, 130), torch.float32, dev, 0)       # hd 130
    with pytest.raises(KernelError):
        kops.wkv6(r, r, r, r, r[0, 0])
    r = _rand((1, 4, 2, 32), torch.float32, dev, 0)
    with pytest.raises(KernelError):                       # mixed dtypes
        kops.wkv6(r, r.bfloat16(), r, r, r[0, 0])
    a = _rand((2, 4, 8), torch.float32, dev, 1)
    with pytest.raises(KernelError):                       # fp16
        kops.rglru_scan(a.half(), a.half())
    with pytest.raises(KernelError):                       # mixed devices
        kops.rglru_scan(a, a.cpu())
    with pytest.raises(KernelError):                       # bad h0
        kops.rglru_scan(a, a, a[:, 0, :4])


@pytest.mark.parametrize("arch,kernel,per_prefill", [
    ("rwkv6-1.6b", "wkv6", lambda cfg: cfg.num_layers),
    ("recurrentgemma-2b", "rglru_scan",
     lambda cfg: rglru.layer_types(cfg).count("rec")),
])
def test_tiny_recurrent_cascade_on_card_uses_kernel(dev, arch, kernel,
                                                    per_prefill):
    """The compiled cascade of a tiny recurrent model at f32: its kernel
    runs once per recurrent layer and prefill dispatch, the attention
    kernels never, and the greedy tokens equal the plain model loop."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_tiny_config(arch), dtype="float32",
                              use_kernels=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    plain = build_model(dataclasses.replace(cfg, use_kernels=False))
    toks = torch.randint(0, cfg.vocab_size, (3, 40), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0))
    try:
        pre, dec = dc.build_ops(model, params, cache_len=48)
        dep = dc.build(rt, pre, dec)
        table = dc.Table([("tokens", torch.Tensor)],
                         [(toks[i],) for i in range(3)])
        counters = [getattr(kops, n) for n in (
            kernel, "flash_attention", "decode_attention")]
        n0 = [c.launches for c in counters]
        out = dep.execute(table).result(300)
        chain = dep.plan.ops[-1].op
        runs = chain.batch_dispatches + chain.row_dispatches
        got_n = [c.launches - n for c, n in zip(counters, n0)]
        assert got_n == [per_prefill(cfg) * runs, 0, 0]
        got = [int(r.values[0]) for r in out.rows]
        assert got == dc.reference_decode(plain, params, toks.to(dev),
                                          cache_len=48)
    finally:
        rt.stop()


# -- the serving runtime on the card ------------------------------------------

def _tiny_yi(dev):
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32",
                              use_kernels=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    plain = build_model(dataclasses.replace(cfg, use_kernels=False))
    return cfg, model, params, plain


def _serving_runtime():
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.obs import Tracer

    return dc.Runtime(n_cpu=1, n_gpu=2, net=dc.NetModel(scale=0.0),
                      max_batch=8, batch_wait_ms=50.0,
                      tracer=Tracer(sample_rate=1.0))


def test_batched_cascade_on_card_launches_per_batch(dev):
    """Five one-prompt requests at once through the batching cascade on
    the card: each request's tokens equal the plain loop's on its prompt
    alone (f32), the kernels launch once per batch the tracer saw, and
    the wedge detector stayed quiet."""
    from repro_torch.examples import decode_cascade as dc

    cfg, model, params, plain = _tiny_yi(dev)
    toks = torch.randint(0, cfg.vocab_size, (5, dc.SEQ), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    rt = _serving_runtime()
    try:
        pre, dec = dc.build_ops(model, params)
        dep = dc.build(rt, pre, dec, name="batched", batching=True)
        f0 = kops.flash_attention.launches
        d0 = kops.decode_attention.launches
        got, sizes, _ = dc.serve_requests(dep, toks)
        chain = dep.plan.ops[-1].op
        assert sum(sizes) == 5
        assert chain.batch_dispatches + chain.row_dispatches == len(sizes)
        assert kops.flash_attention.launches - f0 == \
            cfg.num_layers * len(sizes)
        assert kops.decode_attention.launches - d0 == \
            cfg.num_layers * dc.STEPS * len(sizes)
        assert rt.pool.fault_counts["wedge"] == 0
    finally:
        rt.stop()
    assert got == [dc.reference_decode(plain, params, toks[i:i + 1].to(dev))[0]
                   for i in range(5)]


def test_device_resident_demux_on_card(dev):
    """``[prefill, decode]`` merged across requests, then three pinned
    decode steps per request: the parts crossing the edge are
    DeviceTables on the card, the first chain copies nothing back to the
    host, and the tokens equal the plain loop's (f32)."""
    from repro_torch.core.compiler import compile_flow
    from repro_torch.core.dataflow import Dataflow
    from repro_torch.core.table import DeviceTable
    from repro_torch.examples import decode_cascade as dc

    cfg, model, params, plain = _tiny_yi(dev)
    toks = torch.randint(0, cfg.vocab_size, (3, dc.SEQ), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    rt = _serving_runtime()
    try:
        pre, dec = dc.build_ops(model, params)
        _, dec_batched = dc.build_ops(model, params)
        fl = Dataflow([("tokens", torch.Tensor)])
        node = fl.apply_op(pre, gpu=True, batching=True).apply_op(
            dec_batched, gpu=True, batching=True)
        for _ in range(dc.STEPS - 1):
            node = node.apply_op(dec, gpu=True)
        fl.output = node
        dep = compile_flow(fl, rt, fusion=True, name="split")
        n1, n2 = dep.dag.nodes
        seen = []
        inner = dep.dag.nodes[n2].fn

        def spy(tables, ctx):
            seen.append((type(tables[0]), tables[0].device.type))
            return inner(tables, ctx)

        dep.dag.nodes[n2].fn = spy
        futs = [dep.execute(dc.Table([("tokens", torch.Tensor)],
                                     [(toks[i],)])) for i in range(3)]
        got = [int(f.result(300).rows[0].values[0]) for f in futs]
        deadline = time.perf_counter() + 30
        while len(rt.tracer.kept("split")) < 3:
            assert time.perf_counter() < deadline
            time.sleep(0.01)
        for tr in rt.tracer.kept("split"):
            (e1,) = [s for s in tr.spans if s.name == f"exec@{n1}"]
            assert "gathers" not in e1.attrs.get("copies", {})
        assert rt.pool.fault_counts["wedge"] == 0
    finally:
        rt.stop()
    assert seen == [(DeviceTable, "cuda")] * 3
    assert got == [dc.reference_decode(plain, params, toks[i:i + 1].to(dev))[0]
                   for i in range(3)]


def test_full_width_verify_allocates_nothing_and_launches_nothing(dev):
    """yi-9b at full width (2 of its 48 layers, bf16, kernels on): the
    verifier walks the cascade on fake tensors around the weights on the
    card, checks both attention kernels at yi-9b's shapes, and neither
    allocates on the card nor launches a kernel."""
    from repro_torch.analysis import analyze
    from repro_torch.configs import get_config
    from repro_torch.core.ir import PhysicalPlan
    from repro_torch.core.passes import build_pipeline
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=2,
                              use_kernels=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    pre, dec = dc.build_ops(model, params, cache_len=1024)
    plan = build_pipeline(fusion=True, device=dev).run(
        PhysicalPlan.from_dataflow(dc.build_flow(pre, dec, steps=2)))
    sample = Table([("tokens", torch.Tensor)],
                   [(torch.zeros(256, dtype=torch.int32),)])
    gc.collect()        # earlier tests' garbage must not be freed inside
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    launches = {k: getattr(kops, k).launches for k in
                ("flash_attention", "decode_attention")}
    rep = analyze(plan, sample=sample, device=dev, budget_bytes=64 << 30)
    torch.cuda.synchronize()
    assert rep.ok, rep.table()
    assert torch.cuda.memory_allocated(dev) == held
    assert {k: getattr(kops, k).launches for k in launches} == launches
    shapes = {k: s for _op, k, s in rep.kernel_checks}
    assert shapes["flash_attention"][0] == (1, 32, 256, 128)
    assert shapes["decode_attention"][0] == (1, 32, 128)


def test_cf103_verdict_matches_kernel_error_on_the_card(dev):
    """A flash step whose head_dim (12) breaks the CUDA rule: the
    verifier rejects the compile, and the same plan compiled without it
    raises KernelError on its first call; head_dim 16 passes both."""
    from repro_torch.analysis import VerificationError
    from repro_torch.core.compiler import compile_flow
    from repro_torch.core.dataflow import Dataflow
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc

    def flow():
        fl = Dataflow([("q", torch.Tensor), ("k", torch.Tensor),
                       ("v", torch.Tensor)])
        step = kops.kernel_step("flash_attention", causal=True)
        fl.output = fl.map(step, names=["o"], gpu=True).map(
            _double_t, names=["o"], gpu=True)
        return fl

    def sample(hd):
        t = torch.randn(4, 64, hd, generator=torch.Generator().manual_seed(0))
        return Table([("q", torch.Tensor), ("k", torch.Tensor),
                      ("v", torch.Tensor)], [(t, t, t), (t, t, t)])

    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0))
    try:
        with pytest.raises(VerificationError, match="CF103"):
            compile_flow(flow(), rt, fusion=True, verify=True,
                         verify_input=sample(12), name="bad")
        dep = compile_flow(flow(), rt, fusion=True, name="bad-unverified")
        with pytest.raises(KernelError, match="head_dim"):
            dep.execute(sample(12)).result(120)
        n0 = kops.flash_attention.launches
        dep = compile_flow(flow(), rt, fusion=True, verify=True,
                           verify_input=sample(16), name="good")
        assert dep.verification.ok
        out = dep.execute(sample(16)).result(120)
        assert kops.flash_attention.launches > n0
        assert len(out.rows) == 2
    finally:
        rt.stop()


def _double_t(o: torch.Tensor) -> torch.Tensor:
    return o * 2


def test_competitive_cascade_on_card_under_hangs(dev):
    """The tiny f32 cascade as two competitive replicas on two GPU
    workers, a hang fault on the GPU class: every request's tokens equal
    the plain loop's, hangs were injected, and no wedge."""
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.serving import FaultPlan

    cfg, model, params, plain = _tiny_yi(dev)
    toks = torch.randint(0, cfg.vocab_size, (6, dc.SEQ), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3))
    rt = dc.Runtime(n_cpu=1, n_gpu=2, net=dc.NetModel(scale=0.0),
                    hang_timeout_s=30.0)
    try:
        pre, dec = dc.build_ops(model, params)
        dep = dc.build(rt, pre, dec, competitive=2, name="competitive")
        inj = rt.set_fault_plan(FaultPlan(seed=5).hang(
            rate=0.5, hang_s=0.5, classes=("gpu",)))
        got = [int(dep.execute(Table([("tokens", torch.Tensor)],
                                     [(toks[i],)])).result(300)
                   .rows[0].values[0]) for i in range(6)]
        assert inj.counts["hang"] >= 1
        assert rt.pool.fault_counts["wedge"] == 0
    finally:
        rt.stop()
    assert got == [dc.reference_decode(plain, params, toks[i:i + 1].to(dev))[0]
                   for i in range(6)]


# -- profiling on the card ----------------------------------------------------

def test_timing_hook_synchronises_the_card_and_counts_bytes(dev,
                                                            monkeypatch):
    """The decode stage's cost hook on the card: its bytes are the
    output's ``numel x element_size``, each timed call ends in a
    synchronise of the card, and an error the card reports there
    propagates out of the hook."""
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.models import registry

    cfg, model, params, _ = _tiny_yi(dev)
    _, dec = dc.build_ops(model, params)
    _, _, leaves = registry._cache_layout(model, dc.CACHE)
    row = 8 + sum(t.numel() * t.element_size() for t in leaves)
    synced = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: (synced.append(d), real(d))[1])
    got = dec.cost_hook(4)
    assert got["out_bytes"] == 4 * row and got["runs"] == 3
    assert got["mean_s"] > 0 and len(synced) == 4    # warm-up + 3 runs
    assert all(torch.device(d).type == "cuda" for d in synced)

    def failing(d=None):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(torch.cuda, "synchronize", failing)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        dec.cost_hook(1)


def test_profiler_sync_waits_for_the_card_and_propagates(dev, monkeypatch):
    """``profile_plan`` times a chain on the card to the end of its device
    work; a synchronise that fails is not swallowed."""
    from repro_torch.core.ir import PhysicalPlan
    from repro_torch.core.passes import build_pipeline
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.profiling import profile_plan, profiler

    cfg, model, params, _ = _tiny_yi(dev)
    pre, dec = dc.build_ops(model, params, measure=False)
    plan = build_pipeline(fusion=True, device=dev).run(
        PhysicalPlan.from_dataflow(dc.build_flow(pre, dec, batching=True)))
    toks = torch.randint(0, cfg.vocab_size, (dc.SEQ,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    sample = Table([("tokens", torch.Tensor)], [(toks,)])
    fp = profile_plan(plan, sample, batch_sizes=(1, 2), runs=2)
    (curve,) = fp.curves.values()
    assert sorted(curve.buckets) == [1, 2] and curve.per_row_s > 0
    cols = Table([("x", torch.Tensor)], [(torch.ones(4, device=dev),)])

    def failing(d=None):
        raise RuntimeError("CUDA error: unspecified launch failure")
    monkeypatch.setattr(torch.cuda, "synchronize", failing)
    with pytest.raises(RuntimeError, match="launch failure"):
        profiler._sync(cols)


def test_warm_deployment_pays_the_allocator_growth_before_traffic(dev):
    """On the card a cold bucket costs allocator growth: the warm walk
    pays it, and the first request at a warmed bucket allocates no more
    than the walk's peak and builds no executable."""
    from repro_torch.core.compiler import compile_flow
    from repro_torch.core.lowering import EXECUTABLE_CACHE
    from repro_torch.core.table import Table
    from repro_torch.examples import decode_cascade as dc
    from repro_torch.profiling import NodeConfig, PlanConfig, warm_deployment

    cfg, model, params, plain = _tiny_yi(dev)
    toks = torch.randint(0, cfg.vocab_size, (4, dc.SEQ), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3))
    rt = dc.Runtime(n_cpu=1, n_gpu=1, net=dc.NetModel(scale=0.0),
                    max_batch=4)
    try:
        pre, dec = dc.build_ops(model, params, measure=False)
        fl = dc.build_flow(pre, dec, batching=True)
        probe = compile_flow(fl, rt, fusion=True, name="probe")
        (node,) = probe.dag.nodes.values()
        cfg4 = PlanConfig(nodes={node.plan_op_id: NodeConfig(
            max_batch=4, batch_buckets=(1, 2, 4), batched_lowering=True)})
        green = compile_flow(fl, rt, fusion=True, plan_config=cfg4,
                             name="green", register=False)
        def baseline():
            gc.collect()            # results in reference cycles
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            return torch.cuda.memory_allocated(dev)

        held = baseline()
        w = warm_deployment(rt, green, Table([("tokens", torch.Tensor)],
                                             [(toks[0],)]))
        torch.cuda.synchronize(dev)
        warm_growth = torch.cuda.max_memory_allocated(dev) - held
        assert not w["errors"] and w["buckets"] == [1, 2, 4]
        assert warm_growth > 0
        held = baseline()
        traces0 = EXECUTABLE_CACHE.traces()
        out = rt.call_dag_object(green.dag, Table(
            [("tokens", torch.Tensor)], [(t,) for t in toks])).result(60)
        torch.cuda.synchronize(dev)
        assert torch.cuda.max_memory_allocated(dev) - held <= warm_growth
        assert EXECUTABLE_CACHE.traces() == traces0
    finally:
        rt.stop()
    want = [dc.reference_decode(plain, params, toks[i:i + 1].to(dev))[0]
            for i in range(4)]
    assert [int(r.values[0]) for r in out.rows] == want
