"""The blocking of the port's two attention kernels, emulated in plain
PyTorch on the CPU and held to the reference package's Pallas kernels in
interpret mode and to its naive oracles, on the same numpy inputs.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``);
these emulations repeat their algorithms step by step, so what the
blocking changes against the reference (which tiles are skipped, how the
splits of the cache merge, where P is rounded) is tested here:

* decode (``csrc/decode_attention.cu``): the ring cache cut into
  ``split_plan`` splits of tiles of ``TILE`` slots; tiles with no valid
  slot skipped when the sequence has a valid slot anywhere; per-split
  (m, l, acc) partials merged as the combine kernel does.  f32, atol and
  rtol 1e-5 (both sides compute in f32, in different orders).
* flash (``csrc/flash_attention.cu``, the tensor-core instances): query
  tiles of 64 rows (``wgmma``) or 128 (``pingpong``, head_dim 256: two
  consumers of 64 rows that share each kv tile) against 64-key tiles,
  the tiles that the causal mask or the window empty for the whole query
  tile skipped, P rounded to bf16 before P V and the row sum taken of the
  rounded values.  bf16 inputs, held at ``tol("bfloat16")`` of
  ``tests/test_torch_kernels.py`` (2e-2).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    TILE, split_plan)
from repro_torch.kernels.flash_attention import Q_TILE  # noqa: E402

jref_attention = jax.jit(jref.attention_ref, static_argnames=(
    "causal", "window", "softcap", "scale"))
jref_decode = jax.jit(jref.decode_attention_ref, static_argnames=(
    "window", "softcap", "scale"))

NEG = -1e30
BK = 64               # keys per kv tile of the tensor-core flash instances


def _np(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# -- decode: split-S over the ring cache -------------------------------------

def split_decode(q, k, v, kpos, qpos, *, window=0, softcap=0.0):
    """The split kernel and the combine kernel, in plain torch.  Returns
    (out, tiles computed, tiles in the cache)."""
    B, H, hd = q.shape
    K, S = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    splits, chunk = split_plan(B, K, S)
    valid = (kpos >= 0) & (kpos <= qpos[:, None])
    if window > 0:
        valid &= (qpos[:, None] - kpos) < window
    out = torch.empty((B, H, hd))
    computed = 0
    for b in range(B):
        any_valid = bool(valid[b].any())
        for kh in range(K):
            qg = q[b, kh * G:(kh + 1) * G].float()
            parts = []
            for sp in range(splits):
                m = torch.full((G,), -math.inf)
                l = torch.zeros(G)
                acc = torch.zeros(G, hd)
                end = min(S, (sp + 1) * chunk)
                for s0 in range(sp * chunk, end, TILE):
                    s1 = min(end, s0 + TILE)
                    vt = valid[b, s0:s1]
                    if any_valid and not bool(vt.any()):
                        continue
                    computed += 1
                    x = qg @ k[b, kh, s0:s1].float().T * scale
                    if softcap > 0:
                        x = softcap * torch.tanh(x / softcap)
                    x = torch.where(vt[None], x, torch.full_like(x, NEG))
                    mn = torch.maximum(m, x.max(dim=1).values)
                    corr = torch.exp(m - mn)
                    p = torch.exp(x - mn[:, None])
                    l = l * corr + p.sum(dim=1)
                    acc = acc * corr[:, None] + p @ v[b, kh, s0:s1].float()
                    m = mn
                parts.append((m, l, acc))
            ms = torch.stack([p[0] for p in parts])           # [splits, G]
            M = ms.max(dim=0).values
            w = torch.where(ms == -math.inf, torch.zeros_like(ms),
                            torch.exp(ms - M))
            L = (w * torch.stack([p[1] for p in parts])).sum(dim=0)
            A = (w[:, :, None] * torch.stack([p[2] for p in parts])).sum(0)
            out[b, kh * G:(kh + 1) * G] = A / L.clamp_min(1e-30)[:, None]
    return out.to(q.dtype), computed, B * K * -(-S // TILE)


def _ring(B, W, filled):
    """kpos [B, W] of a ring cache: row b holds positions 0..filled[b]-1
    at slot pos % W (later positions overwrite earlier ones); qpos is the
    last position written (0 for an empty row)."""
    kpos = np.full((B, W), -1, np.int32)
    for b, n in enumerate(filled):
        for pos in range(n):
            kpos[b, pos % W] = pos
    qpos = np.array([max(n - 1, 0) for n in filled], np.int32)
    return kpos, qpos


DECODE_CASES = {
    # name: (B, H, K, S, hd, filled per row, qpos override, window)
    "ring_264_of_1024": (2, 8, 2, 1024, 32, [264, 264], None, 0),
    "ring_wrapped": (2, 4, 2, 64, 32, [100, 130], None, 0),
    "all_empty": (2, 4, 2, 64, 32, [0, 0], None, 0),
    "window_excludes_every_key": (1, 4, 2, 128, 32, [40], [200], 8),
    "group_48": (1, 48, 1, 256, 32, [190], None, 0),
    "ragged_100": (2, 4, 2, 100, 32, [100, 57], None, 16),
    "splits_not_dividing_S": (4, 8, 4, 1000, 32, [1000, 700, 333, 5],
                              None, 0),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_split_decode_matches_pallas_and_oracle(case):
    B, H, K, S, hd, filled, qpos_at, window = DECODE_CASES[case]
    q = _np((B, H, hd), 0)
    k = _np((B, K, S, hd), 1)
    v = _np((B, K, S, hd), 2)
    kpos, qpos = _ring(B, S, filled)
    if qpos_at is not None:
        qpos = np.array(qpos_at, np.int32)
    got, computed, total = split_decode(
        *(torch.from_numpy(a) for a in (q, k, v, kpos, qpos)),
        window=window)
    want = jops.decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, kpos, qpos)), window=window,
        block_s=S, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)
    oracle = jref_decode(*(jnp.asarray(a) for a in (q, k, v, kpos, qpos)),
                         window=window)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=1e-5,
                               rtol=1e-5)
    splits, chunk = split_plan(B, K, S)
    assert splits * chunk >= S > (splits - 1) * chunk
    if case == "ring_264_of_1024":
        # 9 of the 32 tiles of each (b, kv head) hold a valid slot
        assert computed == 9 * B * K and total == 32 * B * K
    if case in ("all_empty", "window_excludes_every_key"):
        # no valid slot: nothing is skipped, and the result is mean(V)
        assert computed == total
        mean_v = v.mean(axis=2).repeat(H // K, axis=1)
        np.testing.assert_allclose(_f32(got), mean_v, atol=1e-5)


# -- flash: tensor-core tiles ------------------------------------------------

def tiled_flash(q, k, v, *, causal=True, window=0, softcap=0.0, bq=64):
    """A tensor-core instance in plain torch: f32 scores of bf16 inputs,
    an online softmax over 64-key tiles for query tiles of ``bq`` rows
    (64: ``wgmma``; 128: ``pingpong``, whose two consumers compute every
    kv tile of their 128-row tile), P rounded to bf16.  Returns (out,
    (query tile, kv tile) pairs computed, pairs without skipping)."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    nk = -(-S // BK)
    out = torch.empty((B, H, S, hd), dtype=q.dtype)
    computed = total = 0
    for q0 in range(0, S, bq):
        q1 = min(S, q0 + bq)
        t_hi = min(nk, (q1 - 1) // BK + 1) if causal else nk
        t_lo = (q0 - window + 1) // BK if window > 0 and \
            q0 - window + 1 > 0 else 0
        computed += (t_hi - t_lo) * B * H
        total += nk * B * H
        qp = torch.arange(q0, q1)[:, None]
        qt = q[:, :, q0:q1].float()
        m = torch.full((B, H, q1 - q0), NEG)
        l = torch.zeros((B, H, q1 - q0))
        acc = torch.zeros((B, H, q1 - q0, hd))
        for t in range(t_lo, t_hi):
            k0, k1 = t * BK, min(S, t * BK + BK)
            kt = k[:, :, k0:k1].float().repeat_interleave(G, dim=1)
            vt = v[:, :, k0:k1].float().repeat_interleave(G, dim=1)
            x = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
            if softcap > 0:
                x = softcap * torch.tanh(x / softcap)
            kp = torch.arange(k0, k1)[None, :]
            masked = torch.zeros((q1 - q0, k1 - k0), dtype=torch.bool)
            if causal:
                masked |= kp > qp
            if window > 0:
                masked |= qp - kp >= window
            x = torch.where(masked, torch.full_like(x, NEG), x)
            mn = torch.maximum(m, x.max(dim=-1).values)
            corr = torch.exp(m - mn)
            p = torch.exp(x - mn[..., None]).bfloat16().float()
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vt
            m = mn
        out[:, :, q0:q1] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out, computed, total


FLASH_CASES = {
    # name: (B, H, K, S, hd, causal, window, softcap, Pallas blocks or None)
    "causal_gqa": (2, 4, 2, 256, 64, True, 0, 0.0, 64),
    "causal_ragged_200": (1, 4, 1, 200, 64, True, 0, 0.0, None),
    "window_96": (1, 2, 1, 320, 64, True, 96, 0.0, 64),
    "window_ragged_150": (1, 2, 2, 150, 32, True, 40, 0.0, None),
    "softcap": (1, 2, 1, 128, 128, True, 0, 30.0, 64),
    "non_causal_window_ragged": (1, 2, 1, 100, 64, False, 30, 0.0, None),
    # head_dim 256 (gemma2-9b, the ping-pong instance), scaled down
    "hd256_window_softcap_ragged": (1, 4, 2, 200, 256, True, 40, 50.0,
                                    None),
    "hd256_global_softcap": (1, 2, 1, 256, 256, True, 0, 50.0, 128),
}


def _check_tiled_flash(case, bq):
    B, H, K, S, hd, causal, window, softcap, blocks = FLASH_CASES[case]
    arrays = [_np((B, n, S, hd), 30 + i) for i, n in enumerate((H, K, K))]
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrays)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    got, computed, total = tiled_flash(tq, tk, tv, causal=causal,
                                       window=window, softcap=softcap,
                                       bq=bq)
    assert got.dtype == torch.bfloat16
    tol = 2e-2
    oracle = jref_attention(jq, jk, jv, causal=causal, window=window,
                            softcap=softcap)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol, rtol=tol)
    if blocks is not None:
        want = jops.flash_attention(jq, jk, jv, causal=causal,
                                    window=window, softcap=softcap,
                                    block_q=blocks, block_k=blocks,
                                    interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                                   rtol=tol)
    # a causal mask leaves whole tiles out of every query tile but one
    if causal and S > bq:
        assert computed < total
    if S == 256 and causal and not window:
        # yi-9b's served shape: 10 of the 16 (q tile, kv tile) pairs at
        # 64 rows; 6 of 8 at 128
        want = {64: (10, 16), 128: (6, 8)}[bq]
        assert (computed, total) == (want[0] * B * H, want[1] * B * H)
    return got


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_tiled_flash_matches_pallas_and_oracle(case):
    """64-row query tiles: the ``wgmma`` instance."""
    _check_tiled_flash(case, Q_TILE["wgmma"])


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_tiled_flash_128_rows_matches_pallas_and_oracle(case):
    """128-row query tiles: the ``pingpong`` instance, whose two
    consumers of 64 rows run every kv tile of their 128-row tile (a tile
    that the masks empty for one consumer's rows weighs exactly 0 there,
    or is wiped by the correction of its first valid key)."""
    _check_tiled_flash(case, Q_TILE["pingpong"])


@pytest.mark.parametrize("bq,computed", [(64, 108), (128, 60)])
def test_tiled_flash_tiles_at_a_scaled_local_layer(bq, computed):
    """gemma2-9b's local layer (S 8192, window 4096) scaled down by 8 to
    S 1024, window 512: 108 of the 256 (query tile, kv tile) pairs at 64
    rows; 60 of 128 at 128 rows, i.e. 120 products of 64 x 64 against
    108 (at full size 6336 against 6240: 1.5% more work for two
    consumers that share each kv tile)."""
    S, W, hd = 1024, 512, 32
    arrays = [_np((1, 1, S, hd), 40 + i) for i in range(3)]
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrays)
    got, n, total = tiled_flash(tq, tk, tv, window=W, softcap=50.0, bq=bq)
    assert (n, total) == (computed, (S // bq) * (S // BK))
    oracle = jref_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                              for a in arrays), window=W, softcap=50.0)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=2e-2,
                               rtol=2e-2)
