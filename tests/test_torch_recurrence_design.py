"""The blocking of the port's two recurrence kernels, emulated in plain
PyTorch on the CPU and held to the reference package's Pallas kernels in
interpret mode and to its naive oracles, on the same numpy inputs.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``);
these emulations repeat their algorithms step by step, so what the
blocking changes against the reference (the order of the sums, the
carries between pieces of T) is tested here:

* wkv6 (``csrc/wkv6.cu``): S cut into tiles of 4 rows by 4 columns,
  rows padded with zeros to the instance's size, the
  columns cut into blocks of at most 64; per step each lane's partial of
  ``r . S`` over its 4 rows, the ``lanes`` partials of a column combined
  in the order of the reduce-scatter (every ``32 / cols`` steps) that
  leaves the sum on lane ``(step * cols + column) % lanes``, and
  ``sum_i q_i`` once per step in the warp's order (32 lanes, then a
  butterfly), added as ``v_j * sum q``.
* rglru_scan (``csrc/rglru_scan.cu``): T cut into the plan's segments
  (``scan_plan``), each folded from zero into its composite (product of
  ``a``, local h); the composites folded into the carries as the kernel
  folds them (warps of a block, then the blocks of the cluster after
  h0); then each segment's recurrence run again from its carry.

f32 throughout, atol and rtol 1e-5: both sides compute in f32, in
different orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models.rwkv6 import wkv_scan as jax_wkv_scan  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    STAGED_STEPS, scan_plan)
from repro_torch.kernels.wkv6 import lanes  # noqa: E402

TOL = 1e-5
# wkv6's tiling, as the constants of csrc/wkv6.cu set it: kCols, kCC,
# kSteps and kV.  A change there has to be made here too.
COLS_PER_BLOCK = 64       # kCols: most columns of S per block
COLS_PER_THREAD = 4       # kCC: the columns of a thread's tile of S
STEPS_PER_CHUNK = 8       # kSteps: steps staged per chunk
REDUCED = 32              # kV: partials per lane per reduce-scatter
jref_wkv6 = jax.jit(jref.wkv6_ref)
jref_rglru = jax.jit(jref.rglru_scan_ref)
jax_wkv_scan_jit = jax.jit(jax_wkv_scan)


def _np(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _decay(shape, seed, kind):
    """Per-step decays: "mid" in (0.45, 0.95), "near0" in (1e-4, 1e-2),
    "near1" in (0.99, 0.9999)."""
    z = 1.0 / (1.0 + np.exp(-_np(shape, seed, 1.0)))
    lo, hi = {"mid": (0.45, 0.95), "near0": (1e-4, 1e-2),
              "near1": (0.99, 0.9999)}[kind]
    return (lo + (hi - lo) * z).astype(np.float32)


def _f(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


def _butterfly(parts, lane):
    """What ``lane`` holds after xor rounds of len(parts) / 2 .. 1 over
    the lanes' values (each round adds the partner's value to its own)."""
    cur = list(parts)
    m = len(cur) // 2
    while m >= 1:
        cur = [cur[g] + cur[g ^ m] for g in range(len(cur))]
        m //= 2
    return cur[lane]


# -- wkv6: rows of S split over lanes, columns over blocks --------------------

def block_plan(hd):
    """How the kernel cuts one (b, h) of head_dim ``hd``: (rows of the
    instance, lanes per column group of 4 rows each, columns per block,
    blocks per (b, h))."""
    L = lanes(hd)
    per_block = min(4 * L, COLS_PER_BLOCK)
    return 4 * L, L, per_block, -(-hd // per_block)


def split_wkv6(r, k, v, w, u):
    """The kernel's arithmetic in plain torch.  Returns (y, final S)."""
    B, T, H, hd = r.shape
    rows, L, per_block, nblocks = block_plan(hd)
    cols = COLS_PER_THREAD
    steps = REDUCED // cols                      # per reduce-scatter
    pad = rows - hd
    rp, kp, wp = (torch.nn.functional.pad(t.float(), (0, pad))
                  for t in (r, k, w))            # [B, T, H, rows]
    up = torch.nn.functional.pad(u.float(), (0, pad))
    vf = v.float()
    # sum_i q_i: lane l sums rows l, l + 32, ...; then a 32-lane butterfly
    q = rp * up * kp
    sq = _butterfly([sum_seq(q[..., i::32]) for i in range(32)], 0)
    y = torch.empty((B, T, H, hd))
    S_out = torch.empty((B, H, hd, hd))
    for blk in range(nblocks):
        j0, j1 = blk * per_block, min(hd, (blk + 1) * per_block)
        n = j1 - j0
        S = torch.zeros((B, H, rows, n))
        for t in range(T):
            vt = vf[:, t, :, j0:j1]                          # [B, H, n]
            r4 = rp[:, t].reshape(B, H, L, 4)                # lane g: 4g + e
            S4 = S.reshape(B, H, L, 4, n)
            part = r4[..., 0, None] * S4[:, :, :, 0]
            for e in range(1, 4):
                part = part + r4[..., e, None] * S4[:, :, :, e]  # [B,H,L,n]
            # the lane that holds column jl's sum after the reduce-scatter
            cs = t % STEPS_PER_CHUNK % steps
            for jl in range(n):
                g = (cs * cols + jl % cols) % L
                total = _butterfly([part[:, :, lane, jl]
                                    for lane in range(L)], g)
                y[:, t, :, j0 + jl] = total + vt[..., jl] * sq[:, t]
            S = wp[:, t, :, :, None] * S + \
                kp[:, t, :, :, None] * vt[:, :, None, :]
        S_out[:, :, :, j0:j1] = S[:, :, :hd]
    return y, S_out


def sum_seq(t):
    """Sum over the last dim in index order (one lane's running sum)."""
    acc = torch.zeros(t.shape[:-1])
    for i in range(t.shape[-1]):
        acc = acc + t[..., i]
    return acc


WKV_CASES = {
    # name: (B, T, H, hd, decay, Pallas chunk or None for the oracle only)
    "t1": (2, 1, 2, 64, "mid", 1),
    "t_shorter_than_a_chunk": (1, 5, 2, 64, "mid", 5),
    "ragged_last_chunk": (1, 21, 2, 64, "mid", None),
    "served_head_dim_two_chunks": (2, 16, 2, 64, "mid", 8),
    "hd32": (1, 12, 2, 32, "mid", 4),
    "hd100_two_column_blocks": (1, 11, 1, 100, "mid", None),
    "hd128": (1, 8, 1, 128, "mid", 8),
    "decay_near_0": (1, 16, 2, 64, "near0", 16),
    "decay_near_1": (1, 19, 2, 64, "near1", None),
}


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_split_wkv6_matches_pallas_and_oracle(case):
    B, T, H, hd, decay, chunk = WKV_CASES[case]
    r, k, v = (_np((B, T, H, hd), i) for i in range(3))
    w = _decay((B, T, H, hd), 3, decay)
    u = _np((H, hd), 4)
    y, S = split_wkv6(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    j = [jnp.asarray(a) for a in (r, k, v, w, u)]
    np.testing.assert_allclose(_f(y), _f(jref_wkv6(*j)), atol=TOL,
                               rtol=TOL)
    if chunk is not None:
        np.testing.assert_allclose(
            _f(y), _f(jops.wkv6(*j, chunk=chunk, interpret=True)),
            atol=TOL, rtol=TOL)
    jy, jS = jax_wkv_scan_jit(*j, jnp.zeros((B, H, hd, hd), jnp.float32))
    np.testing.assert_allclose(_f(S), _f(jS), atol=TOL, rtol=TOL)


def test_wkv6_block_plan():
    """rwkv6-1.6b's head_dim 64: 16 lanes of 4 rows per column group, all
    64 columns in one block; head_dim 100 and 128 take 32 lanes and two
    blocks of columns, head_dim 32 8 lanes."""
    assert block_plan(64) == (64, 16, 64, 1)
    assert block_plan(32) == (32, 8, 32, 1)
    assert block_plan(100) == (128, 32, 64, 2)
    assert block_plan(128) == (128, 32, 64, 2)


# -- rglru_scan: T split over the warps of a block and a cluster --------------

def cluster_scan(a, x, h0=None, *, plan):
    """The kernel's arithmetic in plain torch for the plan (blocks per
    cluster, warps per block, steps per segment)."""
    nt, warps, seg = plan
    B, T, R = a.shape
    a, x = a.float(), x.float()
    bounds, comps = [], []
    for s in range(nt * warps):                   # each warp's segment
        t0 = min(T, s * seg)
        t1 = min(T, t0 + seg)
        P, h = torch.ones((B, R)), torch.zeros((B, R))
        for t in range(t0, t1):
            h = a[:, t] * h + x[:, t]
            P = P * a[:, t]
        comps.append((P, h))
        bounds.append((t0, t1))
    out = torch.empty((B, T, R))
    blocks = []                                   # each block's composite
    prefixes = []                                 # per warp, in its block
    for q in range(nt):
        pp, ph = torch.ones((B, R)), torch.zeros((B, R))
        for wi in range(warps):
            prefixes.append((pp, ph))
            Pw, hw = comps[q * warps + wi]
            if wi == warps - 1:
                blocks.append((pp * Pw, Pw * ph + hw))
            ph = Pw * ph + hw
            pp = pp * Pw
    for q in range(nt):
        carry = h0.float() if h0 is not None else torch.zeros((B, R))
        for Pq, hq in blocks[:q]:
            carry = Pq * carry + hq
        for wi in range(warps):
            s = q * warps + wi
            pp, ph = prefixes[s]
            c = pp * carry + ph
            t0, t1 = bounds[s]
            for t in range(t0, t1):               # again, from the carry
                c = a[:, t] * c + x[:, t]
                out[:, t] = c
    return out


RGLRU_CASES = {
    # name: (B, T, R, decay, h0, Pallas (chunk, block_r) or None, plan
    # override)
    "t1": (2, 1, 256, "mid", True, (1, 128), None),
    "t7_one_segment": (2, 7, 128, "mid", False, (7, 128), None),
    "t_shorter_than_the_cluster": (1, 3, 128, "mid", True, (3, 128),
                                   (8, 1, 1)),
    "t33_four_warps": (2, 33, 256, "mid", True, (33, 128), None),
    "t65_ragged_segments": (1, 65, 128, "mid", False, None, None),
    "served_plan_t256": (1, 256, 128, "mid", True, (128, 128), None),
    "cluster_of_5_t600": (1, 600, 64, "mid", True, None, None),
    "empty_segments": (1, 65, 64, "mid", True, None, (8, 2, 8)),
    "two_sweeps_t4100": (1, 4100, 32, "mid", True, None, None),
    "decay_near_0": (2, 64, 128, "near0", True, (64, 128), None),
    "decay_near_1": (2, 200, 128, "near1", True, None, None),
}


@pytest.mark.parametrize("case", sorted(RGLRU_CASES))
def test_cluster_scan_matches_pallas_and_oracle(case):
    B, T, R, decay, with_h0, pallas, plan = RGLRU_CASES[case]
    plan = plan or scan_plan(T)
    a = _decay((B, T, R), 10, decay)
    x = _np((B, T, R), 11)
    h0 = _np((B, R), 12) if with_h0 else None
    got = cluster_scan(torch.from_numpy(a), torch.from_numpy(x),
                       None if h0 is None else torch.from_numpy(h0),
                       plan=plan)
    ja, jx = jnp.asarray(a), jnp.asarray(x)
    jh0 = None if h0 is None else jnp.asarray(h0)
    np.testing.assert_allclose(_f(got), _f(jref_rglru(ja, jx, jh0)),
                               atol=TOL, rtol=TOL)
    if pallas is not None:
        chunk, block_r = pallas
        want = jops.rglru_scan(ja, jx, jh0, chunk=chunk, block_r=block_r,
                               interpret=True)
        np.testing.assert_allclose(_f(got), _f(want), atol=TOL, rtol=TOL)


def test_rglru_scan_plan():
    """recurrentgemma-2b's prefill (T = 256): clusters of 2 blocks of 4
    warps, 32 steps a warp, staged in shared memory; T = 2048 takes 8
    blocks of 8 warps; beyond that, segments are swept twice; every plan
    covers T."""
    assert scan_plan(256) == (2, 4, 32)
    assert scan_plan(33) == (1, 4, 9)
    assert scan_plan(2048) == (8, 8, 32)
    assert scan_plan(4100) == (8, 8, 65)                # 65 > 32: two sweeps
    assert scan_plan(1) == (1, 1, 1)
    for T in (1, 7, 33, 65, 256, 600, 2048, 4100):
        nt, warps, seg = scan_plan(T)
        assert 1 <= nt <= 8 and 1 <= warps <= 8
        assert nt * warps * seg >= T
        assert (seg <= STAGED_STEPS) == (T <= 2048)
