"""The yardstick's arithmetic against hand-worked numbers."""
import statistics
import types

import pytest

from perfbench.lib import flops, hw, stats
from perfbench.lib.profile import DeviceOp, Dispatch, Profile


def test_flash_counts_causal_pairs_and_each_byte_once():
    # yi-9b's prefill at 4 rows: q, o [4, 256, 32, 128], k, v [.., 4, 128]
    f = flash = flops.flash_attention(4, 32, 4, 256, 128)
    assert f["bytes"] == 2 * 4 * 256 * 128 * (32 + 32 + 4 + 4) == 18874368
    # 256 * 257 / 2 = 32896 causal pairs; QK^T and PV, 2 ops a MAC
    assert f["flops"] == 4 * 4 * 32 * 32896 * 128 == 2155872256
    assert flash["bound"] == "bytes"
    assert f["seconds"] == pytest.approx(18874368 / 3.35e12)
    assert f["seconds"] * 1e3 == pytest.approx(0.005634, rel=1e-3)


def test_decode_counts_valid_slots_only():
    d = flops.decode_attention(1, 32, 4, 128, valid=257)
    # q and o: 32 x 128 bf16 each; each valid slot: k and v (4 x 128
    # bf16) and its int32 position
    assert d["bytes"] == 2 * 32 * 128 * 2 + 257 * (2 * 2 * 4 * 128 + 4)
    assert d["bytes"] == 543748
    assert d["flops"] == 4 * 32 * 257 * 128
    assert d["bound"] == "bytes"
    more = flops.decode_attention(1, 32, 4, 128, valid=1024)
    assert more["bytes"] - d["bytes"] == (1024 - 257) * 2052


def test_least_time_names_its_bound():
    ops_bound = flops.least_time(67e12, 1.0, "float32")
    assert ops_bound["bound"] == "operations" and ops_bound["seconds"] == 1
    bytes_bound = flops.least_time(1.0, 3.35e12, "bfloat16")
    assert bytes_bound["bound"] == "bytes" and bytes_bound["seconds"] == 1


def test_model_flops_and_step_mfu():
    assert flops.model_flops(8_567_263_232, 264) == pytest.approx(4.523e12,
                                                                  rel=1e-3)
    from perfbench.lib import cells
    r = cells.reader("step_mfu")
    ctx = types.SimpleNamespace(
        n_params=1_000_000_000, tokens_per_request=lambda: 264,
        dispatches=[Dispatch(0, 1, 1, 1, 0.5, 0), Dispatch(1, 2, 3, 4, 1.5,
                                                             0)])
    # 4 real rows (padding not counted) x 2 x 1e9 x 264 over 2 s at 989e12
    want = 4 * 2e9 * 264 / (2.0 * hw.PEAK_FLOPS_BF16) * 100
    assert r.read(ctx) == pytest.approx(want)


def test_percentile_and_spread():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile(xs, 0) == 1.0 and stats.percentile(xs, 100) == 5
    assert stats.percentile([1.0, float("inf")], 95) == float("inf")
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)
    assert stats.spread([10.0] * 6) == 0.0


def _profile(kernels, dispatches, copies=()):
    import numpy as np
    return Profile(0.0, 10.0, list(kernels), list(copies), 7, [],
                   np.zeros(0), np.zeros(0), list(dispatches))


def test_busy_idle_and_gaps():
    p = _profile([DeviceOp("a", 1.0, 2.0, None), DeviceOp("b", 1.5, 3.0,
                                                          None),
                  DeviceOp("c", 9.5, 11.0, None)], [])
    assert p.busy() == [(1.0, 3.0), (9.5, 10.0)]
    assert p.busy_s() == pytest.approx(2.5)
    assert p.gaps() == [(0.0, 1.0), (3.0, 9.5)]
    from perfbench.lib import cells
    ctx = types.SimpleNamespace(profile=p)
    assert cells.reader("device_idle").read(ctx) == pytest.approx(75.0)


def test_roofline_share_at_one_row_and_batched():
    from perfbench.lib import cells
    L = 2
    least1 = flops.flash_attention(1, 32, 4, 256, 128)["seconds"]
    least4 = flops.flash_attention(4, 32, 4, 256, 128)["seconds"]
    ks = [DeviceOp("void flash_wgmma_kernel<>", i, i + 2 * least1, 0)
          for i in range(L)]                       # one row, 50% of bound
    ks += [DeviceOp("flash_wgmma_kernel", 5 + i, 5 + i + least4, 1)
           for i in range(L)]                      # 3 rows in bucket 4
    ks += [DeviceOp("flash_wgmma_kernel", 7 + i, 7 + i + least1, 2)
           for i in range(L * 2)]                  # 2 rows, per row
    ks += [DeviceOp("flash_wgmma_kernel", 9, 9.5, 3)]   # partly traced
    disp = [Dispatch(0, 1, 1, 1, 1, 0), Dispatch(5, 6, 3, 4, 1, 0),
            Dispatch(7, 8, 2, 2, 1, 0), Dispatch(9, 9.9, 1, 1, 1, 0)]
    ctx = types.SimpleNamespace(
        profile=_profile(ks, disp), prompt_len=256, steps=8,
        model={"num_layers": L, "num_heads": 32, "num_kv_heads": 4,
               "head_dim": 128})
    got = cells.reader("flash_attention_roofline").read(ctx)
    t_min = L * least1 + L * least4 + 2 * L * least1
    t_dev = 2 * L * least1 + L * least4 + 2 * L * least1
    assert got == pytest.approx(t_min / t_dev * 100)
    assert got < 100
