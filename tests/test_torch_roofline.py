"""The port's roofline package on the CPU, held to the reference
package's ``roofline/``.

* ``flops.estimate`` is the reference's arithmetic in the reference's
  order over the port's copies of the configs and layouts, so its
  ``to_dict()`` must EQUAL the reference's (exact float equality) for
  every arch, every input shape and each ``(chips, mp)`` of a single
  GPU, one 8-GPU node and the reference's 256-chip pod;
* the reference's roofline checks (``tests/test_roofline.py``) with the
  H100's constants: ``Roofline``'s terms and bottleneck, the estimator's
  useful-ratio bands, backprop's share of a training step, and decode
  being memory-bound;
* ``from_counted`` counts ``2*M*N*K`` FLOPs and the operand and result
  bytes of one matmul exactly, and on tiny dense prefills counts exactly
  ``estimate``'s ``fwd_flops`` (see ``test_counted_prefill_equals_estimate``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.roofline import analysis as jax_analysis  # noqa: E402
from repro.roofline import flops as jax_flops  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, InputShape,  # noqa: E402
                                 get_config, get_tiny_config)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.roofline import analysis, flops, hw  # noqa: E402

MESHES = ((1, 1), (8, 8), (256, 16))


@pytest.mark.parametrize("chips,mp", MESHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_estimate_equals_reference(arch, shape, chips, mp):
    got = flops.estimate(get_config(arch), SHAPES[shape], chips=chips,
                         mp=mp).to_dict()
    want = jax_flops.estimate(jax_config(arch), SHAPES[shape], chips=chips,
                              mp=mp).to_dict()
    assert got == want


@pytest.mark.parametrize("arch", ["gemma2-9b", "rwkv6-1.6b",
                                  "recurrentgemma-2b"])
def test_long_context_estimate_equals_reference(arch):
    shape = SHAPES["long_500k"]
    got = flops.estimate(get_config(arch), shape, chips=1, mp=1,
                         long_context=True).to_dict()
    want = jax_flops.estimate(jax_config(arch), shape, chips=1, mp=1,
                              long_context=True).to_dict()
    assert got == want


def test_hw_holds_the_h100_data_sheet():
    assert hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.PEAK_FLOPS_F32 == 67e12
    assert hw.HBM_BW == 3.35e12
    assert hw.HBM_BYTES == 80e9
    # NVLink 4: 18 links, 900 GB/s both directions together
    assert hw.NVLINK_LINKS * hw.NVLINK_BW_PER_LINK * 2 == 900e9
    assert hw.GPUS_PER_NODE == 8


def test_roofline_terms_and_bottleneck():
    r = analysis.Roofline(flops=989e12, hbm_bytes=3.35e12, coll_bytes=0,
                          model_flops=989e12, chips=1)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == 0.0
    assert r.bottleneck in ("compute", "memory")
    assert r.step_time_lower_bound == pytest.approx(1.0)
    r2 = analysis.Roofline(flops=1, hbm_bytes=1, coll_bytes=450e9)
    assert r2.t_collective == pytest.approx(1.0)
    assert r2.bottleneck == "collective"


def test_roofline_dict_has_the_reference_keys():
    kw = dict(flops=3e12, hbm_bytes=2e11, coll_bytes=5e9,
              model_flops=2.5e12, chips=4)
    got = analysis.Roofline(**kw).to_dict()
    want = jax_analysis.Roofline(**kw).to_dict()
    assert list(got) == list(want)
    for k in ("flops_per_device", "hbm_bytes_per_device",
              "coll_bytes_per_device", "model_flops", "useful_ratio"):
        assert got[k] == want[k]
    assert got["t_compute_s"] == 3e12 / 989e12
    assert got["t_memory_s"] == 2e11 / 3.35e12


@pytest.mark.parametrize("arch,shape,expect_ratio_range", [
    ("yi-9b", "train_4k", (0.2, 1.0)),
    ("yi-9b", "decode_32k", (0.3, 1.05)),
    ("arctic-480b", "train_4k", (0.1, 1.0)),
    ("rwkv6-1.6b", "decode_32k", (0.5, 1.2)),
])
def test_analytic_estimator_sanity(arch, shape, expect_ratio_range):
    """Useful ratio = MODEL_FLOPS / executed must be in a sane band —
    executed >= useful (up to small approximation slack)."""
    est = flops.estimate(get_config(arch), SHAPES[shape], chips=256, mp=16)
    ratio = est.model_flops / est.step_flops
    lo, hi = expect_ratio_range
    assert lo <= ratio <= hi, (arch, shape, ratio)


def test_train_flops_dominated_by_backprop():
    tr = flops.estimate(get_config("yi-9b"), SHAPES["train_4k"], chips=256,
                        mp=16)
    assert tr.step_flops >= 3 * tr.fwd_flops


@pytest.mark.parametrize("chips,mp", [(256, 16), (1, 1)])
def test_decode_memory_bound_on_h100(chips, mp):
    est = flops.estimate(get_config("granite-34b"), SHAPES["decode_32k"],
                         chips=chips, mp=mp)
    t_c = est.step_flops / chips / hw.PEAK_FLOPS_BF16
    t_m = est.hbm_bytes_per_chip / hw.HBM_BW
    assert t_m > t_c


@pytest.mark.parametrize("M,K,N", [(8, 16, 32), (5, 7, 3), (64, 128, 1)])
def test_counted_matmul_is_exact(M, K, N):
    a, b = torch.randn(M, K), torch.randn(K, N)
    r = analysis.from_counted(torch.matmul, a, b, model_flops=2 * M * K * N,
                              chips=1)
    assert r.flops == 2 * M * N * K
    assert r.hbm_bytes == (M * K + K * N + M * N) * 4
    assert r.coll_bytes == 0 and r.t_collective == 0
    assert r.useful_ratio == 1.0


def test_counted_views_move_no_bytes():
    a = torch.randn(6, 4)
    c = analysis.count(lambda x: x.t().reshape(4, 6)[1:], a)
    assert c == {"flops": 0.0, "hbm_bytes": 0.0, "coll_bytes": 0.0}


@pytest.mark.parametrize("arch,S", [("yi-9b", 64), ("glm4-9b", 64),
                                    ("granite-34b", 64), ("yi-9b", 2048)])
def test_counted_prefill_equals_estimate(arch, S):
    """The plain path's products are exactly the ones ``estimate``
    counts: q/k/v/o projections at the unpadded heads (``mp=1``), every
    (query, key) pair of every chunk pair (the plain chunked attention
    masks and does not skip; S = 2048 is 2 x 2 chunks of 1024), the MLP's
    2 or 3 matrices and the unembedding at a vocab that is already a
    multiple of 256.  Neither counts elementwise work or the embedding
    gather.  So the band is float rounding of the sums: rel 1e-12."""
    cfg = dataclasses.replace(get_tiny_config(arch), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((2, S), dtype=torch.int32)
    r = analysis.from_counted(lambda t: model.logits(params, {"tokens": t}),
                              toks, model_flops=0.0, chips=1)
    est = flops.estimate(cfg, InputShape("prefill", S, 2, "prefill"),
                         chips=1, mp=1)
    assert r.flops == pytest.approx(est.fwd_flops, rel=1e-12)
    assert r.hbm_bytes > 0 and r.coll_bytes == 0
