"""The decoder layer's fused elementwise glue (``kernels/glue.py``) on the
CPU, where each wrapper runs its plain version.

* Each plain version is the eager composition it replaces, bit for bit,
  in f32 and bf16: ``add_rmsnorm`` is the residual add and
  ``layers.rmsnorm`` (also without the add, and in gemma2's post-norm
  order), ``rope`` is ``layers.apply_rope`` of q and k,
  ``rope_cache_write`` is the decode step's RoPE and ring write (a
  wrapped ring, a windowed ring, no rotation at theta 0), ``gated_act``
  is ``layers._act(gate) * up`` (silu, gelu).
* The transformer's prefill, full forward and decode steps with
  ``use_kernels=True`` (the glue kernels) give logits and caches
  identical to ``use_kernels=False`` on tiny yi-9b, gemma2-9b and
  granite-34b configs, and to ``use_kernels=True`` with the glue eager
  (``layer_ops.with_plain(GLUE)`` in place of ``layer_ops.layer_ops``)
  on those, llama-3.2-vision-11b (a cross layer) and deepseek-moe-16b (a
  dense first layer, shared experts, the MoE kernels' wrappers).
* Counting: a decode step calls ``add_rmsnorm`` twice a layer plus the
  final norm (gemma2's post norms twice more), ``rope_cache_write`` and
  ``gated_act`` once a layer (granite's MLP is not gated), a prefill
  ``rope`` in place of ``rope_cache_write``; a ``kv_quant``, a layernorm
  and a mesh configuration call none of them.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.kernels import build, glue  # noqa: E402
from repro_torch.models import (build_model, layer_ops, layers,  # noqa: E402
                                 transformer)

DTYPES = [torch.float32, torch.bfloat16]
GLUE = ("add_rmsnorm", "rope", "rope_cache_write", "gated_act")
CPU = torch.device("cpu")
#: prompt longer than the cache, so the rings wrap and decode overwrites
SEQ, CACHE, STEPS = 20, 16, 2
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _rand(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


# -- the plain versions against the eager composition -------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_delta", [True, False])
def test_add_rmsnorm_plain_is_the_eager_add_and_norm(dtype, with_delta):
    x = _rand((2, 5, 64), dtype, 0)
    delta = _rand((2, 5, 64), dtype, 1) if with_delta else None
    scale = _rand((64,), dtype, 2, 0.1)
    got_x, got_h = glue.add_rmsnorm(x, delta, scale)
    want_x = x + delta if with_delta else x
    _same(got_x, want_x)
    _same(got_h, layers.rmsnorm(want_x, scale))
    if not with_delta:
        assert got_x is x


@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rmsnorm_keeps_the_post_norm_order(dtype):
    """gemma2's post norms: the attention output is normed alone, then
    added to the residual, whose sum the next norm reads."""
    x, out = _rand((2, 5, 64), dtype, 0), _rand((2, 5, 64), dtype, 1)
    s1, s2 = _rand((64,), dtype, 2, 0.1), _rand((64,), dtype, 3, 0.1)
    _, normed = glue.add_rmsnorm(out, None, s1)
    got_x, got_h = glue.add_rmsnorm(x, normed, s2)
    want_x = x + layers.rmsnorm(out, s1)
    _same(got_x, want_x)
    _same(got_h, layers.rmsnorm(want_x, s2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batched_positions", [False, True])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_plain_is_apply_rope(dtype, batched_positions, theta):
    q, k = _rand((2, 7, 4, 32), dtype, 0), _rand((2, 7, 2, 32), dtype, 1)
    positions = torch.arange(7, dtype=torch.int32) + 3
    if batched_positions:
        positions = torch.stack([positions, positions * 5])
    got_q, got_k = glue.rope(q, k, positions,
                             transformer.rope_table(32, theta, CPU))
    _same(got_q, layers.apply_rope(q, positions, theta))
    _same(got_k, layers.apply_rope(k, positions, theta))


def test_rope_without_theta_is_the_identity():
    q, k = _rand((1, 3, 2, 16), torch.bfloat16, 0), _rand(
        (1, 3, 1, 16), torch.bfloat16, 1)
    assert transformer.rope_table(16, 0.0, CPU) is None
    got_q, got_k = glue.rope(q, k, torch.arange(3, dtype=torch.int32), None)
    assert got_q is q and got_k is k


def test_rope_table_is_built_once_and_not_kept_from_fake_tensors():
    table = transformer.rope_table(24, 1234.0, CPU)
    _same(table, layers.rope_frequencies(24, 1234.0, device=CPU))
    assert transformer.rope_table(24, 1234.0, CPU) is table
    with FakeTensorMode():
        fake = transformer.rope_table(40, 4321.0, CPU)
    assert (40, 4321.0, CPU) not in transformer._ROPE_TABLES
    assert not isinstance(transformer.rope_table(40, 4321.0, CPU),
                          type(fake))


def _eager_rope_and_ring_write(q, k, v, pos, kc, vc, pc, theta):
    """The decode step's RoPE and ring write, a batch row at a time: q
    and k rotated by ``layers.apply_rope``, then k, v and the position
    written into slot ``pos % W`` of the row's ring."""
    q = layers.apply_rope(q, pos[:, None], theta)
    k = layers.apply_rope(k, pos[:, None], theta)
    W = kc.shape[1]
    for b, p in enumerate(pos.tolist()):
        kc[b, p % W] = k[b, 0]
        vc[b, p % W] = v[b, 0]
        pc[b, p % W] = p
    return q


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,W,theta,pos", [
    ("wrapped", 16, 10000.0, [20, 35, 16]),     # pos >= W: the ring wrapped
    ("window", 8, 10000.0, [5, 9, 100]),        # a local layer's short ring
    ("no rotation", 16, 0.0, [3, 17, 4]),       # rope_theta <= 0
])
def test_rope_cache_write_plain_is_the_eager_rope_and_ring_write(
        dtype, case, W, theta, pos):
    B, H, K, hd = 3, 4, 2, 32
    q = _rand((B, 1, H, hd), dtype, 0)
    k, v = _rand((B, 1, K, hd), dtype, 1), _rand((B, 1, K, hd), dtype, 2)
    pos = torch.tensor(pos, dtype=torch.int32)
    # the ring as the decode step holds it: a block's slice of a stacked,
    # batch-moved leaf (strided)
    ring = [_rand((2, W, B, K, hd), dtype, 3).movedim(2, 1)[1],
            _rand((2, W, B, K, hd), dtype, 4).movedim(2, 1)[1],
            torch.randint(-1, W, (2, W, B), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(5)
                          ).movedim(2, 1)[1]]
    mine = [t.clone() for t in ring]
    theirs = [t.clone() for t in ring]
    got = glue.rope_cache_write(q, k, v, pos, *mine,
                                transformer.rope_table(hd, theta, CPU))
    want = _eager_rope_and_ring_write(q, k, v, pos, *theirs, theta)
    _same(got, want)
    for a, b in zip(mine, theirs):
        _same(a, b)
    if theta <= 0.0:
        assert got is q


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_act_plain_is_the_eager_gate(dtype, act):
    gate, up = _rand((3, 2, 96), dtype, 0, 3.0), _rand((3, 2, 96), dtype, 1)
    _same(glue.gated_act(gate, up, act), layers._act(gate, act) * up)


# -- the transformer with and without the glue kernels -----------------------

def _serve(arch, **over):
    """Full forward, prefill and STEPS greedy decode steps of a tiny
    ``arch``: every logit and cache leaf, in order."""
    cfg = dataclasses.replace(get_tiny_config(arch), **over)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, SEQ),
                                     generator=g, dtype=torch.int32)}
    if cfg.family == "vlm":
        for lp in params["blocks"].values():       # open the cross gates
            if "cross" in lp:
                lp["cross"]["gate"].fill_(0.5)
        batch["media"] = _rand((2, cfg.num_media_tokens, cfg.d_model),
                               torch.bfloat16, 2)
    out = [model.logits(params, batch)]
    logits, cache = model.prefill(params, batch, CACHE)
    pos = torch.full((2,), SEQ, dtype=torch.int32)
    for _ in range(STEPS):
        out += [logits] + [cache[n] for n in sorted(cache)]
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        logits, cache = model.decode_step(params, tok, pos, cache)
        pos = pos + 1
    return out + [logits] + [cache[n] for n in sorted(cache)]


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-9b", "granite-34b"])
def test_glue_kernel_path_equals_the_plain_path(arch):
    plain = _serve(arch, use_kernels=False)
    fused = _serve(arch, use_kernels=True)
    assert len(plain) == len(fused)
    for a, b in zip(plain, fused):
        _same(b, a)


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-9b", "granite-34b",
                                  "llama-3.2-vision-11b",
                                  "deepseek-moe-16b"])
def test_glue_kernels_equal_the_eager_glue(monkeypatch, arch):
    """The attention and MoE kernels' wrappers on both sides, the glue's
    wrappers or its eager composition: llama-3.2-vision's attention
    kernels' plain versions differ from the plain path's chunked
    attention in the last bits, so this holds its cross layers (the
    held-back add flushed before the cross attention reads the residual)
    to the glue alone."""
    fused = _serve(arch, use_kernels=True)
    monkeypatch.setattr(layer_ops, "layer_ops",
                        layer_ops.with_plain(layer_ops.GLUE))
    eager = _serve(arch, use_kernels=True)
    assert len(eager) == len(fused)
    for a, b in zip(eager, fused):
        _same(b, a)


@pytest.fixture
def counted(monkeypatch):
    """Calls of each kernel wrapper that reach ``build.card_of``."""
    counts = {}
    card_of = build.card_of

    def counting(name, tensors):
        counts[name] = counts.get(name, 0) + 1
        return card_of(name, tensors)

    monkeypatch.setattr(build, "card_of", counting)
    return counts


def _glue_calls(arch, counts, **over):
    """The glue wrappers' calls of one prefill and of one decode step of a
    tiny ``arch`` (``use_kernels=True`` unless ``over`` says)."""
    cfg = dataclasses.replace(get_tiny_config(arch),
                              **{"use_kernels": True, **over})
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    counts.clear()
    logits, cache = model.prefill(params, {"tokens": toks}, CACHE)
    pre = {k: counts.get(k, 0) for k in GLUE}
    counts.clear()
    model.decode_step(params, logits[:, -1].argmax(-1).to(
        torch.int32)[:, None], torch.full((2,), 8, dtype=torch.int32), cache)
    return cfg.num_layers, pre, {k: counts.get(k, 0) for k in GLUE}


@pytest.mark.parametrize("arch,norms_a_layer,gated", [
    ("yi-9b", 2, True), ("gemma2-9b", 4, True), ("granite-34b", 2, False)])
def test_each_layer_calls_each_glue_kernel_once(counted, arch, norms_a_layer,
                                                gated):
    L, pre, dec = _glue_calls(arch, counted)
    act = L if gated else 0
    assert pre == {"add_rmsnorm": norms_a_layer * L + 1, "rope": L,
                   "rope_cache_write": 0, "gated_act": act}
    assert dec == {"add_rmsnorm": norms_a_layer * L + 1, "rope": 0,
                   "rope_cache_write": L, "gated_act": act}


@pytest.mark.parametrize("over", [{"kv_quant": True}, {"norm": "layernorm"},
                                  {"use_kernels": False}])
def test_other_configurations_call_no_glue_kernel(counted, over):
    _, pre, dec = _glue_calls("yi-9b", counted, **over)
    assert pre == dec == dict.fromkeys(GLUE, 0)


MESH = textwrap.dedent('''
    import dataclasses, json, socket
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_tiny_config
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as M, sharding as sh
    from repro_torch.models import build_model
    from repro_torch.models.partition import P

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    mesh = M.make_host_mesh((1, 1), device_type="cpu")
    ax = M.make_axis_info(mesh)
    counts = {}
    card_of = build.card_of

    def counting(name, tensors):
        counts[name] = counts.get(name, 0) + 1
        return card_of(name, tensors)

    build.card_of = counting
    cfg = dataclasses.replace(get_tiny_config("yi-9b"), dtype="float32",
                              use_kernels=True)
    plain = build_model(cfg, "cpu")
    params = plain.init(torch.Generator().manual_seed(0))
    model = build_model(cfg, "cpu", ax)
    dparams = sh.distribute(params, mesh, sh.param_pspecs(
        params, cfg, ax, mode="serve"))
    toks = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    batch = sh.distribute({"tokens": toks}, mesh,
                          {"tokens": P(ax.batch, None)})
    logits, cache = model.prefill(dparams, batch, 16)
    pos = sh.distribute({"pos": torch.full((2,), 8, dtype=torch.int32)},
                        mesh, {"pos": P(ax.batch)})["pos"]
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    model.decode_step(dparams, tok, pos, cache)
    dist.destroy_process_group()
    print(json.dumps(counts))
''')


def test_a_mesh_calls_no_glue_kernel(tmp_path):
    """Under a (1, 1) gloo mesh the layers keep the DTensor composition:
    the attention kernels' wrappers run on each rank's shards, no glue
    wrapper is called."""
    script = tmp_path / "mesh_glue.py"
    script.write_text(MESH)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    assert counts.get("flash_attention") and counts.get("decode_attention")
    assert not any(counts.get(k) for k in GLUE), counts
