"""The port's training modules held to the reference package's on the CPU.

Tiny configs at float32, the reference's own parameters bridged through
``interop.params_from_numpy``.  Checked:

* AdamW and Adafactor (factored and unfactored leaves, clipping on) on
  identical params and grads: params and state at atol 1e-6 over three
  steps;
* five AdamW steps of tiny yi-9b on ``SyntheticLM(seed 0)``: per-step
  losses at rel 1e-4;
* ``grad_accum=2``: the reference's own check (``tests/test_training.py``:
  a duplicated microbatch equals one plain step, loss at rel 1e-2 and
  params within 1e-2) on the port, and the port's accumulated step against
  the reference's;
* ``SyntheticLM``'s batches equal the reference's exactly;
* checkpoints: a file written by either package restores in the other,
  equal on every leaf, bf16 included;
* ``remat_policy``: the three policies give the same loss and grads;
  ``aten.mm``/``aten.addmm`` calls in ``backward()``: ``nothing``
  recomputes every product, so it counts the most, ``dots`` saves them,
  so it counts as many as ``everything``, which recomputes nothing;
* the eval step on a ``use_kernels=True`` model (the kernels' plain
  versions on the CPU) equals the plain model's, and a CUDA wrapper's
  guard refuses inputs that require grad under grad mode only;
* ``launch.train.run`` and ``examples.train_small`` on ``device="cpu"``.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_tiny_config as jax_tiny  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training import optim as jax_optim  # noqa: E402
from repro.training import train_step as jax_ts  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.examples import train_small  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import checkpoint, data, optim  # noqa: E402
from repro_torch.training import train_step  # noqa: E402

OPT_ATOL = 1e-6
LOSS_REL = 1e-4


def _cfgs(arch, **fields):
    return (dataclasses.replace(jax_tiny(arch), dtype="float32", **fields),
            dataclasses.replace(get_tiny_config(arch), dtype="float32",
                                **fields))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bridge(tree):
    return interop.params_from_numpy(_np(tree), device="cpu")


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
#: leaves: two factored (both trailing dims >= 128, one stacked), an
#: unfactored matrix, a trailing dim under 128 and a vector
OPT_SHAPES = {"stack": (2, 128, 160), "mat": (130, 128), "thin": (64, 32),
              "narrow": (256, 96), "vec": (16,)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(name):
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in OPT_SHAPES.items()}
    cfg = dict(name=name, lr=1e-2, warmup_steps=2, grad_clip=1.0)
    j_init, j_update = jax_optim.make_optimizer(
        name, jax_optim.OptConfig(**cfg))
    t_init, t_update = optim.make_optimizer(name, optim.OptConfig(**cfg))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = j_init(jp)
    tp = interop.params_from_numpy(params, device="cpu")
    ts = t_init(tp)
    for step in range(3):
        # norms far above grad_clip: the clip scale is on
        grads = {k: (rng.standard_normal(s) * 3).astype(np.float32)
                 for k, s in OPT_SHAPES.items()}
        jp, js, jn = j_update(jp, {k: jnp.asarray(v)
                                   for k, v in grads.items()}, js)
        tn = t_update(tp, interop.params_from_numpy(grads, device="cpu"), ts)
        assert float(jn) > 10 * cfg["grad_clip"]
        assert _rel(tn, jn) <= 1e-6
    for got, want in zip(optim.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=OPT_ATOL, rtol=0)
    want_state = _np(js)
    assert jax.tree.structure(want_state) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), ts))
    for got, want in zip(optim.leaves(ts), jax.tree.leaves(want_state)):
        assert got.dtype == interop.torch_dtype(want.dtype)
        np.testing.assert_allclose(got.numpy(), want, atol=OPT_ATOL,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fields", [
    dict(vocab_size=512, seq_len=32, batch_size=4, seed=0),
    dict(vocab_size=100, seq_len=37, batch_size=3, seed=7, motif_len=5,
         num_motifs=16, noise_prob=0.3),
])
def test_synthetic_lm_matches_reference(fields):
    ref = jax_data.SyntheticLM(jax_data.DataConfig(**fields))
    got = data.SyntheticLM(data.DataConfig(**fields))
    for _ in range(3):
        a, b = ref.batch(), got.batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


# ---------------------------------------------------------------------------
# train steps against the reference's
# ---------------------------------------------------------------------------
def test_five_adamw_steps_of_tiny_yi_match_reference():
    jc, tc = _cfgs("yi-9b")
    jm, tm = jax_build(jc), build_model(tc, device="cpu")
    opt = dict(lr=3e-3, warmup_steps=2)
    jstate = jax_ts.init_train_state(jm, jax.random.PRNGKey(0),
                                     jax_optim.OptConfig(**opt))
    tstate = train_step.init_train_state(
        tm, opt_cfg=optim.OptConfig(**opt),
        params=_bridge(jstate["params"]))
    j_step = jax.jit(jax_ts.make_train_step(jm, jax_optim.OptConfig(**opt)))
    t_step = train_step.make_train_step(tm, optim.OptConfig(**opt))
    src = data.SyntheticLM(data.DataConfig(vocab_size=jc.vocab_size,
                                           seq_len=32, batch_size=4, seed=0))
    j_losses, t_losses = [], []
    for _ in range(5):
        batch = src.batch()
        jstate, jm_ = j_step(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tstate, tm_ = t_step(tstate, _tensors(batch))
        j_losses.append(float(jm_["loss"]))
        t_losses.append(float(tm_["loss"]))
    for got, want in zip(t_losses, j_losses):
        assert _rel(got, want) <= LOSS_REL, (t_losses, j_losses)
    assert t_losses[-1] < t_losses[0]


def test_grad_accum_matches_single_batch_and_reference():
    jc, tc = _cfgs("glm4-9b")
    key = jax.random.PRNGKey(1)
    jm = jax_build(jc)
    params = jm.init(key)
    tok = np.asarray(jax.random.randint(key, (2, 16), 0, jc.vocab_size))
    one, two = {"tokens": tok}, {"tokens": np.concatenate([tok, tok])}

    def port(accum, batch):
        tm = build_model(dataclasses.replace(tc, grad_accum=accum),
                         device="cpu")
        state = train_step.init_train_state(tm, params=_bridge(params))
        return train_step.make_train_step(tm)(state, _tensors(batch))

    s1, m1 = port(1, one)
    s2, m2 = port(2, two)
    # the reference's own bar (tests/test_training.py)
    assert _rel(m2["loss"], m1["loss"]) <= 1e-2
    d = max(float((a - b).abs().max().detach()) for a, b in zip(
        optim.leaves(s1["params"]), optim.leaves(s2["params"])))
    assert d < 1e-2
    # and the accumulated step against the reference's
    jm2 = jax_build(dataclasses.replace(jc, grad_accum=2))
    js, jmet = jax.jit(jax_ts.make_train_step(jm2))(
        {"params": params, "opt": jax_optim.adamw_init(params)},
        {"tokens": jnp.asarray(two["tokens"])})
    assert _rel(m2["loss"], jmet["loss"]) <= 1e-5
    assert _rel(m2["grad_norm"], jmet["grad_norm"]) <= 1e-5
    lr_step = float(jax_optim.schedule(jax_optim.OptConfig(), jnp.int32(1)))
    diffs = np.concatenate([
        np.abs(a.detach().double().numpy() - np.asarray(b)).ravel()
        for a, b in zip(optim.leaves(s2["params"]),
                        jax.tree.leaves(js["params"]))])
    assert diffs.max() <= 2 * lr_step and np.median(diffs) <= 1e-7


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------
def _bits(a):
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def _port_bits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return ("bfloat16", tuple(t.shape),
                t.view(torch.int16).numpy().tobytes())
    return (str(t.numpy().dtype), tuple(t.shape), t.numpy().tobytes())


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_checkpoint_files_restore_across_packages(tmp_path, opt_name):
    jc = dataclasses.replace(jax_tiny("yi-9b"), optimizer=opt_name)
    tc = dataclasses.replace(get_tiny_config("yi-9b"), optimizer=opt_name)
    assert jc.dtype == "bfloat16"
    jstate = jax_ts.init_train_state(jax_build(jc), jax.random.PRNGKey(3))
    # a moved optimizer state, so no leaf is all zeros
    jstate["opt"] = jax.tree.map(lambda t: t + 1, jstate["opt"])
    tm = build_model(tc, device="cpu")
    template = train_step.init_train_state(
        tm, torch.Generator().manual_seed(5))

    jax_ckpt.save(str(tmp_path / "ref"), jstate, 7)
    restored = checkpoint.restore(str(tmp_path / "ref"), template)
    got = [_port_bits(t) for t in optim.leaves(restored)]
    assert got == [_bits(a) for a in jax.tree.leaves(jstate)]

    template["opt"]["step"] += 11
    checkpoint.save(str(tmp_path / "port"), template, 11)
    assert jax_ckpt.latest_step(str(tmp_path / "port")) == 11
    back = jax_ckpt.restore(str(tmp_path / "port"), jstate)
    assert [_bits(a) for a in jax.tree.leaves(back)] == [
        _port_bits(t) for t in optim.leaves(template)]


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------
class _CountProducts(TorchDispatchMode):
    """Counts ``aten.mm``/``aten.addmm`` calls while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_products(policy, params, batch):
    """(loss, grads, mm/addmm calls during backward) under ``policy``."""
    _, tc = _cfgs("yi-9b", remat_policy=policy)
    tm = build_model(tc, device="cpu")
    loss, _ = tm.loss(params, batch, remat=True)
    flat = optim.leaves(params)
    with _CountProducts() as counter:
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), grads, counter.n


def test_remat_policies_same_grads_and_recompute_as_named():
    jc, _ = _cfgs("yi-9b")
    params = train_step.trainable(_bridge(jax_build(jc).init(
        jax.random.PRNGKey(0))))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32))}
    out = {p: _backward_products(p, params, batch)
           for p in ("nothing", "dots", "everything")}
    loss0, grads0, _ = out["everything"]
    for loss, grads, _ in out.values():
        assert float(loss) == float(loss0)
        for a, b in zip(grads, grads0):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    n = {p: o[2] for p, o in out.items()}
    assert n["nothing"] > n["dots"] == n["everything"] > 0, n
    with pytest.raises(ValueError, match="remat_policy"):
        _backward_products("sometimes", params, batch)


# ---------------------------------------------------------------------------
# eval step and the kernel guard
# ---------------------------------------------------------------------------
def test_eval_step_with_kernel_wrappers_equals_plain():
    jc, tc = _cfgs("yi-9b")
    params = train_step.trainable(_bridge(jax_build(jc).init(
        jax.random.PRNGKey(0))))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32))}
    plain = train_step.make_eval_step(build_model(tc, device="cpu"))
    kern = train_step.make_eval_step(build_model(
        dataclasses.replace(tc, use_kernels=True), device="cpu"))
    a, b = plain(params, batch), kern(params, batch)
    assert b["loss"].grad_fn is None            # no graph in an eval step
    assert _rel(b["loss"], a["loss"]) <= 1e-5


def test_kernel_guard_refuses_inputs_that_require_grad():
    q = torch.zeros((1, 2, 8, 8), requires_grad=True)
    k = torch.zeros((1, 1, 8, 8))
    with pytest.raises(build.KernelError, match="no backward kernel"):
        build.refuse_autograd("flash_attention", (q, k, k))
    with torch.no_grad():
        build.refuse_autograd("flash_attention", (q, k, k))
    build.refuse_autograd("flash_attention", (q.detach(), k, k))
    # on the CPU the wrapper runs its plain version, which differentiates
    out = kops.flash_attention(q, k, k)
    assert out.grad_fn is not None


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["yi-9b", "llama-3.2-vision-11b",
                                  "whisper-medium"])
def test_launch_train_runs_on_cpu(tmp_path, arch):
    losses, state = launch_train.run(arch, steps=2, batch_size=2,
                                     seq_len=16, device="cpu",
                                     ckpt_dir=str(tmp_path), log_every=0)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert int(state["opt"]["step"]) == 2
    back = checkpoint.restore(str(tmp_path), state)
    assert all(torch.equal(a.detach(), b) for a, b in zip(
        optim.leaves(state), optim.leaves(back)))


def test_train_small_learns_and_round_trips_on_cpu(tmp_path):
    losses = train_small.main(
        ["--device", "cpu", "--steps", "40", "--d-model", "64",
         "--layers", "1", "--vocab", "128", "--seq-len", "16",
         "--ckpt-dir", str(tmp_path)])
    assert losses[-1] < losses[0] - 1.0
    assert os.path.exists(tmp_path / "step_20.npz")
