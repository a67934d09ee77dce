"""The port's training loss and train step on every arch, held to the
reference package's on the CPU.

Tiny configs at float32; the reference's own parameters
(``Model.init(PRNGKey(0))``) bridged through ``interop.params_from_numpy``;
the same numpy batch (vlm media and whisper frames included).  One jitted
reference computation per arch (a module-scoped fixture) gives
``jax.value_and_grad`` of its ``Model.loss`` (remat on, as its train step
runs it) and, in the same jit, the reference's optimizer update on those
grads: the reference's train step, whose body at ``grad_accum == 1`` is
exactly these two calls (``training/train_step.py:44-63``).  Checked:

* ``Model.loss`` and its ``aux`` at rel 1e-5, and every gradient leaf at
  max |d| <= 1e-4 * max |ref leaf| + 1e-7 (both sides sum in f32 in
  different orders);
* one train step (the reference's ``test_models_smoke.py`` step): loss and
  grad norm at rel 1e-5; the updated params at max |d| <= 2 * lr_step (at
  step 1 AdamW moves an element by at most lr_step, so an element whose
  near-zero gradient flips sign between the packages moves 2 * lr_step
  apart) with a median |d| <= 1e-7.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_tiny_config as jax_tiny  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training import optim as jax_optim  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_tiny_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import optim, train_step  # noqa: E402

B, S = 2, 16
LOSS_REL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-7


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["media"] = (rng.standard_normal(
            (B, cfg.num_media_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@pytest.fixture(scope="module", params=ARCH_IDS)
def side(request):
    """One arch: the reference's loss, grads and train step (one jit), as
    numpy, beside the port's model, bridged params and batch."""
    arch = request.param
    jc = dataclasses.replace(jax_tiny(arch), dtype="float32")
    tc = dataclasses.replace(get_tiny_config(arch), dtype="float32")
    jm = jax_build(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = _batch(jc)
    opt = jax_optim.OptConfig(name=jc.optimizer)
    opt_init, opt_update = jax_optim.make_optimizer(jc.optimizer, opt)

    @jax.jit
    def reference(params, batch):
        (loss, met), grads = jax.value_and_grad(
            lambda p: jm.loss(p, batch, remat=True), has_aux=True)(params)
        new_params, _, gnorm = opt_update(params, grads, opt_init(params))
        return loss, met, grads, new_params, gnorm

    out = reference(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met, grads, new_params, gnorm = jax.tree.map(np.asarray, out)
    return {"arch": arch, "tc": tc, "tm": build_model(tc, device="cpu"),
            "params": jax.tree.map(np.asarray, jp), "batch": batch,
            "loss": loss, "met": met, "grads": grads,
            "new_params": new_params, "grad_norm": gnorm,
            "lr_step": float(jax_optim.schedule(opt, jnp.int32(1)))}


def _port_params(side):
    return train_step.trainable(
        interop.params_from_numpy(side["params"], device="cpu"))


def _port_batch(side):
    return {k: torch.from_numpy(v) for k, v in side["batch"].items()}


def test_loss_aux_and_every_grad_match_reference(side):
    loss, met, grads = train_step.value_and_grad(
        side["tm"], _port_params(side), _port_batch(side))
    assert _rel(loss, side["loss"]) <= LOSS_REL, side["arch"]
    assert _rel(met["ce"], side["met"]["ce"]) <= LOSS_REL
    assert abs(float(met["aux"]) - float(side["met"]["aux"])) <= \
        LOSS_REL * abs(float(side["met"]["aux"])), side["arch"]
    if side["tc"].num_experts:
        assert float(met["aux"]) > 0.0      # the router's loss is summed
    ref_leaves = jax.tree.leaves(side["grads"])
    got_leaves = optim.leaves(grads)
    assert len(got_leaves) == len(ref_leaves)
    for got, want in zip(got_leaves, ref_leaves):
        assert tuple(got.shape) == want.shape
        bar = GRAD_REL * np.abs(want).max() + GRAD_ABS
        assert np.abs(got.double().numpy() - want).max() <= bar, side["arch"]


def test_one_train_step_matches_reference(side):
    tm, tc = side["tm"], side["tc"]
    opt = optim.OptConfig(name=tc.optimizer)
    state = train_step.init_train_state(tm, opt_cfg=opt,
                                        params=_port_params(side))
    state, metrics = train_step.make_train_step(tm, opt)(
        state, _port_batch(side))
    assert _rel(metrics["loss"], side["loss"]) <= LOSS_REL
    assert _rel(metrics["grad_norm"], side["grad_norm"]) <= LOSS_REL
    assert int(state["opt"]["step"]) == 1
    diffs = np.concatenate([
        np.abs(got.detach().double().numpy() - want).ravel()
        for got, want in zip(optim.leaves(state["params"]),
                             jax.tree.leaves(side["new_params"]))])
    assert diffs.max() <= 2 * side["lr_step"], side["arch"]
    assert np.median(diffs) <= 1e-7, side["arch"]
    # the step moved the params
    moved = sum(float(np.abs(a - b.detach().double().numpy()).sum())
                for a, b in zip(jax.tree.leaves(side["params"]),
                                optim.leaves(state["params"])))
    assert moved > 0.0
