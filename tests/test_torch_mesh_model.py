"""Models under a mesh: the port at gloo world size 8 against the
reference at 8 host devices, the (1, 1) mesh against no mesh, and the
dry-run of every family.

* Tiny yi-9b and arctic-480b (f32) on a (data 2, model 4) mesh: the
  reference builds its model with that mesh's axes (heads padded to the
  model axis), places its params by ``param_pspecs`` and runs a prefill
  and one decode step under ``jit``; the port takes the same params
  through the bridge (which checks every leaf's shape at model axis 4),
  places them as DTensors by its own ``param_pspecs`` in 8 gloo ranks
  and runs the same steps.  Logits agree within 1e-4, and the training
  loss (cross entropy plus the router's load-balance term) within 1e-5.
* One arch of every family: greedy tokens of a prefill and three decode
  steps under a (1, 1) mesh (gloo, world size 1; params, tokens and cache
  DTensors) equal the ``ax=None`` run's, logits within 1e-5.
* A DTensor given to a kernel wrapper raises ``KernelError``.
* One tiny step of every family (and rwkv6's decode step) through
  ``launch.dryrun.build_dryrun`` on the fake group (a (2, 4) mesh): it
  traces, reports its memory and collectives, and CUDA stays
  uninitialised.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("yi-9b", "arctic-480b")
FAMILIES = ("yi-9b", "arctic-480b", "llama-3.2-vision-11b", "whisper-medium",
            "rwkv6-1.6b", "recurrentgemma-2b")
B, S, CACHE = 4, 16, 32
#: the dry-run's tiny steps: every family, and rwkv6's decode step too
DRY_COMBOS = ("yi-9b:train", "arctic-480b:decode",
              "llama-3.2-vision-11b:prefill", "whisper-medium:prefill",
              "rwkv6-1.6b:train", "rwkv6-1.6b:decode",
              "recurrentgemma-2b:decode")

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_tiny_config
    from repro.launch import sharding as sh
    from repro.launch.mesh import make_mesh
    from repro.models import build_model
    from repro.models.partition import AxisInfo

    out, B, S, CACHE = sys.argv[1], *map(int, sys.argv[2:5])
    mesh = make_mesh((2, 4), ("data", "model"))
    ax = AxisInfo(mesh=mesh, data=("data",), model="model")
    for arch in sys.argv[5:]:
        cfg = dataclasses.replace(get_tiny_config(arch), dtype="float32")
        model = build_model(cfg, ax)
        params = model.init(jax.random.PRNGKey(0))
        mode = "serve" if cfg.num_experts == 0 else "train"
        params = jax.device_put(params, sh.to_shardings(
            mesh, sh.param_pspecs(params, cfg, ax, mode=mode)))
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        res = {"tokens": tokens}
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            res["p:" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
        with mesh:
            logits, cache = jax.jit(lambda p, t: model.prefill(
                p, {"tokens": t}, CACHE))(params, jnp.asarray(tokens))
            nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
            pos = jnp.full((B,), S, jnp.int32)
            step, _ = jax.jit(model.decode_step)(params, nxt[:, None], pos,
                                                 cache)
            loss, _ = jax.jit(lambda p, t: model.loss(
                p, {"tokens": t}, remat=False))(params, jnp.asarray(tokens))
        res.update(logits=np.asarray(logits), nxt=np.asarray(nxt),
                   step=np.asarray(step), loss=np.asarray(loss))
        np.savez(f"{out}.{arch}.npz", **res)
""")

PORT = textwrap.dedent("""
    import dataclasses, socket, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, port, base, S, CACHE, archs):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        torch.set_num_threads(1)
        from repro_torch.configs import get_tiny_config
        from repro_torch.interop import params_from_numpy
        from repro_torch.launch import mesh as M, sharding as sh
        from repro_torch.models import build_model
        from repro_torch.models.partition import P
        mesh = M.make_host_mesh((2, 4), device_type="cpu")
        ax = M.make_axis_info(mesh)
        for arch in archs:
            cfg = dataclasses.replace(get_tiny_config(arch), dtype="float32")
            model = build_model(cfg, "cpu", ax)
            z = np.load(f"{base}.{arch}.npz")
            tree = {}
            for key in z.files:
                if key.startswith("p:"):
                    node, parts = tree, key[2:].split("/")
                    for p in parts[:-1]:
                        node = node.setdefault(p, {})
                    node[parts[-1]] = z[key]
            params = params_from_numpy(tree, "cpu", model=model)
            mode = "serve" if cfg.num_experts == 0 else "train"
            params = sh.distribute(params, mesh, sh.param_pspecs(
                params, cfg, ax, mode=mode))
            b = ax.batch
            batch = sh.distribute(
                {"tokens": torch.from_numpy(z["tokens"]),
                 "nxt": torch.from_numpy(z["nxt"])[:, None],
                 "pos": torch.full((z["tokens"].shape[0],), S,
                                   dtype=torch.int32)},
                mesh, {"tokens": P(b, None), "nxt": P(b, None),
                       "pos": P(b)})
            logits, cache = model.prefill(
                params, {"tokens": batch["tokens"]}, CACHE)
            step, _ = model.decode_step(params, batch["nxt"], batch["pos"],
                                        cache)
            loss, _ = model.loss(params, {"tokens": batch["tokens"]},
                                 remat=False)
            res = {"logits": logits.full_tensor().numpy(),
                   "step": step.full_tensor().numpy(),
                   "loss": loss.full_tensor().detach().numpy()}
            if rank == 0:
                np.savez(f"{base}.{arch}.port.npz", **res)
        dist.destroy_process_group()

    if __name__ == "__main__":
        base, (S, CACHE), archs = sys.argv[1], map(int, sys.argv[2:4]), \
            sys.argv[4:]
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.start_processes(run, args=(8, port, base, S, CACHE, archs),
                           nprocs=8, start_method="spawn")
""")

ONE_BY_ONE = textwrap.dedent("""
    import dataclasses, json, socket, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_tiny_config
    from repro_torch.launch import mesh as M, sharding as sh
    from repro_torch.models import build_model
    from repro_torch.models.partition import P, is_dtensor

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    mesh = M.make_host_mesh((1, 1), device_type="cpu")
    ax = M.make_axis_info(mesh)

    def greedy(model, params, batch, steps=3):
        logits, cache = model.prefill(params, batch, 24)
        toks, outs = [], []
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        pos = torch.full(tok.shape, batch["tokens"].shape[1],
                         dtype=torch.int32)
        if model.ax is not None:
            d = sh.distribute({"pos": pos}, mesh, {"pos": P(ax.batch)})
            pos = d["pos"]
        for _ in range(steps):
            toks.append(tok)
            outs.append(logits[:, -1])
            logits, cache = model.decode_step(params, tok[:, None], pos,
                                              cache)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            pos = pos + 1
        toks.append(tok)
        outs.append(logits[:, -1])
        full = lambda t: t.full_tensor() if is_dtensor(t) else t
        return ([full(t).tolist() for t in toks],
                torch.stack([full(o) for o in outs]))

    res = {}
    for arch in sys.argv[1:]:
        cfg = dataclasses.replace(get_tiny_config(arch), dtype="float32")
        plain = build_model(cfg, "cpu")
        params = plain.init(torch.Generator().manual_seed(0))
        if cfg.family == "vlm":         # open the cross gates
            for lp in params["blocks"].values():
                if "cross" in lp:
                    lp["cross"]["gate"].fill_(0.5)
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8),
                                         generator=g, dtype=torch.int32)}
        if cfg.family == "vlm":
            batch["media"] = torch.randn(2, cfg.num_media_tokens,
                                         cfg.d_model, generator=g)
        if cfg.family == "audio":
            batch["frames"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                          generator=g)
        want, wl = greedy(plain, params, batch)
        meshed = build_model(cfg, "cpu", ax)
        mode = "serve" if cfg.num_experts == 0 else "train"
        dparams = sh.distribute(params, mesh, sh.param_pspecs(
            params, cfg, ax, mode=mode))
        bspecs = {k: P(ax.batch, *([None] * (t.dim() - 1)))
                  for k, t in batch.items()}
        got, gl = greedy(meshed, dparams, sh.distribute(batch, mesh, bspecs))
        res[arch] = {"want": want, "got": got,
                     "err": float((gl - wl).abs().max())}
    # a DTensor that reaches a kernel wrapper is refused, never gathered
    # into a whole tensor nor run on the plain version
    from repro_torch.kernels import build, ops as kops
    q = sh.distribute({"q": torch.randn(1, 2, 8, 16)}, mesh,
                      {"q": P(None, None, None, None)})["q"]
    try:
        kops.flash_attention(q, q, q, causal=True)
        res["kernel_refused"] = False
    except build.KernelError as e:
        res["kernel_refused"] = "DTensor" in str(e)
    print(json.dumps(res))
""")

DRYRUN = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import get_tiny_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun

    shapes = {"train": InputShape("train", 32, 8, "train"),
              "prefill": InputShape("prefill", 64, 4, "prefill"),
              "decode": InputShape("decode", 64, 4, "decode")}
    res = {}
    for arch, kind in (a.split(":") for a in sys.argv[1:]):
        r = dryrun.build_dryrun(arch, kind, cfg=get_tiny_config(arch),
                                shape=shapes[kind],
                                mesh_shape=((2, 4), ("data", "model")))
        res[f"{arch}:{kind}"] = {"memory": r["memory"],
                                 "collectives": r["collectives"],
                                 "roofline": r["roofline_counted"],
                                 "cuda": r["cuda_initialized"]}
    res["cuda_after"] = torch.cuda.is_initialized()
    print(json.dumps(res))
""")


def _start(script, args, path):
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, str(path), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _done(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the module, started at once: the reference and
    then the port at (2, 4), the (1, 1) mesh, and the dry-runs."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("mesh")
    base = str(tmp / "run")
    procs = {"ref": _start(REFERENCE, [base, str(B), str(S), str(CACHE),
                                       *ARCHS], tmp / "reference.py"),
             "one": _start(ONE_BY_ONE, list(FAMILIES), tmp / "one.py"),
             "dry": _start(DRYRUN, list(DRY_COMBOS), tmp / "dryrun.py")}
    try:
        _done(procs["ref"])
        procs["port"] = _start(PORT, [base, str(S), str(CACHE), *ARCHS],
                               tmp / "port.py")
        _done(procs["port"])
        out = {"base": base}
        for k in ("one", "dry"):
            out[k] = json.loads(_done(procs[k]).strip().splitlines()[-1])
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_logits_match_reference(runs, arch):
    want = np.load(f"{runs['base']}.{arch}.npz")
    got = np.load(f"{runs['base']}.{arch}.port.npz")
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["step"], want["step"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_by_one_mesh_keeps_tokens(runs, arch):
    r = runs["one"][arch]
    assert r["got"] == r["want"]
    assert r["err"] < 1e-5, r["err"]


def test_kernel_wrapper_refuses_a_dtensor(runs):
    assert runs["one"]["kernel_refused"] is True


@pytest.mark.parametrize("combo", DRY_COMBOS)
def test_dryrun_traces_every_family(runs, combo):
    dry = runs["dry"]
    r = dry[combo]
    mem = r["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["peak_est_bytes"] >= mem["argument_bytes"]
    assert mem["hbm_per_chip"] == 80e9
    assert r["collectives"]["total"] > 0        # a (2, 4) mesh talks
    assert r["roofline"]["flops_per_device"] > 0
    assert r["cuda"] is False
    assert dry["cuda_after"] is False
