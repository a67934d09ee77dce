"""The port's expert-parallel MoE at gloo world size 8 against the
reference's at 8 host devices, on a (data 2, model 4) mesh.

One subprocess runs the reference's ``moe_apply_ep`` under an 8-device
mesh (``XLA_FLAGS`` forces 8 host devices, as ``tests/test_moe_ep.py``
does) and writes its inputs and outputs; a second runs the port's
``moe_apply_ep`` in 8 gloo ranks (``torch.multiprocessing``) on the same
numpy inputs and parameters.  Tiny arctic-480b in f32, for seq-sharded
and decode tokens x ``all_to_all`` and ``allgather`` dispatch, at
``capacity_factor`` 8 (nothing drops) and 1.0 (pairs drop: which ones
depends on the stable sort of expert ids), and with int8 experts.  ``y``
and ``aux`` agree within 1e-5.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CASES = [(cf, seq, disp, q) for cf, q in ((8.0, False), (1.0, False),
                                          (1.0, True))
         for seq in (True, False) for disp in ("all_to_all", "allgather")]
TOL = 1e-5

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_tiny_config
    from repro.launch.mesh import make_mesh
    from repro.models import moe as moe_lib
    from repro.models.partition import AxisInfo

    out, cases = sys.argv[1], eval(sys.argv[2])
    base = dataclasses.replace(get_tiny_config("arctic-480b"),
                               dtype="float32")
    mesh = make_mesh((2, 4), ("data", "model"))
    ax = AxisInfo(mesh=mesh, data=("data",), model="model")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 8, base.d_model)) * 0.3).astype(np.float32)
    params = jax.tree.map(lambda t: t[0], moe_lib.moe_init(
        jax.random.PRNGKey(0), base, jnp.float32, 1))
    qparams = moe_lib.quantize_expert_weights(params)
    res = {"x": x}
    for tree, tag in ((params, "p"), (qparams, "q")):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = "/".join(str(k.key) for k in path)
            res[f"{tag}:{name}"] = np.asarray(leaf)
    with mesh:
        for i, (cf, seq, disp, q) in enumerate(cases):
            cfg = dataclasses.replace(base, capacity_factor=cf)
            y, aux = jax.jit(lambda x, p: moe_lib.moe_apply_ep(
                x, p, cfg, ax, seq_sharded=seq, dispatch=disp))(
                    jnp.asarray(x), qparams if q else params)
            res[f"y{i}"], res[f"aux{i}"] = np.asarray(y), np.asarray(aux)
    np.savez(out, **res)
""")

PORT = textwrap.dedent("""
    import dataclasses, os, socket, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def tree(z, tag):
        out = {}
        for key in z.files:
            if key.startswith(tag + ":"):
                node, parts = out, key[len(tag) + 1:].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = torch.from_numpy(z[key])
        return out

    def run(rank, world, port, inp, out, cases):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        torch.set_num_threads(1)
        from repro_torch.configs import get_tiny_config
        from repro_torch.launch import mesh as M, sharding as sh
        from repro_torch.models import moe
        from repro_torch.models.partition import P
        base = dataclasses.replace(get_tiny_config("arctic-480b"),
                                   dtype="float32")
        mesh = M.make_host_mesh((2, 4), device_type="cpu")
        ax = M.make_axis_info(mesh)
        z = np.load(inp)
        x = sh.distribute({"x": torch.from_numpy(z["x"])}, mesh,
                          {"x": P(ax.batch, None, None)})["x"]

        def spec(path, t):
            # one layer of param_pspecs(mode="train"): experts over model,
            # the FSDP dim over data; router replicated
            name = path[-1]
            if name == "router":
                return P(None, None)
            if name == "s":
                return P("model", None)
            return P("model", ax.data, None)

        res = {}
        for i, (cf, seq, disp, q) in enumerate(cases):
            cfg = dataclasses.replace(base, capacity_factor=cf)
            p = tree(z, "q" if q else "p")
            p = sh.distribute(p, mesh, sh.tree_map_with_path(spec, p))
            y, aux = moe.moe_apply_ep(x, p, cfg, ax, seq_sharded=seq,
                                      dispatch=disp)
            res[f"y{i}"] = y.full_tensor().numpy()
            res[f"aux{i}"] = aux.full_tensor().numpy()
        if rank == 0:
            np.savez(out, **res)
        dist.destroy_process_group()

    if __name__ == "__main__":
        inp, out, cases = sys.argv[1], sys.argv[2], eval(sys.argv[3])
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.start_processes(run, args=(8, port, inp, out, cases), nprocs=8,
                           start_method="spawn")
""")


def _run(script, args, path):
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, str(path), *args], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("moe_ep")
    ref, port = tmp / "ref.npz", tmp / "port.npz"
    _run(REFERENCE, [str(ref), repr(CASES)], tmp / "reference.py")
    _run(PORT, [str(ref), str(port), repr(CASES)], tmp / "port.py")
    return np.load(ref), np.load(port)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"cf{c[0]}-{'seq' if c[1] else 'decode'}-"
                              f"{c[2]}{'-int8' if c[3] else ''}"
                              for c in CASES])
def test_ep_matches_reference(results, i):
    ref, port = results
    np.testing.assert_allclose(port[f"y{i}"], ref[f"y{i}"], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(port[f"aux{i}"], ref[f"aux{i}"], rtol=0,
                               atol=TOL)


def test_capacity_drops_pairs(results):
    """At ``capacity_factor`` 1.0 some pairs drop (the output differs
    from the drop-free one) in both packages, so the drop cases above
    compare which pairs dropped."""
    ref, port = results
    for side in (ref, port):
        for j in range(4):
            assert np.abs(side[f"y{j}"] - side[f"y{j + 4}"]).max() > 1e-3
