"""The import guard compares whole top-level names."""
from perfbench.lib.guard import forbidden_modules


def test_refuses_the_jax_reproduction():
    assert forbidden_modules(["jax"]) == ["jax"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client"]) == [
        "jax", "jaxlib"]
    assert forbidden_modules(["repro", "repro.core.table"]) == ["repro"]
    assert forbidden_modules(["flax.linen"]) == ["flax"]


def test_accepts_the_port_and_names_that_only_begin_alike():
    assert forbidden_modules(["repro_torch", "repro_torch.core.table",
                              "reproduce", "jaxtyping", "torch",
                              "perfbench.lib.guard"]) == []


def test_a_module_loaded_by_a_reader_withholds_the_result(monkeypatch,
                                                         capsys):
    """A metric's reader that pulls in a forbidden module, after set-up's
    look has passed, leaves the run with no result line and a non-zero
    exit code: the look is made again at exit."""
    import sys
    import time
    import types

    import torch

    from conftest import tiny
    from perfbench.lib import cells, harness

    real = cells.reader

    def reader(name, *a, **kw):
        mod = real(name, *a, **kw)
        if name != "throughput":
            return mod

        def read(ctx):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return mod.read(ctx)
        return types.SimpleNamespace(UNIT=mod.UNIT, read=read)

    monkeypatch.setattr(cells, "reader", reader)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    out = harness.run(tiny("yi-9b", sample=4), 3, 0.3, False,
                      torch.device("cpu"), time.perf_counter(),
                      guard=harness.clean)
    assert out is not None and "throughput" in out["metrics"]
    capsys.readouterr()
    assert harness.emit(out) == 3
    got = capsys.readouterr()
    assert got.out == ""
    assert "at exit" in got.err and "['jax']" in got.err
    monkeypatch.delitem(sys.modules, "jax")
    assert harness.emit(out) == 0
    assert capsys.readouterr().out.startswith('{"correct": ')
