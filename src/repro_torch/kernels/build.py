"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use (never at import), into ``build/kernels/`` at the
root of the checkout, under a file name that carries a hash of the
sources so an edited kernel is rebuilt.  All sources are compiled at once,
one ``nvcc`` process each.

A failed build, a missing ``nvcc`` and a refused launch all raise
:class:`KernelError`: the port never falls back to a plain version for a
tensor that lies on the card.  Nor does a call that autograd would have
to differentiate: the kernels have no backward (the reference's Pallas
kernels have none either), so a wrapper refuses CUDA inputs that require
grad while grad mode is on (:func:`refuse_autograd`), where a launch
would return a tensor cut off from the graph.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("decode_attention", "flash_attention", "wkv6",
                  "rglru_scan", "add_rmsnorm", "rope", "rope_cache_write",
                  "gated_act", "moe_route", "moe_permute", "moe_combine")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: the kernels' ``dtype`` argument: the element type of their inputs
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float
_c_i64 = ctypes.c_longlong
_c_i64p = ctypes.POINTER(ctypes.c_longlong)

#: the C entry point of each kernel library: (function, argtypes)
SIGNATURES = {
    "decode_attention": (
        "decode_attention_launch",
        [_c_ptr] * 8 + [_c_int] * 7 + [_c_i64p, _c_float, _c_float,
                                       _c_int, _c_int, _c_int, _c_ptr]),
    "flash_attention": (
        "flash_attention_launch",
        [_c_ptr] * 4 + [_c_int] * 5 + [_c_i64p, _c_float, _c_float,
                                       _c_int, _c_int, _c_int, _c_int,
                                       _c_int, _c_ptr]),
    "wkv6": (
        "wkv6_launch",
        [_c_ptr] * 7 + [_c_int] * 6 + [_c_ptr]),
    "rglru_scan": (
        "rglru_scan_launch",
        [_c_ptr] * 4 + [_c_int] * 7 + [_c_ptr]),
    "add_rmsnorm": (
        "add_rmsnorm_launch",
        [_c_ptr] * 5 + [_c_int, _c_int, _c_float, _c_int, _c_int, _c_ptr]),
    "rope": (
        "rope_launch",
        [_c_ptr] * 6 + [_c_int] * 5 + [_c_i64p, _c_int, _c_ptr]),
    "rope_cache_write": (
        "rope_cache_write_launch",
        [_c_ptr] * 9 + [_c_int] * 5 + [_c_i64p, _c_int, _c_ptr]),
    "gated_act": (
        "gated_act_launch",
        [_c_ptr] * 3 + [_c_i64, _c_int, _c_int, _c_int, _c_ptr]),
    "moe_route": (
        "moe_route_launch",
        [_c_ptr] * 6 + [_c_int] * 8 + [_c_ptr]),
    "moe_permute": (
        "moe_permute_launch",
        [_c_ptr] * 5 + [_c_int] * 7 + [_c_ptr]),
    "moe_combine": (
        "moe_combine_launch",
        [_c_ptr] * 4 + [_c_int] * 5 + [_c_ptr]),
}


class KernelError(RuntimeError):
    """A CUDA kernel could not be built, refused its inputs, or failed to
    launch.  Lowered chains never latch a fallback on it."""


_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash(name)}.so"


def build(names: Optional[Iterable[str]] = None, *,
          verbose: bool = False) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes at once.  Returns build seconds per kernel (0.0 when it was
    already built).  ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report (registers, shared memory, spills)."""
    names = list(names or KERNEL_SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs: List = []
    seconds = {name: 0.0 for name in names}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building every kernel first
    when this one is not built yet."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not library_path(name).exists():
                build()
            try:
                lib = ctypes.CDLL(str(library_path(name)))
            except OSError as e:
                raise KernelError(f"cannot load {name}: {e}") from e
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


#: per thread: the list that :func:`abstract_calls` collects into
_ABSTRACT = threading.local()


@contextlib.contextmanager
def abstract_calls():
    """Collect the kernel calls made on fake tensors in this thread (the
    static verifier's shape propagation): yields a list that gains one
    ``(kernel name, operand shapes)`` per call, operands in the order the
    wrapper passes them to :func:`card_of`."""
    outer = getattr(_ABSTRACT, "calls", None)
    _ABSTRACT.calls = calls = []
    try:
        yield calls
    finally:
        _ABSTRACT.calls = outer


def card_of(name: str, tensors) -> Optional[torch.device]:
    """The CUDA device all ``tensors`` lie on, or None when they all lie on
    the CPU (the caller then runs its plain version).  Any other mix
    raises :class:`KernelError`.

    Fake tensors (``FakeTensorMode``: shape and dtype, no storage) also
    give None: the plain version then propagates shapes and computes no
    data, and the call is noted for :func:`abstract_calls`.  A tensor
    that holds data is never fake, so no call on the card takes this.

    A DTensor raises :class:`KernelError`: the kernels run inside the
    models' ``local_map`` regions on each rank's local shards, and a
    wrapper neither gathers a DTensor into a whole tensor nor falls back
    to its plain version.

    Plain tensors (of type ``torch.Tensor`` itself, which neither a
    DTensor nor a fake tensor is) skip both tests: the serving path makes
    a few hundred such calls a decode step, and their host time is the
    step's."""
    if all(type(t) is torch.Tensor for t in tensors):
        return _device_of(name, tensors)
    from torch.utils._python_dispatch import is_traceable_wrapper_subclass
    if any(is_traceable_wrapper_subclass(t) for t in tensors):
        raise KernelError(
            f"{name}: a DTensor reached the kernel wrapper; call it on each "
            "rank's local shards (models.partition.local_region)")
    if any(isinstance(t, FakeTensor) for t in tensors):
        calls = getattr(_ABSTRACT, "calls", None)
        if calls is not None:
            calls.append((name, tuple(tuple(t.shape) for t in tensors)))
        return None
    return _device_of(name, tensors)


def _device_of(name: str, tensors) -> Optional[torch.device]:
    """:func:`card_of` for tensors that hold data."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return None
    device = next(iter(devices))
    if len(devices) != 1 or device.type != "cuda":
        raise KernelError(
            f"{name}: inputs on {sorted(map(str, devices))}; needs all on "
            "one CUDA device (or all on the CPU)")
    refuse_autograd(name, tensors)
    return device


def refuse_autograd(name: str, tensors) -> None:
    """Raise :class:`KernelError` when grad mode is on and any of
    ``tensors`` requires grad: the kernel has no backward, and its output
    would silently carry no gradient to the inputs.  :func:`card_of`
    calls it for CUDA inputs; the CPU's plain versions are
    differentiable and never reach it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise KernelError(
            f"{name}: an input requires grad, and the port has no backward "
            "kernel (the reference package has none either); train the "
            "model with use_kernels=False, and run a kernel under "
            "torch.no_grad()")


def launch(wrapper, device: torch.device, *args) -> None:
    """Launch the kernel named as ``wrapper`` on ``device``'s current
    stream with the C arguments ``args`` (the stream goes last), raise
    :class:`KernelError` when CUDA refuses it, and count the launch in
    ``wrapper.launches``.  ``device`` is made the current device for the
    launch only where it is not already."""
    name = wrapper.__name__
    lib = library(name)
    fn = getattr(lib, SIGNATURES[name][0])
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index == torch.cuda.current_device():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code)
        raise KernelError(f"{name} launch failed: CUDA error {code} "
                          f"({(msg or b'').decode()})")
    count(wrapper, "launches")


def count(wrapper, counter: str, key=None) -> None:
    """Add one to ``wrapper``'s integer attribute ``counter``, or, given a
    ``key``, to that key's entry of the dict attribute ``counter``."""
    with _COUNT_LOCK:            # executor threads launch concurrently
        if key is None:
            setattr(wrapper, counter, getattr(wrapper, counter) + 1)
        else:
            counts = getattr(wrapper, counter)
            counts[key] = counts.get(key, 0) + 1


def strides_arg(values: List[int]):
    """A C ``long long[]`` of element strides for a launch."""
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])
