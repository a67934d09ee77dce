"""Mesh axis bookkeeping shared by models and the launcher (port of the
reference package's ``models/partition.py``, on ``torch.distributed``).

:class:`P` is a partition spec: one entry per tensor dim, each ``None``
(replicated), a mesh axis name, or a tuple of names (the dim is split
over several axes, the first name the major one, as in JAX).
:class:`AxisInfo` describes the logical axes of the active mesh.  Model
code calls ``shard(ax, x, ...)`` where the reference attaches a sharding
constraint: a :class:`~torch.distributed.tensor.DTensor` is
redistributed to the spec's placements, a plain tensor passes through.
With ``ax=None`` (one device, the tests) everything is a no-op, so the
model zoo runs unchanged.

``AxisInfo`` reads axis sizes by name from a
:class:`~torch.distributed.device_mesh.DeviceMesh` (``mesh_dim_names``
and ``shape``) or from any shape-only object with a ``shape`` mapping and
``axis_names``, so spec arithmetic needs no process group.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

AxisName = Union[str, Tuple[str, ...], None]


def _norm(entry: AxisName) -> AxisName:
    """A one-name tuple is that name and an empty one ``None``, as JAX
    normalises a ``PartitionSpec``'s entries."""
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


class P(tuple):
    """A partition spec: ``P("data", None, "model")``.  A tuple, so it
    compares equal to any tuple of the same entries (a JAX
    ``PartitionSpec`` turned into a tuple, say)."""

    def __new__(cls, *axes: AxisName):
        return super().__new__(cls, (_norm(a) for a in axes))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def _names(entry: AxisName) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def check_divisible(shape: Sequence[int], spec: P, mesh) -> None:
    """Raise unless every sharded dim of ``shape`` divides by the product
    of its mesh axes (DTensor would shard it unevenly without a word)."""
    sizes = axis_sizes(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape "
                         f"{tuple(shape)}")
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _names(entry))
        if shape[d] % n:
            raise ValueError(f"dim {d} of shape {tuple(shape)} does not "
                             f"divide over {entry} ({n}) in spec {spec}")


def placements(mesh, spec: P):
    """DTensor placements (one per mesh dim) for ``spec``.  A tensor dim
    split over several mesh axes must name them in the mesh's order, so
    the first is the major one, as in JAX."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _names(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]} "
                                 "shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def place(t: torch.Tensor, mesh, spec: P):
    """``t``, which every rank holds whole, as a DTensor placed by
    ``spec``: each rank keeps a view of its own shard (no copy, no
    collective).  A dim the mesh axes do not divide raises."""
    from torch.distributed.tensor import DTensor
    check_divisible(t.shape, spec, mesh)
    pl = placements(mesh, spec)
    local = t
    coord = mesh.get_coordinate()
    # the major axis first, as ``placements`` orders them
    for i, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(i)
            size = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[i] * size, size)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def unplace(t):
    """The whole value of a DTensor as a plain tensor: its local tensor
    where nothing is split or summed (no copy), else gathered.  A plain
    tensor is returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    if all(isinstance(p, Replicate) for p in t.placements):
        return t.to_local()
    return t.full_tensor()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  None exists before
    ``torch.distributed.tensor`` is imported, so the test does not import
    it: a process without a mesh would pay for that import (seconds of
    compiling its sources where no bytecode is cached) on its first
    dispatch."""
    cls = getattr(sys.modules.get("torch.distributed.tensor"), "DTensor",
                  None)
    return cls is not None and isinstance(x, cls)


@dataclasses.dataclass(frozen=True)
class AxisInfo:
    """Logical axes: ``data`` (batch/FSDP; may be ('pod','data')), ``model``.

    ``shard_batch=False`` (long_500k: global batch 1) keeps weight sharding
    but leaves activation batch dims replicated.
    """
    mesh: object
    data: Tuple[str, ...] = ("data",)
    model: str = "model"
    shard_batch: bool = True

    @property
    def batch(self) -> Optional[Tuple[str, ...]]:
        """Axes for activation batch dims (None when batch is unshardable)."""
        return self.data if self.shard_batch else None

    @property
    def dp_size(self) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.data)

    @property
    def mp_size(self) -> int:
        return axis_sizes(self.mesh)[self.model]

    def spec(self, *axes: AxisName) -> P:
        return P(*axes)

    def sharding(self, *axes: AxisName):
        """The DTensor placements of ``P(*axes)`` on this mesh."""
        return placements(self.mesh, P(*axes))

    def shard(self, x, *axes: AxisName):
        """``x`` redistributed to ``P(*axes)`` when it is a DTensor (the
        reference's ``with_sharding_constraint``); a plain tensor is
        returned as it is."""
        if not is_dtensor(x):
            return x
        check_divisible(x.shape, P(*axes), self.mesh)
        want = self.sharding(*axes)
        if tuple(x.placements) == want:
            return x
        x = _move_shards(x, want)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)


def all_to_all(t, group):
    """Tiled all-to-all along dim 0 over ``group``: chunk i goes to rank
    i, chunk j of the result came from rank j (differentiable)."""
    import torch.distributed._functional_collectives as funcol
    fn = getattr(funcol, "all_to_all_single_autograd",
                 funcol.all_to_all_single)
    return funcol.wait_tensor(fn(t, None, None, group))


def all_gather(t, group, dim: int = 0):
    """Tiled all-gather along ``dim`` over ``group`` (differentiable)."""
    import torch.distributed._functional_collectives as funcol
    fn = getattr(funcol, "all_gather_single_autograd", None)
    if fn is None:                       # torch before 2.12
        fn = funcol.all_gather_tensor_autograd
    return funcol.wait_tensor(fn(t.contiguous(), dim, group))


def pmean(t, groups):
    """The mean of ``t`` over every rank of ``groups``, one group after
    another, as JAX's ``pmean`` over each axis: a sum, then a division
    by the group's size (gloo has no average)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, "sum", g)) / \
            dist.get_world_size(g)
    return t


def heads_spec(ax: Optional[AxisInfo]) -> P:
    """[B, S, H, hd] activations: batch over data, heads over model."""
    return P(dp_axes(ax), None, mp_axis(ax), None)


def _move_shards(x, want):
    """``x`` with each mesh dim whose shard moves from one tensor dim to
    another (and no other mesh dim splits either) moved by one
    all-to-all over that mesh dim's group: each rank splits its local
    tensor along the new dim and joins what it receives along the old
    one.  A mesh dim of one rank takes the wanted placement as it is.
    DTensor's own plan may gather the whole old dim first (on a mesh of
    device type ``cpu`` it always does), which holds the gathered tensor
    whole on every rank."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = x.device_mesh
    pl = list(x.placements)
    local = x.to_local()
    moved = False
    for i, (have, w) in enumerate(zip(pl, want)):
        if mesh.size(i) == 1 and have != w:
            pl[i] = w            # one rank: every placement is the value
            moved = True
            continue
        if not (isinstance(have, Shard) and isinstance(w, Shard)
                and have.dim != w.dim):
            continue
        others = [p for j, p in enumerate(pl) if j != i]
        if any(isinstance(p, Shard) and p.dim in (have.dim, w.dim)
               for p in others):
            continue
        n = mesh.size(i)
        chunks = torch.stack(local.chunk(n, dim=w.dim))   # [n, ...]
        recv = all_to_all(chunks.reshape((-1,) + chunks.shape[2:]),
                           mesh.get_group(i)).reshape(chunks.shape)
        local = torch.cat(recv.unbind(0), dim=have.dim)
        pl[i] = w
        moved = True
    if not moved:
        return x
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def shard(ax: Optional[AxisInfo], x, *axes: AxisName):
    if ax is None:
        return x
    return ax.shard(x, *axes)


def reshard(ax: Optional[AxisInfo], x, *axes: AxisName):
    """:func:`shard` where the reference has no sharding constraint and
    leaves the layout to XLA: the port's own placement ahead of a local
    region or a product (kept apart from :func:`shard`, whose sites are
    the reference's)."""
    if ax is None:
        return x
    return ax.shard(x, *axes)


def gather_fsdp(ax: Optional[AxisInfo], tree):
    """One layer's params with their FSDP dims gathered over the data
    axes (each leaf still split over model): FSDP's all-gather ahead of
    the layer, whose backward reduce-scatters the grads.  The reference
    leaves it to XLA; without it DTensor may gather activations over the
    batch instead."""
    if ax is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_fsdp(ax, v) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate
    names = tuple(tree.device_mesh.mesh_dim_names)
    want = tuple(Replicate() if names[i] in ax.data else p
                 for i, p in enumerate(tree.placements))
    if want == tuple(tree.placements):
        return tree
    return tree.redistribute(tree.device_mesh, want)


def rows(ax: Optional[AxisInfo], x):
    """``x`` [B, S, ...] with whole rows (the sequence gathered) on every
    model rank: the sequence-parallel all-gather ahead of a product whose
    output is split over heads, features or the vocabulary.  The
    reference leaves it to XLA; DTensor's own choice for the product
    could gather the weight instead, or fold batch and sequence into one
    dim split two ways, which its product rules do not take."""
    return reshard(ax, x, dp_axes(ax), *([None] * (x.ndim - 1)))


def vocab_table(params, ax: Optional[AxisInfo]):
    """The embedding table with its FSDP dim gathered (vocab over model):
    DTensor's vocab-parallel lookup then masks and reduces each rank's
    rows; a table also split over data trips its masked reduction."""
    return reshard(ax, params["embed"], mp_axis(ax), None)


def replicated(t: torch.Tensor, like):
    """``t`` (the same on every rank: positions, a positional encoding)
    as a replicated DTensor on ``like``'s mesh when ``like`` is a
    DTensor, so that the two combine; else ``t`` as it is."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def mp_size(ax: Optional[AxisInfo]) -> int:
    return 1 if ax is None else ax.mp_size


def dp_axes(ax: Optional[AxisInfo]):
    """Batch-dim axes for activations (None if batch unshardable/no mesh)."""
    return None if ax is None else ax.batch


def mp_axis(ax: Optional[AxisInfo]) -> Optional[str]:
    return None if ax is None else ax.model


def local(x) -> torch.Tensor:
    """The local shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def local_region(ax: Optional[AxisInfo], fn, in_specs, out_specs,
                 grad_specs=None):
    """``fn`` run on each rank's local shards (``local_map``), as the
    reference's ``shard_map`` runs it, for work that DTensor's own rules
    would gather first (an indexed write, a sort, a kernel launch).  Its
    DTensor arguments must already be placed as ``in_specs`` (``None``
    for a non-tensor): a mismatch raises, nothing is moved quietly.  It
    returns a tuple, placed as ``out_specs``.  ``grad_specs`` says where
    an argument's gradient differs from its placement: ``"partial"``
    makes every mesh axis its spec leaves replicated a partial sum (a
    replicated input that each rank reads with its own tokens).  Without
    a mesh, or with no DTensor argument, ``fn`` is called as it is."""
    if ax is None:
        return fn

    def run(*args):
        if not any(is_dtensor(a) for a in args):
            return fn(*args)
        from torch.distributed.tensor.experimental import local_map
        mesh = ax.mesh

        def pl(s):
            return None if s is None else placements(mesh, s)

        grads = None
        if grad_specs is not None:
            grads = tuple(partial_placements(mesh, s) if g == "partial"
                          else pl(s) for s, g in zip(in_specs, grad_specs))
        return local_map(fn, out_placements=tuple(pl(s) for s in out_specs),
                         in_placements=tuple(pl(s) for s in in_specs),
                         in_grad_placements=grads, device_mesh=mesh)(*args)

    return run


def partial_placements(mesh, spec: P):
    """:func:`placements` with every mesh axis that ``spec`` leaves
    replicated a partial sum (the gradient of a replicated input read by
    every rank's own tokens)."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if isinstance(p, Replicate) else p
                 for p in placements(mesh, spec))
