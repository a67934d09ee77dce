"""Cloudflow operators (paper Table 1) with schema propagation and local
evaluation semantics.

Every operator maps input Table(s) to an output Table.  ``Map``/``Filter``
require Python type annotations on their functions (paper §3.1
"Typechecking and Constraints"); annotations are verified against upstream
schemas at deploy time and against actual values at run time.

Operator hints (``resource_class``, ``batching``, ``high_variance``,
``competitive_replicas``) drive the paper's optimizations (§4).
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.table import Row, Table, Schema, schema_compatible

AGG_FNS = ("count", "sum", "min", "max", "avg")


class TypecheckError(TypeError):
    pass


def _type_ok(value, t) -> bool:
    if t in (Any, None, type(None)):
        return True
    origin = typing.get_origin(t)
    if origin is not None:  # typing generics: check origin only
        return isinstance(value, origin)
    if isinstance(t, type):
        if t is float:
            return isinstance(value, (int, float))
        return isinstance(value, t)
    return True


def fn_signature(fn) -> Tuple[List[Optional[type]], Any]:
    """(per-arg types — None when unannotated, return annotation)."""
    hints = typing.get_type_hints(fn)
    names = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    args = [hints.get(p) for p in names]
    ret = hints.get("return")
    return args, ret


def _ret_schema(ret, names: Optional[Sequence[str]]) -> Schema:
    if ret is None:
        raise TypecheckError("map function needs a return annotation")
    if typing.get_origin(ret) is tuple:
        types = list(typing.get_args(ret))
    else:
        types = [ret]
    names = list(names) if names else [f"out{i}" for i in range(len(types))]
    if len(names) != len(types):
        raise TypecheckError(f"{len(names)} names for {len(types)} outputs")
    return list(zip(names, types))


@dataclasses.dataclass
class Operator:
    """Base: single-input operator."""
    # optimization hints (paper §4)
    resource_class: str = dataclasses.field(default="cpu", init=False)
    batching: bool = dataclasses.field(default=False, init=False)
    high_variance: bool = dataclasses.field(default=False, init=False)
    competitive_replicas: int = dataclasses.field(default=0, init=False)

    @property
    def name(self) -> str:
        return type(self).__name__.lower()

    def out_schema(self, in_schemas: List[Schema]) -> Schema:
        raise NotImplementedError

    def out_grouping(self, in_groupings: List[Optional[str]]):
        return in_groupings[0]

    def apply(self, tables: List[Table], ctx=None) -> Table:
        raise NotImplementedError

    def typecheck(self, in_schemas: List[Schema]) -> Schema:
        return self.out_schema(in_schemas)


def _check_values(values, schema: Schema, where: str):
    if len(values) != len(schema):
        raise TypecheckError(
            f"{where}: returned {len(values)} values for schema {schema}")
    for v, (n, t) in zip(values, schema):
        if not _type_ok(v, t):
            raise TypecheckError(
                f"{where}: column {n!r} expected {t}, got "
                f"{type(v).__name__} ({v!r})")


@dataclasses.dataclass
class Map(Operator):
    fn: Callable
    names: Optional[Sequence[str]] = None

    def __post_init__(self):
        self._arg_types, self._ret = fn_signature(self.fn)
        self._schema = _ret_schema(self._ret, self.names)

    def out_schema(self, in_schemas):
        (in_schema,) = in_schemas
        if self._arg_types and len(self._arg_types) != len(in_schema):
            raise TypecheckError(
                f"map {self.fn.__name__}: takes {len(self._arg_types)} args, "
                f"upstream schema has {len(in_schema)} columns")
        for (n, t), at in zip(in_schema, self._arg_types):
            if at is None:
                continue  # unannotated arg (e.g. injected lookup column)
            if at is not Any and isinstance(at, type) and isinstance(t, type):
                if not (issubclass(t, at) or (at is float and t is int)):
                    raise TypecheckError(
                        f"map {self.fn.__name__}: arg for column {n!r} "
                        f"annotated {at}, upstream type {t}")
        return self._schema

    def apply(self, tables, ctx=None):
        (t,) = tables
        rows = []
        for r in t.rows:
            out = self.fn(*r.values)
            if not isinstance(out, tuple):
                out = (out,)
            _check_values(out, self._schema, f"map {self.fn.__name__}")
            rows.append(r.replace(out))
        out_t = Table(self._schema, grouping=t.grouping)
        out_t.rows = rows
        return out_t


@dataclasses.dataclass
class ModelOp(Map):
    """A registry model stage (``prefill``/``decode_step``/``logits``) as a
    first-class plan operator (white-box models, per PRETZEL).

    Structurally a ``Map`` — ``fn`` is the stage function with declared
    ``torch.Tensor`` annotations, so the op typechecks, fuses, and lowers
    into ``JittedFuse``/``BatchedJittedFuse`` chains like any other map —
    plus:

    * identity: ``model_name``/``stage`` name the registry model and stage,
      so plans and explain output say *which* model runs where;
    * cost hook: ``cost_hook(batch_size) -> {"mean_s", "p99_s", "cv",
      "runs", "out_bytes"}`` measures (or estimates) the stage at a batch
      size, for the profiler (``profiling.profiler.seed_from_model_ops``).

    Built by ``repro_torch.models.registry.model_stage_op``; attach to a
    flow with ``Node.apply_op``."""
    model_name: str = ""
    stage: str = "logits"
    cost_hook: Optional[Callable] = None

    @property
    def name(self):
        return f"model[{self.model_name}:{self.stage}]"


@dataclasses.dataclass
class Filter(Operator):
    fn: Callable

    def __post_init__(self):
        self._arg_types, self._ret = fn_signature(self.fn)
        if self._ret not in (bool, None):
            raise TypecheckError("filter function must return bool")

    def out_schema(self, in_schemas):
        return in_schemas[0]

    def apply(self, tables, ctx=None):
        (t,) = tables
        rows = []
        for r in t.rows:
            keep = self.fn(*r.values)
            # accept scalar boolean *arrays* too (numpy / torch 0-d
            # bools): an array-typed predicate like ``x.sum() > 0``
            # returns one, and the lowered masked path evaluates the same
            # fn — the interpreted oracle must agree with it
            if not isinstance(keep, bool):
                dtype = getattr(keep, "dtype", None)
                if dtype in (np.bool_, torch.bool) and \
                        getattr(keep, "ndim", None) == 0:
                    keep = bool(keep)
                else:
                    raise TypecheckError(
                        f"filter {self.fn.__name__} returned non-bool "
                        f"{type(keep).__name__}")
            if keep:
                rows.append(r)
        return t.with_rows(rows)


@dataclasses.dataclass
class GroupBy(Operator):
    column: str

    def out_schema(self, in_schemas):
        (s,) = in_schemas
        if self.column not in [n for n, _ in s]:
            raise TypecheckError(f"groupby: no column {self.column!r} in {s}")
        return s

    def out_grouping(self, in_groupings):
        if in_groupings[0] is not None:
            raise TypecheckError("groupby over an already-grouped table")
        return self.column

    def apply(self, tables, ctx=None):
        (t,) = tables
        i = t.column_index(self.column)
        rows = [r.replace(r.values, group=r.values[i]) for r in t.rows]
        out = t.with_rows(rows, grouping=self.column)
        return out


@dataclasses.dataclass
class Agg(Operator):
    agg_fn: str
    column: str

    def __post_init__(self):
        if self.agg_fn not in AGG_FNS:
            raise TypecheckError(f"agg fn {self.agg_fn!r} not in {AGG_FNS}")

    def out_schema(self, in_schemas):
        (s,) = in_schemas
        names = [n for n, _ in s]
        if self.column not in names:
            raise TypecheckError(f"agg: no column {self.column!r}")
        t = dict(s)[self.column]
        out_t = int if self.agg_fn == "count" else (
            float if self.agg_fn == "avg" else t)
        return [("group", Any), (self.agg_fn, out_t)]

    def out_grouping(self, in_groupings):
        return None  # agg always un-groups

    def apply(self, tables, ctx=None):
        (t,) = tables
        i = t.column_index(self.column)
        groups: Dict[Any, List[Any]] = {}
        for r in t.rows:
            groups.setdefault(r.group if t.grouping else None, []).append(
                r.values[i])
        out = Table(self.out_schema([t.schema]))
        for g, vals in groups.items():
            if self.agg_fn == "count":
                v = len(vals)
            elif self.agg_fn == "sum":
                v = sum(vals)
            elif self.agg_fn == "min":
                v = min(vals)
            elif self.agg_fn == "max":
                v = max(vals)
            else:
                v = sum(vals) / len(vals)
            out.insert((g, v))
        return out


@dataclasses.dataclass
class Lookup(Operator):
    """Retrieve object(s) from the KVS; ref is a constant key or a column."""
    key: str
    is_column: bool = False
    out_name: str = "lookup"

    def out_schema(self, in_schemas):
        (s,) = in_schemas
        if self.is_column and self.key not in [n for n, _ in s]:
            raise TypecheckError(f"lookup: no column {self.key!r}")
        return list(s) + [(self.out_name, Any)]

    def apply(self, tables, ctx=None):
        (t,) = tables
        if ctx is None or ctx.kvs is None:
            raise RuntimeError("lookup needs a KVS in the execution context")
        rows = []
        ki = t.column_index(self.key) if self.is_column else None
        for r in t.rows:
            key = r.values[ki] if self.is_column else self.key
            val = ctx.kvs_get(key)
            rows.append(r.replace(r.values + (val,)))
        out = Table(self.out_schema([t.schema]), grouping=t.grouping)
        out.rows = rows
        return out


@dataclasses.dataclass
class Join(Operator):
    key: Optional[str] = None      # None -> row ID
    how: str = "inner"             # inner | left | outer

    def __post_init__(self):
        if self.how not in ("inner", "left", "outer"):
            raise TypecheckError(f"join how={self.how!r}")

    def out_schema(self, in_schemas):
        left, right = in_schemas
        return list(left) + list(right)

    def out_grouping(self, in_groupings):
        if any(g is not None for g in in_groupings):
            raise TypecheckError("join inputs must be ungrouped")
        return None

    def apply(self, tables, ctx=None):
        left, right = tables
        lk = (lambda r: r.row_id) if self.key is None else (
            lambda r, i=left.column_index(self.key): r.values[i])
        rk = (lambda r: r.row_id) if self.key is None else (
            lambda r, i=right.column_index(self.key): r.values[i])
        rmap: Dict[Any, List[Row]] = {}
        for r in right.rows:
            rmap.setdefault(rk(r), []).append(r)
        out = Table(self.out_schema([left.schema, right.schema]))
        matched_right = set()
        nones_r = (None,) * len(right.schema)
        for l in left.rows:
            ms = rmap.get(lk(l), [])
            if ms:
                for m in ms:
                    matched_right.add(id(m))
                    out.rows.append(Row(l.values + m.values, l.row_id))
            elif self.how in ("left", "outer"):
                out.rows.append(Row(l.values + nones_r, l.row_id))
        if self.how == "outer":
            nones_l = (None,) * len(left.schema)
            for r in right.rows:
                if id(r) not in matched_right:
                    out.rows.append(Row(nones_l + r.values, r.row_id))
        return out


@dataclasses.dataclass
class Union(Operator):
    def out_schema(self, in_schemas):
        first = in_schemas[0]
        for s in in_schemas[1:]:
            if not schema_compatible(first, s):
                raise TypecheckError(f"union schema mismatch: {first} vs {s}")
        return first

    def apply(self, tables, ctx=None):
        out = tables[0].with_rows(
            [r for t in tables for r in t.rows])
        return out


@dataclasses.dataclass
class AnyOf(Operator):
    """Pass exactly one input through; the runtime picks (wait-for-any)."""
    def out_schema(self, in_schemas):
        return Union().out_schema(in_schemas)

    def apply(self, tables, ctx=None):
        for t in tables:
            if t is not None:
                return t
        raise RuntimeError("anyof: no input available")


@dataclasses.dataclass
class Fuse(Operator):
    """An encapsulated chain of operators executed at one location (§4)."""
    ops: List[Operator] = dataclasses.field(default_factory=list)

    @property
    def name(self):
        return "fuse[" + ",".join(o.name for o in self.ops) + "]"

    def out_schema(self, in_schemas):
        s = in_schemas[0]
        for op in self.ops:
            s = op.out_schema([s])
        return s

    def out_grouping(self, in_groupings):
        g = in_groupings[0]
        for op in self.ops:
            g = op.out_grouping([g])
        return g

    def apply(self, tables, ctx=None):
        (t,) = tables
        for op in self.ops:
            t = op.apply([t], ctx)
        return t
