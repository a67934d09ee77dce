"""Cloudflow's core data structures: a small in-memory relational Table,
plus its device-resident columnar twin (``DeviceTable``).  Port of the
reference package's ``core/table.py``.

A Table has a *schema* (list of (name, type) column descriptors), an optional
*grouping column*, and rows.  Every row carries a hidden ``row_id`` assigned
at dataflow execution time which persists through the pipeline (paper §3.1)
and is the default join key.

A ``DeviceTable`` holds the same logical rows as columns — one tensor per
schema column on an explicit device, rows stacked along dim 0 — so a chain
of lowered GPU operators can hand whole batches from stage to stage
without a host round-trip: ONE upload per column when the batch enters the
device chain, ONE device->host copy per column when it leaves.  Row
identity (``row_ids``, ``groups``) stays on the host; row *liveness* is a
boolean ``mask`` column carried on the device, which is how fused Filter
operators drop rows without forcing a compaction (masked rows are
compacted only at the device->host boundary in ``host_rows``/
``to_table``).
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Schema = List[Tuple[str, type]]

_counter = itertools.count()


class Row:
    __slots__ = ("values", "row_id", "group")

    def __init__(self, values: Tuple[Any, ...], row_id: Optional[int] = None,
                 group: Any = None):
        self.values = tuple(values)
        self.row_id = row_id if row_id is not None else next(_counter)
        self.group = group

    def replace(self, values: Tuple[Any, ...], group=...) -> "Row":
        return Row(values, self.row_id,
                   self.group if group is ... else group)

    def __repr__(self):
        return f"Row(id={self.row_id}, {self.values!r})"


class Table:
    def __init__(self, schema: Schema, rows: Optional[Iterable] = None,
                 grouping: Optional[str] = None):
        self.schema: Schema = [(str(n), t) for n, t in schema]
        self.grouping = grouping
        self.rows: List[Row] = []
        if rows:
            for r in rows:
                self.insert(r)

    # -- construction -------------------------------------------------------
    def insert(self, values, group: Any = None) -> Row:
        if isinstance(values, Row):
            self.rows.append(values)
            return values
        if not isinstance(values, (tuple, list)):
            values = (values,)
        if len(values) != len(self.schema):
            raise ValueError(
                f"row arity {len(values)} != schema arity {len(self.schema)}")
        row = Row(tuple(values), group=group)
        self.rows.append(row)
        return row

    @property
    def columns(self) -> List[str]:
        return [n for n, _ in self.schema]

    def column_index(self, name: str) -> int:
        for i, (n, _) in enumerate(self.schema):
            if n == name:
                return i
        raise KeyError(f"no column {name!r} in {self.columns}")

    def column(self, name: str) -> List[Any]:
        i = self.column_index(name)
        return [r.values[i] for r in self.rows]

    def with_rows(self, rows: List[Row], grouping=...) -> "Table":
        t = Table(self.schema, grouping=self.grouping
                  if grouping is ... else grouping)
        t.rows = list(rows)
        return t

    # -- python sugar ---------------------------------------------------------
    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def __repr__(self):
        g = f", grouped by {self.grouping!r}" if self.grouping else ""
        return (f"Table({self.columns}{g}, {len(self.rows)} rows)\n" +
                "\n".join(f"  {r}" for r in self.rows[:10]))

    def to_dicts(self) -> List[Dict[str, Any]]:
        return [dict(zip(self.columns, r.values)) for r in self.rows]

    @staticmethod
    def from_dicts(schema: Schema, dicts: Sequence[Dict[str, Any]]) -> "Table":
        t = Table(schema)
        for d in dicts:
            t.insert(tuple(d[n] for n, _ in schema))
        return t


def schema_compatible(a: Schema, b: Schema) -> bool:
    return len(a) == len(b) and all(ta == tb for (_, ta), (_, tb)
                                    in zip(a, b))


# ---------------------------------------------------------------------------
# device-resident columnar batches
# ---------------------------------------------------------------------------

#: process-wide host<->device copy accounting (read by tests): a "stack"
#: is one columnar upload event, a "gather" one device->host readback
#: event.  Index uploads and mask bookkeeping (a few bytes) are not counted
#: — the counters track the bulk row payload crossing the PCIe boundary.
HOST_COPIES: Dict[str, int] = {"stacks": 0, "gathers": 0}

# per-thread copy capture: an executor thread brackets one item's
# execution with start/end and gets THAT item's copy counts, without
# the races a global-counter delta would have across worker threads
_copy_capture = threading.local()


def note_host_copy(kind: str) -> None:
    """Count one host<->device bulk copy ('stacks' or 'gathers') against
    the global counters and, when the current thread has a capture open,
    against that capture."""
    HOST_COPIES[kind] += 1
    cap = getattr(_copy_capture, "counts", None)
    if cap is not None:
        cap[kind] = cap.get(kind, 0) + 1


def copy_capture_start() -> None:
    """Begin attributing this thread's host copies (until
    :func:`copy_capture_end`) to the current work item."""
    _copy_capture.counts = {}


def copy_capture_end() -> Optional[Dict[str, int]]:
    """Close this thread's capture; returns the counts since start (None
    when no capture was open, {} when no copies happened)."""
    cap = getattr(_copy_capture, "counts", None)
    _copy_capture.counts = None
    return cap


def reset_host_copies() -> None:
    HOST_COPIES["stacks"] = 0
    HOST_COPIES["gathers"] = 0


def value_key(v) -> Tuple[Tuple[int, ...], str]:
    """(shape, dtype) of one row value: a tensor's own, else those of the
    numpy array it converts to.  Rows stack into one batch only where
    every column's keys agree."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), str(v.dtype)
    a = np.asarray(v)
    return a.shape, str(a.dtype)


def _stack_column(col: List[Any]) -> torch.Tensor:
    """Stack one column's per-row values (tensors on one device, or
    numpy/scalars) into one tensor, on the values' own device."""
    if all(isinstance(v, torch.Tensor) for v in col):
        return torch.stack(col)
    return torch.as_tensor(np.stack([np.asarray(v) for v in col]))


class DeviceTable:
    """A shape-uniform batch of rows living on a device.

    ``columns[j]`` stacks column j of every row along dim 0, padded up to
    a bucketed capacity (``cap``); only the first ``nrows`` entries are
    logical rows, and of those only the ones whose ``mask`` entry is True
    (``mask is None`` means all live).  ``row_ids``/``groups`` keep per-row
    identity on the host so demultiplexing never needs device data.

    ``donatable=True`` marks a table whose buffers have no other live
    consumer (exclusive ownership).  The flag is tracked exactly as in the
    reference; reusing donated storage in place is later work.
    """

    __slots__ = ("schema", "grouping", "columns", "mask", "nrows",
                 "row_ids", "groups", "donatable")

    def __init__(self, schema: Schema, columns: Sequence[Any], nrows: int,
                 row_ids: Sequence[int], groups: Sequence[Any],
                 grouping: Optional[str] = None, mask: Any = None,
                 donatable: bool = False):
        self.schema: Schema = [(str(n), t) for n, t in schema]
        self.columns = list(columns)
        self.nrows = int(nrows)
        self.row_ids = list(row_ids)
        self.groups = list(groups)
        self.grouping = grouping
        self.mask = mask
        self.donatable = donatable

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_columns(schema: Schema, host_cols: Sequence[Sequence[Any]],
                     row_ids: Sequence[int], groups: Sequence[Any],
                     pad_to: Optional[int] = None,
                     grouping: Optional[str] = None,
                     device: DeviceLike = None) -> "DeviceTable":
        """Build from per-column lists of per-row values (numpy arrays or
        tensors): one stack + ONE upload per column to ``device`` (the
        CUDA device unless named; raises without a card).  The row count
        is padded up to ``pad_to`` by repeating row 0 so device shapes
        stay bucket-sized; padding rows carry no mask entry — ``nrows``
        bounds the live range."""
        dev = resolve_device(device)
        n = len(row_ids)
        cap = max(pad_to or n, n)
        columns = []
        for col in host_cols:
            col = list(col)
            stacked = _stack_column(col + col[:1] * (cap - n)) if col \
                else torch.zeros((0,))
            columns.append(stacked.to(dev))
        note_host_copy("stacks")
        return DeviceTable(schema, columns, n, row_ids, groups,
                           grouping=grouping, mask=None, donatable=True)

    @staticmethod
    def from_table(t: Table, pad_to: Optional[int] = None, *,
                   device: DeviceLike = None) -> "DeviceTable":
        """Stack a shape-uniform host table onto ``device`` (the CUDA
        device unless named).  Raises ``ValueError`` when rows are ragged
        or values cannot be stacked — callers fall back to per-row
        execution."""
        for r in t.rows:
            for v in r.values:
                if not isinstance(v, torch.Tensor) and \
                        np.asarray(v).dtype.kind not in "biufc":
                    raise ValueError(f"a {type(v).__name__} value cannot "
                                     "form a DeviceTable")
        keys = [[value_key(v) for v in r.values] for r in t.rows]
        if any(k != keys[0] for k in keys[1:]):
            raise ValueError("ragged rows cannot form a DeviceTable")
        host_cols = [[r.values[j] for r in t.rows]
                     for j in range(len(t.schema))]
        return DeviceTable.from_columns(
            t.schema, host_cols, [r.row_id for r in t.rows],
            [r.group for r in t.rows], pad_to=pad_to, grouping=t.grouping,
            device=device)

    # -- accessors ----------------------------------------------------------
    def __len__(self) -> int:
        return self.nrows

    @property
    def cap(self) -> int:
        return int(self.columns[0].shape[0]) if self.columns else self.nrows

    @property
    def device(self) -> Optional[torch.device]:
        return self.columns[0].device if self.columns else None

    @property
    def nbytes(self) -> int:
        return int(sum(c.numel() * c.element_size() for c in self.columns))

    @property
    def column_names(self) -> List[str]:
        return [n for n, _ in self.schema]

    def column_index(self, name: str) -> int:
        for i, (n, _) in enumerate(self.schema):
            if n == name:
                return i
        raise KeyError(f"no column {name!r} in {self.column_names}")

    def __repr__(self):
        shapes = [tuple(c.shape) for c in self.columns]
        return (f"DeviceTable({self.column_names}, rows={self.nrows}"
                f"/cap={self.cap}, shapes={shapes}"
                f"{', masked' if self.mask is not None else ''})")

    # -- device-side row selection (no host copy) ----------------------------
    def take(self, positions: Sequence[int],
             pad_to: Optional[int] = None) -> "DeviceTable":
        """A new DeviceTable holding ``positions`` (indices < nrows), padded
        to ``pad_to``.  The gather runs on the device (``index_select``) —
        no host round-trip beyond the tiny index upload."""
        pos = [int(p) for p in positions]
        k = len(pos)
        cap = max(pad_to or k, k)
        dev = self.device
        idx = torch.as_tensor(pos + pos[:1] * (cap - k), dtype=torch.long,
                              device=dev)
        cols = [c.index_select(0, idx) for c in self.columns]
        mask = None
        if self.mask is not None:
            mask = self.mask.index_select(0, idx)
        if cap > k:
            valid = torch.arange(cap, device=dev) < k
            mask = valid if mask is None else mask & valid
        return DeviceTable(self.schema, cols, k,
                           [self.row_ids[p] for p in pos],
                           [self.groups[p] for p in pos],
                           grouping=self.grouping, mask=mask, donatable=True)

    # -- device->host boundary ----------------------------------------------
    def host_rows(self) -> List[Tuple[int, Row]]:
        """Materialize live rows as ``(position, Row)`` pairs: one
        synchronise, then ONE ``.cpu()`` per column (row values are CPU
        tensor views); masked-out (filtered) and padding rows are
        compacted away here — and only here."""
        dev = self.device
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        host = [c.cpu() for c in self.columns]
        mask_h = self.mask.cpu() if self.mask is not None else None
        note_host_copy("gathers")
        out: List[Tuple[int, Row]] = []
        for i in range(self.nrows):
            if mask_h is not None and not bool(mask_h[i]):
                continue
            out.append((i, Row(tuple(c[i] for c in host),
                               self.row_ids[i], self.groups[i])))
        return out

    def to_table(self) -> Table:
        t = Table(self.schema, grouping=self.grouping)
        t.rows = [r for _, r in self.host_rows()]
        return t


#: the paper-facing name: a schema-tagged columnar batch (device-resident).
ColumnBatch = DeviceTable
