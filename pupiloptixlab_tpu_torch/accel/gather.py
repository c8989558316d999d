"""Row gathers into planes + counts below sorted tables.

Mirrors pupiloptixlab_tpu/accel/gather.py. ``gather_cols`` returns the
transposed (C, N) layout (each attribute a dense (N,) plane), for every
column or, with ``cols=``, for the columns a caller reads;
``count_less`` is the batched searchsorted-left used to invert CDFs, over
one shared table or, with ``rows=``, over a row of a table per query.
Out-of-range indices and rows clamp to [0, T-1] (callers mask invalid
lanes).

Kernels (csrc/gather.cu):
  gather_planes (K3) <- _make_gather_kernel and _transpose_kernel
  count_less    (K4) <- _make_count_kernel
Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel, once, for CUDA tensors (or raises). The wrappers validate each
tensor with one pass of attribute reads, and cache what a column selection
compiles to, so that a call costs the host about what one PyTorch op does.
"""

from __future__ import annotations

import ctypes

import torch

from pupiloptixlab_tpu_torch import kernels

_COUNT_CHUNK = 1 << 16  # queries per chunk of the plain linear count
_MAX_LIST_COLS = 32     # csrc/gather.cu kMaxCols: columns of a selection that is no run

# (cols, table columns, column stride) -> (ctypes offsets, count, step)
_col_specs: dict = {}


def _col_spec(cols, n_cols: int, col_stride: int):
    """What a selection of ``cols`` (None: all) of a table of ``n_cols``
    columns compiles to: element offsets, or the first offset and a step
    for a run of consecutive columns. Raises on a bad selection."""
    if isinstance(cols, (list, range)):
        cols = tuple(cols)
    key = (cols, n_cols, col_stride)
    spec = _col_specs.get(key)
    if spec is not None:
        return spec
    sel = tuple(range(n_cols)) if cols is None else cols
    if not isinstance(sel, tuple) or not sel or not all(
            isinstance(c, int) and 0 <= c < n_cols for c in sel):
        raise ValueError(f"gather: cols must be a non-empty tuple of column indices in "
                         f"[0, {n_cols}), got {cols!r}")
    run = col_stride > 0 and sel == tuple(range(sel[0], sel[0] + len(sel)))
    if not run and len(sel) > _MAX_LIST_COLS:
        raise ValueError(f"gather: at most {_MAX_LIST_COLS} columns that are not a run")
    offs = [sel[0] * col_stride] if run else [c * col_stride for c in sel]
    spec = ((ctypes.c_int * len(offs))(*offs), len(sel), col_stride if run else 0)
    _col_specs[key] = spec
    return spec


def _bad(name, t, want):
    return ValueError(f"{name}: expected {want}, got {t.dtype} {tuple(t.shape)} "
                      f"strides {t.stride()} on {t.device}")


# --- K3: gather into planes ---------------------------------------------------

def gather_planes_plain(table: torch.Tensor, idx: torch.Tensor, cols=None) -> torch.Tensor:
    """Plain version of K3: ``table[clamp(idx)][:, cols].T`` as (K, N) planes."""
    if cols is not None:
        table = table[:, list(cols)]
    return table[idx.clamp(0, table.shape[0] - 1)].T.contiguous()


def gather_planes(table: torch.Tensor, idx: torch.Tensor, cols=None) -> torch.Tensor:
    """table (T, C) f32, any strides, idx (N,) i32 contiguous, cols a tuple
    of K column indices (None: all C) -> (K, N) f32 with
    out[k, i] = table[clamp(idx[i], 0, T-1), cols[k]]. The kernel reads the
    table where it lies: a column slice or a view is never copied."""
    if table.dim() != 2 or table.dtype is not torch.float32:
        raise _bad("gather_planes table", table, "a 2-d float32 tensor")
    t, c = table.shape
    offs, k, step = _col_spec(cols, c, table.stride(1))
    if table.is_cpu:
        return gather_planes_plain(table, idx, cols)
    dev = table.get_device()
    if idx.dtype is not torch.int32 or idx.dim() != 1 or not idx.is_contiguous() \
            or idx.get_device() != dev:
        raise _bad("gather_planes idx", idx, f"a contiguous 1-d int32 tensor on {table.device}")
    if t == 0:
        raise ValueError("gather_planes: empty table")
    n = idx.shape[0]
    out = table.new_empty((k, n))
    fn = kernels.launcher("gather_planes")
    kernels.LAUNCHES["gather_planes"] += 1
    rc = fn(table.data_ptr(), t, table.stride(0), offs, k, step, idx.data_ptr(), n,
            out.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "gather_planes")
    return out


def gather_cols(table: torch.Tensor, idx: torch.Tensor, cols=None) -> torch.Tensor:
    """table (T, C) f32, idx (N,) int -> (K, N) f32 = table[idx][:, cols].T
    (all C columns for ``cols=None``). Indices that are not a contiguous
    int32 tensor are cast or copied first: the main path makes them int32
    where they are born, so that a call is one launch."""
    if idx.dtype is not torch.int32:
        idx = idx.to(torch.int32)
    if not idx.is_contiguous():
        idx = idx.contiguous()
    return gather_planes(table, idx, cols)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (T, C) f32, idx (N,) int -> (N, C) f32 = table[idx]."""
    return gather_cols(table, idx).T


class Fields:
    """Planes gathered for selected columns, indexed by the table's own
    column numbers: ``f[c]`` is column c's (N,) plane, as ``planes[c]`` is
    for a gather of every column."""

    __slots__ = ("planes", "_at")
    _at_of: dict = {}

    def __init__(self, planes: torch.Tensor, cols: tuple):
        self.planes = planes
        at = Fields._at_of.get(cols)
        if at is None:
            at = Fields._at_of[cols] = {c: i for i, c in enumerate(cols)}
        self._at = at

    def __getitem__(self, c: int) -> torch.Tensor:
        return self.planes[self._at[c]]


def gather_fields(table: torch.Tensor, idx: torch.Tensor, cols: tuple,
                  n: int | None = None) -> Fields:
    """``gather_cols(table, idx, cols)`` indexed by column number. With ``n``,
    ``idx`` holds one index that every lane shares: one row is gathered and
    its planes expanded to n lanes."""
    planes = gather_cols(table, idx, cols)
    return Fields(planes if n is None else planes.expand(-1, n), cols)


# --- K4: count below a sorted table --------------------------------------------

def count_less_plain(table: torch.Tensor, q: torch.Tensor,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K4: the linear count of entries strictly below each
    query (in row ``clamp(rows[i])`` of ``table`` with ``rows``), in chunks
    of queries (int32)."""
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    for s in range(0, q.shape[0], _COUNT_CHUNK):
        qs = q[s:s + _COUNT_CHUNK]
        if rows is None:
            tab = table[None, :]
        else:
            tab = table[rows[s:s + _COUNT_CHUNK].clamp(0, table.shape[0] - 1)]
        out[s:s + _COUNT_CHUNK] = (tab < qs[:, None]).sum(1).to(torch.int32)
    return out


def count_less(table: torch.Tensor, queries: torch.Tensor,
               rows: torch.Tensor | None = None) -> torch.Tensor:
    """Number of ``table`` entries strictly below each query -> (N,) i32.

    Shared form: table (T,) f32 nondecreasing, queries (N,) f32, equal to
    searchsorted(table, queries, side='left'). Row-indexed form: table
    (R, T) f32 whose every row is nondecreasing, rows (N,) i32: query i
    counts in row clamp(rows[i], 0, R-1). K4 on CUDA tensors (a lower-bound
    binary search: the same count as the linear one for nondecreasing rows,
    ties and flat runs included; the caller guarantees the order)."""
    if queries.dtype is not torch.float32 or queries.dim() != 1:
        raise _bad("count_less queries", queries, "a 1-d float32 tensor")
    if table.dtype is not torch.float32 or table.dim() != (1 if rows is None else 2):
        raise _bad("count_less table", table,
                   "a float32 (T,) table" if rows is None else "a float32 (R, T) table")
    n = queries.shape[0]
    if rows is not None and (rows.dtype is not torch.int32 or rows.dim() != 1
                             or rows.shape[0] != n):
        raise _bad("count_less rows", rows, f"a 1-d int32 tensor of {n} rows")
    table, q = table.contiguous(), queries.contiguous()
    if rows is not None:
        rows = rows.contiguous()
    if table.is_cpu:
        return count_less_plain(table, q, rows)
    dev = table.get_device()
    if q.get_device() != dev or (rows is not None and rows.get_device() != dev):
        raise ValueError(f"count_less: every tensor must be on {table.device}")
    r_rows, t_cols = (1, table.shape[0]) if rows is None else table.shape
    if r_rows == 0:
        raise ValueError("count_less: a table of no rows")
    out = q.new_empty(n, dtype=torch.int32)
    fn = kernels.launcher("count_less")
    kernels.LAUNCHES["count_less"] += 1
    rc = fn(table.data_ptr(), r_rows, t_cols, t_cols, q.data_ptr(),
            None if rows is None else rows.data_ptr(), n, out.data_ptr(),
            kernels.stream_ptr(dev))
    kernels.check(rc, "count_less")
    return out
