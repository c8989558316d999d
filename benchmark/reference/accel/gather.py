"""Row gathers into planes and counts below sorted tables, in plain PyTorch.

Copied from the port's plain versions (accel/gather.py:
``gather_planes_plain``, ``count_less_plain``) under the port's names, so
that the copied shading code calls them where the port launches K3 and K4.
``gather_cols`` returns the transposed (C, N) layout (each attribute a
dense (N,) plane), for every column or, with ``cols=``, for the columns a
caller reads; ``count_less`` is the batched searchsorted-left used to
invert CDFs, over one shared table or, with ``rows=``, over a row of a
table per query. Out-of-range indices and rows clamp to [0, T-1].
"""

from __future__ import annotations

import torch

_COUNT_CHUNK = 1 << 16  # queries per chunk of the linear count


def gather_cols(table: torch.Tensor, idx: torch.Tensor, cols=None) -> torch.Tensor:
    """table (T, C) f32, idx (N,) int -> (K, N) f32 = table[clamp(idx)][:, cols].T."""
    if cols is not None:
        table = table[:, list(cols)]
    return table[idx.long().clamp(0, table.shape[0] - 1)].T.contiguous()


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (T, C) f32, idx (N,) int -> (N, C) f32 = table[idx]."""
    return gather_cols(table, idx).T


class Fields:
    """Planes gathered for selected columns, indexed by the table's own
    column numbers: ``f[c]`` is column c's (N,) plane."""

    __slots__ = ("planes", "_at")

    def __init__(self, planes: torch.Tensor, cols: tuple):
        self.planes = planes
        self._at = {c: i for i, c in enumerate(cols)}

    def __getitem__(self, c: int) -> torch.Tensor:
        return self.planes[self._at[c]]


def gather_fields(table: torch.Tensor, idx: torch.Tensor, cols: tuple,
                  n: int | None = None) -> Fields:
    """``gather_cols(table, idx, cols)`` indexed by column number. With ``n``,
    ``idx`` holds one index that every lane shares: one row is gathered and
    its planes expanded to n lanes."""
    planes = gather_cols(table, idx, cols)
    return Fields(planes if n is None else planes.expand(-1, n), cols)


def count_less(table: torch.Tensor, q: torch.Tensor,
               rows: torch.Tensor | None = None) -> torch.Tensor:
    """The linear count of entries strictly below each query (in row
    ``clamp(rows[i])`` of ``table`` with ``rows``), in chunks of queries
    (int32)."""
    table, q = table.contiguous(), q.contiguous()
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    for s in range(0, q.shape[0], _COUNT_CHUNK):
        qs = q[s:s + _COUNT_CHUNK]
        if rows is None:
            tab = table[None, :]
        else:
            tab = table[rows[s:s + _COUNT_CHUNK].long().clamp(0, table.shape[0] - 1)]
        out[s:s + _COUNT_CHUNK] = (tab < qs[:, None]).sum(1).to(torch.int32)
    return out
