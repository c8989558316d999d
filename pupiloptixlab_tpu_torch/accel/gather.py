"""Row gathers into planes + counts below a sorted table.

Mirrors pupiloptixlab_tpu/accel/gather.py. ``gather_cols`` returns the
transposed (C, N) layout (each attribute a dense (N,) plane);
``count_less`` is the batched searchsorted-left used to invert CDFs.
Out-of-range indices clamp to [0, T-1] (callers mask invalid lanes).

Kernels (csrc/gather.cu):
  gather_planes (K3) <- _make_gather_kernel and _transpose_kernel
  count_less    (K4) <- _make_count_kernel
Each wrapper runs its plain PyTorch version for CPU tensors and launches
the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from pupiloptixlab_tpu_torch import kernels

_COUNT_CHUNK = 1 << 16  # queries per chunk of the plain linear count


def _check(name, t, dtype, ndim, device):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")


# --- K3: gather into planes ---------------------------------------------------

def gather_planes_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ``table[clamp(idx)].T`` as (C, N) planes."""
    t = table.shape[0]
    return table[idx.clamp(0, t - 1)].T.contiguous()


def gather_planes(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (T, C) f32 contiguous, idx (N,) i32 contiguous -> (C, N) f32
    with out[c, i] = table[clamp(idx[i], 0, T-1), c]."""
    if table.device.type == "cpu":
        return gather_planes_plain(table, idx)
    _check("gather_planes table", table, torch.float32, 2, table.device)
    _check("gather_planes idx", idx, torch.int32, 1, table.device)
    t, c = table.shape
    n = idx.shape[0]
    if t == 0:
        raise ValueError("gather_planes: empty table")
    out = torch.empty((c, n), dtype=torch.float32, device=table.device)
    fn = kernels.launcher("gather_planes")
    kernels.LAUNCHES["gather_planes"] += 1
    rc = fn(table.data_ptr(), t, c, idx.data_ptr(), n, out.data_ptr(),
            kernels.stream_ptr(table.device))
    kernels.check(rc, "gather_planes")
    return out


def gather_cols(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (T, C) f32, idx (N,) int -> (C, N) f32 = table[idx].T."""
    return gather_planes(table.contiguous(), idx.to(torch.int32).contiguous())


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (T, C) f32, idx (N,) int -> (N, C) f32 = table[idx]."""
    return gather_cols(table, idx).T


# --- K4: count below a sorted table --------------------------------------------

def count_less_plain(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: the linear count of entries strictly below each
    query, in chunks of queries (int32)."""
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    for s in range(0, q.shape[0], _COUNT_CHUNK):
        qs = q[s:s + _COUNT_CHUNK]
        out[s:s + _COUNT_CHUNK] = (table[None, :] < qs[:, None]).sum(1).to(torch.int32)
    return out


def count_less(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Number of ``table`` entries strictly below each query: table (T,)
    f32 nondecreasing, queries (N,) f32 -> (N,) i32, equal to
    searchsorted(table, queries, side='left'). K4 on CUDA tensors (a
    lower-bound binary search, the same count for a sorted table)."""
    table, q = table.contiguous(), queries.contiguous()
    if table.device.type == "cpu":
        return count_less_plain(table, q)
    _check("count_less table", table, torch.float32, 1, table.device)
    _check("count_less q", q, torch.float32, 1, table.device)
    n = q.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=q.device)
    fn = kernels.launcher("count_less")
    kernels.LAUNCHES["count_less"] += 1
    rc = fn(table.data_ptr(), table.shape[0], q.data_ptr(), n, out.data_ptr(),
            kernels.stream_ptr(table.device))
    kernels.check(rc, "count_less")
    return out
