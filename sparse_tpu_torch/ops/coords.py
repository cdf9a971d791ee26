"""Coordinate plumbing: indptr <-> row ids, (row, col) sorting and dedup.

Port of ``sparse_tpu/ops/coords.py``: the same vectorized formulations
(batched binary search for row expansion, one stable key sort, a
boundary-mask dedup) on torch tensors, so they run on the device the
tensors live on. Sorted segments are summed by :func:`segment_sum` in one
fixed order (the reference's ``jax.ops.segment_sum``), never by scatter
atomics, so a repeated call gives the same bits on the card.
"""

from __future__ import annotations

import torch

from ..utils import host_int

_INT32_MAX = 2**31 - 1


def expand_rows(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Per-nnz row ids from a CSR indptr (CSR -> COO row coordinates)."""
    if nnz == 0:
        return torch.zeros((0,), dtype=indptr.dtype, device=indptr.device)
    pts = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    rows = torch.searchsorted(
        indptr, pts, right=True, out_int32=indptr.dtype == torch.int32
    )
    return (rows - 1).to(indptr.dtype)


def segment_sum(values: torch.Tensor, offsets: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sums of the contiguous segments ``offsets[i]:offsets[i + 1]`` of
    ``values`` along ``axis`` (0 or, for ``[B, nnz]`` values, 1), 0 for an
    empty segment. Floating values go through ``torch.segment_reduce``,
    which sums each segment in one order on every call; complex values sum
    their real and imaginary parts apart. Integer sums are exact in any
    order and take ``index_add_``."""
    if values.is_complex():
        return torch.view_as_complex(segment_sum(torch.view_as_real(values), offsets, axis))
    if not values.is_floating_point():
        seg = expand_rows(offsets, values.shape[axis])
        shape = list(values.shape)
        shape[axis] = offsets.shape[0] - 1
        return torch.zeros(shape, dtype=values.dtype, device=values.device).index_add_(
            axis, seg, values)
    if axis:
        offsets = offsets.expand(*values.shape[:axis], offsets.shape[0])
    return torch.segment_reduce(values, "sum", offsets=offsets, axis=axis)


def rows_to_indptr(sorted_rows: torch.Tensor, m: int, dtype=None) -> torch.Tensor:
    """Sorted row ids -> indptr (one searchsorted over the sorted coords)."""
    dtype = dtype or (sorted_rows.dtype if sorted_rows.numel() else torch.int32)
    if not sorted_rows.numel():
        return torch.zeros((m + 1,), dtype=dtype, device=sorted_rows.device)
    targets = torch.arange(m + 1, dtype=sorted_rows.dtype, device=sorted_rows.device)
    return torch.searchsorted(sorted_rows.contiguous(), targets).to(dtype)


def lexsort_rc(primary, secondary, shape) -> torch.Tensor:
    """Stable order making (primary, secondary) lexicographically sorted.

    ``shape`` = (extent of primary, extent of secondary). One fused key
    sort: int32 when the key space fits int32, int64 otherwise.
    """
    p, s = int(shape[0]), int(shape[1])
    kdt = torch.int32 if p * s <= _INT32_MAX else torch.int64
    keys = primary.to(kdt) * s + secondary.to(kdt)
    return torch.argsort(keys, stable=True)


def sort_coo(rows, cols, vals, shape, by="row"):
    """Lexicographic sort of COO triples by (row, col) or (col, row)."""
    if by == "row":
        order = lexsort_rc(rows, cols, shape)
    else:
        order = lexsort_rc(cols, rows, (shape[1], shape[0]))
    return rows[order], cols[order], vals[order]


def dedup_sorted(rows, cols, vals):
    """Collapse duplicate (already lex-sorted) (row, col) pairs, summing
    their values. Returns (unique_rows, unique_cols, unique_vals, nunique);
    one host fetch for the unique count.
    """
    nnz = rows.shape[0]
    if nnz == 0:
        return rows, cols, vals, 0
    is_new = torch.ones((nnz,), dtype=torch.bool, device=rows.device)
    is_new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    nunique = host_int(is_new.sum())
    if nunique == nnz:
        return rows, cols, vals, nnz
    first = torch.nonzero(is_new).squeeze(1)
    ends = torch.full((1,), nnz, dtype=first.dtype, device=first.device)
    uvals = segment_sum(vals, torch.cat([first, ends]))
    return rows[first], cols[first], uvals, nunique
