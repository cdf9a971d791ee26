"""Elementwise CSR ops: add (union), multiply (intersection), dense multiply,
diagonal extraction, sums, elementwise max/min (``sparse_tpu/ops/elementwise.py``).

The reference's 2-pass count and fill becomes a device sort or search,
one counted host fetch for the result's nnz (``hostsync``), and a
fixed-size fill. Every sum runs in sorted order (``coords.segment_sum``)
and never by scatter-adds, so each op repeats bit for bit on the card.
"""

from __future__ import annotations

import torch

from .. import hostsync
from ..types import index_dtype_for
from .conv import csr_to_csc
from .coords import (
    dedup_sorted,
    expand_rows,
    lexsort_rc,
    nonzero_count,
    rows_to_indptr,
    run_starts,
    segment_searchsorted,
    segment_sum,
)

_INT32_MAX = 2**31 - 1


def _empty(m, shape, dt, dev):
    idt = index_dtype_for(shape, 0)
    return (torch.zeros((m + 1,), dtype=idt, device=dev), torch.zeros((0,), dtype=idt, device=dev),
            torch.zeros((0,), dtype=dt, device=dev))


def _union_merge(indptr_a, indices_a, data_a, indptr_b, indices_b, data_b, shape):
    """The union prologue: both operands' COO triples concatenated and
    lex-sorted (stable, so A's entry comes before B's at a shared
    position). Coordinates are int64 only where a dimension needs it."""
    cdt = torch.int64 if max(int(shape[0]), int(shape[1])) > _INT32_MAX else torch.int32
    rows = torch.cat([expand_rows(indptr_a, data_a.shape[0]).to(cdt),
                      expand_rows(indptr_b, data_b.shape[0]).to(cdt)])
    cols = torch.cat([indices_a.to(cdt), indices_b.to(cdt)])
    dt = torch.promote_types(data_a.dtype, data_b.dtype)
    vals = torch.cat([data_a.to(dt), data_b.to(dt)])
    order = lexsort_rc(rows, cols, shape)
    return rows[order], cols[order], vals[order], dt


def csr_add_csr(indptr_a, indices_a, data_a, indptr_b, indices_b, data_b, shape):
    """Union add: concatenate the triples, lex sort, collapse duplicates."""
    srows, scols, svals, _ = _union_merge(indptr_a, indices_a, data_a, indptr_b, indices_b,
                                          data_b, shape)
    urows, ucols, uvals, nunique = dedup_sorted(srows, scols, svals)
    idt = index_dtype_for(shape, nunique)
    return rows_to_indptr(urows, int(shape[0]), dtype=idt), ucols.to(idt), uvals


def csr_mult_csr(indptr_a, indices_a, data_a, indptr_b, indices_b, data_b, shape):
    """Intersection multiply: each A nonzero's column searched in B's own
    row (``segment_searchsorted``), no fused keys."""
    m = int(shape[0])
    dt = torch.promote_types(data_a.dtype, data_b.dtype)
    nnz_b = data_b.shape[0]
    if nnz_b == 0 or data_a.shape[0] == 0:
        return _empty(m, shape, dt, data_a.device)
    rows_a = expand_rows(indptr_a, data_a.shape[0])
    ends = indptr_b[rows_a + 1]
    idx = segment_searchsorted(indices_b, indptr_b[rows_a], ends, indices_a)
    idx_c = idx.clamp(0, nnz_b - 1)
    match = (idx < ends) & (indices_b[idx_c] == indices_a)
    n_match = hostsync.fetch_int(match.sum())
    take = nonzero_count(match, n_match)
    vals = data_a[take].to(dt) * data_b[idx_c[take]].to(dt)
    idt = index_dtype_for(shape, n_match)
    return rows_to_indptr(rows_a[take], m, dtype=idt), indices_a[take].to(idt), vals


def csr_mult_dense(indptr, indices, data, dense, shape):
    """Structure-preserving multiply by a dense matrix."""
    rows = expand_rows(indptr, data.shape[0])
    return data * dense[rows, indices]


def csr_diagonal(indptr, indices, data, shape, k: int = 0):
    """The k-th diagonal: the entries with col = row + k summed row by row
    in order, then read at each diagonal slot."""
    m, n = int(shape[0]), int(shape[1])
    out_len = min(m + min(k, 0), n - max(k, 0))
    if out_len <= 0:
        return torch.zeros((0,), dtype=data.dtype, device=data.device)
    nnz = data.shape[0]
    if nnz == 0:
        return torch.zeros((out_len,), dtype=data.dtype, device=data.device)
    rows = expand_rows(indptr, nnz).to(torch.int64)
    on_diag = indices.to(torch.int64) == rows + k
    per_row = segment_sum(torch.where(on_diag, data, torch.zeros((), dtype=data.dtype,
                                                                 device=data.device)), indptr)
    lo = max(-k, 0)  # A[i, i + k] sits at slot i - max(-k, 0)
    return per_row[lo: lo + out_len]


def csr_sum(indptr, indices, data, shape, axis=None):
    """Sum of all entries, or per column (axis 0: the entries sorted by
    column, ``conv.csr_to_csc``, then summed in order) or per row."""
    if axis is None:
        return data.sum()
    if axis in (0, -2):
        col_indptr, _, cdata = csr_to_csc(indptr, indices, data, shape)
        return segment_sum(cdata, col_indptr)
    if axis in (1, -1):
        return segment_sum(data, indptr)
    raise ValueError(f"invalid axis {axis}")


def csr_minmax_csr(indptr_a, indices_a, data_a, indptr_b, indices_b, data_b, shape, is_max):
    """Elementwise maximum (``is_max``) or minimum of two CSRs. Union merge
    as for add; a position stored in one operand only compares with the
    other's implicit zero, one stored in both takes the max/min of the two.
    Exact zeros in the result are dropped (canonical output)."""
    m = int(shape[0])
    srows, scols, svals, dt = _union_merge(indptr_a, indices_a, data_a, indptr_b, indices_b,
                                           data_b, shape)
    nnz = srows.shape[0]
    if nnz == 0:
        return _empty(m, shape, dt, srows.device)
    first, _ = run_starts(srows, scols)
    offs = torch.cat([first, torch.full((1,), nnz, dtype=first.dtype, device=first.device)])
    uvals = torch.segment_reduce(svals, "max" if is_max else "min", offsets=offs)
    # a position stored once compares with the other operand's implicit 0
    with_zero = (torch.maximum if is_max else torch.minimum)(
        uvals, torch.zeros((), dtype=dt, device=srows.device))
    uvals = torch.where((offs[1:] - offs[:-1]) == 1, with_zero, uvals)
    keep = uvals != 0
    nkeep = hostsync.fetch_int(keep.sum())
    kept = nonzero_count(keep, nkeep)
    sel = first[kept]
    idt = index_dtype_for(shape, nkeep)
    return rows_to_indptr(srows[sel], m, dtype=idt), scols[sel].to(idt), uvals[kept]
