"""Format conversions: dense<->CSR, COO<->CSR/CSC, CSR<->CSC, ELL build.

Port of ``sparse_tpu/ops/conv.py``: count on the device, one host fetch
for the size, then a fixed-shape fill. Duplicates are summed in sorted
order (``coords.dedup_sorted``), never by scatter-adds, so every
conversion repeats bit for bit on either device.
"""

from __future__ import annotations

import torch

from ..types import index_dtype_for
from .coords import dedup_sorted, expand_rows, lexsort_rc, rows_to_indptr, sort_coo


def dense_to_csr(d: torch.Tensor):
    """Dense [m, n] -> (indptr, indices, data, nnz)."""
    m, n = d.shape
    flat = torch.nonzero(d.reshape(-1) != 0).squeeze(1)
    nnz = int(flat.shape[0])
    idt = index_dtype_for(d.shape, nnz)
    flat = flat.to(idt)
    rows = flat // n
    cols = flat % n
    data = d.reshape(-1)[flat]
    indptr = rows_to_indptr(rows, m, dtype=idt)
    return indptr, cols, data, nnz


def csr_to_dense(indptr, indices, data, shape):
    return coo_to_dense(expand_rows(indptr, data.shape[0]), indices, data, shape)


def coo_to_dense(rows, cols, vals, shape):
    """Dense [m, n] of COO triples, duplicates summed: one stable (row,
    col) sort, the runs summed in order (``dedup_sorted``), then each
    entry written once, so a repeated call gives the same bits."""
    out = torch.zeros(tuple(shape), dtype=vals.dtype, device=vals.device)
    if vals.shape[0] == 0:
        return out
    urows, ucols, uvals, _ = dedup_sorted(*sort_coo(rows, cols, vals, shape))
    out[urows.long(), ucols.long()] = uvals
    return out


def coo_to_csr(rows, cols, vals, shape):
    """COO -> CSR: one (row, col) sort, then duplicates summed."""
    m = int(shape[0])
    srows, scols, svals = sort_coo(rows, cols, vals, shape, by="row")
    urows, ucols, uvals, _ = dedup_sorted(srows, scols, svals)
    idt = index_dtype_for(shape, uvals.shape[0])
    indptr = rows_to_indptr(urows, m, dtype=idt)
    return indptr, ucols.to(idt), uvals


def coo_to_csc(rows, cols, vals, shape):
    return coo_to_csr(cols, rows, vals, (shape[1], shape[0]))


def csr_to_coo(indptr, indices, data, shape):
    return expand_rows(indptr, data.shape[0]), indices, data


def csr_to_csc(indptr, indices, data, shape):
    """CSR -> CSC via a stable (col, row) sort."""
    nnz = data.shape[0]
    m, n = int(shape[0]), int(shape[1])
    rows = expand_rows(indptr, nnz)
    order = lexsort_rc(indices, rows, (n, m))
    idt = index_dtype_for(shape, nnz)
    col_indptr = rows_to_indptr(indices[order], n, dtype=idt)
    return col_indptr, rows[order].to(idt), data[order]


def csr_to_ell(indptr, indices, data, m: int, k: int):
    """Padded-row (ELL) layout: [m, k] index/value planes; padding slots
    point at column 0 with value 0."""
    nnz = data.shape[0]
    idt = indices.dtype
    ell_idx = torch.zeros((m, k), dtype=idt, device=data.device)
    ell_val = torch.zeros((m, k), dtype=data.dtype, device=data.device)
    if nnz == 0:
        return ell_idx, ell_val
    rows = expand_rows(indptr, nnz)
    slot = torch.arange(nnz, dtype=idt, device=data.device) - indptr[rows].to(idt)
    ell_idx[rows, slot] = indices
    ell_val[rows, slot] = data
    return ell_idx, ell_val
