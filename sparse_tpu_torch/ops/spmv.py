"""CSR/CSC SpMV and SpMM in plain torch (``sparse_tpu/ops/spmv.py``).

Segment path: per-nnz products reduced by row with ``index_add_``; ELL
path: one gather per padded-row plane plus adds. Neither is a TPU kernel
in the reference (both are XLA gathers there), so both stay plain torch.
"""

from __future__ import annotations

import torch

from .coords import expand_rows


def _result_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return torch.promote_types(a.dtype, b.dtype)


def csr_spmv_segment(indptr, indices, data, x, m: int):
    """y = A @ x via gather + segment sum. General path, any row profile."""
    nnz = data.shape[0]
    out_dt = _result_dtype(data, x)
    y = torch.zeros((m,), dtype=out_dt, device=x.device)
    if nnz == 0:
        return y
    rows = expand_rows(indptr, nnz)
    prod = data.to(out_dt) * x[indices].to(out_dt)
    return y.index_add_(0, rows, prod)


def csr_spmv_ell(ell_indices, ell_data, x):
    """y = A @ x on the padded-row (ELL) layout: k 1-D gathers + adds."""
    k = ell_data.shape[1]
    acc = ell_data[:, 0] * x[ell_indices[:, 0]]
    for kk in range(1, k):
        acc = acc + ell_data[:, kk] * x[ell_indices[:, kk]]
    return acc


def csr_spmm_segment(indptr, indices, data, B, m: int):
    """C = A @ B with B dense [k, n]."""
    nnz = data.shape[0]
    out_dt = _result_dtype(data, B)
    C = torch.zeros((m, B.shape[1]), dtype=out_dt, device=B.device)
    if nnz == 0:
        return C
    rows = expand_rows(indptr, nnz)
    prod = data.to(out_dt)[:, None] * B[indices].to(out_dt)
    return C.index_add_(0, rows, prod)


def csr_spmm_ell(ell_indices, ell_data, B):
    """C = A @ B on the ELL layout: k row-gathers of B + accumulate."""
    k = ell_data.shape[1]
    acc = ell_data[:, 0, None] * B[ell_indices[:, 0]]
    for kk in range(1, k):
        acc = acc + ell_data[:, kk, None] * B[ell_indices[:, kk]]
    return acc


def csc_spmv(indptr, indices, data, x, m: int):
    """y = A @ x with A in CSC: gather x by column, scatter-add to rows."""
    nnz = data.shape[0]
    out_dt = _result_dtype(data, x)
    y = torch.zeros((m,), dtype=out_dt, device=x.device)
    if nnz == 0:
        return y
    cols = expand_rows(indptr, nnz)  # compressed axis of CSC = columns
    return y.index_add_(0, indices, data.to(out_dt) * x[cols].to(out_dt))
