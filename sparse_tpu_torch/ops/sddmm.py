"""SDDMM: sampled dense-dense matmul, out = A_vals * (C @ D) at A's
sparsity (``sparse_tpu/ops/sddmm.py``).

Each nonzero gathers its row of C and its column of D and contracts
them; the gathers run in chunks of nonzeros so that the ``[nnz, k]``
intermediates stay bounded at any nnz.
"""

from __future__ import annotations

import torch

from .coords import expand_rows

#: nonzeros whose ``[chunk, k]`` gathers are live at once
CHUNK = 1 << 24


def _sddmm(lines, others, data, C_rows, D_cols):
    """vals[e] = data[e] * dot(C_rows[lines[e]], D_cols[others[e]])."""
    nnz = data.shape[0]
    dt = torch.promote_types(torch.promote_types(data.dtype, C_rows.dtype), D_cols.dtype)
    out = torch.empty((nnz,), dtype=dt, device=data.device)
    C_rows, D_cols = C_rows.to(dt).contiguous(), D_cols.to(dt).contiguous()
    for lo in range(0, nnz, CHUNK):
        hi = min(lo + CHUNK, nnz)
        inner = (C_rows[lines[lo:hi]] * D_cols[others[lo:hi]]).sum(dim=1)
        torch.mul(data[lo:hi].to(dt), inner, out=out[lo:hi])
    return out


def csr_sddmm(indptr, indices, data, C, D):
    """vals_out[e] = data[e] * dot(C[row_e, :], D[:, col_e])."""
    if data.shape[0] == 0:
        return data
    return _sddmm(expand_rows(indptr, data.shape[0]), indices, data, C, D.T)


def csc_sddmm(indptr, indices, data, C, D):
    """CSC variant: the compressed axis is columns, the indices rows."""
    if data.shape[0] == 0:
        return data
    return _sddmm(indices, expand_rows(indptr, data.shape[0]), data, C, D.T)
