"""DIA (diagonal) sparse array (``sparse_tpu/dia.py``).

Layout matches scipy: ``data[k, j]`` holds ``A[j - offsets[k], j]``
(column-indexed diagonals). Offsets stay on the host as a numpy int64
array: they are static structure, like the shape.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import SparseArray
from .config import settings
from .ops.coords import dedup_sorted, sort_coo
from .types import index_dtype_for
from .utils import as_tensor


class dia_array(SparseArray):
    format = "dia"

    def __init__(self, arg, shape=None, dtype=None, device=None):
        if isinstance(arg, tuple) and len(arg) == 2 and not np.isscalar(arg[0]):
            data, offsets = arg
            data = as_tensor(data, device)
            offsets = np.atleast_1d(np.asarray(offsets, dtype=np.int64))
            if shape is None:
                raise ValueError("dia_array((data, offsets)) requires shape=")
        elif isinstance(arg, SparseArray) or hasattr(arg, "tocoo"):
            from .coo import coo_array

            c = arg.tocoo() if isinstance(arg, SparseArray) else coo_array(arg, device=device)
            data, offsets, shape = _coo_to_dia(c)
        else:
            from .coo import coo_array

            data, offsets, shape = _coo_to_dia(coo_array(arg, device=device))
        if dtype is not None:
            data = data.to(dtype)
        self.data = data if device is None else as_tensor(data, device)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self._shape = (int(shape[0]), int(shape[1]))

    @property
    def nnz(self) -> int:
        """Count of stored entries that fall inside the matrix bounds."""
        m, n = self.shape
        L = self.data.shape[1]
        total = 0
        for off in self.offsets:
            total += max(0, int(min(n, m + off, L) - max(0, off)))
        return total

    def _data_array(self):
        return self.data

    def _with_data(self, data):
        return dia_array((data, self.offsets), shape=self.shape)

    def _offsets_tensor(self) -> torch.Tensor:
        return torch.as_tensor(self.offsets, device=self.device)

    # -- conversions -------------------------------------------------------
    def tocoo(self):
        from .coo import coo_array

        m, n = self.shape
        nd, L = self.data.shape
        cols = torch.arange(L, device=self.device)[None, :].expand(nd, L)
        rows = cols - self._offsets_tensor()[:, None]
        valid = (rows >= 0) & (rows < m) & (cols < n) & (self.data != 0)
        take = torch.nonzero(valid.reshape(-1)).squeeze(1)
        out = coo_array(
            (self.data.reshape(-1)[take], (rows.reshape(-1)[take], cols.reshape(-1)[take])),
            shape=self.shape,
        )
        out._duplicate_free = True  # one slot per (diagonal, column)
        return out

    def _direct_parts(self, by_row: bool):
        """Sort-free conversion to CSR (by_row) or CSC parts on the device.

        Within a row, entries at ascending offsets have ascending columns
        (col = row + offset); within a column, entries at descending
        offsets have ascending rows (row = col - offset). So both compressed
        forms fall out of a masked transpose, with no sort. Returns
        (indptr, indices, data).
        """
        m, n = self.shape
        dev = self.device
        nd, L = self.data.shape
        if by_row:
            order = np.argsort(self.offsets, kind="stable")
            lines = m
        else:
            order = np.argsort(-self.offsets, kind="stable")
            lines = n
        d = torch.as_tensor(self.offsets[order], device=dev)[:, None]
        line = torch.arange(lines, device=dev)[None, :]
        pos = line + d if by_row else line - d  # columns (CSR) / rows (CSC)
        src = pos if by_row else line.expand(nd, lines)  # data column index
        valid = (pos >= 0) & (pos < (n if by_row else m)) & (src < L)
        data = self.data[torch.as_tensor(order, device=dev)]
        gathered = torch.take_along_dim(data, src.clamp(0, max(L - 1, 0)), dim=1)
        valid &= gathered != 0
        validT = valid.T
        vals = gathered.T[validT]
        idt = index_dtype_for(self.shape, int(vals.shape[0]))
        indices = pos.T[validT].to(idt)
        indptr = torch.zeros((lines + 1,), dtype=idt, device=dev)
        indptr[1:] = torch.cumsum(valid.sum(dim=0), 0)
        return indptr, indices, vals

    def tocsr(self):
        from .csr import csr_array

        indptr, indices, vals = self._direct_parts(by_row=True)
        return csr_array.from_parts(vals, indices, indptr, self.shape)

    def tocsc(self):
        from .csc import csc_array

        indptr, indices, vals = self._direct_parts(by_row=False)
        return csc_array.from_parts(vals, indices, indptr, self.shape)

    def todia(self):
        return self

    def toarray(self):
        return self.tocoo().toarray()

    def transpose(self, axes=None):
        """offsets -> -offsets with a per-diagonal shift."""
        if axes is not None:
            raise ValueError("transpose with axes != None is unsupported")
        m, n = self.shape
        L = self.data.shape[1]
        Lt = max(m, L)
        # dataT[k, j] = data[k, j + offsets[k]] on the transposed shape (n, m)
        src = torch.arange(Lt, device=self.device)[None, :] + self._offsets_tensor()[:, None]
        ok = (src >= 0) & (src < L)
        gathered = torch.take_along_dim(self.data, src.clamp(0, max(L - 1, 0)), dim=1)
        dataT = torch.where(ok, gathered, torch.zeros((), dtype=self.data.dtype, device=self.device))
        return dia_array((dataT, -self.offsets), shape=(n, m))

    @property
    def T(self):
        return self.transpose()

    # -- arithmetic --------------------------------------------------------
    def dot(self, other):
        """SpMV stays in DIA (no gathers at all): the prepared kernel under
        spmv_mode 'auto'/'pallas', else the plain shifted adds. Everything
        else routes through CSR."""
        if not isinstance(other, SparseArray):
            x = as_tensor(other, self.device)
            # the DIA path needs scipy-width planes (data.shape[1] == n)
            if x.ndim == 1 and x.shape[0] == self.shape[1] == self.data.shape[1]:
                offs = tuple(int(o) for o in self.offsets)
                if settings.spmv_mode in ("auto", "pallas"):
                    from .kernels.dia_spmv import cached_prepared_spmv

                    y = cached_prepared_spmv(self, self.data, offs, self.shape, x)
                    if y is not None:  # None only on the CPU, past the reference's gates
                        return y
                from .ops.dia_spmv import dia_spmv_torch

                return dia_spmv_torch(self.data, offs, x, self.shape)
        return self.tocsr().dot(other)

    def _rdot(self, other):
        return self.tocsr()._rdot(other)

    def __add__(self, other):
        return self.tocsr() + other

    def __mul__(self, other):
        if np.isscalar(other) or getattr(other, "ndim", 1) == 0:
            return self._with_data(self.data * other)
        return self.tocsr().multiply(other)

    def multiply(self, other):
        return self.__mul__(other)

    def sum(self, axis=None):
        return self.tocsr().sum(axis=axis)

    def diagonal(self, k=0):
        """The plane of offset ``k`` read at its columns (zeros where the
        matrix stores no such diagonal)."""
        m, n = self.shape
        out_len = min(m + min(k, 0), n - max(k, 0))
        if out_len <= 0:
            return torch.zeros((0,), dtype=self.dtype, device=self.device)
        hits = np.nonzero(self.offsets == k)[0]
        if hits.size == 0:
            return torch.zeros((out_len,), dtype=self.dtype, device=self.device)
        lo = max(0, k)
        seg = self.data[int(hits[0]), lo: lo + out_len]
        return torch.nn.functional.pad(seg, (0, out_len - seg.shape[0]))

    def __str__(self):
        return (
            f"<{self.shape[0]}x{self.shape[1]} DIA array,"
            f" ndiags={self.data.shape[0]}, dtype={self.dtype}, device={self.device}>"
        )

    __repr__ = __str__


def _coo_to_dia(c):
    """COO -> (data, offsets, shape); duplicates summed in sorted order
    (``coords.dedup_sorted``), each plane slot written once. One host
    fetch of the distinct offsets."""
    m, n = c.shape
    offs_dev = c.col.to(torch.int64) - c.row.to(torch.int64)
    offsets = torch.unique(offs_dev)
    nd = int(offsets.shape[0])
    data = torch.zeros((max(nd, 1), n), dtype=c.data.dtype, device=c.data.device)
    if c.nnz:
        k = torch.searchsorted(offsets, offs_dev)
        uk, ucol, uval, _ = dedup_sorted(*sort_coo(k, c.col, c.data, (nd, n)))
        data[uk, ucol.long()] = uval
    offsets = offsets.cpu().numpy() if nd else np.zeros((1,), dtype=np.int64)
    return data, offsets, (m, n)
