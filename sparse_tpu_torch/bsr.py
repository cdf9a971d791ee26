"""BSR (block sparse row) format (``sparse_tpu/bsr.py``).

``indptr`` [Mb + 1], ``indices`` [nnzb] block-column ids and ``data``
[nnzb, R, C] dense blocks, all on the array's device. Stored zeros inside
blocks are kept (scipy semantics): ``nnz`` counts stored values,
``count_nonzero`` the true nonzeros. A product gathers the x blocks of the
stored blocks, multiplies each block by its x block, and sums each block
row in order (``ops.coords.segment_sum``), so a repeated product gives the
same bits on the card.
"""

from __future__ import annotations

import torch

from .base import SparseArray
from .ops.coords import counts_to_indptr, expand_rows, lexsort_rc, segment_sum
from .utils import as_tensor, host_array, host_int


class bsr_array(SparseArray):
    format = "bsr"

    def __init__(self, arg1, shape=None, dtype=None, blocksize=None, device=None):
        if isinstance(arg1, tuple) and len(arg1) == 3:
            from .module import _torch_dtype

            data, indices, indptr = arg1
            data = as_tensor(data, device, None if dtype is None else _torch_dtype(dtype))
            if data.ndim != 3:
                raise ValueError("bsr data must be [nnzb, R, C]")
            if blocksize is not None and tuple(map(int, blocksize)) != tuple(data.shape[1:]):
                raise ValueError(f"blocksize {tuple(blocksize)} does not match data blocks "
                                 f"{tuple(data.shape[1:])}")
            self.data = data
            self.indices = as_tensor(indices, data.device)
            self.indptr = as_tensor(indptr, data.device)
            R, C = int(data.shape[1]), int(data.shape[2])
            if shape is None:
                nb = host_int(self.indices.max()) + 1 if data.shape[0] else 1
                shape = ((self.indptr.shape[0] - 1) * R, nb * C)
            self._shape = tuple(int(s) for s in shape)
            if self._shape[0] % R or self._shape[1] % C:
                raise ValueError(f"shape {self._shape} not divisible by blocksize {(R, C)}")
            return
        if isinstance(arg1, SparseArray):
            src = arg1.tocsr()
        else:
            from .csr import csr_array

            src = csr_array(arg1, device=device)
        B = src.tobsr(blocksize=blocksize)
        self.data, self.indices, self.indptr, self._shape = B.data, B.indices, B.indptr, B.shape

    @property
    def blocksize(self):
        return (int(self.data.shape[1]), int(self.data.shape[2]))

    @property
    def nnz(self) -> int:
        return int(self.data.numel())

    def _data_array(self):
        return self.data

    def _with_data(self, data):
        return bsr_array((data, self.indices, self.indptr), shape=self.shape)

    def _block_rows(self):
        return expand_rows(self.indptr, int(self.data.shape[0])).to(torch.int64)

    # -- conversions --------------------------------------------------------
    def tocoo(self):
        """Entrywise COO on the array's device, stored zeros dropped."""
        from .coo import coo_array

        R, C = self.blocksize
        brow, bcol = self._block_rows(), self.indices.to(torch.int64)
        dev = self.data.device
        rows = (brow[:, None, None] * R
                + torch.arange(R, device=dev)[None, :, None]).expand(-1, R, C).reshape(-1)
        cols = (bcol[:, None, None] * C
                + torch.arange(C, device=dev)[None, None, :]).expand(-1, R, C).reshape(-1)
        vals = self.data.reshape(-1)
        keep = vals != 0
        return coo_array((vals[keep], (rows[keep], cols[keep])), shape=self.shape)

    def tocsr(self):
        return self.tocoo().tocsr()

    def tocsc(self):
        return self.tocoo().tocsc()

    def todia(self):
        return self.tocoo().todia()

    def tobsr(self, blocksize=None):
        if blocksize is None or tuple(blocksize) == self.blocksize:
            return self
        return self.tocsr().tobsr(blocksize=blocksize)

    def toarray(self):
        """Host numpy, as the reference returns (duplicate blocks summed
        in order by the COO conversion)."""
        return host_array(self.tocoo().toarray())

    def transpose(self):
        R, C = self.blocksize
        brow, bcol = self._block_rows(), self.indices.to(torch.int64)
        Mb, Nb = self.shape[0] // R, self.shape[1] // C
        order = lexsort_rc(bcol, brow, (Nb, Mb))
        indptr = counts_to_indptr(torch.bincount(bcol, minlength=Nb), torch.int64)
        return bsr_array((self.data[order].transpose(1, 2), brow[order], indptr),
                         shape=(self.shape[1], self.shape[0]))

    @property
    def T(self):
        return self.transpose()

    # -- products -----------------------------------------------------------
    def _product(self, X):
        """A @ X for X [n] or [n, k] of the result dtype: each stored block
        times its gathered x block, then in-order sums over block rows."""
        R, C = self.blocksize
        m, n = self.shape
        tail = tuple(X.shape[1:])
        if self.data.shape[0] == 0:
            return torch.zeros((m, *tail), dtype=X.dtype, device=X.device)
        gath = X.reshape(n // C, C, *tail)[self.indices.to(torch.int64)]
        data = self.data.to(X.dtype)
        if tail:
            prod = torch.einsum("brc,bck->brk", data, gath)
        else:
            prod = (data * gath[:, None, :]).sum(-1)
        return segment_sum(prod, self.indptr.to(torch.int64)).reshape(m, *tail)

    def dot(self, other):
        if isinstance(other, SparseArray):
            return self.tocsr() @ other
        x = as_tensor(other, self.data.device)
        if x.ndim not in (1, 2):
            raise ValueError("bsr dot expects a vector or matrix")
        if x.shape[0] != self.shape[1]:
            raise ValueError(f"dimension mismatch: {self.shape} @ {tuple(x.shape)}")
        return self._product(x.to(torch.promote_types(self.dtype, x.dtype)))

    def __add__(self, other):
        other = other.tocsr() if isinstance(other, bsr_array) else other
        return self.tocsr() + other

    def multiply(self, other):
        other = other.tocsr() if isinstance(other, bsr_array) else other
        return self.tocsr().multiply(other)

    def sum(self, axis=None):
        return self.tocsr().sum(axis=axis)

    def __repr__(self):
        return (f"<{self.shape[0]}x{self.shape[1]} BSR array, blocksize={self.blocksize}, "
                f"nnzb={int(self.data.shape[0])}, dtype={self.dtype}>")

    __str__ = __repr__
