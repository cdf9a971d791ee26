"""CSC sparse array (``sparse_tpu/csc.py``): the CSR encoding of the
transpose, so transposition is a zero-copy reinterpretation.

Products run on the array's CSR form, built once and plan-cached on the
CSC object: they then take CSR's row-wise paths (DIA, SELL, ELL, segment)
and their kernels, which sum each row in a fixed order. The reference's
column-split product (scatter-add by row) would add with atomics on the
card, in an order that changes from run to run."""

from __future__ import annotations

import numpy as np
import torch

from . import plan_cache
from .base import SparseArray
from .ops import conv
from .ops.coords import expand_rows
from .ops.elementwise import csr_diagonal, csr_sum
from .ops.sddmm import csc_sddmm
from .utils import as_tensor, host_int, resolve_device


class csc_array(SparseArray):
    format = "csc"

    def __init__(self, arg, shape=None, dtype=None, device=None):
        from .coo import coo_array

        if isinstance(arg, SparseArray):
            c = arg.tocsc()
            data, indices, indptr, shape = c.data, c.indices, c.indptr, c.shape
        elif isinstance(arg, tuple) and len(arg) == 3:
            data, indices, indptr = (as_tensor(a, device) for a in arg)
            if shape is None:
                nrows = host_int(indices.max()) + 1 if indices.shape[0] else 0
                shape = (nrows, indptr.shape[0] - 1)
        elif isinstance(arg, tuple) and len(arg) == 2 and isinstance(arg[1], tuple):
            c = coo_array(arg, shape=shape, device=device).tocsc()
            data, indices, indptr, shape = c.data, c.indices, c.indptr, c.shape
        elif isinstance(arg, tuple) and len(arg) == 2:
            shape = (int(arg[0]), int(arg[1]))
            dev = resolve_device(device)
            indptr = torch.zeros((shape[1] + 1,), dtype=torch.int32, device=dev)
            indices = torch.zeros((0,), dtype=torch.int32, device=dev)
            data = torch.zeros((0,), dtype=dtype or torch.float32, device=dev)
        elif hasattr(arg, "tocsc"):  # scipy
            s = arg.tocsc()
            data, indices, indptr = (as_tensor(a, device) for a in (s.data, s.indices, s.indptr))
            shape = s.shape
        else:  # dense
            d = as_tensor(arg, device)
            if d.ndim != 2:
                raise ValueError("CSC arrays must be 2-D")
            indptr, indices, data, _ = conv.dense_to_csr(d.T)
            shape = d.shape
        if dtype is not None:
            data = data.to(dtype)
        dev = resolve_device(device) if device is not None else data.device
        self.data, self.indices, self.indptr = data.to(dev), indices.to(dev), indptr.to(dev)
        self._shape = (int(shape[0]), int(shape[1]))

    @classmethod
    def from_parts(cls, data, indices, indptr, shape):
        obj = object.__new__(cls)
        obj.data, obj.indices, obj.indptr = data, indices, indptr
        obj._shape = (int(shape[0]), int(shape[1]))
        return obj

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def _data_array(self):
        return self.data

    def _with_data(self, data):
        return csc_array.from_parts(data, self.indices, self.indptr, self.shape)

    def dot(self, other):
        """A @ x through the plan-cached CSR form (row-wise, fixed order)."""
        if isinstance(other, SparseArray):
            return self.tocsr().dot(other)
        return plan_cache.get(self, "csr", self.tocsr).dot(other)

    def matvec(self, x):
        return self.dot(x)

    def _rdot(self, other):
        """B @ A = (A^T B^T)^T on A^T, the CSR that shares these buffers
        (plan-cached; its row-wise products sum in a fixed order)."""
        B = as_tensor(other, self.device)
        At = plan_cache.get(self, "transpose", self.transpose)
        return At.dot(B) if B.ndim == 1 else At.dot(B.T).T

    def sddmm(self, C, D):
        vals = csc_sddmm(self.indptr, self.indices, self.data, as_tensor(C, self.device),
                         as_tensor(D, self.device))
        return self._with_data(vals)

    # -- elementwise / reductions ------------------------------------------
    def __add__(self, other):
        if isinstance(other, SparseArray):
            return (self.tocsr() + other).tocsc()
        return self.tocsr() + other  # a scalar raises there, a dense operand densifies

    def __mul__(self, other):
        if np.isscalar(other) or getattr(other, "ndim", 1) == 0:
            return self._with_data(self.data * other)
        return self.tocsr().multiply(other).tocsc()

    def multiply(self, other):
        return self.__mul__(other)

    def sum(self, axis=None):
        """CSC of A is CSR of A^T: the axis flips."""
        if axis is None:
            return self.data.sum()
        flip = {0: 1, -2: 1, 1: 0, -1: 0}[axis]
        return csr_sum(self.indptr, self.indices, self.data, (self.shape[1], self.shape[0]),
                       axis=flip)

    def diagonal(self, k=0):
        return csr_diagonal(self.indptr, self.indices, self.data, (self.shape[1], self.shape[0]),
                            k=-k)

    def tocsc(self):
        return self

    def tocsr(self):
        from .csr import csr_array

        indptr, indices, data = conv.csr_to_csc(
            self.indptr, self.indices, self.data, (self.shape[1], self.shape[0])
        )
        return csr_array.from_parts(data, indices, indptr, self.shape)

    def tocoo(self):
        from .coo import coo_array

        cols = expand_rows(self.indptr, self.nnz)
        out = coo_array((self.data, (self.indices, cols)), shape=self.shape)
        out._duplicate_free = True  # column-major order, not canonical
        return out

    def todia(self):
        from .dia import dia_array

        return dia_array(self.tocoo())

    def toarray(self):
        return conv.csr_to_dense(
            self.indptr, self.indices, self.data, (self.shape[1], self.shape[0])
        ).T

    def transpose(self, axes=None):
        if axes is not None:
            raise ValueError("transpose with axes != None is unsupported")
        from .csr import csr_array

        return csr_array.from_parts(
            self.data, self.indices, self.indptr, (self.shape[1], self.shape[0])
        )

    @property
    def T(self):
        return self.transpose()

    def __str__(self):
        return (
            f"<{self.shape[0]}x{self.shape[1]} CSC array, nnz={self.nnz},"
            f" dtype={self.dtype}, device={self.device}>"
        )

    __repr__ = __str__
