"""COO sparse array (``sparse_tpu/coo.py``): conversion to CSR/CSC is one
stable key sort on the device (``ops.coords.sort_coo``)."""

from __future__ import annotations

import numpy as np
import torch

from .base import SparseArray, resolve_shape
from .ops import conv
from .ops.coords import dedup_sorted, expand_rows, sort_coo
from .types import index_dtype_for
from .utils import as_tensor, resolve_device


class coo_array(SparseArray):
    format = "coo"
    # raw COO may hold unsorted / duplicate triples until converted
    has_sorted_indices = False
    has_canonical_format = False

    def __init__(self, arg, shape=None, dtype=None, device=None):
        if isinstance(arg, SparseArray):
            c = arg.tocoo()
            row, col, data, shape = c.row, c.col, c.data, c.shape
            device = c.device if device is None else device
        elif isinstance(arg, tuple) and len(arg) == 2 and isinstance(arg[1], tuple):
            data, (row, col) = arg
            data = as_tensor(data, device)
            row, col = as_tensor(row, device), as_tensor(col, device)
            shape = resolve_shape(shape, row, col)
        elif isinstance(arg, tuple) and len(arg) == 2 and all(
            isinstance(s, (int, np.integer)) for s in arg
        ):
            shape = (int(arg[0]), int(arg[1]))
            dev = resolve_device(device)
            row = col = torch.zeros((0,), dtype=torch.int32, device=dev)
            data = torch.zeros((0,), dtype=dtype or torch.float32, device=dev)
        elif hasattr(arg, "tocoo"):  # scipy sparse
            c = arg.tocoo()
            row, col = as_tensor(c.row, device), as_tensor(c.col, device)
            data, shape = as_tensor(c.data, device), c.shape
        else:  # dense
            d = as_tensor(arg, device)
            if d.ndim != 2:
                raise ValueError("COO arrays must be 2-D")
            indptr, col, data, _ = conv.dense_to_csr(d)
            row, shape = expand_rows(indptr, data.shape[0]), d.shape
        dev = resolve_device(device) if device is not None else data.device
        if dtype is not None:
            data = data.to(dtype)
        idt = index_dtype_for(shape, data.shape[0])
        self.row = row.to(device=dev, dtype=idt)
        self.col = col.to(device=dev, dtype=idt)
        self.data = data.to(dev)
        self._shape = (int(shape[0]), int(shape[1]))

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def _data_array(self):
        return self.data

    def _with_data(self, data):
        return coo_array((data, (self.row, self.col)), shape=self.shape)

    def tocoo(self):
        return self

    def sum_duplicates(self):
        """Canonicalize in place: lex-sort, sum duplicate (row, col) pairs."""
        srows, scols, svals = sort_coo(self.row, self.col, self.data, self.shape)
        self.row, self.col, self.data, _ = dedup_sorted(srows, scols, svals)
        self.has_sorted_indices = True
        self.has_canonical_format = True

    def tocsr(self):
        from .csr import csr_array

        indptr, indices, data = conv.coo_to_csr(self.row, self.col, self.data, self.shape)
        return csr_array.from_parts(data, indices, indptr, self.shape)

    def tocsc(self):
        from .csc import csc_array

        indptr, indices, data = conv.coo_to_csc(self.row, self.col, self.data, self.shape)
        return csc_array.from_parts(data, indices, indptr, self.shape)

    def todia(self):
        from .dia import dia_array

        return dia_array(self)

    def toarray(self):
        return conv.coo_to_dense(self.row, self.col, self.data, self.shape)

    def transpose(self, axes=None):
        if axes is not None:
            raise ValueError("transpose with axes != None is unsupported")
        return coo_array(
            (self.data, (self.col, self.row)), shape=(self.shape[1], self.shape[0])
        )

    @property
    def T(self):
        return self.transpose()

    def dot(self, other):
        return self.tocsr().dot(other)

    def _rdot(self, other):
        return self.tocsr()._rdot(other)

    def tensordot(self, other, axes=2):
        """np.tensordot for 2-D operands: one shared axis (a transposed
        product) or both axes (a full contraction to a scalar)."""
        ndim_b = getattr(other, "ndim", np.ndim(other))
        if isinstance(axes, (int, np.integer)):
            k = int(axes)
            a_axes, b_axes = tuple(range(self.ndim - k, self.ndim)), tuple(range(k))
        else:
            a_axes, b_axes = axes
            a_axes = (int(a_axes),) if isinstance(a_axes, (int, np.integer)) else a_axes
            b_axes = (int(b_axes),) if isinstance(b_axes, (int, np.integer)) else b_axes
            for ax, nd, side in (*((ax, self.ndim, "a") for ax in a_axes),
                                 *((ax, ndim_b, "b") for ax in b_axes)):
                if not -nd <= int(ax) < nd:
                    raise ValueError(f"axes value {ax} out of range for {side} (ndim {nd})")
            a_axes = tuple(int(ax) % self.ndim for ax in a_axes)
            b_axes = tuple(int(ax) % ndim_b for ax in b_axes)
        if len(a_axes) != len(b_axes):
            raise ValueError("axes lists must have the same length")

        def flipped(b):
            return b.transpose() if isinstance(b, SparseArray) else as_tensor(b, self.device).T

        if len(a_axes) == 1:
            a = self if a_axes[0] == self.ndim - 1 else self.transpose()
            b = flipped(other) if ndim_b == 2 and b_axes[0] == 1 else other
            return a.dot(b)
        if len(a_axes) == 2 and ndim_b == 2:
            # full contraction: sum_ij A[i, j] * B'[i, j]
            b = flipped(other) if a_axes[0] != b_axes[0] else other
            b = b.toarray() if isinstance(b, SparseArray) else as_tensor(b, self.device)
            if tuple(b.shape) != tuple(self.shape):
                raise ValueError(f"shape mismatch in tensordot: {self.shape} vs {tuple(b.shape)}")
            return self.multiply(b).sum()
        raise NotImplementedError(
            "tensordot on 2-D sparse arrays supports 1- or 2-axis contractions")

    def __add__(self, other):
        return self.tocsr() + other

    def __mul__(self, other):
        if np.isscalar(other) or getattr(other, "ndim", 1) == 0:
            return self._with_data(self.data * other)
        return self.tocsr() * other

    def multiply(self, other):
        return self.tocsr().multiply(other)

    def sum(self, axis=None):
        if axis is None:
            return self.data.sum()
        return self.tocsr().sum(axis=axis)

    def diagonal(self, k=0):
        return self.tocsr().diagonal(k=k)

    def __str__(self):
        return (
            f"<{self.shape[0]}x{self.shape[1]} COO array, nnz={self.nnz},"
            f" dtype={self.dtype}, device={self.device}>"
        )

    __repr__ = __str__
