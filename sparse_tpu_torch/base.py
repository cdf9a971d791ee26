"""Shared sparse-array machinery (``sparse_tpu/base.py``'s main-path subset)."""

from __future__ import annotations

import numpy as np
import torch

from .utils import host_int


class SparseArray:
    """Common surface of the formats (scipy.sparse.sparray analog)."""

    ndim = 2
    # make numpy defer binary ops (x @ A, x * A) to our reflected methods
    __array_ufunc__ = None
    __array_priority__ = 100.0

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self) -> torch.dtype:
        return self._data_array().dtype

    @property
    def device(self) -> torch.device:
        return self._data_array().device

    @property
    def nnz(self) -> int:
        raise NotImplementedError

    def getnnz(self) -> int:
        return self.nnz

    def _data_array(self) -> torch.Tensor:
        raise NotImplementedError

    def asformat(self, format: str):
        """Convert to the named format ('csr', 'csc', 'coo', 'dia', 'dense')."""
        if format is None or format == self.format:
            return self
        conv = getattr(self, "to" + format, None)
        if conv is None:
            raise ValueError(f"Format {format} is unknown.")
        return conv()

    def todense(self):
        return self.toarray()

    def __neg__(self):
        return self._with_data(-self._data_array())

    def __abs__(self):
        return self._with_data(self._data_array().abs())

    def astype(self, dtype):
        return self._with_data(self._data_array().to(dtype))

    def copy(self):
        return self._with_data(self._data_array().clone())

    def __truediv__(self, other):
        if np.isscalar(other) or getattr(other, "ndim", 1) == 0:
            return self._with_data(self._data_array() / other)
        return NotImplemented

    def __mul__(self, other):
        if np.isscalar(other) or getattr(other, "ndim", 1) == 0:
            return self._with_data(self._data_array() * other)
        return NotImplemented

    def __rmul__(self, other):
        return self.__mul__(other)

    def __matmul__(self, other):
        return self.dot(other)

    # constructions sort and deduplicate (COO overrides)
    has_sorted_indices = True
    has_canonical_format = True


def resolve_shape(shape, rows, cols):
    if shape is not None:
        return (int(shape[0]), int(shape[1]))
    if rows.shape[0] == 0:
        return (0, 0)
    return (host_int(rows.max()) + 1, host_int(cols.max()) + 1)
