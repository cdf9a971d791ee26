"""DOK (dictionary-of-keys) format (``sparse_tpu/dok.py``): a host staging
format, a ``{(i, j): value}`` dict with numpy values and O(1) edits, whose
``tocoo``/``tocsr`` make the one upload to ``settings.device``. No math
runs in DOK itself: it converts to CSR, as scipy's DOK does."""

from __future__ import annotations

import numpy as np

from .base import HostStagingArray, SparseArray
from .utils import host_array


class dok_array(HostStagingArray):
    format = "dok"

    def __init__(self, arg1, shape=None, dtype=None):
        if isinstance(arg1, tuple) and len(arg1) == 2 and all(
            isinstance(s, (int, np.integer)) for s in arg1
        ):
            self._shape = (int(arg1[0]), int(arg1[1]))
            self._dtype = np.dtype(dtype or np.float64)
            self._d = {}
            return
        if isinstance(arg1, SparseArray):
            # canonical COO: a raw COO may hold duplicates, which the dict
            # would last-write instead of summing
            coo = arg1._canonical_coo()
            rows, cols, vals = (host_array(a) for a in (coo.row, coo.col, coo.data))
            self._shape = coo.shape
        else:
            dense = host_array(arg1)
            if dense.ndim != 2:
                raise ValueError("dok_array expects a 2-D input")
            rows, cols = np.nonzero(dense)
            vals = dense[rows, cols]
            self._shape = dense.shape
        if shape is not None:
            shape = tuple(int(s) for s in shape)
            if rows.size and (int(rows.max()) >= shape[0] or int(cols.max()) >= shape[1]):
                raise ValueError(f"shape {shape} cannot hold entries of shape {self._shape}")
            self._shape = shape
        self._dtype = np.dtype(dtype or vals.dtype)
        self._d = {(int(r), int(c)): self.dtype.type(v)
                   for r, c, v in zip(rows, cols, vals) if v != 0}

    # -- dict-like surface -------------------------------------------------
    @property
    def nnz(self) -> int:
        return len(self._d)

    def __len__(self):
        return len(self._d)

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def items(self):
        return self._d.items()

    def __iter__(self):
        return iter(self._d)

    def __contains__(self, key):
        return key in self._d

    def get(self, key, default=0.0):
        return self._d.get((int(key[0]), int(key[1])), default)

    def _check_key(self, key):
        if not (isinstance(key, tuple) and len(key) == 2):
            raise IndexError("dok indices must be (row, col) pairs")
        i, j = int(key[0]), int(key[1])
        m, n = self.shape
        i += m if i < 0 else 0
        j += n if j < 0 else 0
        if not (0 <= i < m and 0 <= j < n):
            raise IndexError(f"index {key} out of range for shape {self.shape}")
        return i, j

    def __getitem__(self, key):
        return self._d.get(self._check_key(key), self.dtype.type(0))

    def __setitem__(self, key, value):
        k = self._check_key(key)
        if value == 0:
            self._d.pop(k, None)
        else:
            self._d[k] = self.dtype.type(value)

    def __delitem__(self, key):
        del self._d[self._check_key(key)]

    # -- conversions --------------------------------------------------------
    def tocoo(self):
        from .coo import coo_array

        if self._d:
            ks = np.array(list(self._d.keys()), dtype=np.int64)
            vs = np.fromiter(self._d.values(), dtype=self.dtype, count=len(self._d))
            rows, cols = ks[:, 0], ks[:, 1]
        else:
            rows = cols = np.zeros(0, dtype=np.int64)
            vs = np.zeros(0, dtype=self.dtype)
        return coo_array((vs, (rows, cols)), shape=self.shape)

    def tocsr(self):
        return self.tocoo().tocsr()

    def todok(self):
        return self

    def toarray(self):
        out = np.zeros(self.shape, dtype=self.dtype)
        for (i, j), v in self._d.items():
            out[i, j] = v
        return out

    def copy(self):
        new = dok_array(self.shape, dtype=self.dtype)
        new._d = dict(self._d)
        return new

    def _data_array(self):
        return np.fromiter(self._d.values(), dtype=self.dtype, count=len(self._d))

    def _with_data(self, data):
        data = np.asarray(data)
        new = dok_array(self.shape, dtype=data.dtype)
        new._d = {k: data.dtype.type(v) for k, v in zip(self._d.keys(), data)}
        return new

    def transpose(self):
        new = dok_array((self.shape[1], self.shape[0]), dtype=self.dtype)
        new._d = {(j, i): v for (i, j), v in self._d.items()}
        return new
