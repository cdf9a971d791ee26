"""LIL (list-of-lists) format (``sparse_tpu/lil.py``): a host staging
format of per-row sorted column and value lists with cheap row edits,
scipy's format for building row by row, converted once (``tocsr``) to
``settings.device`` for compute."""

from __future__ import annotations

import bisect

import numpy as np

from .base import HostStagingArray, SparseArray
from .utils import host_array


class lil_array(HostStagingArray):
    format = "lil"

    def __init__(self, arg1, shape=None, dtype=None):
        if isinstance(arg1, tuple) and len(arg1) == 2 and all(
            isinstance(s, (int, np.integer)) for s in arg1
        ):
            self._shape = (int(arg1[0]), int(arg1[1]))
            self._dtype = np.dtype(dtype or np.float64)
            self.rows = [[] for _ in range(self.shape[0])]
            self.data = [[] for _ in range(self.shape[0])]
            return
        if isinstance(arg1, SparseArray):
            C = arg1.tocsr()
            indptr, indices, vals = (host_array(a) for a in (C.indptr, C.indices, C.data))
            self._shape = C.shape
        else:
            dense = host_array(arg1)
            if dense.ndim != 2:
                raise ValueError("lil_array expects a 2-D input")
            self._shape = dense.shape
            r, indices = np.nonzero(dense)
            vals = dense[r, indices]
            indptr = np.searchsorted(r, np.arange(self.shape[0] + 1))
        old_m = self._shape[0]
        if shape is not None:
            shape = tuple(int(s) for s in shape)
            if old_m > shape[0] or (len(indices) and int(np.max(indices)) >= shape[1]):
                raise ValueError(f"shape {shape} cannot hold entries of shape {self._shape}")
            self._shape = shape
        self._dtype = np.dtype(dtype or vals.dtype)
        self.rows = [list(map(int, indices[indptr[i]:indptr[i + 1]])) if i < old_m else []
                     for i in range(self.shape[0])]
        self.data = [[self.dtype.type(v) for v in vals[indptr[i]:indptr[i + 1]]] if i < old_m
                     else [] for i in range(self.shape[0])]

    @property
    def nnz(self) -> int:
        return sum(len(r) for r in self.rows)

    def _check(self, i, axis):
        ext = self.shape[axis]
        i = int(i)
        i += ext if i < 0 else 0
        if not 0 <= i < ext:
            raise IndexError(f"index {i} out of range for axis {axis}")
        return i

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 2:
            i, j = self._check(key[0], 0), self._check(key[1], 1)
            pos = bisect.bisect_left(self.rows[i], j)
            if pos < len(self.rows[i]) and self.rows[i][pos] == j:
                return self.data[i][pos]
            return self.dtype.type(0)
        # a whole row reads as a dense 1-D vector (scipy returns a sparse row)
        i = self._check(key, 0)
        out = np.zeros(self.shape[1], dtype=self.dtype)
        out[self.rows[i]] = self.data[i]
        return out

    def __setitem__(self, key, value):
        if isinstance(key, tuple) and len(key) == 2:
            i, j = self._check(key[0], 0), self._check(key[1], 1)
            pos = bisect.bisect_left(self.rows[i], j)
            present = pos < len(self.rows[i]) and self.rows[i][pos] == j
            if value == 0:
                if present:
                    del self.rows[i][pos]
                    del self.data[i][pos]
            elif present:
                self.data[i][pos] = self.dtype.type(value)
            else:
                self.rows[i].insert(pos, j)
                self.data[i].insert(pos, self.dtype.type(value))
            return
        # whole-row assignment from a dense vector
        i = self._check(key, 0)
        row = host_array(value)
        if row.shape != (self.shape[1],):
            raise ValueError(f"row assignment expects shape ({self.shape[1]},), got {row.shape}")
        nz = np.nonzero(row)[0]
        self.rows[i] = list(map(int, nz))
        self.data[i] = [self.dtype.type(v) for v in row[nz]]

    # -- conversions --------------------------------------------------------
    def tocsr(self):
        from .csr import csr_array

        indptr = np.zeros(self.shape[0] + 1, dtype=np.int64)
        np.cumsum([len(r) for r in self.rows], out=indptr[1:])
        indices = np.array([j for r in self.rows for j in r], dtype=np.int64)
        return csr_array((self._data_array(), indices, indptr), shape=self.shape)

    def tocoo(self):
        return self.tocsr().tocoo()

    def tolil(self):
        return self

    def toarray(self):
        out = np.zeros(self.shape, dtype=self.dtype)
        for i, (r, d) in enumerate(zip(self.rows, self.data)):
            out[i, r] = d
        return out

    def copy(self):
        new = lil_array(self.shape, dtype=self.dtype)
        new.rows = [list(r) for r in self.rows]
        new.data = [list(d) for d in self.data]
        return new

    def _data_array(self):
        return np.array([v for d in self.data for v in d], dtype=self.dtype)

    def _with_data(self, data):
        data = np.asarray(data)
        new = lil_array(self.shape, dtype=data.dtype)
        new.rows = [list(r) for r in self.rows]
        it = iter(data)
        new.data = [[data.dtype.type(next(it)) for _ in d] for d in self.data]
        return new

    def transpose(self):
        return self.tocsr().T.tolil()
