"""Shared sparse-array machinery (``sparse_tpu/base.py``).

The formats' common surface: format dispatch, the zero-preserving data
ufuncs, the python numeric protocol, scipy's reductions (``ops.reduce``)
and the canonicalization and in-place edits (``setdiag``, ``resize``,
``eliminate_zeros``). Everything runs as torch ops on the array's
device; the in-place edits drop the array's cached plans
(``plan_cache.forget``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import hostsync, plan_cache
from .ops.coords import expand_rows
from .utils import host_array, host_int


class SparseArray:
    """Common surface of the formats (scipy.sparse.sparray analog)."""

    ndim = 2
    # make numpy defer binary ops (x @ A, x * A) to our reflected methods
    __array_ufunc__ = None
    __array_priority__ = 100.0
    # in-place edits so far (``_become``)
    _edits = 0

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

    def count_nonzero(self) -> int:
        return hostsync.fetch_int((self._data_array() != 0).sum())

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

    def todok(self):
        """Host dictionary-of-keys staging copy (``dok.dok_array``)."""
        from .dok import dok_array

        return dok_array(self)

    def tolil(self):
        """Host list-of-lists staging copy (``lil.lil_array``)."""
        from .lil import lil_array

        return lil_array(self)

    def tobsr(self, blocksize=None):
        """Block sparse row copy (``bsr.bsr_array``) of [R, C] dense blocks,
        built on the array's device. ``blocksize=None`` estimates the block
        structure as scipy does (the largest candidate whose fill
        efficiency clears 0.7; (1, 1) when there is none); the shape must
        divide by the chosen size."""
        from .bsr import bsr_array
        from .ops.coords import counts_to_indptr

        C = self.tocsr()
        m, n = C.shape
        rows = expand_rows(C.indptr, C.nnz).to(torch.int64)
        cols = C.indices.to(torch.int64)
        if blocksize is None:
            blocksize = _estimate_blocksize(rows, cols, (m, n))
        R, Cb = tuple(map(int, blocksize))
        if R < 1 or Cb < 1 or m % R or n % Cb:
            raise ValueError(f"blocksize {(R, Cb)} does not divide shape {(m, n)}")
        Nb = n // Cb
        ublocks, binv = torch.unique(rows // R * Nb + cols // Cb, return_inverse=True)
        data = torch.zeros((ublocks.shape[0], R, Cb), dtype=C.dtype, device=C.device)
        data[binv, rows % R, cols % Cb] = C.data
        counts = torch.bincount(ublocks // Nb, minlength=m // R)
        return bsr_array((data, ublocks % Nb, counts_to_indptr(counts, torch.int64)), shape=(m, n))

    # -- data ufuncs (zero-preserving) -------------------------------------
    def _map(self, fn):
        return self._with_data(fn(self._data_array()))

    def __neg__(self):
        return self._map(torch.neg)

    def __abs__(self):
        return self._map(torch.abs)

    def conjugate(self):
        return self._map(torch.conj_physical)

    conj = conjugate

    def power(self, n):
        return self._map(lambda d: d**n)

    def astype(self, dtype):
        from .module import _torch_dtype

        return self._map(lambda d: d.to(_torch_dtype(dtype)))

    def copy(self):
        return self._map(torch.clone)

    def sqrt(self):
        return self._map(torch.sqrt)

    def rint(self):
        return self._map(torch.round)  # half to even, like numpy

    def sign(self):
        return self._map(torch.sgn)

    def expm1(self):
        return self._map(torch.expm1)

    def log1p(self):
        return self._map(torch.log1p)

    def sin(self):
        return self._map(torch.sin)

    def sinh(self):
        return self._map(torch.sinh)

    def tan(self):
        return self._map(torch.tan)

    def tanh(self):
        return self._map(torch.tanh)

    def arcsin(self):
        return self._map(torch.asin)

    def arcsinh(self):
        return self._map(torch.asinh)

    def arctan(self):
        return self._map(torch.atan)

    def arctanh(self):
        return self._map(torch.atanh)

    def deg2rad(self):
        return self._map(torch.deg2rad)

    def rad2deg(self):
        return self._map(torch.rad2deg)

    def trunc(self):
        return self._map(torch.trunc)

    def ceil(self):
        return self._map(torch.ceil)

    def floor(self):
        return self._map(torch.floor)

    # -- python numeric protocol --------------------------------------------
    def __sub__(self, other):
        return self + (-other)

    def __rsub__(self, other):
        return (-self) + other

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

    def __rmatmul__(self, other):
        return self._rdot(other)

    def mean(self, axis=None):
        s = self.sum(axis=axis)
        m, n = self.shape
        if axis is None:
            return s / (m * n)
        return s / (m if axis in (0, -2) else n)

    # -- reductions (scipy semantics: implicit zeros participate); axis
    # reductions return dense 1-D tensors where scipy returns a sparse
    # 1-row matrix
    @staticmethod
    def _reject_out(out):
        if out is not None:
            raise ValueError("Sparse arrays do not support an 'out' parameter.")

    def max(self, axis=None, out=None):
        from .ops.reduce import min_or_max

        self._reject_out(out)
        return min_or_max(self, True, axis=axis)

    def min(self, axis=None, out=None):
        from .ops.reduce import min_or_max

        self._reject_out(out)
        return min_or_max(self, False, axis=axis)

    def nanmax(self, axis=None, out=None):
        from .ops.reduce import min_or_max

        self._reject_out(out)
        return min_or_max(self, True, axis=axis, nan=True)

    def nanmin(self, axis=None, out=None):
        from .ops.reduce import min_or_max

        self._reject_out(out)
        return min_or_max(self, False, axis=axis, nan=True)

    def argmax(self, axis=None, out=None):
        """First row-major position of the max (implicit zeros count)."""
        from .ops.reduce import arg_min_or_max

        self._reject_out(out)
        return arg_min_or_max(self, True, axis=axis)

    def argmin(self, axis=None, out=None):
        from .ops.reduce import arg_min_or_max

        self._reject_out(out)
        return arg_min_or_max(self, False, axis=axis)

    def trace(self, offset=0):
        """Sum of the ``offset`` diagonal."""
        return self.diagonal(k=offset).sum()

    def _canonical_coo(self):
        """A COO view with duplicates summed: the canonical COO of CSR and
        summed COO, or the duplicate-free (not row-sorted) ``tocoo`` of CSC
        and DIA; a raw COO is canonicalized on a copy."""
        coo = self.tocoo()
        if not (getattr(coo, "has_canonical_format", True)
                or getattr(coo, "_duplicate_free", False)):
            coo = coo.copy()
            coo.sum_duplicates()
        return coo

    def nonzero(self):
        """(row, col) tensors of the explicitly nonzero entries, row-major."""
        from .ops.coords import lexsort_rc

        coo = self._canonical_coo()
        keep = coo.data != 0
        rows, cols = coo.row[keep], coo.col[keep]
        order = lexsort_rc(rows, cols, self.shape)
        return rows[order], cols[order]

    def maximum(self, other):
        """Elementwise max with a sparse operand or a non-positive scalar
        (a positive scalar would give a dense result: it raises)."""
        return self._minmax_binary(other, is_max=True)

    def minimum(self, other):
        return self._minmax_binary(other, is_max=False)

    def _minmax_binary(self, other, is_max: bool):
        from .csr import csr_array
        from .ops.elementwise import csr_minmax_csr

        opname = "maximum" if is_max else "minimum"
        if np.isscalar(other):
            # `not (<= 0)` also catches NaN, which would fill every implicit zero
            if (not (other <= 0)) if is_max else (not (other >= 0)):
                raise NotImplementedError(
                    f"{opname} with a {'positive/NaN' if is_max else 'negative/NaN'} scalar "
                    "produces a dense result; densify explicitly")
            op = torch.maximum if is_max else torch.minimum
            A = self.tocsr()
            return A._with_data(op(A.data, torch.tensor(other, dtype=A.dtype, device=A.device)))
        if not isinstance(other, SparseArray):
            raise TypeError(f"{opname} expects a sparse operand or scalar")
        if self.shape != other.shape:
            raise ValueError(f"inconsistent shapes: {self.shape} vs {other.shape}")
        A, B = self.tocsr(), other.tocsr()
        indptr, indices, data = csr_minmax_csr(A.indptr, A.indices, A.data, B.indptr, B.indices,
                                               B.data, self.shape, is_max)
        return csr_array.from_parts(data, indices, indptr, self.shape)

    # -- canonical form (constructions sort and deduplicate; COO overrides)
    has_sorted_indices = True
    has_canonical_format = True

    def sum_duplicates(self):
        """No-op for the compressed formats (always canonical)."""

    def sort_indices(self):
        """No-op: construction sorts indices."""

    def sorted_indices(self):
        return self.copy()

    def prune(self):
        """No-op: the index and data buffers are always exactly nnz long."""

    def _become(self, rebuilt) -> None:
        """Take ``rebuilt``'s contents in place, dropping this array's lazy
        layouts and its plan-cached operators, and count the edit in
        ``_edits`` for what holds a layout outside the cache."""
        edits = self._edits + 1
        plan_cache.forget(self)
        self.__dict__.clear()
        self.__dict__.update(rebuilt.__dict__)
        self._edits = edits

    def _rebuilt(self, rows, cols, vals, shape, canonical=False):
        from .coo import coo_array

        out = coo_array((vals, (rows, cols)), shape=shape)
        if canonical:
            out.has_sorted_indices = out.has_canonical_format = True
        return out if self.format == "coo" else out.asformat(self.format)

    def setdiag(self, values, k=0):
        """Set the ``k``-th diagonal in place: a scalar broadcast, or one
        value a slot (extra values ignored, a short array sets a prefix).
        Explicit zeros are stored, as in scipy."""
        from .ops.coords import dedup_sorted, sort_coo

        m, n = self.shape
        dlen = min(m + min(k, 0), n - max(k, 0))
        if dlen <= 0:
            raise ValueError("k exceeds matrix dimensions")
        dev = self.device
        vals = torch.as_tensor(values, device=dev).to(self.dtype)
        vals = vals.expand(dlen) if vals.ndim == 0 else vals[:dlen]
        i = torch.arange(vals.shape[0], dtype=torch.int64, device=dev)
        coo = self._canonical_coo()
        rows = torch.cat([coo.row.to(torch.int64), i + max(-k, 0)])
        cols = torch.cat([coo.col.to(torch.int64), i + max(k, 0)])
        # stable sort, keep-last dedup: the appended diagonal wins
        urows, ucols, uvals, _ = dedup_sorted(
            *sort_coo(rows, cols, torch.cat([coo.data, vals]), self.shape), sum_duplicates=False)
        self._become(self._rebuilt(urows, ucols, uvals, self.shape, canonical=True))

    def reshape(self, *shape, order="C"):
        """Reshape to another 2-D shape of the same size (int64 flat index
        arithmetic on the device, scipy's coo.reshape rule)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if len(shape) != 2:
            raise ValueError("sparse arrays are 2-D; reshape takes (m, n)")
        m, n = self.shape
        m2, n2 = int(shape[0]), int(shape[1])
        if m2 * n2 != m * n:
            raise ValueError(f"cannot reshape array of size {m * n} into shape {shape}")
        coo = self.tocoo()
        rows, cols = coo.row.to(torch.int64), coo.col.to(torch.int64)
        if order == "C":
            flat = rows * n + cols
            r2, c2 = flat // n2, flat % n2
        else:
            flat = cols * m + rows
            r2, c2 = flat % m2, flat // m2
        return self._rebuilt(r2, c2, coo.data, (m2, n2))

    def resize(self, *shape):
        """Change the shape in place, dropping out-of-range entries."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        m2, n2 = int(shape[0]), int(shape[1])
        coo = self.tocoo()
        keep = (coo.row < m2) & (coo.col < n2)
        self._become(self._rebuilt(coo.row[keep], coo.col[keep], coo.data[keep], (m2, n2)))
        self._shape = (m2, n2)

    def check_format(self, full_check: bool = True):
        """Validate the compressed formats' invariants (scipy check_format):
        indptr length and monotonicity, index bounds, indices sorted within
        each row. One counted fetch of the flags; other formats pass."""
        indptr = getattr(self, "indptr", None)
        if indptr is None:
            return
        major, minor = self.shape if self.format == "csr" else self.shape[::-1]
        if indptr.shape[0] != major + 1:
            raise ValueError(f"index pointer size {indptr.shape[0]} != {major + 1}")
        idx = self.indices
        flags = [indptr[0] != 0, (indptr[1:] < indptr[:-1]).any(), indptr[-1] > idx.shape[0]]
        if full_check and idx.shape[0]:
            lines = expand_rows(indptr, idx.shape[0])
            flags += [(idx.min() < 0) | (idx.max() >= minor),
                      ((lines[1:] == lines[:-1]) & (idx[1:] < idx[:-1])).any()]
        bad = hostsync.fetch(torch.stack(flags))
        msgs = ("index pointer should start with 0", "index pointer values must not decrease",
                "Last value of index pointer exceeds nnz",
                f"indices out of bounds for axis of size {minor}",
                "indices must be sorted within each row")
        for flag, msg in zip(bad, msgs):
            if flag:
                raise ValueError(msg)

    def eliminate_zeros(self):
        """Drop explicitly stored zeros in place (a COO holding duplicates
        is canonicalized first, as scipy does)."""
        coo = self._canonical_coo()
        keep = coo.data != 0
        if bool(keep.all()):
            if self.format == "coo" and coo is not self:
                self._become(coo)  # the summed duplicates persist
            return
        self._become(self._rebuilt(coo.row[keep], coo.col[keep], coo.data[keep], self.shape))


def resolve_shape(shape, rows, cols):
    if shape is not None:
        return (int(shape[0]), int(shape[1]))
    if rows.shape[0] == 0:
        return (0, 0)
    return (host_int(rows.max()) + 1, host_int(cols.max()) + 1)


def _estimate_blocksize(rows, cols, shape, efficiency: float = 0.7):
    """scipy-style block-structure estimate from int64 coordinates: the
    largest candidate (r, c) dividing the shape whose dense-block fill
    nnz / (nnzb r c) clears ``efficiency``, else (1, 1)."""
    m, n = shape
    nnz = int(rows.shape[0])
    if nnz == 0:
        return (1, 1)
    for r, c in ((6, 6), (4, 4), (3, 3), (2, 2)):
        if m % r or n % c:
            continue
        nnzb = torch.unique(rows // r * (n // c) + cols // c).shape[0]
        if nnz / (nnzb * r * c) >= efficiency:
            return (r, c)
    return (1, 1)


class HostStagingArray(SparseArray):
    """Common surface of the host staging formats (``dok``, ``lil``): their
    entries live in Python containers with numpy values, their dtype is a
    numpy dtype, and conversions to CSR/COO land on ``settings.device``.
    The zero-preserving ufuncs run torch's functions on the host values."""

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self) -> torch.device:
        return torch.device("cpu")

    def count_nonzero(self) -> int:
        return int(np.count_nonzero(self._data_array()))

    def _map(self, fn):
        return self._with_data(host_array(fn(torch.from_numpy(self._data_array()))))

    def tocsc(self):
        return self.tocsr().tocsc()

    def todia(self):
        return self.tocsr().todia()

    # math converts to CSR on the device (scipy's own DOK/LIL math converts too)
    def __matmul__(self, other):
        return self.tocsr() @ other

    def dot(self, other):
        return self.tocsr().dot(other)

    def __add__(self, other):
        other = other.tocsr() if isinstance(other, HostStagingArray) else other
        return self.tocsr() + other

    def __mul__(self, other):
        return self.tocsr() * other

    def multiply(self, other):
        other = other.tocsr() if isinstance(other, HostStagingArray) else other
        return self.tocsr().multiply(other)

    def sum(self, axis=None):
        return self.tocsr().sum(axis=axis)

    @property
    def T(self):
        return self.transpose()

    def __repr__(self):
        return (f"<{self.shape[0]}x{self.shape[1]} {self.format.upper()} array, nnz={self.nnz},"
                f" dtype={self.dtype}>")

    __str__ = __repr__
