"""CSR sparse array (``sparse_tpu/csr.py``).

SpMV dispatch keeps the reference's order (``csr.py:398-446``): banded
matrices (``_maybe_dia``) take the prepared DIA kernel, then the prepared
SELL-C-sigma kernel (``_maybe_sell``), then the ELL gather path, then the
segment path. ``x @ A`` runs on the plan-cached transpose, sparse @
sparse is the ESC SpGEMM (``ops.spgemm``), and the elementwise products,
sums and diagonals are ``ops.elementwise``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from . import plan_cache
from .base import SparseArray
from .config import settings
from .ops import conv, elementwise, spmv as spmv_ops, tropical
from .ops.coords import expand_rows
from .ops.sddmm import csr_sddmm
from .ops.spgemm import spgemm_csr_csr
from .utils import as_tensor, host_int, resolve_device

_SPMV_MODES = ("auto", "pallas", "sell", "ell", "segment")


class csr_array(SparseArray):
    format = "csr"

    def __init__(self, arg, shape=None, dtype=None, device=None):
        from .coo import coo_array

        if isinstance(arg, SparseArray):
            c = arg.tocsr()
            data, indices, indptr, shape = c.data, c.indices, c.indptr, c.shape
        elif isinstance(arg, tuple) and len(arg) == 3:
            data, indices, indptr = (as_tensor(a, device) for a in arg)
            if shape is None:
                ncols = host_int(indices.max()) + 1 if indices.shape[0] else 0
                shape = (indptr.shape[0] - 1, ncols)
        elif isinstance(arg, tuple) and len(arg) == 2 and isinstance(arg[1], tuple):
            c = coo_array(arg, shape=shape, device=device).tocsr()
            data, indices, indptr, shape = c.data, c.indices, c.indptr, c.shape
        elif isinstance(arg, tuple) and len(arg) == 2:
            shape = (int(arg[0]), int(arg[1]))
            dev = resolve_device(device)
            indptr = torch.zeros((shape[0] + 1,), dtype=torch.int32, device=dev)
            indices = torch.zeros((0,), dtype=torch.int32, device=dev)
            data = torch.zeros((0,), dtype=dtype or torch.float32, device=dev)
        elif hasattr(arg, "tocsr"):  # scipy sparse
            s = arg.tocsr()
            data, indices, indptr = (as_tensor(a, device) for a in (s.data, s.indices, s.indptr))
            shape = s.shape
        else:  # dense
            d = as_tensor(arg, device)
            if d.ndim != 2:
                raise ValueError("CSR arrays must be 2-D")
            indptr, indices, data, _ = conv.dense_to_csr(d)
            shape = d.shape
        if dtype is not None:
            data = data.to(dtype)
        dev = resolve_device(device) if device is not None else data.device
        self._init(data.to(dev), indices.to(dev), indptr.to(dev), shape)

    def _init(self, data, indices, indptr, shape):
        self.data, self.indices, self.indptr = data, indices, indptr
        self._shape = (int(shape[0]), int(shape[1]))
        self._ell = None  # lazy (ell_indices, ell_data)
        self._ell_width_cache = None
        self._dia = False  # False = unchecked, None = not banded, else planes

    @classmethod
    def from_parts(cls, data, indices, indptr, shape):
        obj = object.__new__(cls)
        obj._init(data, indices, indptr, shape)
        return obj

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def _data_array(self):
        return self.data

    def _with_data(self, data):
        return csr_array.from_parts(data, self.indices, self.indptr, self.shape)

    # -- layouts -------------------------------------------------------------
    def _ell_width(self) -> int:
        """Max row length; one host fetch, cached."""
        if self._ell_width_cache is None:
            counts = self.indptr[1:] - self.indptr[:-1]
            self._ell_width_cache = host_int(counts.max()) if self.shape[0] else 0
        return self._ell_width_cache

    def _maybe_ell(self):
        """Build/cache the padded-row layout when profitable (settings.spmv_mode)."""
        mode = settings.spmv_mode
        m = self.shape[0]
        if mode in ("segment", "sell") or m == 0 or self.nnz == 0:
            return None
        k = self._ell_width()
        mean = max(self.nnz / m, 1.0)
        if mode in ("ell", "pallas") or k <= settings.ell_max_ratio * mean:
            if self._ell is None:
                self._ell = conv.csr_to_ell(self.indptr, self.indices, self.data, m, max(k, 1))
            return self._ell
        return None

    def _maybe_dia(self):
        """Detect banded structure and cache scipy-layout DIA planes.

        At most ``settings.dia_max_diags`` distinct diagonals and bounded
        fill; one host fetch of the distinct offsets at first use, the
        result cached (None = not banded).
        """
        if self._dia is not False:
            return self._dia
        self._dia = None
        m, n = self.shape
        nnz = self.nnz
        if nnz == 0:
            return None
        rows = expand_rows(self.indptr, nnz)
        # col - row fits int32 whenever both dims do
        odt = torch.int32 if max(m, n) <= 2**31 - 1 else torch.int64
        offs = torch.unique(self.indices.to(odt) - rows.to(odt))
        D = int(offs.shape[0])
        if D > settings.dia_max_diags or D * n > settings.dia_max_fill * nnz:
            return None
        from .dia import _coo_to_dia  # duplicate-summing plane build

        planes, offsets, _ = _coo_to_dia(self.tocoo())
        self._dia = (planes, tuple(int(o) for o in offsets))
        return self._dia

    def _maybe_sell(self):
        """The plan-cached SELL-C-sigma operator (``kernels/sell_spmv.py``),
        or None. Under ``spmv_mode`` 'sell' and 'pallas' it applies to every
        matrix with nonzeros; under 'auto' only where the ELL gate declines
        (max row length beyond ``ell_max_ratio`` x the mean). Packed once on
        first use: the chunk layout on the card (built there), the
        reference's slab pack on the CPU."""
        mode = settings.spmv_mode
        if mode not in ("auto", "sell", "pallas"):
            return None
        if self.shape[0] == 0 or self.nnz == 0:
            return None
        if mode == "auto":
            mean = max(self.nnz / self.shape[0], 1.0)
            if self._ell_width() <= settings.ell_max_ratio * mean:
                return None  # tight profile: the ELL path takes it

        def build():
            from .kernels.sell_spmv import PreparedCSR

            return PreparedCSR(self.indptr, self.indices, self.data, self.shape,
                               device=self.device)

        return plan_cache.get(self, "sell", build)

    def prepare(self, mode: str | None = None):
        """Warm the layouts of the current (or given) ``spmv_mode`` eagerly:
        banded detection, the SELL pack (only with the plan cache on, where
        it has somewhere to live), ELL. Returns self."""
        prev = settings.spmv_mode
        try:
            if mode is not None:
                settings.spmv_mode = mode
            if settings.spmv_mode in ("auto", "pallas"):
                self._maybe_dia()
            if settings.plan_cache:
                self._maybe_sell()
            self._maybe_ell()
        finally:
            settings.spmv_mode = prev
        return self

    # -- products ------------------------------------------------------------
    def dot(self, other):
        """A @ other: SpMV for a dense 1-D operand, SpMM for a dense 2-D
        one, SpGEMM (``ops.spgemm``) for a sparse one."""
        if isinstance(other, SparseArray):
            if self.shape[1] != other.shape[0]:
                raise ValueError(f"dimension mismatch: {self.shape} @ {other.shape}")
            b = other.tocsr()
            indptr, indices, data = spgemm_csr_csr(self.indptr, self.indices, self.data, b.indptr,
                                                   b.indices, b.data, self.shape, b.shape)
            return csr_array.from_parts(data, indices, indptr, (self.shape[0], b.shape[1]))
        x = as_tensor(other, self.device)
        if x.ndim not in (1, 2):
            raise ValueError("can only multiply by 1-D or 2-D arrays")
        if x.shape[0] != self.shape[1]:
            raise ValueError(f"dimension mismatch: {self.shape} @ {tuple(x.shape)}")
        return self._spmv(x) if x.ndim == 1 else self._spmm(x)

    def _spmv(self, x):
        mode = settings.spmv_mode
        if mode not in _SPMV_MODES:
            raise ValueError(f"unknown spmv_mode {mode!r}")
        if mode in ("auto", "pallas"):
            dia = self._maybe_dia()
            if dia is not None:
                from .kernels.dia_spmv import cached_prepared_spmv

                y = cached_prepared_spmv(self, dia[0], dia[1], self.shape, x)
                if y is not None:  # None only on the CPU, past the reference's gates
                    return y
                from .ops.dia_spmv import dia_spmv_torch

                return dia_spmv_torch(dia[0], dia[1], x, self.shape)
        prep = self._maybe_sell()
        if prep is not None:
            return prep(x)
        ell = self._maybe_ell()
        if ell is not None:
            return spmv_ops.csr_spmv_ell(ell[0], ell[1], x)
        return spmv_ops.csr_spmv_segment(self.indptr, self.indices, self.data, x, self.shape[0])

    def _spmm(self, B):
        ell = self._maybe_ell()
        if ell is not None:
            return spmv_ops.csr_spmm_ell(ell[0], ell[1], B)
        prep = self._maybe_sell()  # skewed profiles: plain slab gathers
        if prep is not None:
            return prep.matmat(B)
        return spmv_ops.csr_spmm_segment(self.indptr, self.indices, self.data, B, self.shape[0])

    def matvec(self, x):
        return self.dot(x)

    def _rdot(self, other):
        """B @ A = (A^T B^T)^T: the plan-cached transpose's products run on
        its own plan-cached CSR, row by row in a fixed order (no atomics),
        so ``x @ A`` repeats bit for bit on the card as ``A.T @ x`` does."""
        B = as_tensor(other, self.device)
        return self.T.dot(B) if B.ndim == 1 else self.T.dot(B.T).T

    def sddmm(self, C, D):
        """A's values times (C @ D) at A's nonzeros."""
        vals = csr_sddmm(self.indptr, self.indices, self.data, as_tensor(C, self.device),
                         as_tensor(D, self.device))
        return self._with_data(vals)

    def _ell_plane(self):
        ell = self._maybe_ell()
        return None if ell is None else ell[0]

    def tropical_spmv(self, x):
        """(max, lexicographic) semiring SpMV over [n, f] integer tuples."""
        return tropical.tropical_spmv(self.indptr, self.indices, self.data,
                                      as_tensor(x, self.device), self.shape[0],
                                      ell_idx=self._ell_plane())

    def mis_tropical(self, k=1, invalid=None, seed=0):
        """MIS(k) flags by the tropical tournament on the device: [m] int32,
        2 = member, 0 = dominated, -1 = invalid."""
        return tropical.mis_flags(self.indptr, self.indices, self.data, self.shape[0], k=k,
                                  invalid=invalid, seed=seed, ell_idx=self._ell_plane())

    def mis_aggregate_cols(self, flags):
        """(aggregate column per node, n_coarse) from MIS flags: each node
        routed to its nearest root, on the device."""
        return tropical.mis_aggregate_cols(self.indptr, self.indices, self.data, self.shape[0],
                                           as_tensor(flags, self.device),
                                           ell_idx=self._ell_plane())

    # -- elementwise ---------------------------------------------------------
    def __add__(self, other):
        if np.isscalar(other):
            if other == 0:
                return self.copy()
            raise NotImplementedError("adding a nonzero scalar densifies")
        if isinstance(other, SparseArray):
            b = other.tocsr()
            indptr, indices, data = elementwise.csr_add_csr(
                self.indptr, self.indices, self.data, b.indptr, b.indices, b.data, self.shape)
            return csr_array.from_parts(data, indices, indptr, self.shape)
        return self.toarray() + as_tensor(other, self.device)  # dense: a dense result

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, other):
        if np.isscalar(other) or getattr(other, "ndim", 1) == 0:
            return self._with_data(self.data * other)
        return self.multiply(other)

    def multiply(self, other):
        """Elementwise product with a scalar, a sparse operand
        (intersection) or a dense one (broadcast rows or columns scale the
        nonzeros in place, with no [m, n] broadcast)."""
        if np.isscalar(other) or getattr(other, "ndim", 1) == 0:
            return self._with_data(self.data * other)
        if isinstance(other, SparseArray):
            b = other.tocsr()
            indptr, indices, data = elementwise.csr_mult_csr(
                self.indptr, self.indices, self.data, b.indptr, b.indices, b.data, self.shape)
            return csr_array.from_parts(data, indices, indptr, self.shape)
        d = as_tensor(other, self.device)
        m, n = self.shape
        if d.ndim == 1:
            d = d[None, :]
        if d.ndim != 2 or d.shape[0] not in (1, m) or d.shape[1] not in (1, n):
            raise ValueError(f"inconsistent shapes: {self.shape} and {tuple(d.shape)}")
        if tuple(d.shape) == (1, 1):
            return self._with_data(self.data * d[0, 0])
        if d.shape[1] == 1:  # a column: scale rows
            return self._with_data(self.data * d[expand_rows(self.indptr, self.nnz), 0])
        if d.shape[0] == 1:  # a row: scale columns
            return self._with_data(self.data * d[0, self.indices])
        return self._with_data(elementwise.csr_mult_dense(self.indptr, self.indices, self.data,
                                                          d, self.shape))

    # -- reductions / extraction ---------------------------------------------
    def sum(self, axis=None):
        return elementwise.csr_sum(self.indptr, self.indices, self.data, self.shape, axis=axis)

    def diagonal(self, k=0):
        return elementwise.csr_diagonal(self.indptr, self.indices, self.data, self.shape, k=k)

    # -- conversions ---------------------------------------------------------
    def tocsr(self):
        return self

    def tocoo(self):
        from .coo import coo_array

        rows, cols, data = conv.csr_to_coo(self.indptr, self.indices, self.data, self.shape)
        out = coo_array((data, (rows, cols)), shape=self.shape)
        out.has_sorted_indices = True
        out.has_canonical_format = True
        return out

    def tocsc(self):
        from .csc import csc_array

        indptr, indices, data = conv.csr_to_csc(self.indptr, self.indices, self.data, self.shape)
        return csc_array.from_parts(data, indices, indptr, self.shape)

    def todia(self):
        from .dia import dia_array

        return dia_array(self.tocoo())

    def toarray(self):
        return conv.csr_to_dense(self.indptr, self.indices, self.data, self.shape)

    def transpose(self, axes=None):
        """Zero-copy transpose: the same buffers read as CSC (like scipy).
        The view is plan-cached on this array, so ``A.T @ x`` reuses the
        CSR form the view builds for its products."""
        if axes is not None:
            raise ValueError("transpose with axes != None is unsupported")
        from .csc import csc_array

        return plan_cache.get(self, "transpose", lambda: csc_array.from_parts(
            self.data, self.indices, self.indptr, (self.shape[1], self.shape[0])
        ))

    @property
    def T(self):
        return self.transpose()

    def __str__(self):
        return (
            f"<{self.shape[0]}x{self.shape[1]} CSR array, nnz={self.nnz},"
            f" dtype={self.dtype}, device={self.device}>"
        )

    __repr__ = __str__
