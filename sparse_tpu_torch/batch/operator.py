"""Pattern-shared batched operators: one sparsity pattern, stacked values.

Port of ``sparse_tpu/batch/operator.py``. Many systems that share a sparsity
pattern (one mesh or graph, different coefficients) are solved together:
the pattern packs (the SELL slab geometry on the CPU, the chunk layout on
a CUDA device, DIA offset maps) are keyed on the *pattern* in
``plan_cache``, and a ``(B, nnz)`` value stack repacks on the device as one
gather through the pattern's source maps.

* :class:`SparsityPattern`: host-held CSR structure, the plan-cache key;
* :class:`BatchedCSR`: stacked values over one pattern; ``matvec`` launches
  the batched chunk kernel (``kernels/sell_spmv.sell_chunk_spmv_batched``)
  once a product on a CUDA operand in every ``spmv_mode`` but 'segment';
* :class:`BatchedDIA`: stacked diagonal planes for banded patterns;
* :func:`make_batched_operator`: stacks of CSR matrices, dense ``[B, m, n]``
  stacks, ``(pattern, values)`` pairs.

Every batched operator has ``as_block_operator()``, the ``(B*m, B*n)``
block-diagonal ``LinearOperator`` view that ``linalg.make_linear_operator``
uses.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import plan_cache
from ..config import settings
from ..ops import spmv as spmv_ops
from ..utils import as_tensor, host_array


class SparsityPattern:
    """Immutable host-held CSR sparsity pattern shared by a batch.

    Holds numpy ``indptr``/``indices`` plus a content fingerprint; identity
    (this object) is the plan-cache key, so one pattern object should serve
    all same-pattern work. Its device packs go to the device of the values
    they are applied with.
    """

    __slots__ = ("indptr", "indices", "shape", "nnz", "_fp", "__weakref__")

    def __init__(self, indptr, indices, shape):
        self.indptr = np.ascontiguousarray(host_array(indptr))
        self.indices = np.ascontiguousarray(host_array(indices))
        self.shape = (int(shape[0]), int(shape[1]))
        self.nnz = int(self.indices.shape[0])
        if self.indptr.shape[0] != self.shape[0] + 1:
            raise ValueError(
                f"indptr length {self.indptr.shape[0]} != rows+1 ({self.shape[0] + 1})"
            )
        self._fp = None

    @classmethod
    def from_csr(cls, A) -> "SparsityPattern":
        """From anything CSR-shaped (``csr_array``, scipy CSR)."""
        if isinstance(A, SparsityPattern):
            return A
        if hasattr(A, "tocsr") and not hasattr(A, "indptr"):
            A = A.tocsr()
        return cls(A.indptr, A.indices, A.shape)

    @property
    def fingerprint(self) -> tuple:
        """Content hash (not the cache key, which is this object)."""
        if self._fp is None:
            h = hashlib.sha1()
            h.update(np.int64(self.shape[0]).tobytes())
            h.update(np.int64(self.shape[1]).tobytes())
            h.update(self.indptr.astype(np.int64).tobytes())
            h.update(self.indices.astype(np.int64).tobytes())
            self._fp = (self.shape, self.nnz, h.hexdigest())
        return self._fp

    def matches(self, other: "SparsityPattern") -> bool:
        return self is other or self.fingerprint == other.fingerprint

    def sell_pack(self, device):
        """The pattern's one-time SELL slab pack on ``device``, plan-cached:
        a :class:`_SellPatternPack` (plan, index planes, ``pos``, and the
        per-slab packed slot -> nnz position maps)."""
        dev = torch.device(device)
        return plan_cache.get(self, f"sell.pattern:{dev}", lambda: self._build_sell(dev))

    def sell_chunks(self, device):
        """The pattern's chunk layout on ``device`` (``sell_chunk_pack``,
        built there, with its slot -> nnz map), plan-cached: the card's
        batched layout, the same as every lane's lone ``PreparedCSR``."""
        from ..kernels.sell_spmv import sell_chunk_pack

        dev = torch.device(device)
        return plan_cache.get(self, f"sell.chunks:{dev}", lambda: sell_chunk_pack(
            as_tensor(self.indptr, dev), as_tensor(self.indices, dev), None, self.shape,
            with_src=True))

    def _build_sell(self, device):
        from ..kernels.sell_spmv import sell_pack

        plan, slabs, pos, srcs = sell_pack(
            self.indptr, self.indices, np.zeros(self.nnz, dtype=np.float32),
            self.shape, with_srcs=True, device=device,
        )
        return _SellPatternPack(plan, tuple(it for it, _vt in slabs), pos, srcs)

    def dia_pack(self, device, max_diags: int | None = None):
        """Offsets, the ``[D, n]`` nnz source map and its validity mask on
        ``device`` for banded patterns, plan-cached; raises ``ValueError``
        past ``max_diags`` (default ``settings.dia_max_diags``) diagonals."""
        dev = torch.device(device)
        return plan_cache.get(self, f"dia.pattern:{dev}",
                              lambda: self._build_dia(max_diags, dev))

    def _build_dia(self, max_diags, device):
        limit = int(max_diags or settings.dia_max_diags)
        counts = self.indptr[1:] - self.indptr[:-1]
        rows = np.repeat(np.arange(self.shape[0], dtype=np.int64), counts)
        offs_all = self.indices.astype(np.int64) - rows
        offsets = np.unique(offs_all)
        if len(offsets) > limit:
            raise ValueError(
                f"pattern has {len(offsets)} distinct diagonals (> {limit}); not DIA-shaped"
            )
        D, n = len(offsets), self.shape[1]
        k_of = np.searchsorted(offsets, offs_all)
        src = np.full((D, n), -1, dtype=np.int64)
        # scipy DIA convention: data[k, j] holds A[j - o_k, j]
        src[k_of, self.indices.astype(np.int64)] = np.arange(self.nnz)
        src_dt = np.int32 if self.nnz < 2**31 else np.int64
        return (tuple(int(o) for o in offsets), as_tensor(src.astype(src_dt), device),
                as_tensor(src >= 0, device))

    def __repr__(self):
        return f"SparsityPattern(shape={self.shape}, nnz={self.nnz})"


def _gather_masked(values, src, valid):
    """``values[:, src]`` with zeros where ``valid`` is false."""
    g = values[:, src.clamp(min=0)]
    return torch.where(valid, g, torch.zeros((), dtype=values.dtype, device=values.device))


class _SellPatternPack:
    """Device-resident pattern half of the batched SELL layout."""

    __slots__ = ("plan", "idx_slabs", "pos", "srcs")

    def __init__(self, plan, idx_slabs, pos, srcs):
        self.plan, self.idx_slabs, self.pos, self.srcs = plan, idx_slabs, pos, srcs

    def pack_values(self, values):
        """A ``(B, nnz)`` value stack as per-slab ``[B, K, R]`` planes (pad
        slots zero): one gather per slab."""
        return tuple(_gather_masked(values, src, src >= 0) for src in self.srcs)


class BatchedOperator:
    """Abstract batched linear operator: ``matvec`` maps ``(B, n)`` ->
    ``(B, m)``, one independent system per lane."""

    shape: tuple  # (B, m, n)
    dtype: torch.dtype
    device: torch.device

    @property
    def batch(self) -> int:
        return self.shape[0]

    def matvec(self, X):
        raise NotImplementedError

    def matmat(self, X):
        """Default batched SpMM: a column loop over ``(B, n, k)``."""
        return torch.stack([self.matvec(X[:, :, j]) for j in range(X.shape[2])], dim=2)

    def __matmul__(self, X):
        X = as_tensor(X, self.device)
        if X.ndim == 2:
            return self.matvec(X)
        if X.ndim == 3:
            return self.matmat(X)
        raise ValueError("batched operators apply to (B, n) or (B, n, k)")

    def lane(self, i: int):
        raise NotImplementedError

    def as_block_operator(self):
        """The ``(B*m, B*n)`` block-diagonal LinearOperator view: any
        unbatched solver takes a batch as one decoupled system."""
        from ..linalg import LinearOperator

        B, m, n = self.shape

        def mv(x):
            return self.matvec(x.reshape(B, n)).reshape(-1)

        def mm(X):
            k = X.shape[1]
            Y = self.matmat(X.T.reshape(k, B, n).permute(1, 2, 0))
            return Y.reshape(B * m, k)

        op = LinearOperator((B * m, B * n), matvec=mv, matmat=mm, dtype=self.dtype)
        op.device = self.device
        return op


class BatchedCSR(BatchedOperator):
    """Stacked CSR values ``(B, nnz)`` over one shared pattern.

    One pattern pack (plan-cached on the pattern) serves the whole batch:
    the values repack once on the device through the pattern's source
    maps. On a CUDA operand ``matvec`` launches the batched chunk kernel
    once a product in every ``spmv_mode`` but 'segment' (f32/f64; other
    dtypes raise), with value slots and workspace kept per dtype. On the
    CPU it keeps the reference's choice over the slab pack: the kernel path
    (its plain version) under 'pallas' within the VMEM gates at f32, the
    plain batched slab formulation otherwise; 'segment' takes the per-lane
    segment path, which needs no pack.
    """

    def __init__(self, pattern, values, dtype=None):
        self.pattern = SparsityPattern.from_csr(pattern)
        values = as_tensor(values, dtype=dtype)
        if values.ndim == 1:
            values = values[None, :]
        if values.ndim != 2 or values.shape[1] != self.pattern.nnz:
            raise ValueError(
                f"values must be (B, nnz={self.pattern.nnz}); got {tuple(values.shape)}"
            )
        self.values = values
        m, n = self.pattern.shape
        self.shape = (int(values.shape[0]), m, n)
        self.dtype = values.dtype
        self.device = values.device
        self._vals_packed = {}  # dtype -> per-slab [B, K, R] planes, or [slots, B] on the card
        self._ws = {}  # dtype -> SellWorkspace of the batched chunk kernel

    @classmethod
    def from_stack(cls, mats, pattern=None):
        """From same-pattern matrices (``csr_array`` / scipy CSR): checks
        every lane's pattern against the first and stacks the values (on
        the first lane's device when it is a port array)."""
        mats = list(mats)
        if not mats:
            raise ValueError("empty batch")
        first = SparsityPattern.from_csr(mats[0])
        if pattern is None:
            pattern = first
        elif not pattern.matches(first):
            raise ValueError("lane 0 does not match the given pattern")
        vals = []
        for i, A in enumerate(mats):
            if i and not pattern.matches(SparsityPattern.from_csr(A)):
                raise ValueError(f"lane {i} has a different sparsity pattern")
            vals.append(host_array(A.data if hasattr(A, "data") else A))
        dev = getattr(mats[0], "device", None)
        return cls(pattern, as_tensor(np.stack(vals), dev if isinstance(dev, torch.device) else None))

    def lane(self, i: int):
        """Lane ``i`` as a ``csr_array`` on the operator's device."""
        from ..csr import csr_array

        return csr_array.from_parts(
            self.values[i], as_tensor(self.pattern.indices, self.device),
            as_tensor(self.pattern.indptr, self.device), self.pattern.shape,
        )

    def with_values(self, values):
        """Same pattern, new value stack (the pattern pack is reused)."""
        return BatchedCSR(self.pattern, values)

    def _packed(self, dt):
        """(pattern slab pack, per-slab value planes at ``dt``); packs once."""
        pack = self.pattern.sell_pack(self.device)
        if dt not in self._vals_packed:
            self._vals_packed[dt] = pack.pack_values(self.values.to(dt))
        return pack, self._vals_packed[dt]

    def _chunk_packed(self, dt):
        """(pattern chunk layout, ``[slots, B]`` value slots at ``dt``,
        workspace) on the card; packs once."""
        from ..kernels.sell_spmv import SellWorkspace

        ch = self.pattern.sell_chunks(self.device)
        if dt not in self._vals_packed:
            self._vals_packed[dt] = ch.pack_values(self.values.to(dt))
            self._ws[dt] = SellWorkspace(ch, dt, self.batch)
        return ch, self._vals_packed[dt], self._ws[dt]

    def _pallas_viable(self, pack, X) -> bool:
        from ..kernels.sell_spmv import PALLAS_MAX_K, PALLAS_MAX_X

        if not pack.idx_slabs or X.shape[1] > PALLAS_MAX_X:
            return False
        if any(K > PALLAS_MAX_K for K, _, _ in pack.plan.slab_meta):
            return False
        return torch.promote_types(self.dtype, X.dtype) == torch.float32

    def _check(self, X, ndim):
        want = (self.batch, self.shape[2])
        if X.ndim != ndim or tuple(X.shape[:2]) != want:
            tail = ")" if ndim == 2 else ", k)"
            raise ValueError(f"expected X of shape ({want[0]}, {want[1]}{tail}; "
                             f"got {tuple(X.shape)}")

    def matvec(self, X):
        from ..kernels import sell_spmv as K

        X = as_tensor(X, self.device)
        self._check(X, 2)
        mode = settings.spmv_mode
        if mode == "segment" or self.pattern.nnz == 0:
            return self._matvec_segment(X)
        if X.device.type != "cpu":
            dt = K.kernel_dtype(self.dtype, X.dtype, "batched SELL SpMV")
            ch, vals, ws = self._chunk_packed(dt)
            return K.sell_chunk_spmv_batched(ch, vals, X.to(dt), ws)
        pack, vals = self._packed(self.dtype)
        if mode == "pallas" and self._pallas_viable(pack, X):
            return K.sell_spmv_batched(pack.plan, pack.idx_slabs, vals, pack.pos, X)
        return spmv_ops.csr_spmv_sell_batched(
            pack.idx_slabs, vals, pack.pos, X, pack.plan.zero_rows
        )

    def _matvec_segment(self, X):
        return spmv_ops.csr_spmv_segment_batched(
            as_tensor(self.pattern.indptr, self.device),
            as_tensor(self.pattern.indices, self.device),
            self.values, X, self.pattern.shape[0],
        )

    def matmat(self, X):
        X = as_tensor(X, self.device)
        self._check(X, 3)
        if settings.spmv_mode == "segment" or self.pattern.nnz == 0:
            indptr = as_tensor(self.pattern.indptr, self.device)
            indices = as_tensor(self.pattern.indices, self.device)
            m = self.pattern.shape[0]
            return torch.stack([
                spmv_ops.csr_spmm_segment(indptr, indices, self.values[b], X[b], m)
                for b in range(self.batch)
            ])
        if X.device.type != "cpu":  # plain torch over the card's layout
            ch, vals, _ws = self._chunk_packed(self.dtype)
            return torch.stack([spmv_ops.csr_spmm_chunks(ch, vals[:, b], X[b])
                                for b in range(self.batch)])
        pack, vals = self._packed(self.dtype)
        return spmv_ops.csr_spmm_sell_batched(
            pack.idx_slabs, vals, pack.pos, X, pack.plan.zero_rows
        )

    def todia(self, max_diags=None) -> "BatchedDIA":
        """Banded view through the pattern's DIA source map (plan-cached)."""
        return BatchedDIA.from_batched_csr(self, max_diags=max_diags)

    def __repr__(self):
        return (
            f"<BatchedCSR B={self.batch} shape={self.pattern.shape} "
            f"nnz={self.pattern.nnz} dtype={self.dtype} device={self.device}>"
        )


class BatchedDIA(BatchedOperator):
    """Stacked diagonal planes ``(B, D, n)`` over shared offsets: the
    batched zero-gather SpMV for banded patterns, lane by lane through
    ``ops.dia_spmv.dia_spmv_torch``."""

    def __init__(self, data, offsets, shape):
        data = as_tensor(data)
        if data.ndim != 3:
            raise ValueError("BatchedDIA data must be (B, D, n)")
        self.data = data
        self.offsets = tuple(int(o) for o in offsets)
        m, n = int(shape[0]), int(shape[1])
        if data.shape[1] != len(self.offsets) or data.shape[2] != n:
            raise ValueError(
                f"data {tuple(data.shape)} inconsistent with offsets "
                f"D={len(self.offsets)} and shape {shape}"
            )
        self.shape = (int(data.shape[0]), m, n)
        self.dtype = data.dtype
        self.device = data.device

    @classmethod
    def from_batched_csr(cls, bcsr: BatchedCSR, max_diags=None):
        offsets, src, valid = bcsr.pattern.dia_pack(bcsr.device, max_diags=max_diags)
        return cls(_gather_masked(bcsr.values, src, valid), offsets, bcsr.pattern.shape)

    def lane(self, i: int):
        from ..dia import dia_array

        return dia_array((self.data[i], np.asarray(self.offsets)),
                         shape=(self.shape[1], self.shape[2]))

    def matvec(self, X):
        from ..ops.dia_spmv import dia_spmv_torch

        X = as_tensor(X, self.device)
        if X.ndim != 2 or tuple(X.shape) != (self.batch, self.shape[2]):
            raise ValueError(f"matvec expects X of shape ({self.batch}, {self.shape[2]}); "
                             f"got {tuple(X.shape)}")
        shape = (self.shape[1], self.shape[2])
        return torch.stack([
            dia_spmv_torch(self.data[b], self.offsets, X[b], shape) for b in range(self.batch)
        ])

    def __repr__(self):
        return (f"<BatchedDIA B={self.batch} shape={self.shape[1:]} "
                f"D={len(self.offsets)} dtype={self.dtype}>")


def make_batched_operator(A) -> BatchedOperator:
    """Coerce ``A`` to a :class:`BatchedOperator`: batched operators as they
    are, ``(pattern, values)`` pairs, sequences of same-pattern CSR
    matrices, or a dense ``[B, m, n]`` stack."""
    if isinstance(A, BatchedOperator):
        return A
    if isinstance(A, tuple) and len(A) == 2 and isinstance(A[0], SparsityPattern):
        return BatchedCSR(A[0], A[1])
    if isinstance(A, (list, tuple)) and A and (hasattr(A[0], "indptr") or hasattr(A[0], "tocsr")):
        return BatchedCSR.from_stack(A)
    X = as_tensor(A)
    if X.ndim == 3:
        return _BatchedDense(X)
    raise TypeError(f"cannot interpret {type(A).__name__} as a batched operator")


class _BatchedDense(BatchedOperator):
    """Dense ``[B, m, n]`` stack: the oracle operator of the tests."""

    def __init__(self, stack):
        self.stack = as_tensor(stack)
        self.shape = tuple(int(s) for s in self.stack.shape)
        self.dtype = self.stack.dtype
        self.device = self.stack.device

    def lane(self, i: int):
        return self.stack[i]

    def matvec(self, X):
        return torch.einsum("bmn,bn->bm", self.stack, as_tensor(X, self.device))

    def matmat(self, X):
        return torch.einsum("bmn,bnk->bmk", self.stack, as_tensor(X, self.device))


def as_batched_matvec(A):
    """``A`` as a ``(B, n) -> (B, m)`` callable (batched operators,
    callables, dense stacks)."""
    if isinstance(A, BatchedOperator):
        return A.matvec
    if callable(A):
        return A
    return make_batched_operator(A).matvec
