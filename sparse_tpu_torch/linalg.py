"""LinearOperator framework and conjugate gradients (``sparse_tpu/linalg.py``
``:66-372`` and ``:461-732``).

``cg`` keeps the reference's three paths and their stopping rule (absolute
``||r|| < tol`` tested every ``conv_test_iters`` iterations and at
``maxiter - 1``):

* unpreconditioned banded f32 solves take the fused two-kernel iteration
  (``kernels/cg_dia.py``) in conv-test-sized chunks with one host fetch of
  rho per chunk — on by default on CUDA, and on the CPU (through the
  kernels' plain versions) only under ``settings.fused_cg == "force"``;
* every other solve takes ``_cg_device_loop``: a torch loop whose scalars
  stay on the device, read by the host only at the test points;
* a ``callback`` selects ``_cg_host_loop``.

``batched_cg``/``batched_bicgstab``/``batched_gmres`` solve B systems over
one sparsity pattern (``sparse_tpu_torch.batch.krylov``), and
``make_linear_operator`` takes a batched operator as its block-diagonal
view.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import SparseArray
from .config import settings
from .utils import as_tensor, resolve_device


# ---------------------------------------------------------------------------
# LinearOperator protocol
# ---------------------------------------------------------------------------
class LinearOperator:
    def __init__(self, shape, matvec=None, rmatvec=None, matmat=None, dtype=None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype if dtype is not None else torch.float32
        self._matvec_impl = matvec
        self._rmatvec_impl = rmatvec
        self._matmat_impl = matmat

    def matvec(self, x):
        if self._matvec_impl is None:
            raise NotImplementedError
        return self._matvec_impl(x)

    def rmatvec(self, x):
        if self._rmatvec_impl is None:
            raise NotImplementedError
        return self._rmatvec_impl(x)

    def matmat(self, X):
        if self._matmat_impl is not None:
            return self._matmat_impl(X)
        return torch.stack([self.matvec(X[:, i]) for i in range(X.shape[1])], dim=1)

    def _apply(self, x):
        x = as_tensor(x, getattr(self, "device", None))
        if x.ndim == 0:
            raise ValueError("Scalar operands are not allowed, use '*' instead")
        return self.matvec(x) if x.ndim == 1 else self.matmat(x)

    def __matmul__(self, x):
        if isinstance(x, LinearOperator):
            return _ProductOperator(self, x)
        return self._apply(x)

    def __add__(self, other):
        if isinstance(other, LinearOperator):
            return _SumOperator(self, other)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, LinearOperator):
            return _SumOperator(self, _ScaledOperator(other, -1.0))
        return NotImplemented

    def __mul__(self, x):
        # scipy semantics: operator -> composition, scalar -> scaling,
        # array -> application
        if isinstance(x, LinearOperator):
            return _ProductOperator(self, x)
        if np.isscalar(x) or getattr(x, "ndim", 1) == 0:
            return _ScaledOperator(self, x)
        return self._apply(x)

    def __rmul__(self, alpha):
        if np.isscalar(alpha) or getattr(alpha, "ndim", 1) == 0:
            return _ScaledOperator(self, alpha)
        return NotImplemented

    dot = __mul__

    def __neg__(self):
        return _ScaledOperator(self, -1.0)

    def __pow__(self, p):
        if not isinstance(p, (int, np.integer)) or p < 0:
            raise ValueError("operator power requires a non-negative int")
        if self.shape[0] != self.shape[1]:
            raise ValueError("operator power requires a square operator")
        if p == 0:
            return IdentityOperator(self.shape, dtype=self.dtype)
        return _PowerOperator(self, int(p))

    @property
    def H(self):
        """Adjoint (conjugate transpose): matvec = this operator's rmatvec."""
        return LinearOperator(
            (self.shape[1], self.shape[0]), matvec=self.rmatvec, rmatvec=self.matvec,
            dtype=self.dtype,
        )

    @property
    def T(self):
        """Transpose. For complex operators: conj . rmatvec . conj."""
        if self.dtype.is_complex:
            return LinearOperator(
                (self.shape[1], self.shape[0]),
                matvec=lambda x: torch.conj(self.rmatvec(torch.conj(x))),
                rmatvec=lambda x: torch.conj(self.matvec(torch.conj(x))),
                dtype=self.dtype,
            )
        return self.H


class IdentityOperator(LinearOperator):
    def matvec(self, x):
        return x

    def rmatvec(self, x):
        return x


def _scalar_dtype(alpha) -> torch.dtype:
    return torch.as_tensor(alpha).dtype


class _SumOperator(LinearOperator):
    def __init__(self, a, b):
        if a.shape != b.shape:
            raise ValueError(f"operator shape mismatch: {a.shape} + {b.shape}")
        super().__init__(a.shape, dtype=torch.promote_types(a.dtype, b.dtype))
        self._a, self._b = a, b

    def matvec(self, x):
        return self._a.matvec(x) + self._b.matvec(x)

    def rmatvec(self, x):
        return self._a.rmatvec(x) + self._b.rmatvec(x)

    def matmat(self, X):
        return self._a.matmat(X) + self._b.matmat(X)


class _ScaledOperator(LinearOperator):
    def __init__(self, a, alpha):
        dt = a.dtype if isinstance(alpha, (int, float)) else torch.promote_types(
            a.dtype, _scalar_dtype(alpha)
        )
        super().__init__(a.shape, dtype=dt)
        self._a, self._alpha = a, alpha

    def matvec(self, x):
        return self._alpha * self._a.matvec(x)

    def rmatvec(self, x):
        return np.conj(self._alpha) * self._a.rmatvec(x)

    def matmat(self, X):
        return self._alpha * self._a.matmat(X)


class _ProductOperator(LinearOperator):
    def __init__(self, a, b):
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"operator shape mismatch: {a.shape} @ {b.shape}")
        super().__init__((a.shape[0], b.shape[1]), dtype=torch.promote_types(a.dtype, b.dtype))
        self._a, self._b = a, b

    def matvec(self, x):
        return self._a.matvec(self._b.matvec(x))

    def rmatvec(self, x):
        return self._b.rmatvec(self._a.rmatvec(x))

    def matmat(self, X):
        return self._a.matmat(self._b.matmat(X))


class _PowerOperator(LinearOperator):
    """A ** p as a flat application loop."""

    def __init__(self, a, p):
        super().__init__(a.shape, dtype=a.dtype)
        self._a, self._p = a, p

    def matvec(self, x):
        for _ in range(self._p):
            x = self._a.matvec(x)
        return x

    def rmatvec(self, x):
        for _ in range(self._p):
            x = self._a.rmatvec(x)
        return x

    def matmat(self, X):
        for _ in range(self._p):
            X = self._a.matmat(X)
        return X


class _SparseMatrixLinearOperator(LinearOperator):
    def __init__(self, A):
        super().__init__(A.shape, dtype=A.dtype)
        self.A = A
        self.device = A.device
        # warm the layouts (banded detection, ELL) once, at wrap time
        prepare = getattr(A, "prepare", None)
        if prepare is not None:
            prepare()

    def matvec(self, x):
        return self.A.dot(x)

    def rmatvec(self, x):
        # the adjoint: conjugate x rather than the matrix (A.T is zero-copy)
        if self.dtype.is_complex:
            return torch.conj(self.A.T.dot(torch.conj(x)))
        return self.A.T.dot(x)

    def matmat(self, X):
        return self.A.dot(X)


class _DenseMatrixLinearOperator(LinearOperator):
    def __init__(self, A):
        A = as_tensor(A)
        super().__init__(A.shape, dtype=A.dtype)
        self.A = A
        self.device = A.device

    def matvec(self, x):
        return self.A @ x

    def rmatvec(self, x):
        return self.A.T.conj() @ x

    def matmat(self, X):
        return self.A @ X


def make_linear_operator(A) -> LinearOperator:
    if isinstance(A, LinearOperator):
        return A
    if isinstance(A, SparseArray):
        return _SparseMatrixLinearOperator(A)
    from .batch.operator import BatchedOperator

    if isinstance(A, BatchedOperator):
        # B independent systems are one (B*m, B*n) block-diagonal system
        return A.as_block_operator()
    return _DenseMatrixLinearOperator(A)


aslinearoperator = make_linear_operator


def cg_axpby(y, x, a, b, isalpha=True, negate=False):
    """y + (a/b) x (isalpha) or y (a/b) + x (not isalpha); sign optional."""
    s = a / b
    if negate:
        s = -s
    return y + s * x if isalpha else y * s + x


# single-precision dot products accumulate in double precision
_DOT_ACC = {torch.float32: torch.float64, torch.complex64: torch.complex128}


def _vdot(a, b):
    """Inner product over the last axis, first argument conjugated
    (np.vdot for vectors). Single-precision products are summed in double
    precision and rounded once, so the result does not depend on the order
    of the reduction: a lane of a batched solve (``batch.krylov``) gets the
    scalars of the lone solve bit for bit."""
    prod = torch.conj(a) * b
    return torch.sum(prod, dim=-1, dtype=_DOT_ACC.get(prod.dtype, prod.dtype)).to(prod.dtype)


def _operator_device(A) -> torch.device:
    if isinstance(A, (SparseArray, torch.Tensor)):
        return A.device
    dev = getattr(A, "device", None)
    return dev if dev is not None else resolve_device()


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------
def cg(A, b, x0=None, tol=1e-08, maxiter=None, M=None, callback=None, atol=None,
       conv_test_iters=25):
    """Conjugate gradient. Returns (x, iters), reference semantics:
    absolute ||r|| < tol tested every conv_test_iters iterations. Runs on
    the device of ``A`` (a tensor or sparse array), else on
    ``settings.device``."""
    if atol is not None:
        raise ValueError("atol is not supported.")
    b = as_tensor(b, _operator_device(A))
    n = b.shape[0]
    if maxiter is None:
        maxiter = n * 10
    if M is None and callback is None:
        fused = _try_fused_cg(A, b, x0, tol, maxiter, conv_test_iters)
        if fused is not None:
            return fused[0], fused[1]
    A = make_linear_operator(A)
    M = IdentityOperator(A.shape, dtype=A.dtype) if M is None else make_linear_operator(M)
    x = torch.zeros_like(b) if x0 is None else as_tensor(x0, b.device)
    if callback is not None:
        return _cg_host_loop(A, b, x, tol, maxiter, M, callback, conv_test_iters)
    r = b - A.matvec(x)
    return _cg_device_loop(A, b, x, r, tol, maxiter, M, conv_test_iters)


def _try_fused_cg(A, b, x0, tol, maxiter, conv_test_iters):
    """Fused-iteration fast path for unpreconditioned CG on banded f32
    operators, in conv-test-sized chunks with one host fetch of rho per
    chunk: the same iterates and stopping rule as ``_cg_device_loop``.
    Returns ``(x, iters, rho_f, info)`` — ``info`` 0 = converged, -1 =
    nonfinite rho (a breakdown, not convergence), iters = maxiter
    exhausted — or None when the path does not apply.
    """
    mode = settings.fused_cg
    if not mode:
        return None
    if b.device.type != "cuda" and mode != "force":
        return None  # off the card only as the test hook
    from .csr import csr_array
    from .dia import dia_array

    planes = offsets = None
    if isinstance(A, dia_array):
        planes, offsets = A.data, tuple(int(o) for o in A.offsets)
    elif isinstance(A, csr_array):
        dia = A._maybe_dia()  # cached banded detection
        if dia is not None:
            planes, offsets = dia
    if planes is None:
        return None
    m, n_ = A.shape
    if m != n_ or b.ndim != 1 or b.shape[0] != m or maxiter < 1:
        return None
    band = max((abs(int(o)) for o in offsets), default=0)
    if b.device.type == "cpu" and band > settings.pallas_max_band:
        return None  # the reference's VMEM gate; the CUDA kernels take any band
    dt = torch.promote_types(planes.dtype, b.dtype)
    if dt != torch.float32:  # the reference's f32-only gate
        return None
    if x0 is not None:
        x0 = as_tensor(x0, b.device)

    from .kernels.cg_dia import cg_dia_fused
    from .kernels.dia_spmv import prepared_dia

    packed = prepared_dia(A, planes, offsets, (m, planes.shape[1]), dt).planes
    tol2 = float(tol) ** 2
    chunk = max(int(conv_test_iters), 1)
    state = None
    iters = 0
    x = None
    rho_f = None
    while iters < maxiter:
        # the device loop's test points: every conv_test_iters iterations
        # and at iters == maxiter - 1
        k = min(chunk, max(maxiter - 1 - iters, 1))
        k = min(k, maxiter - iters)
        x, _r, rho, state = cg_dia_fused(
            planes, offsets, b, x0, m, iters=k, state=state, return_state=True,
            planes=packed,
        )
        iters += k
        rho_f = float(rho)
        if not math.isfinite(rho_f):
            return x, iters, rho_f, -1
        if rho_f < tol2:
            return x, iters, rho_f, 0
    info = 0 if (rho_f is not None and rho_f < tol2) else iters
    return x, iters, rho_f, info


def _cg_device_loop(A, b, x, r, tol, maxiter, M, conv_test_iters):
    """CG with the scalars on the device; the host reads ||r||^2 only at
    the test points (iters % conv_test_iters == 0 or iters == maxiter - 1)."""
    tol2 = torch.tensor(tol, dtype=r.real.dtype) ** 2
    p = torch.zeros_like(b)
    rho = torch.zeros((), dtype=b.dtype, device=b.device)
    iters = 0
    while iters < maxiter:
        tested = iters % conv_test_iters == 0 or iters == maxiter - 1
        if tested and iters > 0 and bool(_vdot(r, r).real.cpu() < tol2):
            break
        z = M.matvec(r)
        rho1 = rho
        rho = _vdot(r, z)
        if iters == 0:
            p = z
        else:
            p = z + (rho / torch.where(rho1 == 0, torch.ones_like(rho1), rho1)) * p
        q = A.matvec(p)
        pq = _vdot(p, q)
        alpha = rho / torch.where(pq == 0, torch.ones_like(pq), pq)  # 0/0 guard
        x = x + alpha * p
        r = r - alpha * q
        iters += 1
    return x, iters


def _cg_host_loop(A, b, x, tol, maxiter, M, callback, conv_test_iters):
    """Host-driven CG with a per-iteration ``callback(x)``."""
    r = b - A.matvec(x)
    iters = 0
    rho = None
    p = None
    while iters < maxiter:
        z = M.matvec(r)
        rho1 = rho
        rho = _vdot(r, z)
        p = z if iters == 0 else cg_axpby(p, z, rho, rho1, isalpha=False)
        q = A.matvec(p)
        pq = _vdot(p, q)
        pq = torch.where(pq == 0, torch.ones_like(pq), pq)
        x = cg_axpby(x, p, rho, pq, isalpha=True)
        r = cg_axpby(r, q, rho, pq, isalpha=True, negate=True)
        iters += 1
        if callback is not None:
            callback(x)
        if (iters % conv_test_iters == 0 or iters == maxiter - 1) and float(
            torch.linalg.vector_norm(r)
        ) < tol:
            break
    return x, iters


# ---------------------------------------------------------------------------
# Batched entry points (sparse_tpu_torch.batch.krylov): B systems sharing
# one sparsity pattern, one masked loop with per-lane convergence
# ---------------------------------------------------------------------------
def batched_cg(A, b, **kwargs):
    """Batched CG; see :func:`sparse_tpu_torch.batch.krylov.batched_cg`."""
    from .batch.krylov import batched_cg as _impl

    return _impl(A, b, **kwargs)


def batched_bicgstab(A, b, **kwargs):
    """Batched BiCGStab; see
    :func:`sparse_tpu_torch.batch.krylov.batched_bicgstab`."""
    from .batch.krylov import batched_bicgstab as _impl

    return _impl(A, b, **kwargs)


def batched_gmres(A, b, **kwargs):
    """Batched restarted GMRES; see
    :func:`sparse_tpu_torch.batch.krylov.batched_gmres`."""
    from .batch.krylov import batched_gmres as _impl

    return _impl(A, b, **kwargs)
