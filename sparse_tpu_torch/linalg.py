"""LinearOperator framework, conjugate gradients and the Krylov solvers
(``sparse_tpu/linalg.py`` ``:54-372`` and ``:461-2234``).

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

``spsolve`` is ``cg``. ``cgs``, ``bicg`` and ``bicgstab`` keep
``_cg_device_loop``'s shape. ``gmres`` runs each restart cycle on the
device and fetches one packed triple a cycle. ``minres``, ``tfqmr``,
``qmr``, ``lsqr`` and ``lsmr`` run the reference's ``lax.while_loop`` as
``hostsync.device_while``: chunks of masked iterations, one fetch of the
stop flag a chunk. ``lgmres`` and ``gcrotmk`` drive augmented cycles from
the host, their small least squares solved on the host from a device QR.
Every host fetch of these drivers goes through ``hostsync.fetch``, which
counts it in ``hostsync.HOST_SYNCS``. Adjoint products (``rmatvec``) run
on a CSR of the transpose held by the operator, so they repeat bit for bit
on the card.

``batched_cg``/``batched_bicgstab``/``batched_gmres`` solve B systems over
one sparsity pattern (``sparse_tpu_torch.batch.krylov``), and
``make_linear_operator`` takes a batched operator as its block-diagonal
view.

The rest of scipy.sparse.linalg's surface: ``eigsh`` (thick-restart
Lanczos, each cycle on the device with one host fetch) and ``svds`` on
its normal operator; ``norm``, ``onenormest``, ``matrix_power`` (SpGEMM)
and ``expm_multiply`` (Al-Mohy-Higham, each Taylor stage a
``hostsync.device_while``); ``lobpcg``, ``eigs`` and
``funm_multiply_krylov`` (``_eigen``); the direct solvers and incomplete
factorizations (``_direct``); ``LaplacianNd`` (``_laplacian``); and
scipy's legacy namespaces (``linalg.isolve`` etc.).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import hostsync, plan_cache
from .base import SparseArray
from .config import settings
from .utils import as_tensor, resolve_device
from ._direct import (  # noqa: F401  (scipy.sparse.linalg surface)
    SpILU,
    SuperLU,
    expm,
    factorized,
    ic0,
    ilu0,
    inv,
    is_sptriangular,
    spbandwidth,
    spilu,
    splu,
    spsolve_triangular,
)
from ._eigen import (  # noqa: F401
    ArpackError,
    ArpackNoConvergence,
    eigs,
    funm_multiply_krylov,
    lobpcg,
)


class MatrixRankWarning(UserWarning):
    """scipy.sparse.linalg.MatrixRankWarning alias."""


def use_solver(**kwargs):
    """scipy API no-op: there is no UMFPACK toggle here."""


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
        self._AT = None  # (A._edits when built, A^T)
        # warm the layouts (banded detection, ELL) once, at wrap time
        prepare = getattr(A, "prepare", None)
        if prepare is not None:
            prepare()

    def _transpose(self):
        """A^T in a row-wise format, built on the first adjoint product and
        held, plan cache or not, until A is edited in place (``setdiag``,
        ``resize``, ``eliminate_zeros``): a CSR array (the CSC view's
        plan-cached CSR form), or a DIA array for a DIA operand. Its
        products take the row-wise DIA, SELL, ELL or segment paths, which
        sum each row in a fixed order, so an adjoint product repeats bit for
        bit on the card."""
        edits = getattr(self.A, "_edits", 0)
        if self._AT is None or self._AT[0] != edits:
            AT = self.A.T
            if AT.format == "csc":
                AT = plan_cache.get(AT, "csr", AT.tocsr)
            elif AT.format != "dia":
                AT = AT.tocsr()
            prepare = getattr(AT, "prepare", None)
            if prepare is not None:
                prepare()
            self._AT = (edits, AT)
        return self._AT[1]

    def matvec(self, x):
        return self.A.dot(x)

    def rmatvec(self, x):
        # the adjoint: conjugate x rather than the matrix
        if self.dtype.is_complex:
            AT = self._transpose()
            return torch.conj_physical(AT.dot(torch.conj_physical(as_tensor(x, self.device))))
        return self._transpose().dot(x)

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


def _operator_device(A, b=None) -> torch.device:
    """The device a solve runs on: that of ``A`` (a tensor, sparse array or
    operator that has one), else of ``b`` when it is a tensor, else
    ``settings.device``."""
    if isinstance(A, (SparseArray, torch.Tensor)):
        return A.device
    dev = getattr(A, "device", None)
    if dev is None and isinstance(b, torch.Tensor):
        return b.device
    return dev if dev is not None else resolve_device()


_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _real_dtype(dt: torch.dtype) -> torch.dtype:
    return _REAL.get(dt, dt)


def _nz(t):
    """``t`` with exact zeros replaced by 1: the reference's 0/0 guards."""
    return torch.where(t == 0, torch.ones_like(t), t)


def _tested(iters: int, maxiter: int, conv_test_iters: int) -> bool:
    """The reference's test points: every ``conv_test_iters`` iterations
    and at ``maxiter - 1``."""
    return iters % conv_test_iters == 0 or iters == maxiter - 1


def _converged(r, tol2) -> bool:
    """||r||^2 < tol2, read on the host (one counted fetch)."""
    return bool(hostsync.fetch(_vdot(r, r).real < tol2))


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
    b = as_tensor(b, _operator_device(A, b))
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
        rho_f = float(hostsync.fetch(rho))
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
        if iters > 0 and _tested(iters, maxiter, conv_test_iters) and _converged(r, tol2):
            break
        z = M.matvec(r)
        rho1 = rho
        rho = _vdot(r, z)
        p = z if iters == 0 else z + (rho / _nz(rho1)) * p
        q = A.matvec(p)
        alpha = rho / _nz(_vdot(p, q))  # 0/0 guard
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
            hostsync.fetch(torch.linalg.vector_norm(r))
        ) < tol:
            break
    return x, iters


def spsolve(A, b, **kwargs):
    """Sparse solve through :func:`cg`; returns x."""
    x, _ = cg(A, b, **kwargs)
    return x


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


# ---------------------------------------------------------------------------
# CGS, BiCG, BiCGSTAB: cg's device loop, host reads at its test points
# ---------------------------------------------------------------------------
def _bicg_setup(A, b, x0, tol, maxiter):
    """The common start of cgs, bicg and bicgstab: (A as an operator, b,
    x, r = b - A x, tol^2 on the device, maxiter)."""
    b = as_tensor(b, _operator_device(A, b))
    if maxiter is None:
        maxiter = b.shape[0] * 10
    A = make_linear_operator(A)
    x = torch.zeros_like(b) if x0 is None else as_tensor(x0, b.device)
    r = b - A.matvec(x)
    tol2 = torch.tensor(tol, dtype=r.real.dtype, device=b.device) ** 2
    return A, b, x, r, tol2, maxiter


# ---------------------------------------------------------------------------
# CGS
# ---------------------------------------------------------------------------
def cgs(A, b, x0=None, tol=1e-08, maxiter=None, callback=None, conv_test_iters=25):
    """Conjugate gradient squared; returns (x, iters). Stops on absolute
    ||r|| < tol, read on the host only at ``cg``'s test points;
    ``callback(x)`` is called once, on the final iterate."""
    A, b, x, r, tol2, maxiter = _bicg_setup(A, b, x0, tol, maxiter)
    rtilde = r
    u = p = q = torch.zeros_like(b)
    rho = torch.zeros((), dtype=b.dtype, device=b.device)
    iters = 0
    while iters < maxiter:
        if iters > 0 and _tested(iters, maxiter, conv_test_iters) and _converged(r, tol2):
            break
        rho_new = _vdot(rtilde, r)
        beta = rho_new / _nz(rho)
        if iters == 0:
            u = p = r
        else:
            u = r + beta * q
            p = u + beta * (q + beta * p)
        v = A.matvec(p)
        alpha = rho_new / _nz(_vdot(rtilde, v))
        q = u - alpha * v
        uq = u + q
        x = x + alpha * uq
        r = r - alpha * A.matvec(uq)
        rho = rho_new
        iters += 1
    if callback is not None:
        callback(x)
    return x, iters


# ---------------------------------------------------------------------------
# BiCG
# ---------------------------------------------------------------------------
def bicg(A, b, x0=None, tol=1e-08, maxiter=None, callback=None, conv_test_iters=25):
    """Biconjugate gradient: one product with A and one with its adjoint
    an iteration; returns (x, iters), ``cgs``'s stopping rule."""
    A, b, x, r, tol2, maxiter = _bicg_setup(A, b, x0, tol, maxiter)
    rt = r
    p = pt = torch.zeros_like(b)
    rho = torch.zeros((), dtype=b.dtype, device=b.device)
    iters = 0
    while iters < maxiter:
        if iters > 0 and _tested(iters, maxiter, conv_test_iters) and _converged(r, tol2):
            break
        rho_new = _vdot(rt, r)
        beta = rho_new / _nz(rho)
        if iters == 0:
            p, pt = r, rt
        else:
            p, pt = r + beta * p, rt + beta * pt
        q = A.matvec(p)
        qt = A.rmatvec(pt)
        alpha = rho_new / _nz(_vdot(pt, q))  # 0/0 guard: b = 0 or an exact x0
        x = x + alpha * p
        r = r - alpha * q
        rt = rt - alpha * qt
        rho = rho_new
        iters += 1
    if callback is not None:
        callback(x)
    return x, iters


# ---------------------------------------------------------------------------
# BiCGSTAB
# ---------------------------------------------------------------------------
def bicgstab(A, b, x0=None, tol=1e-08, maxiter=None, callback=None, conv_test_iters=25):
    """BiCGStab with the reference's guards on rho, omega and <t, t>;
    returns (x, iters), ``cgs``'s stopping rule."""
    A, b, x, r, tol2, maxiter = _bicg_setup(A, b, x0, tol, maxiter)
    rtilde = r
    p = v = torch.zeros_like(b)
    rho = torch.zeros((), dtype=b.dtype, device=b.device)
    alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    iters = 0
    while iters < maxiter:
        if iters > 0 and _tested(iters, maxiter, conv_test_iters) and _converged(r, tol2):
            break
        rho_new = _vdot(rtilde, r)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = r if iters == 0 else r + beta * (p - omega * v)
        v = A.matvec(p)
        alpha = rho_new / _nz(_vdot(rtilde, v))  # 0/0 guard: b = 0 or an exact x0
        s = r - alpha * v
        t = A.matvec(s)
        omega = _vdot(t, s) / _nz(_vdot(t, t))
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        iters += 1
    if callback is not None:
        callback(x)
    return x, iters


# ---------------------------------------------------------------------------
# GMRES: restarted, Givens-rotation least squares
# ---------------------------------------------------------------------------
def gmres(A, b, x0=None, tol=1e-08, restart=None, maxiter=None, M=None, callback=None,
          atol=None):
    """Restarted GMRES (right side ``M``); returns (x, iters). Converges on
    ||r|| <= max(tol ||b||, atol). Each restart cycle runs on the device
    (:func:`_gmres_cycle`) and the host fetches one packed
    (inner steps, entry residual, breakdown) triple a cycle;
    ``callback(x)`` is called after every cycle that did work. A complex A,
    b or x0 makes the Krylov basis complex."""
    b = as_tensor(b, _operator_device(A, b))
    n = b.shape[0]
    A = make_linear_operator(A)
    M = IdentityOperator(A.shape, dtype=A.dtype) if M is None else make_linear_operator(M)
    dt = torch.promote_types(b.dtype, A.dtype)
    if x0 is not None:
        x0 = as_tensor(x0, b.device)
        dt = torch.promote_types(dt, x0.dtype)
    b = b.to(dt)
    restart = min(20 if restart is None else restart, n)
    if maxiter is None:
        maxiter = max(n // restart, 1) * 10
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    target = torch.clamp(tol * torch.linalg.vector_norm(b),
                         min=max(atol if atol is not None else 0.0, 1e-30))
    total_iters = 0
    for _outer in range(maxiter):
        x, info = _gmres_cycle(A, M, x, b, target, restart)
        # the one host fetch of the cycle
        inner, _beta, bdown = hostsync.fetch(info)
        inner = int(inner)
        if inner == 0 and not bdown:
            break  # converged on entry
        # a breakdown stage did a matvec but adds no column; count it so
        # iters reflects work and the outer loop stays bounded
        total_iters += inner + (1 if bdown else 0)
        if callback is not None:
            callback(x)
    return x, total_iters


def _gmres_cycle(A, M, x, b, target, restart: int):
    """One restart cycle with no host read: ``restart`` Arnoldi steps, each
    a fixed list of tensor ops, masked once the device flag ``done`` is set
    (converged, a breakdown, or an entry residual already at the target).
    Step j orthogonalizes against V[:j+1] by two passes of classical
    Gram-Schmidt, applies the j accumulated Givens rotations to the new
    Hessenberg column and makes rotation j; a masked triangular solve
    then updates x. Returns ``(x', info)``, ``info = [inner steps, entry
    residual norm, breakdown flag]``."""
    n = b.shape[0]
    dt, dev = b.dtype, b.device
    rdt = _real_dtype(dt)
    r = M.matvec(b - A.matvec(x))
    beta = torch.linalg.vector_norm(r)
    start_ok = beta > target
    V = torch.zeros((restart + 1, n), dtype=dt, device=dev)
    V[0] = r / torch.where(start_ok, beta, torch.ones_like(beta))
    H = torch.zeros((restart + 1, restart), dtype=dt, device=dev)
    G = torch.zeros((restart, 2, 2), dtype=dt, device=dev)  # rotation i: [c, s; -conj(s), c]
    g = torch.zeros((restart + 1,), dtype=dt, device=dev)
    g[0] = beta.to(dt)
    k = torch.zeros((), dtype=torch.int64, device=dev)
    done = ~start_ok
    bdown = torch.zeros((), dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=rdt, device=dev)
    for j in range(restart):
        active = ~done
        w = M.matvec(A.matvec(V[j]))
        Vj = V[: j + 1]
        hcol = Vj.conj() @ w
        w = w - hcol @ Vj
        h2 = Vj.conj() @ w  # one reorthogonalization pass
        w = w - h2 @ Vj
        hkk = torch.linalg.vector_norm(w)
        grew = hkk > 1e-30
        V[j + 1] = torch.where(active & grew, w / torch.where(grew, hkk, one), V[j + 1])
        col = torch.zeros((restart + 1,), dtype=dt, device=dev)
        col[: j + 1] = hcol + h2
        col[j + 1] = hkk.to(dt)
        for i in range(j):  # the accumulated rotations, in order
            col[i : i + 2] = G[i] @ col[i : i + 2]
        hk, hk1 = col[j], col[j + 1]
        ahk, ahk1 = hk.abs(), hk1.abs()
        denom = torch.sqrt(ahk * ahk + ahk1 * ahk1)
        breakdown = denom <= 0
        denom_s = torch.where(breakdown, one, denom)
        # rotation j: real c, possibly complex s
        ck = torch.where(ahk == 0, 0.0, ahk / denom_s)
        hk_unit = torch.where(ahk == 0, 1.0, hk / torch.where(ahk == 0, one, ahk))
        sk = torch.where(ahk == 0, torch.conj(hk1) / torch.where(ahk1 == 0, one, ahk1),
                         hk_unit * torch.conj(hk1) / denom_s)
        col[j] = ck * hk + sk * hk1
        col[j + 1].zero_()
        H[:, j] = torch.where(active, col, H[:, j])
        rot = torch.stack([torch.stack([ck.to(dt), sk]), torch.stack([-torch.conj(sk), ck.to(dt)])])
        G[j] = torch.where(active, rot, G[j])
        gk1 = -torch.conj(sk) * g[j]
        step = active & ~breakdown
        g_j = torch.where(step, ck * g[j], g[j])
        g[j + 1] = torch.where(step, gk1, g[j + 1])
        g[j] = g_j
        k = k + step.to(k.dtype)
        bdown = bdown | (active & breakdown)
        done = done | (active & (breakdown | (gk1.abs() < target)))
    # masked triangular solve of H[:k, :k] y = g[:k]: columns past k get a
    # unit diagonal and a zero right-hand side
    mk = (torch.arange(restart, device=dev) < k).to(rdt)
    Hs = H[:restart, :restart] * (mk[:, None] * mk[None, :]) + torch.diag(1.0 - mk).to(dt)
    y = torch.linalg.solve_triangular(Hs, (g[:restart] * mk)[:, None], upper=True)[:, 0]
    x = x + y @ V[:restart]
    return x, torch.stack([k.to(rdt), beta.to(rdt), bdown.to(rdt)])


# ---------------------------------------------------------------------------
# LSQR: Golub-Kahan bidiagonalization
# ---------------------------------------------------------------------------
def lsqr(A, b, damp=0.0, atol=1e-08, btol=1e-08, conlim=1e8, iter_lim=None, calc_var=False):
    """Golub-Kahan bidiagonalization least squares (Paige & Saunders, as in
    scipy), one ``hostsync.device_while`` loop whose scalar recurrences and
    stopping estimates stay on the device. Returns scipy's 10-tuple
    (x, istop, itn, r1norm, r2norm, anorm, acond, arnorm, xnorm, var);
    ``var`` is estimated only under ``calc_var=True`` (zeros otherwise)."""
    b = as_tensor(b, _operator_device(A, b))
    A = make_linear_operator(A)
    dt = torch.promote_types(b.dtype, A.dtype)
    b = b.to(dt)
    dev = b.device
    m, n = A.shape
    if iter_lim is None:
        iter_lim = 2 * n
    rdt = _real_dtype(dt)
    eps = float(torch.finfo(rdt).eps)

    def scalar(v):
        return torch.tensor(v, dtype=rdt, device=dev)

    dampsq = scalar(damp * damp)
    ctol = scalar(1.0 / conlim if conlim > 0 else 0.0)
    atol_d, btol_d = scalar(atol), scalar(btol)
    x0 = torch.zeros((n,), dtype=dt, device=dev)
    bnorm = torch.linalg.vector_norm(b)
    beta0 = bnorm
    ok0 = beta0 > 0
    u = b / torch.where(ok0, beta0, torch.ones_like(beta0))
    v = A.rmatvec(u)
    alpha0 = torch.linalg.vector_norm(v)
    v = v / torch.where(alpha0 > 0, alpha0, torch.ones_like(alpha0))
    zero = scalar(0.0)
    init = dict(
        x=x0, u=u, v=v, w=v, var=torch.zeros((n,), dtype=dt, device=dev),
        alpha=alpha0.to(rdt), phibar=beta0.to(rdt), rhobar=alpha0.to(rdt),
        anorm=zero, ddnorm=zero, res2=zero, xxnorm=zero, z=zero,
        cs2=scalar(-1.0), sn2=zero,
        rnorm=beta0.to(rdt), r1norm=beta0.to(rdt), xnorm=zero, acond=zero,
        arnorm=(alpha0 * beta0).to(rdt),
        itn=torch.zeros((), dtype=torch.int32, device=dev),
        istop=torch.zeros((), dtype=torch.int32, device=dev),
    )
    # degenerate entries (b == 0 or A^H b == 0): never enter the loop
    dead = ~ok0 | (init["arnorm"] == 0)
    bn = bnorm.to(rdt)

    def cond(s):
        return (s["istop"] == 0) & (s["itn"] < iter_lim) & ~dead

    def body(s):
        itn = s["itn"] + 1
        u = A.matvec(s["v"]) - s["alpha"].to(dt) * s["u"]
        beta = torch.linalg.vector_norm(u).to(rdt)
        bpos = beta > 0
        u = u / torch.where(bpos, beta, 1.0).to(dt)
        anorm = torch.where(bpos, torch.sqrt(s["anorm"] ** 2 + s["alpha"] ** 2 + beta**2 + dampsq),
                            s["anorm"])
        v_new = A.rmatvec(u) - beta.to(dt) * s["v"]
        alpha_new = torch.linalg.vector_norm(v_new).to(rdt)
        v_new = v_new / torch.where(alpha_new > 0, alpha_new, 1.0).to(dt)
        v = torch.where(bpos, v_new, s["v"])
        alpha = torch.where(bpos, alpha_new, s["alpha"])
        # eliminate the damping diagonal with its own rotation; with no
        # damping rhobar1 is rhobar (signed: sqrt would drop the sign)
        damped = dampsq > 0
        rhobar1 = torch.where(damped, torch.sqrt(s["rhobar"] ** 2 + dampsq), s["rhobar"])
        psi = torch.where(damped, (dampsq**0.5 / rhobar1) * s["phibar"], zero)
        phibar = torch.where(damped, (s["rhobar"] / rhobar1) * s["phibar"], s["phibar"])
        # plane rotation annihilating beta
        rho = torch.sqrt(rhobar1**2 + beta**2)
        cs = rhobar1 / rho
        sn = beta / rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        tau = sn * phi
        x = s["x"] + (phi / rho).to(dt) * s["w"]
        ddnorm = s["ddnorm"] + _vdot(s["w"], s["w"]).real.to(rdt) / rho**2
        var = s["var"] + (s["w"] / rho.to(dt)) ** 2 if calc_var else s["var"]
        w = v - (theta / rho).to(dt) * s["w"]
        # estimates of ||x||, cond(A) and the residual norms
        delta = s["sn2"] * rho
        gambar = -s["cs2"] * rho
        rhs = phi - delta * s["z"]
        zbar = rhs / gambar
        xnorm = torch.sqrt(s["xxnorm"] + zbar**2)
        gamma = torch.sqrt(gambar**2 + theta**2)
        cs2 = gambar / gamma
        sn2 = theta / gamma
        z = rhs / gamma
        xxnorm = s["xxnorm"] + z**2
        acond = anorm * torch.sqrt(ddnorm)
        res2 = s["res2"] + psi**2
        rnorm = torch.sqrt(phibar**2 + res2)
        arnorm = alpha * torch.abs(tau)
        r1sq = rnorm**2 - dampsq * xxnorm
        r1norm = torch.sqrt(torch.abs(r1sq)) * torch.where(r1sq >= 0, 1.0, -1.0).to(rdt)
        # scipy's tests, later ones taking priority
        test1 = rnorm / bn
        test2 = arnorm / (anorm * rnorm + eps)
        test3 = 1.0 / (acond + eps)
        t1 = test1 / (1 + anorm * xnorm / bn)
        rtol = btol_d + atol_d * anorm * xnorm / bn
        istop = torch.zeros_like(s["istop"])
        istop = torch.where(itn >= iter_lim, 7, istop)
        istop = torch.where(1 + test3 <= 1, 6, istop)
        istop = torch.where(1 + test2 <= 1, 5, istop)
        istop = torch.where(1 + t1 <= 1, 4, istop)
        istop = torch.where(test3 <= ctol, 3, istop)
        istop = torch.where(test2 <= atol_d, 2, istop)
        istop = torch.where(test1 <= rtol, 1, istop)
        return dict(
            x=x, u=u, v=v, w=w, var=var, alpha=alpha, phibar=phibar, rhobar=rhobar,
            anorm=anorm, ddnorm=ddnorm, res2=res2, xxnorm=xxnorm, z=z, cs2=cs2, sn2=sn2,
            rnorm=rnorm, r1norm=r1norm, xnorm=xnorm, acond=acond, arnorm=arnorm,
            itn=itn, istop=istop,
        )

    def stats(s):
        return (s["istop"], s["itn"], s["r1norm"], s["rnorm"], s["anorm"], s["acond"],
                s["arnorm"], s["xnorm"], dead, bn)

    out, _, st = hostsync.device_while(cond, body, init, iter_lim, stats=stats)
    if st[8]:  # degenerate: b == 0 or A^H b == 0
        r0 = float(st[9])
        return x0, 0, 0, r0, r0, 0.0, 0.0, 0.0, 0.0, init["var"]
    return (out["x"], int(st[0]), int(st[1]), float(st[2]), float(st[3]), float(st[4]),
            float(st[5]), float(st[6]), float(st[7]), out["var"])


# ---------------------------------------------------------------------------
# MINRES / LSMR / TFQMR / QMR: one device loop each
# ---------------------------------------------------------------------------
def _sym_ortho(a, b):
    """Stable Givens (c, s, r) with r = hypot(a, b); c = 1, s = 0 when
    r = 0. Scaled like hypot, so squaring cannot overflow in f32."""
    scale = torch.maximum(torch.abs(a), torch.abs(b))
    an, bn = a / _nz(scale), b / _nz(scale)
    r = scale * torch.sqrt(an * an + bn * bn)
    safe = _nz(r)
    return torch.where(r == 0, 1.0, a / safe), torch.where(r == 0, 0.0, b / safe), r


def minres(A, b, x0=None, shift=0.0, tol=1e-5, maxiter=None, M=None, callback=None,
           conv_test_iters=1):
    """MINRES for symmetric, possibly indefinite systems (A - shift I) x = b,
    ``M`` a symmetric positive-definite preconditioner (scipy semantics).
    Converges on the M-preconditioned residual estimate
    <= tol ||b||, tested every ``conv_test_iters`` iterations. Returns
    (x, iters)."""
    b = as_tensor(b, _operator_device(A, b))
    n = b.shape[0]
    if maxiter is None:
        maxiter = 5 * n
    A = make_linear_operator(A)
    dt = torch.promote_types(b.dtype, A.dtype)
    b = b.to(dt)
    dev = b.device
    rdt = _real_dtype(dt)
    x = torch.zeros_like(b) if x0 is None else as_tensor(x0, dev).to(dt)
    shift_d = torch.tensor(shift, dtype=dt, device=dev)
    Mop = None if M is None else make_linear_operator(M)

    def op(v):
        return A.matvec(v) - shift_d * v

    def precond(v):
        return v if Mop is None else Mop.matvec(v)

    r1 = b - op(x)
    y1 = precond(r1)
    b1sq = _vdot(r1, y1).real
    beta1 = torch.sqrt(torch.clamp(b1sq, min=0)).to(rdt)
    bnorm = torch.sqrt(_vdot(b, b).real).to(rdt)
    # relative to ||b||, not ||r0||: a warm x0 must not tighten the target
    tiny = float(torch.finfo(rdt).tiny)
    target = torch.tensor(tol, dtype=rdt, device=dev) * torch.clamp(bnorm, min=tiny)
    zero = torch.zeros((), dtype=rdt, device=dev)
    zvec = torch.zeros_like(b)
    init = dict(
        x=x, r1=r1, r2=r1, y=y1, w=zvec, w2=zvec,
        oldb=zero, beta=beta1, dbar=zero, epsln=zero, phibar=beta1,
        cs=torch.tensor(-1.0, dtype=rdt, device=dev), sn=zero,
        itn=torch.zeros((), dtype=torch.int32, device=dev),
    )
    dead = (beta1 == 0) | (bnorm == 0)
    b1sq_h, bnorm_h = hostsync.fetch(torch.stack([b1sq.to(rdt), bnorm]))
    if Mop is not None and b1sq_h < 0:
        raise ValueError("minres: indefinite preconditioner")
    if x0 is not None and bnorm_h == 0:
        # b == 0: the solution of A x = 0 is x = 0 (scipy), not x0
        return torch.zeros_like(b), 0

    def cond(s):
        tested = ((s["itn"] % conv_test_iters) == 0) | (s["itn"] >= maxiter)
        converged = tested & (s["itn"] > 0) & (s["phibar"] <= target)
        return (s["itn"] < maxiter) & ~converged & ~dead

    def body(s):
        itn = s["itn"] + 1
        beta = s["beta"]
        v = s["y"] / _nz(beta).to(dt)
        y = op(v)
        y = torch.where(itn >= 2, y - (beta / _nz(s["oldb"])).to(dt) * s["r1"], y)
        alfa = _vdot(v, y).real.to(rdt)
        y = y - (alfa / _nz(beta)).to(dt) * s["r2"]
        r1_n, r2_n = s["r2"], y
        y_n = precond(y)
        oldb = beta
        beta_n = torch.sqrt(torch.clamp(_vdot(y, y_n).real, min=0)).to(rdt)
        # the previous rotation on the new column of T
        oldeps = s["epsln"]
        delta = s["cs"] * s["dbar"] + s["sn"] * alfa
        gbar = s["sn"] * s["dbar"] - s["cs"] * alfa
        epsln = s["sn"] * beta_n
        dbar = -s["cs"] * beta_n
        # the current rotation
        cs, sn, gamma = _sym_ortho(gbar, beta_n)
        gamma = torch.clamp(gamma, min=tiny)
        phi = cs * s["phibar"]
        phibar = sn * s["phibar"]
        w1, w2 = s["w2"], s["w"]
        w = (v - oldeps.to(dt) * w1 - delta.to(dt) * w2) / gamma.to(dt)
        return dict(
            x=s["x"] + phi.to(dt) * w, r1=r1_n, r2=r2_n, y=y_n, w=w, w2=w2,
            oldb=oldb, beta=beta_n, dbar=dbar, epsln=epsln, phibar=phibar, cs=cs, sn=sn,
            itn=itn,
        )

    out, itn, _ = hostsync.device_while(cond, body, init, maxiter, callback=callback)
    return out["x"], itn


def lsmr(A, b, damp=0.0, atol=1e-6, btol=1e-6, conlim=1e8, maxiter=None, x0=None):
    """LSMR (Fong & Saunders): least squares by Golub-Kahan
    bidiagonalization with a MINRES-shaped recurrence, one
    ``hostsync.device_while`` loop. Returns scipy's 8-tuple
    (x, istop, itn, normr, normar, norma, conda, normx). With ``x0`` the
    bidiagonalization starts from b - A x0 (the stopping norms then
    describe that residual system)."""
    b = as_tensor(b, _operator_device(A, b))
    A = make_linear_operator(A)
    dt = torch.promote_types(b.dtype, A.dtype)
    b = b.to(dt)
    dev = b.device
    m, n = A.shape
    if maxiter is None:
        maxiter = min(m, n) * 5
    rdt = _real_dtype(dt)

    def scalar(v):
        return torch.tensor(v, dtype=rdt, device=dev)

    damp_d = scalar(damp)
    ctol = scalar(1.0 / conlim if conlim > 0 else 0.0)
    atol_d, btol_d = scalar(atol), scalar(btol)
    x_off = None if x0 is None else as_tensor(x0, dev).to(dt)
    if x_off is not None:
        b = b - A.matvec(x_off)
    normb = torch.linalg.vector_norm(b).to(rdt)
    beta = normb
    u = b / torch.where(beta > 0, beta, 1.0).to(dt)
    v = torch.where(beta > 0, A.rmatvec(u), torch.zeros((n,), dtype=dt, device=dev))
    alpha = torch.linalg.vector_norm(v).to(rdt)
    v = v / torch.where(alpha > 0, alpha, 1.0).to(dt)
    zero, one = scalar(0.0), scalar(1.0)
    init = dict(
        x=torch.zeros((n,), dtype=dt, device=dev), u=u, v=v,
        h=v, hbar=torch.zeros((n,), dtype=dt, device=dev),
        alpha=alpha, beta=beta, alphabar=alpha, zetabar=alpha * beta,
        rho=one, rhobar=one, cbar=one, sbar=zero, zeta=zero,
        # the residual-estimate recurrence (Fong & Saunders section 5)
        betadd=beta, betad=zero, rhodold=one, tautildeold=zero, thetatilde=zero, d=zero,
        norma2=alpha * alpha, maxrbar=zero, minrbar=scalar(torch.finfo(rdt).max),
        normr=beta, normar=alpha * beta, norma=alpha, conda=one, normx=zero,
        itn=torch.zeros((), dtype=torch.int32, device=dev),
        istop=torch.zeros((), dtype=torch.int32, device=dev),
    )
    dead = (normb == 0) | (init["normar"] == 0)
    normb_s = _nz(normb)

    def cond(s):
        return (s["istop"] == 0) & (s["itn"] < maxiter) & ~dead

    def body(s):
        itn = s["itn"] + 1
        u = A.matvec(s["v"]) - s["alpha"].to(dt) * s["u"]
        beta = torch.linalg.vector_norm(u).to(rdt)
        u = u / torch.where(beta > 0, beta, 1.0).to(dt)
        v = A.rmatvec(u) - beta.to(dt) * s["v"]
        alpha = torch.linalg.vector_norm(v).to(rdt)
        v = v / torch.where(alpha > 0, alpha, 1.0).to(dt)
        # rotation P-hat eliminates the damping
        chat, shat, alphahat = _sym_ortho(s["alphabar"], damp_d)
        # rotation P
        rhoold = s["rho"]
        c, sgiv, rho = _sym_ortho(alphahat, beta)
        thetanew = sgiv * alpha
        alphabar = c * alpha
        # rotation P-bar
        rhobarold = s["rhobar"]
        zetaold = s["zeta"]
        thetabar = s["sbar"] * rho
        rhotemp = s["cbar"] * rho
        cbar, sbar, rhobar = _sym_ortho(s["cbar"] * rho, thetanew)
        zeta = cbar * s["zetabar"]
        zetabar = -sbar * s["zetabar"]
        # h, hbar, x
        hbar = s["h"] - (thetabar * rho / _nz(rhoold * rhobarold)).to(dt) * s["hbar"]
        x = s["x"] + (zeta / _nz(rho * rhobar)).to(dt) * hbar
        h = v - (thetanew / _nz(rho)).to(dt) * s["h"]
        # the ||r|| estimate
        betaacute = chat * s["betadd"]
        betacheck = -shat * s["betadd"]
        betahat = c * betaacute
        betadd = -sgiv * betaacute
        thetatildeold = s["thetatilde"]
        ctildeold, stildeold, rhotildeold = _sym_ortho(s["rhodold"], thetabar)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * s["betad"] + ctildeold * betahat
        tautildeold = (zetaold - thetatildeold * s["tautildeold"]) / _nz(rhotildeold)
        taud = (zeta - thetatilde * tautildeold) / _nz(rhodold)
        d = s["d"] + betacheck * betacheck
        normr = torch.sqrt(d + (betad - taud) ** 2 + betadd * betadd)
        norma2 = s["norma2"] + beta * beta
        norma = torch.sqrt(norma2)
        norma2 = norma2 + alpha * alpha
        normar = torch.abs(zetabar)
        maxrbar = torch.maximum(s["maxrbar"], rhobarold)
        minrbar = torch.where(itn > 1, torch.minimum(s["minrbar"], rhobarold), s["minrbar"])
        conda = torch.maximum(maxrbar, rhotemp) / _nz(torch.minimum(minrbar, rhotemp))
        normx = torch.linalg.vector_norm(x).to(rdt)
        # scipy's istop 1-7
        test1 = normr / normb_s
        test2 = normar / _nz(norma * normr)
        test3 = 1.0 / _nz(conda)
        t1 = test1 / (1 + norma * normx / normb_s)
        rtol = btol_d + atol_d * norma * normx / normb_s
        istop = torch.zeros_like(s["istop"])
        istop = torch.where(itn >= maxiter, 7, istop)
        istop = torch.where(1 + test3 <= 1, 6, istop)
        istop = torch.where(1 + test2 <= 1, 5, istop)
        istop = torch.where(1 + t1 <= 1, 4, istop)
        istop = torch.where(test3 <= ctol, 3, istop)
        istop = torch.where(test2 <= atol_d, 2, istop)
        istop = torch.where(test1 <= rtol, 1, istop)
        return dict(
            x=x, u=u, v=v, h=h, hbar=hbar, alpha=alpha, beta=beta, alphabar=alphabar,
            zetabar=zetabar, rho=rho, rhobar=rhobar, cbar=cbar, sbar=sbar, zeta=zeta,
            betadd=betadd, betad=betad, rhodold=rhodold, tautildeold=tautildeold,
            thetatilde=thetatilde, d=d, norma2=norma2, maxrbar=maxrbar, minrbar=minrbar,
            normr=normr, normar=normar, norma=norma, conda=conda, normx=normx,
            itn=itn, istop=istop,
        )

    def stats(s):
        normx = s["normx"] if x_off is None else torch.linalg.vector_norm(s["x"] + x_off)
        return (s["istop"], s["itn"], s["normr"], s["normar"], s["norma"], s["conda"], normx)

    out, _, st = hostsync.device_while(cond, body, init, maxiter, stats=stats)
    x = out["x"] if x_off is None else out["x"] + x_off
    return (x, int(st[0]), int(st[1]), float(st[2]), float(st[3]), float(st[4]), float(st[5]),
            float(st[6]))


def tfqmr(A, b, x0=None, tol=1e-8, maxiter=None, M=None, callback=None, atol=0.0):
    """Transpose-free QMR (Freund 1993; scipy semantics): one matvec a
    half-iteration, the even and odd halves merged with ``torch.where`` in
    one ``hostsync.device_while`` loop. ``M`` is a left preconditioner (solves
    M A x = M b); converges on tau sqrt(m + 1) <= max(atol, tol ||M r0||).
    Returns (x, iters)."""
    b = as_tensor(b, _operator_device(A, b))
    n = b.shape[0]
    if maxiter is None:
        maxiter = 2 * n * 10
    A = make_linear_operator(A)
    dt = torch.promote_types(b.dtype, A.dtype)
    b = b.to(dt)
    dev = b.device
    rdt = _real_dtype(dt)
    x = torch.zeros_like(b) if x0 is None else as_tensor(x0, dev).to(dt)
    Mop = None if M is None else make_linear_operator(M)

    def opmv(v):
        av = A.matvec(v)
        return av if Mop is None else Mop.matvec(av)

    r = b - A.matvec(x)
    if Mop is not None:
        r = Mop.matvec(r)
    r0norm = torch.sqrt(_vdot(r, r).real).to(rdt)
    target = torch.clamp(torch.tensor(tol, dtype=rdt, device=dev) * r0norm, min=float(atol))
    uhat0 = opmv(r)
    init = dict(
        x=x, u=r, w=r, v=uhat0, uhat=uhat0, d=torch.zeros_like(b),
        rho=_vdot(r, r), alpha=torch.ones((), dtype=dt, device=dev),
        theta=torch.zeros((), dtype=rdt, device=dev), eta=torch.zeros((), dtype=dt, device=dev),
        tau=r0norm, m=torch.zeros((), dtype=torch.int32, device=dev),
    )
    dead = r0norm == 0

    def cond(s):
        converged = s["tau"] * torch.sqrt(s["m"].to(rdt) + 1) <= target
        return (s["m"] < maxiter) & ~converged & ~dead

    def body(s):
        even = (s["m"] % 2) == 0
        vtr = _vdot(r, s["v"])  # r is r* (the frozen shadow residual)
        alpha = torch.where(even, s["rho"] / _nz(vtr), s["alpha"])
        u_even = s["u"] - alpha * s["v"]
        w_n = s["w"] - alpha * s["uhat"]
        d_n = s["u"] + ((s["theta"] ** 2).to(dt) / _nz(alpha)) * s["eta"] * s["d"]
        wnorm = torch.sqrt(_vdot(w_n, w_n).real).to(rdt)
        theta_n = wnorm / _nz(s["tau"])
        c2 = 1.0 / (1.0 + theta_n * theta_n)
        tau_n = s["tau"] * theta_n * torch.sqrt(c2)
        eta_n = c2.to(dt) * alpha
        x_n = s["x"] + eta_n * d_n
        # the odd half: new rho and beta, u, v
        rho_new = _vdot(r, w_n)
        beta = rho_new / _nz(s["rho"])
        u_odd = w_n + beta * s["u"]
        v_partial = beta * s["uhat"] + beta * beta * s["v"]
        u_n = torch.where(even, u_even, u_odd)
        uhat_n = opmv(u_n)
        return dict(
            x=x_n, u=u_n, w=w_n, v=torch.where(even, s["v"], v_partial + uhat_n), uhat=uhat_n,
            d=d_n, rho=torch.where(even, s["rho"], rho_new), alpha=alpha, theta=theta_n,
            eta=eta_n, tau=tau_n, m=s["m"] + 1,
        )

    out, m, _ = hostsync.device_while(cond, body, init, maxiter, count="m", callback=callback)
    return out["x"], m


def qmr(A, b, x0=None, tol=1e-8, maxiter=None, M1=None, M2=None, callback=None,
        conv_test_iters=25):
    """Quasi-minimal residual (Freund & Nachtigal, no look-ahead; the
    Templates formulation scipy implements): one product with A and one
    with its adjoint an iteration. ``M1``/``M2`` are the left and right
    preconditioner factors, operators that apply the inverse (their
    ``rmatvec`` the inverse adjoint). Converges on ||r|| <= tol ||b||,
    tested every ``conv_test_iters`` iterations. Returns (x, iters)."""
    b = as_tensor(b, _operator_device(A, b))
    n = b.shape[0]
    if maxiter is None:
        maxiter = n * 10
    A = make_linear_operator(A)
    dt = torch.promote_types(b.dtype, A.dtype)
    b = b.to(dt)
    dev = b.device
    rdt = _real_dtype(dt)
    x = torch.zeros_like(b) if x0 is None else as_tensor(x0, dev).to(dt)
    M1op = None if M1 is None else make_linear_operator(M1)
    M2op = None if M2 is None else make_linear_operator(M2)

    def m1(v):
        return v if M1op is None else M1op.matvec(v)

    def m1h(v):
        return v if M1op is None else M1op.rmatvec(v)

    def m2(v):
        return v if M2op is None else M2op.matvec(v)

    def m2h(v):
        return v if M2op is None else M2op.rmatvec(v)

    r = b - A.matvec(x)
    tol2 = torch.tensor(tol, dtype=rdt, device=dev) ** 2 * _vdot(b, b).real
    y0 = m1(r)
    z0 = m2h(r)
    rho0 = torch.sqrt(_vdot(y0, y0).real).to(rdt)
    xi0 = torch.sqrt(_vdot(z0, z0).real).to(rdt)
    zvec = torch.zeros_like(b)
    init = dict(
        x=x, r=r, vtilde=r, wtilde=r, y=y0, z=z0, p=zvec, q=zvec, d=zvec, s=zvec,
        rho=rho0, xi=xi0, gamma=torch.ones((), dtype=rdt, device=dev),
        eta=torch.tensor(-1.0, dtype=dt, device=dev), theta=torch.zeros((), dtype=rdt, device=dev),
        epsq=torch.ones((), dtype=dt, device=dev), itn=torch.zeros((), dtype=torch.int32, device=dev),
    )
    dead = rho0 == 0

    def cond(s):
        tested = ((s["itn"] % conv_test_iters) == 0) | (s["itn"] >= maxiter)
        converged = tested & (s["itn"] > 0) & (_vdot(s["r"], s["r"]).real <= tol2)
        return (s["itn"] < maxiter) & ~converged & ~dead

    def body(s):
        itn = s["itn"] + 1
        rho_c, xi_c = _nz(s["rho"]).to(dt), _nz(s["xi"]).to(dt)
        v = s["vtilde"] / rho_c
        yn = s["y"] / rho_c
        w = s["wtilde"] / xi_c
        zn = s["z"] / xi_c
        delta = _vdot(zn, yn)
        eps_c = _nz(s["epsq"])
        first = itn == 1
        pcoef = torch.where(first, 0.0, s["xi"].to(dt) * delta / eps_c)
        qcoef = torch.where(first, 0.0, s["rho"].to(dt) * delta / eps_c)
        p = m2(yn) - pcoef * s["p"]
        q = m1h(zn) - qcoef * s["q"]
        ptilde = A.matvec(p)
        epsq = _vdot(q, ptilde)
        beta = epsq / _nz(delta)
        vtilde = ptilde - beta * v
        y_new = m1(vtilde)
        rho_new = torch.sqrt(_vdot(y_new, y_new).real).to(rdt)
        wtilde = A.rmatvec(q) - torch.conj(beta) * w
        z_new = m2h(wtilde)
        xi_new = torch.sqrt(_vdot(z_new, z_new).real).to(rdt)
        absbeta = torch.abs(beta).to(rdt)
        theta_new = rho_new / _nz(s["gamma"] * absbeta)
        gamma_new = 1.0 / torch.sqrt(1.0 + theta_new * theta_new)
        eta_new = (-s["eta"] * s["rho"].to(dt) * (gamma_new * gamma_new).to(dt)
                   / _nz(beta * (s["gamma"] * s["gamma"]).to(dt)))
        tg2 = ((s["theta"] * gamma_new) ** 2).to(dt)
        later = torch.where(first, 0.0, 1.0)
        d = eta_new * p + later * tg2 * s["d"]
        snew = eta_new * ptilde + later * tg2 * s["s"]
        return dict(
            x=s["x"] + d, r=s["r"] - snew, vtilde=vtilde, wtilde=wtilde, y=y_new, z=z_new,
            p=p, q=q, d=d, s=snew, rho=rho_new, xi=xi_new, gamma=gamma_new, eta=eta_new,
            theta=theta_new, epsq=epsq, itn=itn,
        )

    out, itn, _ = hostsync.device_while(cond, body, init, maxiter, callback=callback)
    return out["x"], itn


# ---------------------------------------------------------------------------
# LGMRES / GCROT(m, k): augmented-subspace Krylov. Both share one cycle:
# a Krylov basis, augmented with recycled directions (which carry their
# A-images, so augmentation costs no matvec), and one minimal-residual
# least squares over the whole block
# ---------------------------------------------------------------------------
def _lstsq_min_norm(AZ, r):
    """The minimum-norm y of min ||r - AZ y||, with singular values below
    eps * max(n, K) * sigma_max cut (the reference's default ``lstsq``
    rule, eps of AZ's dtype). A reduced QR of the tall AZ (n x K) runs on
    its device; the small R and Q^H r move to the host, where an SVD
    solves R y = Q^H r (R has AZ's singular values)."""
    n, K = AZ.shape
    Q, R = torch.linalg.qr(AZ)
    Rh = hostsync.fetch(torch.cat([R, (Q.conj().T @ r)[:, None]], dim=1))
    R, c = Rh[:, :K], Rh[:, K]
    U, sv, Vh = np.linalg.svd(R)
    keep = (sv > 0) & (sv >= np.finfo(sv.dtype).eps * max(n, K) * sv[0])
    coef = (U.conj().T @ c) / np.where(keep, sv, 1)
    y = Vh.conj().T @ np.where(keep, coef, 0)
    return torch.from_numpy(np.ascontiguousarray(y)).to(device=AZ.device, dtype=AZ.dtype)


def _augmented_cycle(A, Mop, r, inner_m, aug):
    """One cycle: Krylov directions from r (right-preconditioned) plus
    ``aug``, a list of (z, Az) pairs. Returns (dx, A dx) minimizing
    ||r - A dx|| over the augmented subspace. The directions are rows of
    preallocated [K, n] blocks, so no step restacks the basis."""
    n = r.shape[0]
    inner_m = max(1, min(int(inner_m), n - len(aug)))  # subspace <= n
    K = inner_m + len(aug)
    V = torch.empty((inner_m + 1, n), dtype=r.dtype, device=r.device)
    Z = torch.empty((K, n), dtype=r.dtype, device=r.device)
    AZ = torch.empty((K, n), dtype=r.dtype, device=r.device)
    rnorm = torch.linalg.vector_norm(r)
    V[0] = r / _nz(rnorm)
    j = 0
    while j < inner_m:
        Z[j] = Mop.matvec(V[j]) if Mop is not None else V[j]
        w = A.matvec(Z[j])
        AZ[j] = w
        j += 1
        Vj = V[:j]
        for _ in range(2):  # two passes of Gram-Schmidt against the basis
            w = w - (Vj.conj() @ w) @ Vj
        wn = torch.linalg.vector_norm(w)
        wn_h, rn_h = hostsync.fetch(torch.stack([wn, rnorm]))
        if float(wn_h) <= 1e-12 * float(rn_h):
            break  # breakdown: the subspace is invariant
        V[j] = w / wn
    for i, (z, az) in enumerate(aug):
        Z[j + i], AZ[j + i] = z, az
    Z, AZ = Z[: j + len(aug)], AZ[: j + len(aug)]
    y = _lstsq_min_norm(AZ.T, r)
    return y @ Z, y @ AZ


def _norm_h(v) -> float:
    """||v|| on the host (one counted fetch)."""
    return float(hostsync.fetch(torch.linalg.vector_norm(v)))


def _augmented_setup(A, b, x0, M):
    b = as_tensor(b, _operator_device(A, b))
    A = make_linear_operator(A)
    dt = torch.promote_types(b.dtype, A.dtype)
    if x0 is not None:
        x0 = as_tensor(x0, b.device)
        dt = torch.promote_types(dt, x0.dtype)
    b = b.to(dt)
    Mop = None if M is None else make_linear_operator(M)
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    return A, b, x, Mop


def lgmres(A, b, x0=None, tol=1e-5, atol=0.0, maxiter=1000, M=None, callback=None,
           inner_m=30, outer_k=3):
    """LGMRES (Baker, Jessup & Manteuffel; scipy semantics): restarted GMRES
    whose restart space is augmented with the last ``outer_k`` corrections.
    Converges on ||r|| <= max(atol, tol ||b||); ``callback(x)`` after every
    outer cycle. Returns (x, info): 0 on convergence, else ``maxiter``."""
    A, b, x, Mop = _augmented_setup(A, b, x0, M)
    bnorm = _norm_h(b)
    target = max(float(atol), float(tol) * (bnorm if bnorm > 0 else 1.0))
    aug = []  # (z, Az) correction pairs, newest first
    for _ in range(int(maxiter)):
        r = b - A.matvec(x)
        if _norm_h(r) <= target:
            return x, 0
        dx, adx = _augmented_cycle(A, Mop, r, int(inner_m), aug)
        x = x + dx
        if callback is not None:
            callback(x)
        dn = torch.linalg.vector_norm(dx)
        if int(outer_k) > 0 and float(hostsync.fetch(dn)) > 0:
            # adx is A dx from the cycle's own images: no extra matvec
            aug = [(dx / dn, adx / dn)] + aug[: int(outer_k) - 1]
    return x, (0 if _norm_h(b - A.matvec(x)) <= target else int(maxiter))


def gcrotmk(A, b, x0=None, tol=1e-5, atol=0.0, maxiter=1000, M=None, callback=None, m=20,
            k=None, truncate="oldest"):
    """GCROT(m, k) (Hicken & Zingg, de Sturler; scipy semantics): GMRES(m)
    with a recycled subspace U whose images C = A U are kept orthonormal;
    each cycle first projects the residual onto C. ``truncate`` ('oldest'
    or 'smallest') picks the pair dropped past ``k``. Returns (x, info),
    0 on convergence."""
    if k is None:
        k = m
    if truncate not in ("oldest", "smallest"):
        raise ValueError("truncate must be 'oldest' or 'smallest'")
    A, b, x, Mop = _augmented_setup(A, b, x0, M)
    bnorm = _norm_h(b)
    target = max(float(atol), float(tol) * (bnorm if bnorm > 0 else 1.0))
    recycled = []  # (u, c) with c = A u / ||A u||, newest last
    for _ in range(int(maxiter)):
        r = b - A.matvec(x)
        # oblique projection onto the recycled image space
        for u, c in recycled:
            alpha = _vdot(c, r)
            x = x + alpha * u
            r = r - alpha * c
        if _norm_h(r) <= target:
            return x, 0
        dx, adx = _augmented_cycle(A, Mop, r, int(m), list(recycled))
        x = x + dx
        if callback is not None:
            callback(x)
        # keep C orthonormal: Gram-Schmidt the new image against the kept
        # ones, the same combination applied to u so that c == A u holds
        unew, cnew = dx, adx
        for u, c in recycled:
            beta = _vdot(c, cnew)
            cnew = cnew - beta * c
            unew = unew - beta * u
        an = torch.linalg.vector_norm(cnew)
        if float(hostsync.fetch(an)) > 1e-12:
            recycled.append((unew / an, cnew / an))
            if len(recycled) > int(k):
                if truncate == "oldest":
                    recycled = recycled[1:]
                else:
                    # 'smallest': drop the image least aligned with the
                    # current correction (the newest pair is always kept)
                    scores = np.abs(hostsync.fetch(torch.stack([_vdot(c, adx) for _, c in
                                                             recycled[:-1]])))
                    drop = int(np.argmin(scores))
                    recycled = recycled[:drop] + recycled[drop + 1:]
    return x, (0 if _norm_h(b - A.matvec(x)) <= target else int(maxiter))


# ---------------------------------------------------------------------------
# eigsh: thick-restart Lanczos with full reorthogonalization
# ---------------------------------------------------------------------------
def _lanczos_factorization(A, V0, start, ncv, rng):
    """Continue a Lanczos factorization from row ``start`` of ``V0``.

    Rows 0..start of ``V0`` are orthonormal: the locked (thick) Ritz block
    and the restart residual direction at ``start`` (plain Lanczos is
    ``start == 0``). Full reorthogonalization against every earlier row
    makes the thick-restart couplings implicit: the recurrence only sees
    alpha and beta. The ``ncv - start`` steps run on the device
    (:func:`_lanczos_device`, in place on ``V0``); the host reads the
    stacked (alphas, betas) once, which the projected eigh needs anyway. A
    breakdown (an invariant subspace, beta < 1e-12) is redone step by step
    (:func:`_lanczos_redo`) with a random restart vector.

    Returns (V, alphas, betas, vres, nmv): ``vres`` the normalized
    (ncv+1)-th vector (the next cycle's restart direction) and ``nmv`` the
    operator applications made."""
    head = V0[: start + 1].clone()
    V, alphas, betas, vres = _lanczos_device(A, V0, start, ncv)
    ab = hostsync.fetch(torch.stack([alphas, betas]))  # the one fetch a cycle
    alphas, betas = ab[0].astype(np.float64), ab[1].astype(np.float64)
    if ncv - start > 1 and float(np.min(betas[start: ncv - 1])) < 1e-12:
        V[: start + 1] = head
        V[start + 1:] = 0
        out = _lanczos_redo(A, V, start, ncv, rng)
        return (*out, 2 * (ncv - start))
    return V, alphas, betas, vres, ncv - start


def _lanczos_device(A, V, start: int, ncv: int):
    """Lanczos steps ``start..ncv-1`` on the device with no host read,
    writing the new basis rows into ``V`` [ncv, n]."""
    dt = V.dtype
    rdt = _real_dtype(dt)
    alphas = torch.zeros((ncv,), dtype=rdt, device=V.device)
    betas = torch.zeros((ncv,), dtype=rdt, device=V.device)
    vres = torch.zeros_like(V[0])
    for j in range(start, ncv):
        w = A.matvec(V[j])
        a = _vdot(V[j], w).real.to(rdt)
        alphas[j] = a
        w = w - a.to(dt) * V[j]
        if j > start:
            w = w - betas[j - 1].to(dt) * V[j - 1]
        Vj = V[: j + 1]
        w = w - (Vj.conj() @ w) @ Vj  # full reorthogonalization (+ thick couplings)
        bnorm = torch.linalg.vector_norm(w).to(rdt)
        betas[j] = bnorm
        nxt = w / torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm)).to(dt)
        if j + 1 < ncv:
            V[j + 1] = nxt
        else:
            vres = nxt
    return V, alphas, betas, vres


def _lanczos_redo(A, V, start: int, ncv: int, rng):
    """The steps of :func:`_lanczos_device` driven from the host, a fetch
    a step: on a breakdown the next row is a random vector (from ``rng``)
    orthogonalized against the basis, and its beta is 0."""
    alphas = np.zeros((ncv,))
    betas = np.zeros((ncv,))
    vres = torch.zeros_like(V[0])
    n = V.shape[1]
    for j in range(start, ncv):
        w = A.matvec(V[j])
        a = float(hostsync.fetch(_vdot(V[j], w).real))
        alphas[j] = a
        w = w - a * V[j]
        if j > start:
            w = w - betas[j - 1] * V[j - 1]
        Vj = V[: j + 1]
        w = w - (Vj.conj() @ w) @ Vj
        bnorm = float(hostsync.fetch(torch.linalg.vector_norm(w)))
        betas[j] = bnorm
        if bnorm < 1e-12:
            vv = hostsync.upload(rng.standard_normal(n), V.device).to(V.dtype)
            vv = vv - (Vj.conj() @ vv) @ Vj
            vv = vv / torch.linalg.vector_norm(vv)
            betas[j] = 0.0
            nxt = vv
        else:
            nxt = w / bnorm
        if j + 1 < ncv:
            V[j + 1] = nxt
        else:
            vres = nxt
    return V, alphas, betas, vres


def _select_ritz(w_all, which, k):
    if which in ("LM", "LA"):
        sel = np.argsort(np.abs(w_all) if which == "LM" else w_all)[::-1][:k]
    elif which in ("SM", "SA"):
        sel = np.argsort(np.abs(w_all) if which == "SM" else w_all)[:k]
    else:
        raise ValueError(f"unknown which={which}")
    return np.sort(sel)


def eigsh(A, k=6, which="LM", v0=None, maxiter=None, tol=0.0, return_eigenvectors=True,
          _stats=None):
    """Symmetric (Hermitian) eigenpairs by thick-restart Lanczos (Wu &
    Simon) with full reorthogonalization, on the operator's device.

    Each cycle continues the factorization past the locked Ritz block
    (:func:`_lanczos_factorization`: ``ncv - l`` steps on the device, one
    host fetch); the projected matrix, diag(locked thetas) + an arrowhead
    of couplings + the new tridiagonal block, is solved on the host. The
    Ritz residual estimates |beta_m s[last]| gate convergence against
    ``tol`` (0: 10 eps of the basis dtype) relative to the largest |theta|,
    up to ``maxiter`` operator applications; a cycle whose worst residual
    fails to halve doubles ``ncv``. The basis dtype is
    result_type(A, v0, float32), and the start vector is
    ``np.random.default_rng(0)``'s. The host's arrays (the start vector,
    the restart's Ritz coefficients) reach the device through
    :func:`hostsync.upload`, so a cycle waits on the device only at its
    fetch. Returns (w, V), w ascending in the
    selected order as host numpy and V [n, k] on the device. A ``_stats``
    dict receives the cycles, operator applications, final ``ncv`` and the
    last cycle's residual estimates of the returned pairs."""
    A = make_linear_operator(A)
    dev = _operator_device(A, v0)
    n = A.shape[0]
    k = min(k, n - 1) if n > 1 else 1
    ncv = min(max(2 * k + 1, 20), n)
    if maxiter is None:
        maxiter = 10 * n
    rng = np.random.default_rng(0)
    # a Hermitian complex A needs a complex basis: a real one would
    # project onto Re(A)'s action
    dt = torch.promote_types(A.dtype, torch.float32)
    if v0 is not None:
        v0 = as_tensor(v0, dev)
        dt = torch.promote_types(dt, v0.dtype)
    if not (dt.is_floating_point or dt.is_complex):
        dt = torch.float32
    v = (hostsync.upload(rng.standard_normal(n), dev) if v0 is None else v0).to(dt)
    v = v / torch.linalg.vector_norm(v)
    eff_tol = tol if tol > 0 else float(torch.finfo(_real_dtype(dt)).eps) * 10
    matvecs = 0
    w = s_sel = V = None
    thetas = barr = None  # locked Ritz values and their arrowhead couplings
    l = 0  # thick block size (0: the plain first cycle)
    V0 = torch.zeros((ncv, n), dtype=dt, device=dev)
    V0[0] = v
    prev_worst = np.inf
    cycles = 0
    while matvecs < int(maxiter) or w is None:
        V, alphas, betas, vres, nmv = _lanczos_factorization(A, V0, l, ncv, rng)
        del V0
        matvecs += nmv
        cycles += 1
        T = np.zeros((ncv, ncv))
        if l:
            T[:l, :l] = np.diag(thetas)
            T[:l, l] = barr
            T[l, :l] = barr
        aa, bb = alphas[l:], betas[l: ncv - 1]
        T[l:, l:] = np.diag(aa)
        if bb.size:
            T[l:, l:] += np.diag(bb, 1) + np.diag(bb, -1)
        w_all, s_full = np.linalg.eigh(T)
        sel = _select_ritz(w_all, which, k)
        w = w_all[sel]
        s_sel = s_full[:, sel]
        resid = np.abs(betas[ncv - 1]) * np.abs(s_sel[-1, :])
        if _stats is not None:
            _stats.update(cycles=cycles, matvecs=matvecs, ncv=ncv, resid=resid)
        scale = max(np.max(np.abs(w_all)), 1e-30)
        if np.all(resid <= eff_tol * scale) or ncv >= n:
            break
        worst = float(np.max(resid))
        if worst > 0.5 * prev_worst:  # a stall: grow the basis (ncv == n is exact)
            ncv = min(2 * ncv, n)
        prev_worst = worst
        # thick restart: lock the k wanted Ritz vectors, the residual
        # direction right after them
        l = min(k, ncv - 2)
        lock = s_full[:, sel[:l]]
        Y = hostsync.upload(lock.T, dev).to(dt) @ V  # [l, n] locked Ritz block
        thetas = w_all[sel[:l]]
        barr = betas[V.shape[0] - 1] * np.real(lock[-1, :])
        V0 = torch.zeros((ncv, n), dtype=dt, device=dev)
        V0[:l] = Y
        V0[l] = vres
        del Y
    if not return_eigenvectors:
        return w
    Y = hostsync.upload(s_sel.T, dev).to(dt) @ V  # [k, n]
    return w, Y.T


# ---------------------------------------------------------------------------
# norms, powers and the action of the exponential
# ---------------------------------------------------------------------------
def norm(A, ord=None, axis=None):
    """Sparse matrix and vector norms (scipy.sparse.linalg.norm): Frobenius
    (default), ord in {1, -1, inf, -inf, 'fro'} for the matrix, the vector
    norms along one ``axis``; from the stored entries, on A's device. Column
    sums go through ``ops.elementwise.csr_sum(axis=0)`` (sorted by column,
    summed in order)."""
    if not isinstance(A, SparseArray):
        raise TypeError("norm expects a sparse array")
    from .ops.elementwise import csr_sum

    C = A.tocsr()
    data = C.data.abs()
    indptr, indices = C.indptr, C.indices
    m, n = C.shape
    if axis is None:
        if ord in (None, "fro", "f"):
            return torch.sqrt(torch.sum(data * data))
        if ord in (1, -1):
            sums = csr_sum(indptr, indices, data, C.shape, axis=0)
        elif ord in (np.inf, -np.inf):
            sums = csr_sum(indptr, indices, data, C.shape, axis=1)
        else:
            raise ValueError(f"invalid norm order {ord!r} for sparse matrices")
        return sums.max() if ord in (1, np.inf) else sums.min()
    if axis not in (0, -2, 1, -1):
        raise ValueError(f"invalid axis {axis}")
    ax = 0 if axis in (0, -2) else 1
    if ord in (None, 2):
        return torch.sqrt(csr_sum(indptr, indices, data * data, C.shape, axis=ax))
    if ord == 1:
        return csr_sum(indptr, indices, data, C.shape, axis=ax)
    if ord == np.inf:
        from .ops.coords import expand_rows

        ids = indices if ax == 0 else expand_rows(indptr, data.shape[0])
        # an empty line's norm is 0: the max starts from 0 (data is |.|)
        return torch.zeros((n if ax == 0 else m,), dtype=data.dtype, device=data.device
                           ).scatter_reduce(0, ids.to(torch.int64), data, "amax")
    raise ValueError(f"invalid norm order {ord!r} along an axis")


def _onenorm_est(A_op, dt, iters: int = 4):
    """Higham/Hager 1-norm power estimate of a LinearOperator: alternate
    x -> y = A x, xi = sign(y), z = A^H xi, x = the unit vector at argmax
    |z|. A lower bound, tight in practice. Returns (est, j): the estimate
    and the column of the best unit-vector probe (||A e_j||_1 == est when
    that probe won; the uniform start never beats the best column)."""
    n = A_op.shape[1]
    dev = _operator_device(A_op)
    x = torch.full((n,), 1.0 / n, dtype=dt, device=dev)
    est = 0.0
    best_j = 0
    cur_j = None  # the unit column x is (None: the uniform start)
    for it in range(iters):
        y = A_op.matvec(x)
        est_new = float(hostsync.fetch(y.abs().sum()))
        # always take the first move: the uniform start can cancel to 0
        if it > 0 and est_new <= est:
            break
        if est_new >= est and cur_j is not None:
            best_j = cur_j
        est = max(est, est_new)
        ay = y.abs()
        xi = torch.where(y == 0, torch.ones_like(y), y / torch.where(ay == 0, torch.ones_like(ay), ay)).conj()
        z = A_op.rmatvec(xi.to(dt))
        cur_j = hostsync.fetch_int(z.abs().argmax())
        x = torch.zeros((n,), dtype=dt, device=dev)
        x[cur_j] = 1.0
        if it == 0:
            best_j = cur_j
    return max(est, 1e-300), best_j


def onenormest(A, t: int = 2, itmax: int = 5, compute_v: bool = False, compute_w: bool = False):
    """The 1-norm of A (scipy.sparse.linalg.onenormest): exact for a sparse
    array (the column sums of |data| by ``csr_sum(axis=0)``, one fetch),
    the Higham/Hager estimate for an operator. ``compute_v``/``compute_w``
    return scipy's certificate: v a unit vector with w = A v and
    est == ||w||_1."""
    A_op = make_linear_operator(A)
    n = A_op.shape[1]
    dev = _operator_device(A_op)
    if isinstance(A, SparseArray):
        from .ops.elementwise import csr_sum

        C = A.tocsr()
        sums = csr_sum(C.indptr, C.indices, C.data.abs(), C.shape, axis=0)
        est, j = hostsync.fetch(torch.stack([sums.max().double(), sums.argmax().double()]))
        est, j = float(est), int(j)
    else:
        est, j = _onenorm_est(A_op, A_op.dtype, iters=itmax)
    if not (compute_v or compute_w):
        return est
    v = torch.zeros((n,), dtype=A_op.dtype, device=dev)
    v[j] = 1.0
    w = A_op.matvec(v)
    out = [float(hostsync.fetch(w.abs().sum()))]  # certified: est == ||A v||_1
    if compute_v:
        out.append(v)
    if compute_w:
        out.append(w)
    return tuple(out)


# Al-Mohy & Higham (2011) theta of the truncated Taylor degrees that
# expm_multiply's (m*, s) choice takes (the table scipy carries)
_EXPM_THETA = {
    5: 2.4e-1, 10: 1.0, 15: 2.2, 20: 3.6, 25: 4.9, 30: 6.3,
    35: 7.7, 40: 9.1, 45: 10.0, 50: 11.0, 55: 12.0,
}


def matrix_power(A, power: int):
    """A**power of a square sparse A (scipy.sparse.linalg.matrix_power:
    non-negative integers) by binary powering over the SpGEMM."""
    import operator

    from .module import identity

    if not isinstance(A, SparseArray):
        raise TypeError("matrix_power expects a sparse array")
    m, n = A.shape
    if m != n:
        raise ValueError("matrix_power expects a square matrix")
    power = operator.index(power)  # rejects 2.5, as scipy
    if power < 0:
        raise ValueError("negative powers are not supported (no sparse inv)")
    if power == 0:
        return identity(n, dtype=A.dtype, format="csr", device=A.device)
    result = None
    base = A.tocsr()
    while power:
        if power & 1:
            result = base if result is None else (result @ base).tocsr()
        power >>= 1
        if power:
            base = (base @ base).tocsr()
    # power 1 would alias A (csr.tocsr() is self): a copy keeps A safe
    if result is A or result is A.tocsr():
        result = result.copy()
    return result


def _expm_dtype(B_dtype, A_dtype, t) -> torch.dtype:
    """result_type(B, A, t) with t a Python scalar (weak: it only makes a
    real result complex)."""
    dt = torch.promote_types(B_dtype, A_dtype)
    if not (dt.is_floating_point or dt.is_complex):
        dt = torch.float32
    if isinstance(t, (complex, np.complexfloating)) and not dt.is_complex:
        dt = torch.promote_types(dt, torch.complex64)
    return dt


def expm_multiply(A, B, t: float = 1.0, start=None, stop=None, num=None, endpoint=True,
                  _a1=None, _stats=None):
    """e^(tA) @ B without forming the exponential (scipy's
    expm_multiply): truncated Taylor with Al-Mohy & Higham's (m*, s) choice
    from the 1-norm (exact for a sparse array, estimated for an operator),
    on A's device. Each of the s stages is one ``hostsync.device_while``
    of at most m terms with the two-consecutive-term stop: one host fetch
    a chunk of ``hostsync.CHECK_EVERY`` terms, terms past the stop frozen
    (their products still run). Complex t*A is fine; B a vector or a
    matrix.

    scipy's time-grid form: with ``start``/``stop``/``num`` the result is
    stacked over ``numpy.linspace(start, stop, num, endpoint=endpoint)``,
    each interval advancing the previous state. A ``_stats`` dict receives
    each stage's (m, s) and the terms the two-term test let it take
    (``stages``)."""
    if start is not None or stop is not None or num is not None:
        if num is None or stop is None:
            raise ValueError("the time-grid form needs stop= and num=")
        if t != 1.0:
            raise ValueError("t= cannot be combined with the start/stop/num grid form")
        start = 0.0 if start is None else start
        ts = np.linspace(start, stop, int(num), endpoint=endpoint)
        # one 1-norm serves every interval (uniform spacing)
        A_op0 = make_linear_operator(A)
        if isinstance(A, SparseArray):
            a1 = float(hostsync.fetch(norm(A, ord=1).real))
        else:
            dev = _operator_device(A_op0, B)
            dt0 = _expm_dtype(as_tensor(B, dev).dtype, A_op0.dtype, ts[-1].item())
            a1 = _onenorm_est(A_op0, dt0)[0]
        out = [expm_multiply(A, B, t=float(ts[0]), _a1=a1, _stats=_stats)]
        for i in range(1, len(ts)):
            out.append(expm_multiply(A, out[-1], t=float(ts[i] - ts[i - 1]), _a1=a1,
                                     _stats=_stats))
        return torch.stack(out)

    A_op = make_linear_operator(A)
    B = as_tensor(B, _operator_device(A_op, B))
    dt = _expm_dtype(B.dtype, A_op.dtype, t)
    B = B.to(dt)
    if _a1 is not None:
        a_norm = _a1 * abs(t)
    elif isinstance(A, SparseArray):
        a_norm = float(hostsync.fetch(norm(A, ord=1).real)) * abs(t)
    else:
        # an operator: the Higham-style estimate (a product with ones can
        # cancel, e.g. [[2, -2], [-2, 2]] @ ones == 0)
        a_norm = _onenorm_est(A_op, dt)[0] * abs(t)
    if a_norm == 0 or B.numel() == 0:
        return B
    best = None  # the smallest cost s * m with ||tA||_1 / s <= theta_m
    for mdeg, theta in _EXPM_THETA.items():
        s = max(int(np.ceil(a_norm / theta)), 1)
        if best is None or s * mdeg < best[0]:
            best = (s * mdeg, mdeg, s)
    _, mdeg, s = best
    rdt = _real_dtype(dt)
    dev = B.device
    scale = torch.tensor(t / s, dtype=dt, device=dev)
    tol = float(torch.finfo(rdt).eps) / 2
    apply = A_op.matvec if B.ndim == 1 else A_op.matmat

    def cond(st):
        return (st["j"] <= mdeg) & ~st["done"]

    def body(st):
        term = apply(st["term"]) * (scale / st["j"].to(dt))
        out = st["out"] + term
        # Al-Mohy & Higham's two-consecutive-term test (as scipy): one
        # dipping term must not stop the series
        c = term.abs().max()
        done = (st["c_prev"] + c) <= tol * out.abs().max()
        return {"term": term, "out": out, "c_prev": c, "j": st["j"] + 1, "done": done}

    F = B
    for _ in range(s):
        state = {"term": F, "out": F,
                 "c_prev": torch.tensor(np.inf, dtype=rdt, device=dev),
                 "j": torch.ones((), dtype=torch.int64, device=dev),
                 "done": torch.zeros((), dtype=torch.bool, device=dev)}
        state, j, _ = hostsync.device_while(cond, body, state, limit=mdeg + 1, count="j")
        F = state["out"]
        if _stats is not None:
            _stats.setdefault("stages", []).append((mdeg, s, j - 1))
    return F


# ---------------------------------------------------------------------------
# svds: thick-restart Lanczos on the normal operator
# ---------------------------------------------------------------------------
def svds(A, k: int = 6, which: str = "LM", return_singular_vectors: bool = True,
         maxiter=None):
    """The k largest singular triplets (scipy.sparse.linalg.svds subset:
    which='LM'; ``maxiter`` is scipy's, the operator applications of the
    Lanczos run).

    A tall A runs :func:`eigsh` on C = A^H A (a product = A x, then the
    adjoint product, on the transpose's held CSR), sigma = sqrt(max(eig,
    0)) and U = A V / sigma; a wide one takes the adjoint. When min(m, n)
    is no larger than the Lanczos basis would be, a dense SVD is exact and
    cheaper. Singular values under numpy's rank cutoff are reported as 0
    with zeroed vectors. Returns (U, s, Vh), s as host numpy."""
    if which != "LM":
        raise NotImplementedError("svds supports which='LM'")
    A_op = make_linear_operator(A)
    dev = _operator_device(A_op)
    m, n = A_op.shape
    if not 1 <= k <= min(m, n) - 1:  # scipy's bound
        raise ValueError(f"k={k} must satisfy 1 <= k <= min(M, N) - 1 = {min(m, n) - 1}")
    if m < n:
        # wide: the svds of the adjoint, mapped back
        adj = LinearOperator((n, m), matvec=A_op.rmatvec, rmatvec=A_op.matvec, dtype=A_op.dtype)
        adj.device = dev
        out = svds(adj, k=k, return_singular_vectors=return_singular_vectors, maxiter=maxiter)
        if not return_singular_vectors:
            return out
        Ua, s, Vha = out
        return Vha.conj().T, s, Ua.conj().T
    rdt = _real_dtype(torch.promote_types(A_op.dtype, torch.float32))
    eps = float(torch.finfo(rdt).eps)
    if n <= max(2 * k + 1, 20):
        # the Lanczos basis would span the whole space: a dense SVD is exact
        dense = A_op.matmat(torch.eye(n, dtype=A_op.dtype, device=dev))
        U, s, Vh = torch.linalg.svd(dense, full_matrices=False)
        U, s, Vh = U[:, :k], hostsync.fetch(s[:k]), Vh[:k]
        cutoff = max(m, n) * eps * (float(s[0]) if len(s) else 0.0)
        live = s > cutoff
        s = np.where(live, s, 0.0)
        if not return_singular_vectors:
            return s
    else:
        C = LinearOperator((n, n), matvec=lambda x: A_op.rmatvec(A_op.matvec(x)),
                           dtype=A_op.dtype)
        C.device = dev
        w, V = eigsh(C, k=k, which="LA", maxiter=maxiter)
        w = np.maximum(np.asarray(w), 0.0)
        order = np.argsort(w)[::-1]
        s = np.sqrt(w[order])
        # the rank cutoff before the vectors: values under it are zeros and
        # their vectors junk
        cutoff = max(m, n) * eps * (float(s[0]) if len(s) else 0.0)
        live = s > cutoff
        s = np.where(live, s, 0.0)
        if not return_singular_vectors:
            return s
        V = V[:, torch.as_tensor(order.copy(), device=dev)]
        safe = torch.as_tensor(np.where(live, np.where(s > 0, s, 1.0), 1.0), device=dev)
        U = A_op.matmat(V) / safe.to(V.dtype)[None, :]
        Vh = V.conj().T
    keep = torch.as_tensor(live.astype(np.float64), device=dev).to(rdt)
    return U * keep[None, :], s, Vh * keep[:, None]


__all__ = [
    "LinearOperator",
    "IdentityOperator",
    "aslinearoperator",
    "make_linear_operator",
    "cg",
    "cgs",
    "bicg",
    "bicgstab",
    "gmres",
    "lsqr",
    "eigsh",
    "spsolve",
    "cg_axpby",
    "norm",
    "expm_multiply",
    "matrix_power",
    "svds",
    "onenormest",
    "minres",
    "lsmr",
    "tfqmr",
    "qmr",
    "SuperLU",
    "splu",
    "spilu",
    "SpILU",
    "ilu0",
    "ic0",
    "factorized",
    "inv",
    "expm",
    "spsolve_triangular",
    "is_sptriangular",
    "spbandwidth",
    "eigs",
    "lobpcg",
    "LaplacianNd",
    "ArpackError",
    "ArpackNoConvergence",
    "MatrixRankWarning",
    "use_solver",
    "lgmres",
    "gcrotmk",
    "funm_multiply_krylov",
]

from ._laplacian import LaplacianNd  # noqa: F401,E402  (imports LinearOperator from here)


def _legacy_namespace(name, symbols):
    """scipy.sparse.linalg's deprecated submodule namespaces
    (``linalg.isolve.cg`` etc.) as module objects, registered in
    ``sys.modules`` so that ``from sparse_tpu_torch.linalg.isolve import cg``
    resolves."""
    import sys
    import types

    mod = types.ModuleType(f"{__name__}.{name}")
    g = globals()
    for s in symbols:
        if s in g:
            setattr(mod, s, g[s])
    sys.modules[mod.__name__] = mod
    return mod


isolve = _legacy_namespace(
    "isolve",
    ["cg", "cgs", "bicg", "bicgstab", "gmres", "lgmres", "gcrotmk", "minres", "qmr", "tfqmr",
     "lsqr", "lsmr"],
)
dsolve = _legacy_namespace(
    "dsolve",
    ["spsolve", "splu", "spilu", "factorized", "spsolve_triangular", "MatrixRankWarning",
     "use_solver"],
)
eigen = _legacy_namespace(
    "eigen", ["eigs", "eigsh", "lobpcg", "svds", "ArpackError", "ArpackNoConvergence"]
)
interface = _legacy_namespace("interface", ["LinearOperator", "aslinearoperator"])
matfuncs = _legacy_namespace("matfuncs", ["expm", "inv", "expm_multiply", "matrix_power"])
