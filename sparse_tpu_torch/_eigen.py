"""LOBPCG, nonsymmetric Arnoldi (``eigs``) and the Krylov action of a matrix
function (``sparse_tpu/_eigen.py``; scipy.sparse.linalg's surface).

* ``lobpcg``: each iteration is one block product (``matmat``: on a CSR
  the plain ELL or SELL slab gathers, no kernel), an [n, 3m]
  orthonormalization and the [3m, 3m] Rayleigh-Ritz ``eigh``, all on the
  operator's device; the host reads the residual norms and Ritz values
  once an iteration.
* ``eigs``: Krylov-Schur restarted Arnoldi. Products and the basis algebra
  stay on the device, a real operator takes a complex vector as two real
  products; the [ncv, ncv] sorted Schur form runs on the host
  (``scipy.linalg.schur``). One host fetch an Arnoldi step.
* ``funm_multiply_krylov``: restarted Arnoldi with f of the accumulated
  Hessenberg evaluated on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import hostsync
from .utils import as_tensor

__all__ = ["lobpcg", "eigs", "funm_multiply_krylov", "ArpackError", "ArpackNoConvergence"]

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


class ArpackError(RuntimeError):
    """scipy.sparse.linalg.ArpackError: an irrecoverable iteration failure
    of eigs/eigsh (e.g. an Arnoldi breakdown below k)."""


class ArpackNoConvergence(ArpackError):
    """scipy's no-convergence error; carries the converged part of the
    result in ``eigenvalues``/``eigenvectors``."""

    def __init__(self, msg, eigenvalues=None, eigenvectors=None):
        super().__init__(msg)
        self.eigenvalues = eigenvalues if eigenvalues is not None else []
        self.eigenvectors = eigenvectors if eigenvectors is not None else []


def _device(A, b=None):
    from .linalg import _operator_device

    return _operator_device(A, b)


def funm_multiply_krylov(f, A, b, *, assume_a="general", t=1.0, atol=0.0, rtol=1e-6,
                         restart_every_m=None, max_restarts=20):
    """y = f(t A) b by restarted Krylov (scipy.sparse.linalg.
    funm_multiply_krylov): Arnoldi with two-pass full reorthogonalization
    (valid for both ``assume_a``), ``f`` applied on the host to the
    accumulated Hessenberg of all cycles (the Eiermann-Ernst restart), and
    this cycle's block of beta f(tH) e1 lifted back through the basis."""
    from .linalg import make_linear_operator

    if assume_a not in ("general", "gen", "hermitian", "her"):
        raise ValueError(f"assume_a={assume_a!r} not in general/hermitian")
    A = make_linear_operator(A)
    n = A.shape[0]
    b = as_tensor(b, _device(A, b))
    dt = torch.promote_types(torch.promote_types(A.dtype, b.dtype), torch.float32)
    b = b.to(dt)
    m = int(restart_every_m) if restart_every_m else min(n, 20)
    m = max(1, min(m, n))
    beta = float(hostsync.fetch(torch.linalg.vector_norm(b)))
    if beta == 0:
        return torch.zeros_like(b)
    y = torch.zeros_like(b)
    H_full = np.zeros((0, 0), dtype=np.complex128)
    last_beta = 0.0
    v = b / beta
    for _ in range(int(max_restarts)):
        V = torch.zeros((m + 1, n), dtype=dt, device=b.device)
        V[0] = v
        H = np.zeros((m + 1, m), dtype=np.complex128)
        # breakdown is relative to each H column's own norm (not ||b||,
        # which would fire falsely for a large b)
        V, H, mdone = _arnoldi_extend(A.matvec, V, H, 0, m, breakdown_tol=1e-12)
        colnorm = float(np.linalg.norm(H[: mdone + 1, mdone - 1]))
        breakdown = float(abs(H[mdone, mdone - 1])) <= 1e-12 * colnorm
        k0 = H_full.shape[0]
        Hnew = np.zeros((k0 + mdone, k0 + mdone), dtype=np.complex128)
        Hnew[:k0, :k0] = H_full
        Hnew[k0:, k0:] = H[:mdone, :mdone]
        if k0 > 0:
            Hnew[k0, k0 - 1] = last_beta
        H_full = Hnew
        last_beta = H[mdone, mdone - 1]
        F = np.asarray(f(t * H_full), dtype=np.complex128)
        coeff = beta * F[k0: k0 + mdone, 0]
        real_out = not b.is_complex()
        if real_out and np.abs(coeff.imag).max(initial=0.0) <= 1e-12 * max(
                np.abs(coeff).max(initial=0.0), 1e-300):
            dy = V[:mdone].T @ torch.as_tensor(coeff.real, device=b.device).to(dt)
        else:
            cdt = _COMPLEX.get(dt, dt)
            dy = V[:mdone].T.to(cdt) @ torch.as_tensor(coeff, device=b.device).to(cdt)
            y = y.to(cdt)
        y = y + dy
        dnorm, ynorm = hostsync.fetch(torch.stack([torch.linalg.vector_norm(dy),
                                                   torch.linalg.vector_norm(y)]))
        if dnorm <= max(float(atol), float(rtol) * max(float(ynorm), 1e-30)):
            return y
        if breakdown:
            return y  # an invariant subspace: the evaluation is exact
        v = V[mdone]
    return y


def _ortho_cols(M):
    """Orthonormal columns by unpivoted QR (a rank-deficient input gets
    arbitrary directions for its null columns)."""
    q, _ = torch.linalg.qr(M)
    return q


def lobpcg(A, X, B=None, M=None, Y=None, tol=None, maxiter=20, largest=True,
           retLambdaHistory=False, retResidualNormsHistory=False):
    """Locally optimal block preconditioned conjugate gradient
    (scipy.sparse.linalg.lobpcg, the standard problem: ``B`` must be
    None). Each iteration: one block product, an [n, 3m]
    orthonormalization and the [3m, 3m] Rayleigh-Ritz ``eigh`` on the
    operator's device; one host fetch (residual norms and Ritz values).
    Returns host numpy (lambda, X), as the reference."""
    from .linalg import make_linear_operator

    if B is not None:
        raise NotImplementedError("lobpcg: generalized problem (B) not supported")
    A = make_linear_operator(A)
    n = A.shape[0]
    X = as_tensor(X, _device(A, X))
    if X.ndim != 2:
        raise ValueError("X must be [n, m]")
    m = X.shape[1]
    if n < 5 * m:
        raise ValueError("lobpcg: n < 5*m; use a dense eigensolver")
    dt = torch.promote_types(torch.promote_types(X.dtype, A.dtype), torch.float32)
    X = X.to(dt)
    rdt = X.real.dtype
    if tol is None:
        tol = float(np.sqrt(torch.finfo(rdt).eps)) * n
    Mop = None if M is None else make_linear_operator(M)
    if Y is not None:
        Y = _ortho_cols(as_tensor(Y, X.device).to(dt))

    def constrain(V):
        return V if Y is None else V - Y @ (Y.conj().T @ V)

    def rayleigh_ritz(S):
        S = _ortho_cols(S)
        T = S.conj().T @ A.matmat(S)
        T = 0.5 * (T + T.conj().T)
        w, C = torch.linalg.eigh(T)
        return S, w, C

    X = _ortho_cols(constrain(X))
    P = None
    lam_hist, res_hist = [], []
    for _ in range(int(maxiter)):
        AX = A.matmat(X)
        lam = torch.diagonal(X.conj().T @ AX).real
        rnorm = torch.linalg.vector_norm(AX - X * lam[None, :], dim=0)
        host = hostsync.fetch(torch.stack([rnorm, lam]))
        res_hist.append(host[0])
        lam_hist.append(host[1])
        if np.all(host[0] <= tol):
            break
        W = AX - X * lam[None, :]
        W = constrain(W if Mop is None else Mop.matmat(W))
        S = torch.cat([X, W] + ([] if P is None else [P]), dim=1)
        S, w, C = rayleigh_ritz(S)
        idx = torch.argsort(w, descending=True)[:m] if largest else torch.argsort(w)[:m]
        X_new = S @ C[:, idx]
        # the implicit P: the new X's component outside the old X's span
        P = X_new - X @ (X.conj().T @ X_new)
        pn = torch.linalg.vector_norm(P, dim=0)
        P = torch.where(pn[None, :] > 0, P / torch.where(pn == 0, torch.ones_like(pn), pn)[None, :],
                        P)
        X = _ortho_cols(X_new)
    lam = torch.diagonal(X.conj().T @ A.matmat(X)).real
    order = torch.argsort(lam, descending=True) if largest else torch.argsort(lam)
    out = (hostsync.fetch(lam[order]), hostsync.fetch(X[:, order]))
    if retLambdaHistory:
        out = out + (lam_hist,)
    if retResidualNormsHistory:
        out = out + (res_hist,)
    return out


# ---------------------------------------------------------------------------
# eigs: Krylov-Schur restarted Arnoldi
# ---------------------------------------------------------------------------
def _arnoldi_extend(matvec, V, H, start, ncv, breakdown_tol=0.0):
    """Extend A V[:j] = V[:j+1] H[:j+1, :j] from column ``start`` to
    ``ncv``: V [ncv+1, n] on the device (rows are the basis), H
    [ncv+1, ncv] host numpy. Two passes of classical Gram-Schmidt against
    every basis row; the host fetches both passes' coefficients and the
    new norm in one read a step. A breakdown is a norm at most
    ``breakdown_tol`` times the new H column's own norm."""
    for j in range(start, ncv):
        w = matvec(V[j])
        Vj = V[: j + 1]
        c1 = Vj.conj() @ w
        w = w - Vj.T @ c1
        c2 = Vj.conj() @ w
        w = w - Vj.T @ c2
        bn = torch.linalg.vector_norm(w)
        host = hostsync.fetch(torch.cat([c1, c2, bn.to(c1.dtype)[None]]))
        H[: j + 1, j] += host[: j + 1]
        H[: j + 1, j] += host[j + 1: 2 * j + 2]
        beta = float(np.real(host[-1]))
        H[j + 1, j] = beta
        colscale = float(np.linalg.norm(H[: j + 2, j]))
        if beta <= breakdown_tol * colscale:  # an invariant subspace
            return V, H, j + 1
        V[j + 1] = w / beta
    return V, H, ncv


def _sort_key(ritz, which):
    """ARPACK's ``which`` as a sort key: smaller is more wanted."""
    which = which.upper()
    if which == "LM":
        return -np.abs(ritz)
    if which == "SM":
        return np.abs(ritz)
    if which == "LR":
        return -ritz.real
    if which == "SR":
        return ritz.real
    if which == "LI":
        return -ritz.imag
    if which == "SI":
        return ritz.imag
    raise ValueError(f"which={which!r} not in LM/SM/LR/SR/LI/SI")


def _select(ritz, which, k):
    return np.argsort(_sort_key(ritz, which), kind="stable")[:k]


def eigs(A, k=6, which="LM", v0=None, ncv=None, maxiter=None, tol=0.0,
         return_eigenvectors=True):
    """Nonsymmetric eigenpairs by Krylov-Schur restarted Arnoldi
    (scipy.sparse.linalg.eigs). Products and basis algebra on the
    operator's device, a real operator applied as two real products to the
    complex basis; the [ncv, ncv] sorted Schur reorder on the host
    (``scipy.linalg.schur``). The default ``tol`` is eps^(2/3) of the
    complex basis. Returns complex host numpy eigenvalues (and vectors)."""
    import scipy.linalg as _sla

    from .linalg import make_linear_operator

    A = make_linear_operator(A)
    dev = _device(A, v0)
    n = A.shape[0]
    if k >= n - 1:
        raise ValueError("k must be < n - 1 for Arnoldi; use a dense solver")
    if ncv is None:
        ncv = min(n - 1, max(2 * k + 1, 20))
    ncv = int(min(ncv, n - 1))
    if maxiter is None:
        maxiter = max(10, n // max(ncv - k, 1)) * 10
    dt = torch.promote_types(A.dtype, torch.float32)
    cdt = _COMPLEX.get(dt, dt)
    rng = np.random.default_rng(0)
    if v0 is None:
        v0 = rng.standard_normal(n)
    v0 = as_tensor(v0, dev).to(cdt)
    v0 = v0 / torch.linalg.vector_norm(v0)
    real_input = not dt.is_complex

    def matvec(v):
        if real_input:  # the operator stays real: a complex vector is 2 products
            return torch.complex(A.matvec(v.real.contiguous()).to(dt),
                                 A.matvec(v.imag.contiguous()).to(dt)).to(cdt)
        return A.matvec(v.to(cdt))

    V = torch.zeros((ncv + 1, n), dtype=cdt, device=dev)
    V[0] = v0
    H = np.zeros((ncv + 1, ncv), dtype=np.complex128)
    V, H, mdone = _arnoldi_extend(matvec, V, H, 0, ncv)
    # the default tol follows the compute precision
    ceps = float(torch.finfo(V.real.dtype).eps)
    tol_eff = tol if tol > 0 else ceps ** (2 / 3)
    partial_count = 0
    partial_vecs = np.zeros((n, 0), dtype=np.complex128)
    partial_evals = np.array([])
    for _ in range(int(maxiter)):
        m = mdone
        if m < k:
            raise ArpackError(
                f"eigs: Arnoldi breakdown at subspace dimension {m} < k={k}; the operator has "
                "an invariant subspace containing v0 — try a different v0 or smaller k")
        Hm = H[:m, :m]
        beta_row = H[m, m - 1] if m < H.shape[0] else 0.0
        ritz_all = np.linalg.eigvals(Hm)
        # select by a magnitude-relative threshold on the `which` key, not
        # by exact values: eigvals and schur differ in the low digits
        key_all = _sort_key(ritz_all, which)
        kth = np.partition(key_all, k - 1)[k - 1]
        sel_tol = 1e-8 * max(float(np.max(np.abs(ritz_all))), 1e-30)

        def sort_fn(lam):
            return bool(_sort_key(np.asarray([lam]), which)[0] <= kth + sel_tol)

        T, Z, sdim = _sla.schur(Hm, output="complex", sort=sort_fn)
        sdim = max(int(sdim), 1)
        # the Ritz pairs of the selected block (its internal order is
        # arbitrary): eigendecompose it and re-select the k wanted
        bs = beta_row * Z[m - 1, :sdim]  # the residual coupling row
        evals_all, Sv = np.linalg.eig(T[:sdim, :sdim])
        order = _select(evals_all, which, min(k, sdim))
        coup = np.abs(bs @ Sv[:, order])  # |A y - lam y| of each Ritz vector
        scale = np.maximum(np.abs(evals_all[order]), 1e-30)
        # the converged pairs so far, for ArpackNoConvergence; the vectors
        # are rebuilt only when the count grows
        part_mask = coup <= tol_eff * scale
        conv = evals_all[order][part_mask]
        if conv.size > partial_count:
            partial_count = conv.size
            small = Z[:, :sdim] @ Sv[:, order][:, part_mask]
            pv = hostsync.fetch(V[:m].T @ torch.as_tensor(small, device=dev).to(cdt))
            nrm = np.linalg.norm(pv, axis=0, keepdims=True)
            partial_vecs = pv / np.where(nrm == 0, 1.0, nrm)
            partial_evals = conv
        if sdim >= k and np.all(coup <= tol_eff * scale):
            evals = evals_all[order]
            vecs_d = V[:m].T @ torch.as_tensor(Z[:, :sdim] @ Sv[:, order], device=dev).to(cdt)
            vecs_d = vecs_d / torch.linalg.vector_norm(vecs_d, dim=0, keepdim=True)
            # the explicit residual gate: the coupling test can pass on a
            # ghost copy of a converged pair in low precision
            R = torch.stack([matvec(vecs_d[:, i]) for i in range(k)], dim=1) - vecs_d * (
                torch.as_tensor(evals, device=dev).to(cdt)[None, :])
            rn = hostsync.fetch(torch.linalg.vector_norm(R, dim=0))
            if np.all(rn <= 10 * tol_eff * np.maximum(np.abs(evals), 1e-30)):
                if not return_eigenvectors:
                    return evals
                return evals, hostsync.fetch(vecs_d)
        # the Krylov-Schur restart: keep the leading sdim Schur vectors
        keep = min(max(sdim, k), m - 1)
        Vnew = (V[:m].T @ torch.as_tensor(Z[:, :keep], device=dev).to(cdt)).T  # [keep, n]
        Hnew = np.zeros_like(H)
        Hnew[:keep, :keep] = T[:keep, :keep]
        Hnew[keep, :keep] = beta_row * Z[m - 1, :keep]
        resid = V[m].clone()
        V.zero_()
        V[:keep] = Vnew
        V[keep] = resid
        H = Hnew
        V, H, mdone = _arnoldi_extend(matvec, V, H, keep, ncv)
    raise ArpackNoConvergence(
        f"eigs: no convergence to tol={tol_eff} within {maxiter} restarts",
        eigenvalues=partial_evals, eigenvectors=partial_vecs)
