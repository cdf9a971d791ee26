"""Radau IIA(5): the implicit Runge-Kutta method for stiff ODEs
(``sparse_tpu/_radau.py``; scipy.integrate.Radau semantics: 3 stages,
order 5, L-stable, with the Hairer-Wanner real/complex split).

The control flow is host numpy, as in the reference; each Newton iteration
applies two device LU factors (one real, one complex, each of dimension n:
the 3n-stage system decouples through the eigenbasis of the inverse of the
Butcher matrix), refactored only when the Jacobian or the step changes.
"""

from __future__ import annotations

import numpy as np
import torch

from ._bdf import BDF as _BDFBase
from ._bdf import _host, _lu_solve, _norm_rms
from .utils import as_tensor

S6 = 6**0.5

# Butcher and collocation data (Hairer & Wanner IV.8, analytic)
C_NODES = np.array([(4 - S6) / 10, (4 + S6) / 10, 1.0])
A_BUTCHER = np.array([
    [11 / 45 - 7 * S6 / 360, 37 / 225 - 169 * S6 / 1800, -2 / 225 + S6 / 75],
    [37 / 225 + 169 * S6 / 1800, 11 / 45 + 7 * S6 / 360, -2 / 225 - S6 / 75],
    [4 / 9 - S6 / 36, 4 / 9 + S6 / 36, 1 / 9],
])
E_ERR = np.array([-13 - 7 * S6, -13 + 7 * S6, -1]) / 3
# interpolator coefficients (the collocation polynomial, analytic)
P_INTERP = np.array([
    [13 / 3 + 7 * S6 / 3, -23 / 3 - 22 * S6 / 3, 10 / 3 + 5 * S6],
    [13 / 3 - 7 * S6 / 3, -23 / 3 + 22 * S6 / 3, 10 / 3 - 5 * S6],
    [1 / 3, -8 / 3, 10 / 3]])


def _transform_constants():
    """The eigen-split of inv(A): one real eigenvalue and a conjugate pair,
    from the analytic Butcher matrix, so that TI_x @ inv(A) = mu_x TI_x
    holds to rounding (the reference's derivation, step for step)."""
    Ainv = np.linalg.inv(A_BUTCHER)
    w, v = np.linalg.eig(Ainv.T)  # v[:, i]^T @ Ainv = w[i] v[:, i]^T
    real_i = int(np.argmin(np.abs(w.imag)))
    cplx_i = int(np.argmax(np.abs(w.imag)))
    mu_real = float(w[real_i].real)
    mu_complex = complex(w[cplx_i])
    if abs(mu_complex.imag) < 1e-12:
        raise RuntimeError("radau: complex pair not found")
    ti_real = v[:, real_i].real.copy()
    ti_complex = v[:, cplx_i].copy()
    TI = np.vstack([ti_real, ti_complex.real, ti_complex.imag])
    return mu_real, mu_complex, np.linalg.inv(TI), TI, ti_real, ti_complex


MU_REAL, MU_COMPLEX, T_MAT, TI_MAT, TI_REAL, TI_COMPLEX = _transform_constants()

NEWTON_MAXITER = 6
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0


class Radau:
    """Radau IIA order-5 solver (``solve_ivp(..., method='Radau')``)."""

    def __init__(self, fun, t0, y0, t_bound, max_step=np.inf, rtol=1e-3, atol=1e-6, jac=None,
                 jac_sparsity=None, vectorized=False, first_step=None, **extraneous):
        from .integrate import OdeSolver, select_initial_step, validate_max_step, validate_tol

        OdeSolver.__init__(self, fun, t0, y0, t_bound, vectorized, support_complex=False)
        self.max_step = validate_max_step(max_step)
        self.rtol, self.atol = validate_tol(rtol, atol, self.n)
        dev = self.y.device
        self.f = _host(self.fun(self.t, self.y))
        self.nfev += 1
        if first_step is None:
            self.h_abs = select_initial_step(self.fun, self.t, self.y, as_tensor(self.f, dev),
                                             self.direction, 3, self.rtol, self.atol)
        else:
            self.h_abs = float(first_step)
        self.h_abs_old = None
        self.error_norm_old = None
        self.newton_tol = max(10 * np.finfo(np.float64).eps / self.rtol, min(0.03, self.rtol**0.5))
        self.sol = None
        # BDF's Jacobian handling (callable, constant or numerical)
        self._jac_arg = jac
        self._jac_callable = None
        self.J = self._validate_jac(self.t, self.y, as_tensor(self.f, dev))
        self.current_jac = True
        self.LU_real = None
        self.LU_complex = None
        self.Z = None

    _validate_jac = _BDFBase._validate_jac
    _as_dense = _BDFBase._as_dense
    _num_jac = _BDFBase._num_jac
    _refresh_jac = _BDFBase._refresh_jac

    def _lu_pair(self, h):
        self.nlu += 2
        J = self.J
        eye = torch.eye(self.n, dtype=J.dtype, device=J.device)
        Jc = J.to(torch.complex128 if J.dtype == torch.float64 else torch.complex64)
        return (torch.linalg.lu_factor(float(MU_REAL / h) * eye - J),
                torch.linalg.lu_factor(complex(MU_COMPLEX / h) * eye.to(Jc.dtype) - Jc))

    def _solve_collocation(self, t, y, h, Z0, scale):
        """Newton on the transformed collocation system (Hairer-Wanner):
        the 3n system splits into one real and one complex n-system."""
        n = self.n
        dev = self.y.device
        M_real = MU_REAL / h
        M_complex = MU_COMPLEX / h
        W = TI_MAT.dot(Z0)
        Z = Z0.copy()
        F = np.empty((3, n))
        ch = h * C_NODES
        dW_norm_old = None
        converged = False
        rate = None
        for k in range(NEWTON_MAXITER):
            for i in range(3):
                F[i] = _host(self.fun(t + ch[i], as_tensor(y + Z[i], dev)))
            self.nfev += 3
            if not np.all(np.isfinite(F)):
                break
            f_real = F.T.dot(TI_REAL) - M_real * W[0]
            f_complex = F.T.dot(TI_COMPLEX) - M_complex * (W[1] + 1j * W[2])
            dW_real = _lu_solve(self.LU_real, f_real)
            dW_complex = _lu_solve(self.LU_complex, f_complex)
            dW = np.vstack([dW_real, dW_complex.real, dW_complex.imag])
            dW_norm = _norm_rms(dW.ravel(), np.tile(scale, 3))
            rate = None if dW_norm_old is None else dW_norm / dW_norm_old
            if rate is not None and (
                rate >= 1 or rate ** (NEWTON_MAXITER - k) / (1 - rate) * dW_norm > self.newton_tol
            ):
                break
            W += dW
            Z = T_MAT.dot(W)
            if dW_norm == 0 or (rate is not None and rate / (1 - rate) * dW_norm
                                < self.newton_tol):
                converged = True
                break
            dW_norm_old = dW_norm
        return converged, k + 1, Z, rate

    def _step_impl(self):
        t = self.t
        y = _host(self.y)
        f = self.f
        dev = self.y.device
        max_step = self.max_step
        min_step = 10 * np.abs(np.nextafter(t, self.direction * np.inf) - t)
        h_abs = min(max(self.h_abs, min_step), max_step)
        if h_abs != self.h_abs:
            self.LU_real = self.LU_complex = None

        rejected = False
        step_accepted = False
        while not step_accepted:
            if h_abs < min_step:
                return False, self.TOO_SMALL_STEP
            h = h_abs * self.direction
            t_new = t + h
            if self.direction * (t_new - self.t_bound) > 0:
                t_new = self.t_bound
            h = t_new - t
            h_abs = np.abs(h)

            if self.sol is None:
                Z0 = np.zeros((3, y.shape[0]))
            else:
                Z0 = _host(self.sol(t + h * C_NODES)).T - y[None, :]

            scale = self.atol + np.abs(y) * self.rtol
            converged = False
            while not converged:
                if self.LU_real is None:
                    self.LU_real, self.LU_complex = self._lu_pair(h)
                converged, n_iter, Z, rate = self._solve_collocation(t, y, h, Z0, scale)
                if not converged:
                    if self.current_jac:
                        break
                    self.J = self._refresh_jac(t, as_tensor(y, dev), as_tensor(f, dev))
                    self.current_jac = True
                    self.LU_real = self.LU_complex = None
            if not converged:
                h_abs *= 0.5
                self.LU_real = self.LU_complex = None
                continue

            y_new = y + Z[2]
            # the embedded error estimate (Hairer-Wanner): the lower-order
            # defect filtered through the real factor for L-stable damping
            ZE = Z.T.dot(E_ERR) / h
            error = _lu_solve(self.LU_real, np.asarray(f) + ZE)
            scale_new = self.atol + np.maximum(np.abs(y), np.abs(y_new)) * self.rtol
            error_norm = _norm_rms(error, scale_new)
            safety = 0.9 * (2 * NEWTON_MAXITER + 1) / (2 * NEWTON_MAXITER + n_iter)
            if rejected and error_norm > 1:
                # the stiff-accurate re-estimate after a rejection
                F0 = _host(self.fun(t, as_tensor(y + error, dev)))
                self.nfev += 1
                error = _lu_solve(self.LU_real, F0 + ZE)
                error_norm = _norm_rms(error, scale_new)
            if error_norm > 1:
                factor = max(MIN_FACTOR, safety * error_norm**-0.25)
                h_abs *= factor
                self.LU_real = self.LU_complex = None
                rejected = True
                continue
            step_accepted = True

        # the predictive step controller (scipy's form)
        if error_norm == 0:
            factor = MAX_FACTOR
        elif self.error_norm_old is None or self.h_abs_old is None:
            factor = min(MAX_FACTOR, safety * error_norm**-0.25)
        else:
            mult = h_abs / self.h_abs_old * (self.error_norm_old / error_norm) ** 0.25
            factor = min(MAX_FACTOR, max(MIN_FACTOR, safety * min(1.0, mult) * error_norm**-0.25))
        self.h_abs_old = h_abs
        self.error_norm_old = error_norm

        f_new = _host(self.fun(t_new, as_tensor(y_new, dev)))
        self.nfev += 1
        self.Z = Z
        self.t = t_new
        self.y = as_tensor(y_new, dev)
        self.f = f_new
        # scipy's controller tail: modest growth snaps to 1, so the LU pair is
        # reused across runs of similar steps
        if factor < 1.2:
            factor = 1.0
        else:
            self.LU_real = self.LU_complex = None
        self.h_abs = h_abs * factor
        if self._jac_callable is not None or self._jac_arg is None:
            self.current_jac = False
        # built from the step's own bounds (t, t_new): the base class updates
        # t_old only after _step_impl returns
        self.sol = _RadauDenseOutput(t, t_new, y, self.Z.T.dot(P_INTERP), dev)
        return True, None

    def _dense_output_impl(self):
        return self.sol


def _RadauDenseOutput(t_old, t, y_old, Q, device):
    """The collocation-polynomial interpolant over one accepted step."""
    from .integrate import DenseOutput

    class RadauDenseOutput(DenseOutput):
        def __init__(s):
            super().__init__(t_old, t)
            s.h = t - t_old
            s.Q = Q
            s.order = Q.shape[1] - 1
            s.y_start = np.asarray(y_old)

        def _call_impl(s, tq):
            tq = np.asarray(tq)
            x = (tq - s.t_old) / s.h
            if tq.ndim == 0:
                y = s.y_start + np.dot(s.Q, np.cumprod(np.tile(x, s.order + 1)))
            else:
                p = np.cumprod(np.tile(x, (s.order + 1, 1)), axis=0)
                y = s.y_start[:, None] + np.dot(s.Q, p)
            return as_tensor(y, device)

    return RadauDenseOutput()
