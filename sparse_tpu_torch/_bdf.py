"""BDF: the variable-order (1-5) implicit multistep method for stiff ODEs
(``sparse_tpu/_bdf.py``; scipy.integrate.BDF semantics, NDF constants).

The control flow (the difference array ``D``, the Newton test, the order
and step choice) is host numpy, as in the reference. The Newton
iteration's linear solves are a dense LU on the state's device
(``torch.linalg.lu_factor`` once a Jacobian or step-size change,
``lu_solve`` an iteration), and the Jacobian of a sparse-matrix right-hand
side can be handed in as a sparse array, which is densified there (the
linear ODE y' = A y of the PDE and quantum workloads).
"""

from __future__ import annotations

import numpy as np
import torch

from . import hostsync
from .utils import as_tensor

MAX_ORDER = 5
NEWTON_MAXITER = 4
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0


def _host(x) -> np.ndarray:
    """A device value as host numpy through the counted fetch."""
    return hostsync.fetch(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _norm_rms(x, scale):
    return float(np.linalg.norm(np.asarray(x) / np.asarray(scale)) / np.sqrt(x.shape[0]))


def _compute_R(order, factor):
    """Pascal-like matrix relating difference arrays at step ratios
    (Shampine & Reichelt, ode15s)."""
    I = np.arange(1, order + 1)[:, None]
    J = np.arange(1, order + 1)[None, :]
    M = np.zeros((order + 1, order + 1))
    M[1:, 1:] = (I - 1 - factor * J) / I
    M[0] = 1
    return np.cumprod(M, axis=0)


def _change_D(D, order, factor):
    R = _compute_R(order, factor)
    U = _compute_R(order, 1)
    RU = R.dot(U)
    D[: order + 1] = RU.T @ D[: order + 1]


def _lu_solve(LU, b) -> np.ndarray:
    """Solve with a device factor for a host right-hand side; host result."""
    lu, piv = LU
    bt = as_tensor(np.asarray(b), lu.device).to(lu.dtype)
    return _host(torch.linalg.lu_solve(lu, piv, bt[:, None])[:, 0])


class BDF:
    """Implicit multistep BDF/NDF solver (``solve_ivp(..., method='BDF')``;
    integrate.py binds it with ``OdeSolver`` as a mixin base)."""

    def __init__(self, fun, t0, y0, t_bound, max_step=np.inf, rtol=1e-3, atol=1e-6, jac=None,
                 jac_sparsity=None, vectorized=False, first_step=None, **extraneous):
        from .integrate import OdeSolver, select_initial_step, validate_max_step, validate_tol

        OdeSolver.__init__(self, fun, t0, y0, t_bound, vectorized, support_complex=True)
        self.max_step = validate_max_step(max_step)
        self.rtol, self.atol = validate_tol(rtol, atol, self.n)
        f = self.fun(self.t, self.y)
        self.nfev += 1
        if first_step is None:
            self.h_abs = select_initial_step(self.fun, self.t, self.y, f, self.direction, 1,
                                             self.rtol, self.atol)
        else:
            self.h_abs = float(first_step)
        self.h_abs_old = None
        self.error_norm_old = None
        # from the validated rtol, which validate_tol may have raised
        self.newton_tol = max(10 * np.finfo(np.float64).eps / self.rtol, min(0.03, self.rtol**0.5))
        self._jac_arg = jac
        self.jac_factor = None
        self.J = self._validate_jac(self.t, self.y, f)
        self.LU = None
        self.current_jac = True

        kappa = np.array([0, -0.1850, -1 / 9, -0.0823, -0.0415, 0])
        self.gamma = np.hstack((0, np.cumsum(1 / np.arange(1, MAX_ORDER + 1))))
        self.alpha = (1 - kappa) * self.gamma
        self.error_const = kappa * self.gamma + 1 / np.arange(1, MAX_ORDER + 2)

        y_h = _host(self.y)
        D = np.empty((MAX_ORDER + 3, self.n), dtype=y_h.dtype)
        D[0] = y_h
        D[1] = _host(f) * self.h_abs * self.direction
        self.D = D
        self.order = 1
        self.n_equal_steps = 0

    # -- the Jacobian (a device matrix) --------------------------------------
    def _validate_jac(self, t, y, f):
        jac = self._jac_arg
        if jac is None:
            self._jac_callable = None
            return self._num_jac(t, y, f)
        if callable(jac):
            self._jac_callable = jac
            J = jac(t, y)
            self.njev += 1
            return self._as_dense(J)
        self._jac_callable = None
        self._jac_const = self._as_dense(jac)
        return self._jac_const

    def _as_dense(self, J):
        """A Jacobian (a port or scipy sparse array, or dense) as a dense
        matrix on the state's device."""
        return as_tensor(J.toarray() if hasattr(J, "toarray") else J, self.y.device)

    def _num_jac(self, t, y, f):
        """Dense forward-difference Jacobian (n extra right-hand sides;
        supply ``jac`` for large systems)."""
        y_np, f_np = _host(y), _host(f)
        n = self.n
        J = np.empty((n, n), dtype=f_np.dtype)
        eps = np.finfo(y_np.real.dtype if np.iscomplexobj(y_np) else y_np.dtype).eps
        h = eps**0.5 * np.maximum(np.abs(y_np), 1e-5)
        for i in range(n):
            yp = y_np.copy()
            yp[i] += h[i]
            J[:, i] = (_host(self.fun(t, as_tensor(yp, self.y.device))) - f_np) / h[i]
        self.nfev += n
        self.njev += 1
        return as_tensor(J, self.y.device)

    def _refresh_jac(self, t, y, f):
        if self._jac_callable is not None:
            self.njev += 1
            return self._as_dense(self._jac_callable(t, y))
        if self._jac_arg is not None:
            return self._jac_const
        return self._num_jac(t, y, f)

    # -- linear algebra ---------------------------------------------------------
    def _lu(self, c):
        self.nlu += 1
        J = self.J.to(torch.promote_types(self.J.dtype, self.y.dtype))
        return torch.linalg.lu_factor(torch.eye(self.n, dtype=J.dtype, device=J.device)
                                      - float(c) * J)

    # -- Newton -------------------------------------------------------------------
    def _solve_bdf_system(self, t_new, y_predict, c, psi, LU, scale):
        d = np.zeros_like(y_predict)
        y = y_predict.copy()
        dy_norm_old = None
        converged = False
        for k in range(NEWTON_MAXITER):
            f = _host(self.fun(t_new, as_tensor(y, self.y.device)))
            self.nfev += 1
            if not np.all(np.isfinite(f)):
                break
            dy = _lu_solve(LU, c * f - psi - d)
            dy_norm = _norm_rms(dy, scale)
            rate = None if dy_norm_old is None else dy_norm / dy_norm_old
            if rate is not None and (
                rate >= 1 or rate ** (NEWTON_MAXITER - k) / (1 - rate) * dy_norm > self.newton_tol
            ):
                break
            y = y + dy
            d = d + dy
            if dy_norm == 0 or (rate is not None and rate / (1 - rate) * dy_norm
                                < self.newton_tol):
                converged = True
                break
            dy_norm_old = dy_norm
        return converged, k + 1, y, d

    # -- stepping ------------------------------------------------------------------
    def _step_impl(self):
        t = self.t
        D = self.D
        max_step = self.max_step
        min_step = 10 * np.abs(np.nextafter(t, self.direction * np.inf) - t)
        if self.h_abs > max_step:
            h_abs = max_step
            _change_D(D, self.order, max_step / self.h_abs)
            self.n_equal_steps = 0
        elif self.h_abs < min_step:
            h_abs = min_step
            _change_D(D, self.order, min_step / self.h_abs)
            self.n_equal_steps = 0
        else:
            h_abs = self.h_abs

        order = self.order
        alpha, gamma, error_const = self.alpha, self.gamma, self.error_const
        atol, rtol = self.atol, self.rtol
        dev = self.y.device

        step_accepted = False
        while not step_accepted:
            if h_abs < min_step:
                return False, self.TOO_SMALL_STEP
            h = h_abs * self.direction
            t_new = t + h
            if self.direction * (t_new - self.t_bound) > 0:
                t_new = self.t_bound
                _change_D(D, order, np.abs(t_new - t) / h_abs)
                self.n_equal_steps = 0
                self.LU = None
            h = t_new - t
            h_abs = np.abs(h)

            y_predict = np.sum(D[: order + 1], axis=0)
            scale = atol + rtol * np.abs(y_predict)
            psi = np.dot(D[1: order + 1].T, gamma[1: order + 1]) / alpha[order]

            converged = False
            c = h / alpha[order]
            while not converged:
                if self.LU is None:
                    self.LU = self._lu(c)
                converged, n_iter, y_new, d = self._solve_bdf_system(t_new, y_predict, c, psi,
                                                                     self.LU, scale)
                if not converged:
                    if self.current_jac:
                        break
                    yp = as_tensor(y_predict, dev)
                    self.J = self._refresh_jac(t_new, yp,
                                               as_tensor(_host(self.fun(t_new, yp)), dev))
                    self.current_jac = True
                    self.LU = None
            if not converged:
                factor = 0.5
                h_abs *= factor
                _change_D(D, order, factor)
                self.n_equal_steps = 0
                self.LU = None
                continue

            safety = 0.9 * (2 * NEWTON_MAXITER + 1) / (2 * NEWTON_MAXITER + n_iter)
            scale = atol + rtol * np.abs(y_new)
            error = error_const[order] * d
            error_norm = _norm_rms(error, scale)
            if error_norm > 1:
                factor = max(MIN_FACTOR, safety * error_norm ** (-1 / (order + 1)))
                h_abs *= factor
                _change_D(D, order, factor)
                self.n_equal_steps = 0
                continue
            step_accepted = True

        self.n_equal_steps += 1
        self.t = t_new
        self.y = as_tensor(y_new, dev)
        self.h_abs = h_abs
        self.h_abs_old = h_abs
        self.error_norm_old = error_norm
        # the Jacobian is now stale at the advanced (t, y): a Newton failure
        # on the next step refreshes it before halving the step; a constant
        # Jacobian never goes stale
        if self._jac_callable is not None or self._jac_arg is None:
            self.current_jac = False

        # update the differences
        D[order + 2] = d - D[order + 1]
        D[order + 1] = d
        for i in reversed(range(order + 1)):
            D[i] += D[i + 1]

        if self.n_equal_steps < order + 1:
            return True, None

        # consider an order change once enough equal steps accumulated
        if order > 1:
            error_m_norm = _norm_rms(error_const[order - 1] * D[order], scale)
        else:
            error_m_norm = np.inf
        if order < MAX_ORDER:
            error_p_norm = _norm_rms(error_const[order + 1] * D[order + 2], scale)
        else:
            error_p_norm = np.inf
        error_norms = np.array([error_m_norm, error_norm, error_p_norm])
        with np.errstate(divide="ignore"):
            factors = error_norms ** (-1 / np.arange(order, order + 3))
        delta_order = int(np.argmax(factors)) - 1
        order += delta_order
        self.order = order
        factor = min(MAX_FACTOR, safety * np.max(factors))
        self.h_abs *= factor
        _change_D(D, order, factor)
        self.n_equal_steps = 0
        self.LU = None
        self.current_jac = False
        return True, None

    def _dense_output_impl(self):
        from .integrate import DenseOutput

        dev = self.y.device

        class BdfDenseOutput(DenseOutput):
            def __init__(s, t_old, t, h, order, D):
                super().__init__(t_old, t)
                s.order = order
                s.t_shift = s.t - h * np.arange(s.order)
                s.denom = h * (1 + np.arange(s.order))
                s.D = D[: order + 1]

            def _call_impl(s, t):
                t = np.asarray(t)
                if t.ndim == 0:
                    p = np.cumprod((t - s.t_shift) / s.denom)
                else:
                    p = np.cumprod((t[None, :] - s.t_shift[:, None]) / s.denom[:, None], axis=0)
                y = np.dot(s.D[1:].T, p)
                y += s.D[0] if y.ndim == 1 else s.D[0][:, None]
                return as_tensor(y, dev)

        return BdfDenseOutput(self.t_old, self.t, self.h_abs * self.direction, self.order,
                              self.D.copy())
