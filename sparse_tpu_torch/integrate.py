"""ODE integration: ``solve_ivp`` with RK23, RK45, DOP853, BDF and Radau
(``sparse_tpu/integrate.py``).

The state ``y`` and every stage live on the device. One step attempt of
an explicit method (the stage evaluations, the candidate ``y_new`` and the
embedded error estimate) runs as torch ops with no host read; the
adaptive step-size controller is host scalar work that reads the error
norm once an attempt, the one counted fetch (``hostsync.fetch``) a step
attempt makes. The setup (the first-step choice) fetches y0, f0 and f1.
Complex systems (the quantum evolution) run as they are. The reference
jits the step; the port has the one eager path. BDF and Radau
(``_bdf.py``, ``_radau.py``) keep their host numpy control flow.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dop853_coefficients, hostsync
from ._bdf import BDF as _BDFImpl
from ._bdf import _host
from ._radau import Radau as _RadauImpl
from .utils import as_tensor

SAFETY = 0.9
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
EPS = np.finfo(float).eps


def _wrap_fun(fun, args):
    """Bind ``args``; a right-hand side that returns host values is moved
    to ``y``'s device."""

    def wrapped(t, y):
        out = fun(t, y, *args)
        return out if isinstance(out, torch.Tensor) else as_tensor(out, y.device)

    return wrapped


def validate_max_step(max_step):
    if max_step <= 0:
        raise ValueError("`max_step` must be positive.")
    return max_step


def validate_tol(rtol, atol, n):
    if rtol < 100 * EPS:
        rtol = 100 * EPS
    atol = np.asarray(atol)
    if atol.ndim > 0 and atol.shape != (n,):
        raise ValueError("`atol` has wrong shape.")
    if np.any(atol < 0):
        raise ValueError("`atol` must be positive.")
    return rtol, atol


def select_initial_step(fun, t0, y0, f0, direction, order, rtol, atol):
    """Empirical first-step selection (Hairer et al., as in scipy): the
    norms on the host, from fetches of y0, f0 and f1."""
    if y0.shape[0] == 0:
        return np.inf
    y0_h, f0_h = _host(y0), _host(f0)
    scale = atol + np.abs(y0_h) * rtol
    d0 = float(np.linalg.norm(y0_h / scale) / np.sqrt(y0.shape[0]))
    d1 = float(np.linalg.norm(f0_h / scale) / np.sqrt(y0.shape[0]))
    h0 = 1e-6 if d0 < 1e-5 or d1 < 1e-5 else 0.01 * d0 / d1
    y1 = y0 + float(np.asarray(h0 * direction, dtype=f0_h.real.dtype)) * f0
    f1 = fun(t0 + h0 * direction, y1)
    d2 = float(np.linalg.norm((_host(f1) - f0_h) / scale) / np.sqrt(y0.shape[0])) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = max(1e-6, h0 * 1e-3)
    else:
        h1 = (0.01 / max(d1, d2)) ** (1.0 / (order + 1))
    return min(100 * h0, h1)


class OdeSolver:
    """Base solver protocol (scipy.integrate.OdeSolver)."""

    TOO_SMALL_STEP = "Required step size is less than spacing between numbers."

    def __init__(self, fun, t0, y0, t_bound, vectorized=False, support_complex=True):
        self.t = t0
        self.t_old = None
        self.y = as_tensor(y0)
        if not (self.y.is_floating_point() or self.y.is_complex()):
            self.y = self.y.to(torch.float64)
        self.t_bound = t_bound
        self.vectorized = vectorized
        if vectorized:
            def fun_single(t, y):
                return fun(t, y[:, None])[:, 0]

            self.fun = fun_single
        else:
            self.fun = fun
        self.direction = np.sign(t_bound - t0) if t_bound != t0 else 1
        self.n = self.y.shape[0]
        self.status = "running"
        self.nfev = 0
        self.njev = 0
        self.nlu = 0

    @property
    def step_size(self):
        if self.t_old is None:
            return None
        return abs(self.t - self.t_old)

    def step(self):
        if self.status != "running":
            raise RuntimeError("Attempt to step on a failed or finished solver.")
        if self.n == 0 or self.t == self.t_bound:
            self.t_old = self.t
            self.t = self.t_bound
            self.status = "finished"
            return None
        t = self.t
        success, message = self._step_impl()
        if not success:
            self.status = "failed"
            return message
        self.t_old = t
        if self.direction * (self.t - self.t_bound) >= 0:
            self.status = "finished"
        return None

    def dense_output(self):
        if self.t_old is None:
            raise RuntimeError("Dense output is available after a successful step was made.")
        if self.n == 0 or self.t == self.t_old:
            return ConstantDenseOutput(self.t_old, self.t, self.y)
        return self._dense_output_impl()


def _stage_sum(h, a, Ks):
    """h * sum_j a_j K_j over the nonzero coefficients (the stage increment)."""
    return h * sum(float(aj) * Kj for aj, Kj in zip(a, Ks) if aj != 0)


class RungeKutta(OdeSolver):
    """Explicit embedded Runge-Kutta base (scipy.integrate's RungeKutta)."""

    C: np.ndarray
    A: np.ndarray
    B: np.ndarray
    E: np.ndarray
    P: np.ndarray
    order: int
    error_estimator_order: int
    n_stages: int

    def __init__(self, fun, t0, y0, t_bound, max_step=np.inf, rtol=1e-3, atol=1e-6,
                 vectorized=False, first_step=None, **extraneous):
        super().__init__(fun, t0, y0, t_bound, vectorized, support_complex=True)
        self.max_step = validate_max_step(max_step)
        self.rtol, self.atol = validate_tol(rtol, atol, self.n)
        self.f = self.fun(self.t, self.y)
        self.nfev += 1
        if first_step is None:
            self.h_abs = select_initial_step(self.fun, t0, self.y, self.f, self.direction,
                                             self.error_estimator_order, self.rtol, self.atol)
            self.nfev += 1
        else:
            if first_step <= 0 or first_step > abs(t_bound - t0):
                raise ValueError("`first_step` has wrong magnitude.")
            self.h_abs = float(first_step)
        self.K = None
        self.error_exponent = -1.0 / (self.error_estimator_order + 1)
        dev, real = self.y.device, self.y.real.dtype
        # the tolerance and the tableau rows the step reads, uploaded once
        self._atol = (float(self.atol) if self.atol.ndim == 0
                      else hostsync.upload(self.atol.astype(np.float64), dev).to(real))
        self._rows = {name: hostsync.upload(np.asarray(getattr(self, name), np.float64),
                                            dev).to(self.y.dtype)
                      for name in self._TABLEAU_ROWS}

    _TABLEAU_ROWS = ("B", "E")

    def _scale(self, y, y_new):
        return self._atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * self.rtol

    def _stages(self, t, h, y, f):
        """The stages K [n_stages + 1, n] (the last the FSAL f_new) and y_new."""
        Ks = [f]
        for s in range(1, self.n_stages):
            Ks.append(self.fun(float(t + self.C[s] * h), y + _stage_sum(h, self.A[s, :s], Ks)))
        y_new = y + h * (self._rows["B"] @ torch.stack(Ks))
        f_new = self.fun(t + h, y_new)
        return torch.stack(Ks + [f_new]), y_new, f_new

    def _attempt(self, t, h, y, f):
        """One step attempt on the device: (y_new, f_new, K, error norm)."""
        K, y_new, f_new = self._stages(t, h, y, f)
        err = h * (self._rows["E"] @ K)
        error_norm = torch.sqrt(torch.mean(torch.abs(err / self._scale(y, y_new)) ** 2))
        return y_new, f_new, K, error_norm

    def _step_impl(self):
        t = self.t
        max_step = self.max_step
        min_step = 10 * abs(np.nextafter(t, self.direction * np.inf) - t)
        h_abs = min(max(self.h_abs, min_step), max_step)
        step_accepted = False
        step_rejected = False
        while not step_accepted:
            if h_abs < min_step:
                return False, self.TOO_SMALL_STEP
            h = h_abs * self.direction
            t_new = t + h
            if self.direction * (t_new - self.t_bound) > 0:
                t_new = self.t_bound
            h = t_new - t
            h_abs = abs(h)
            y_new, f_new, K, error_norm = self._attempt(t, h, self.y, self.f)
            # the stages 1..n_stages-1 and f_new
            self.nfev += self.n_stages
            error_norm = float(hostsync.fetch(error_norm))
            if error_norm < 1:
                factor = (MAX_FACTOR if error_norm == 0
                          else min(MAX_FACTOR, SAFETY * error_norm**self.error_exponent))
                if step_rejected:
                    factor = min(1.0, factor)
                h_abs *= factor
                step_accepted = True
            else:
                h_abs *= max(MIN_FACTOR, SAFETY * error_norm**self.error_exponent)
                step_rejected = True
        self.h_previous = h
        self.y_old = self.y
        self.t = t_new
        self.y = y_new
        self.h_abs = h_abs
        self.f = f_new
        self.K = K
        return True, None

    def _dense_output_impl(self):
        Q = self.K.T @ as_tensor(self.P, self.K.device).to(self.K.dtype)
        return RkDenseOutput(self.t_old, self.t, self.y_old, Q)


class RK23(RungeKutta):
    """Bogacki-Shampine 3(2) pair."""

    order = 3
    error_estimator_order = 2
    n_stages = 3
    C = np.array([0, 1 / 2, 3 / 4])
    A = np.array([[0, 0, 0], [1 / 2, 0, 0], [0, 3 / 4, 0]])
    B = np.array([2 / 9, 1 / 3, 4 / 9])
    E = np.array([5 / 72, -1 / 12, -1 / 9, 1 / 8])
    P = np.array([[1, -4 / 3, 5 / 9], [0, 1, -2 / 3], [0, 4 / 3, -8 / 9], [0, -1, 1]])


class RK45(RungeKutta):
    """Dormand-Prince 5(4) pair."""

    order = 5
    error_estimator_order = 4
    n_stages = 6
    C = np.array([0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1])
    A = np.array([
        [0, 0, 0, 0, 0],
        [1 / 5, 0, 0, 0, 0],
        [3 / 40, 9 / 40, 0, 0, 0],
        [44 / 45, -56 / 15, 32 / 9, 0, 0],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    ])
    B = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84])
    E = np.array([71 / 57600, 0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40])
    P = np.array([
        [1, -8048581381 / 2820520608, 8663915743 / 2820520608, -12715105075 / 11282082432],
        [0, 0, 0, 0],
        [0, 131558114200 / 32700410799, -68118460800 / 10900136933, 87487479700 / 32700410799],
        [0, -1754552775 / 470086768, 14199869525 / 1410260304, -10690763975 / 1880347072],
        [0, 127303824393 / 49829197408, -318862633887 / 49829197408,
         701980252875 / 199316789632],
        [0, -282668133 / 205662961, 2019193451 / 616988883, -1453857185 / 822651844],
        [0, 40617522 / 29380423, -110615467 / 29380423, 69997945 / 29380423],
    ])


class DOP853(RungeKutta):
    """Hairer's 8(5,3) method with 7th-order dense output."""

    n_stages = dop853_coefficients.N_STAGES
    order = 8
    error_estimator_order = 7
    A = dop853_coefficients.A[:n_stages, :n_stages]
    B = dop853_coefficients.B
    C = dop853_coefficients.C[:n_stages]
    E3 = dop853_coefficients.E3
    E5 = dop853_coefficients.E5
    D = dop853_coefficients.D
    A_EXTRA = dop853_coefficients.A[n_stages + 1:]
    C_EXTRA = dop853_coefficients.C[n_stages + 1:]
    E = None  # the error comes from the 5-3 pair below
    _TABLEAU_ROWS = ("B", "E3", "E5")

    def _attempt(self, t, h, y, f):
        K, y_new, f_new = self._stages(t, h, y, f)
        scale = self._scale(y, y_new)
        err5n2 = torch.sum(torch.abs((self._rows["E5"] @ K) / scale) ** 2)
        err3n2 = torch.sum(torch.abs((self._rows["E3"] @ K) / scale) ** 2)
        denom = err5n2 + 0.01 * err3n2
        nn = max(y.shape[0], 1)
        error_norm = abs(h) * err5n2 / torch.sqrt(torch.where(denom == 0, 1.0, denom) * nn)
        return y_new, f_new, K, torch.where(denom > 0, error_norm, 0.0)

    def _dense_output_impl(self):
        """Extended-stage 7th-order interpolant (scipy's)."""
        K = self.K  # [n_stages + 1, n]
        h = self.h_previous
        Ks_ext = list(K)
        for s_ext, (a, c) in enumerate(zip(self.A_EXTRA, self.C_EXTRA)):
            s = self.n_stages + 1 + s_ext
            Ks_ext.append(self.fun(float(self.t_old + c * h),
                                   self.y_old + _stage_sum(h, a[:s], Ks_ext)))
            self.nfev += 1
        K_ext = torch.stack(Ks_ext)
        f_old = K[0]
        delta_y = self.y - self.y_old
        F = torch.cat([torch.stack([delta_y, h * f_old - delta_y,
                                    2 * delta_y - h * (self.f + f_old)]),
                       h * (as_tensor(self.D, K.device).to(K.dtype) @ K_ext)])
        return Dop853DenseOutput(self.t_old, self.t, self.y_old, F)


# ---------------------------------------------------------------------------
# dense outputs
# ---------------------------------------------------------------------------
class DenseOutput:
    def __init__(self, t_old, t):
        self.t_old = t_old
        self.t = t
        self.t_min = min(t, t_old)
        self.t_max = max(t, t_old)

    def __call__(self, t):
        t = np.asarray(t)
        if t.ndim > 1:
            raise ValueError("`t` must be a float or a 1-D array.")
        return self._call_impl(t)


class ConstantDenseOutput(DenseOutput):
    def __init__(self, t_old, t, value):
        super().__init__(t_old, t)
        self.value = value

    def _call_impl(self, t):
        if t.ndim == 0:
            return self.value
        return self.value[:, None].repeat(1, t.shape[0])


class RkDenseOutput(DenseOutput):
    def __init__(self, t_old, t, y_old, Q):
        super().__init__(t_old, t)
        self.h = t - t_old
        self.Q = Q
        self.order = Q.shape[1] - 1
        self.y_old = y_old

    def _call_impl(self, t):
        x = (t - self.t_old) / self.h
        reps = self.order + 1 if t.ndim == 0 else (self.order + 1, 1)
        p = as_tensor(np.cumprod(np.tile(x, reps), axis=0), self.Q.device).to(self.Q.dtype)
        y = self.h * (self.Q @ p)
        return self.y_old + y if t.ndim == 0 else self.y_old[:, None] + y


class Dop853DenseOutput(DenseOutput):
    def __init__(self, t_old, t, y_old, F):
        super().__init__(t_old, t)
        self.h = t - t_old
        self.F = F
        self.y_old = y_old

    def _call_impl(self, t):
        x = (t - self.t_old) / self.h
        if t.ndim == 0:
            x = float(x)
            y = torch.zeros_like(self.y_old)
            for i, f in enumerate(reversed(list(self.F))):
                y = (y + f) * (x if i % 2 == 0 else 1 - x)
            return y + self.y_old
        y = torch.zeros((self.y_old.shape[0], t.shape[0]), dtype=self.y_old.dtype,
                        device=self.y_old.device)
        xj = as_tensor(x[None, :], self.y_old.device).to(torch.promote_types(
            self.y_old.dtype, torch.float64))
        for i, f in enumerate(reversed(list(self.F))):
            y = (y + f[:, None]) * (xj if i % 2 == 0 else 1 - xj)
        return y + self.y_old[:, None]


class OdeSolution:
    """Piecewise dense-output interpolant collection (scipy's)."""

    def __init__(self, ts, interpolants):
        self.ts = np.asarray(ts)
        self.interpolants = interpolants
        d = np.diff(self.ts)
        self.ascending = np.all(d >= 0)
        self.t_min = self.ts[0] if self.ascending else self.ts[-1]
        self.t_max = self.ts[-1] if self.ascending else self.ts[0]

    def _segment(self, t):
        ts = self.ts if self.ascending else self.ts[::-1]
        i = np.clip(np.searchsorted(ts, t, side="left") - 1, 0, len(self.interpolants) - 1)
        if not self.ascending:
            i = len(self.interpolants) - 1 - i
        return int(i)

    def __call__(self, t):
        t = np.asarray(t, dtype=float)
        if t.ndim == 0:
            return self.interpolants[self._segment(t)](t)
        # consecutive query points of one segment: one batched evaluation
        segs = np.array([self._segment(tv) for tv in t])
        cols = []
        i = 0
        while i < t.shape[0]:
            j = i
            while j < t.shape[0] and segs[j] == segs[i]:
                j += 1
            cols.append(self.interpolants[segs[i]](t[i:j]))
            i = j
        return torch.cat(cols, dim=1)


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------
def prepare_events(events, args=()):
    if callable(events):
        events = (events,)
    if events is None:
        return None, None, None
    is_terminal = np.empty(len(events), dtype=bool)
    direction = np.empty(len(events))
    wrapped = []
    for i, event in enumerate(events):
        is_terminal[i] = bool(getattr(event, "terminal", False))
        direction[i] = getattr(event, "direction", 0)
        if args:
            # scipy's contract: events receive the same extra args as fun
            wrapped.append(lambda t, y, event=event: event(t, y, *args))
        else:
            wrapped.append(event)
    return wrapped, is_terminal, direction


def _event_value(event, t, y) -> float:
    return float(_host(event(t, y)))


def solve_event_equation(event, sol, t_old, t):
    from scipy.optimize import brentq

    return brentq(lambda tt: _event_value(event, tt, sol(tt)), t_old, t,
                  xtol=4 * EPS, rtol=4 * EPS)


def find_active_events(g, g_new, direction):
    g, g_new = np.asarray(g), np.asarray(g_new)
    up = (g <= 0) & (g_new >= 0)
    down = (g >= 0) & (g_new <= 0)
    either = up | down
    mask = (up & (direction > 0)) | (down & (direction < 0)) | (either & (direction == 0))
    return np.nonzero(mask)[0]


def handle_events(sol, events, active_events, is_terminal, t_old, t):
    roots = np.asarray([solve_event_equation(events[e], sol, t_old, t) for e in active_events])
    if np.any(is_terminal[active_events]):
        order = np.argsort(np.sign(t - t_old) * roots)
        active_events = active_events[order]
        roots = roots[order]
        stop = np.nonzero(is_terminal[active_events])[0][0]
        return active_events[: stop + 1], roots[: stop + 1], True
    return active_events, roots, False


# ---------------------------------------------------------------------------
# solve_ivp
# ---------------------------------------------------------------------------
class BDF(_BDFImpl, OdeSolver):
    """Stiff variable-order BDF/NDF method (scipy.integrate.BDF); see
    ``_bdf.py``."""


class Radau(_RadauImpl, OdeSolver):
    """Stiff L-stable Radau IIA(5) implicit Runge-Kutta
    (scipy.integrate.Radau); see ``_radau.py``."""


METHODS = {"RK23": RK23, "RK45": RK45, "DOP853": DOP853, "BDF": BDF, "Radau": Radau}

MESSAGES = {
    0: "The solver successfully reached the end of the integration interval.",
    1: "A termination event occurred.",
}


class OdeResult(dict):
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    __setattr__ = dict.__setitem__


def solve_ivp(fun, t_span, y0, method="RK45", t_eval=None, dense_output=False, events=None,
              vectorized=False, args=None, device=None, _step_callback=None, **options):
    """Integrate dy/dt = fun(t, y) (scipy.integrate.solve_ivp's surface).
    ``y0`` as a tensor stays on its device; host values go to ``device``
    (default ``settings.device``). ``out.y`` is a tensor on that device."""
    if method not in METHODS and not (isinstance(method, type) and issubclass(method, OdeSolver)):
        raise ValueError(f"`method` must be one of {set(METHODS)} or OdeSolver class.")
    t0, tf = map(float, t_span)
    y0 = as_tensor(y0, device)
    if y0.ndim != 1:
        raise ValueError("`y0` must be 1-dimensional.")
    fun = _wrap_fun(fun, args or ())

    if t_eval is not None:
        t_eval = np.asarray(t_eval)
        if t_eval.ndim != 1:
            raise ValueError("`t_eval` must be 1-dimensional.")
        if np.any(t_eval < min(t0, tf)) or np.any(t_eval > max(t0, tf)):
            raise ValueError("Values in `t_eval` are not within `t_span`.")
        d = np.diff(t_eval)
        if tf > t0 and np.any(d <= 0) or tf < t0 and np.any(d >= 0):
            raise ValueError("Values in `t_eval` are not properly sorted.")
        if tf < t0:
            t_eval = t_eval[::-1]

    if isinstance(method, str):
        method = METHODS[method]
    solver = method(fun, t0, y0, tf, vectorized=vectorized, **options)

    ts, ys = ([t0], [solver.y]) if t_eval is None else ([], [])
    interpolants = []
    events, is_terminal, event_dir = prepare_events(events, args or ())
    if events is not None:
        g = [_event_value(event, t0, solver.y) for event in events]
        t_events = [[] for _ in range(len(events))]
        y_events = [[] for _ in range(len(events))]
    else:
        t_events = y_events = None

    status = None
    while status is None:
        message = solver.step()
        if solver.status == "finished":
            status = 0
        elif solver.status == "failed":
            status = -1
            break
        t_old, t, y = solver.t_old, solver.t, solver.y
        if _step_callback is not None:
            _step_callback(t, y)
        if dense_output or t_eval is not None or events is not None:
            sol = solver.dense_output()
            if dense_output:
                interpolants.append(sol)
        else:
            sol = None
        if events is not None:
            g_new = [_event_value(event, t, y) for event in events]
            active = find_active_events(g, g_new, event_dir)
            if active.size > 0:
                root_events, roots, terminate = handle_events(sol, events, active, is_terminal,
                                                              t_old, t)
                for e, te in zip(root_events, roots):
                    t_events[e].append(te)
                    y_events[e].append(sol(te))
                if terminate:
                    status = 1
                    t = roots[-1]
                    y = sol(t)
            g = g_new
        if t_eval is None:
            ts.append(t)
            ys.append(y)
        else:
            if solver.direction > 0:
                sel = (t_eval >= t_old) & (t_eval <= t) & (t_eval > (ts[-1] if ts else -np.inf))
            else:
                sel = (t_eval <= t_old) & (t_eval >= t) & (t_eval < (ts[-1] if ts else np.inf))
            for te in t_eval[sel]:
                ts.append(float(te))
                ys.append(sol(np.asarray(float(te))))

    message = MESSAGES.get(status, message)
    if t_events is not None:
        t_events = [np.asarray(te) for te in t_events]
        # [n_occurrences, n], as scipy's
        y_events = [torch.stack(ye, 0) if ye else np.empty((0, solver.n)) for ye in y_events]
    ys_arr = torch.stack(ys, 1) if ys else np.empty((solver.n, 0))
    sol_out = None
    if dense_output and interpolants:
        sol_out = OdeSolution(np.concatenate([[t0], [i.t for i in interpolants]]), interpolants)
    return OdeResult(t=np.asarray(ts), y=ys_arr, sol=sol_out, t_events=t_events,
                     y_events=y_events, nfev=solver.nfev, njev=solver.njev, nlu=solver.nlu,
                     status=status, message=message, success=status >= 0)
