"""sparse_tpu_torch.integrate against sparse_tpu.integrate on the CPU
(mirrors tests/test_integrate.py and tests/test_bdf.py).

The same right-hand sides and seeded initial values go through both
packages in f64 (and complex128). Tolerances:

* the step counts, ``nfev``, ``njev`` and ``nlu`` are equal;
* the accepted times agree to 5e-8 relative and the states to 5e-9 of
  the largest entry: 3.8x and 3x the worst gaps these problems show (1.31e-8
  in t, backward exp_decay; 1.68e-9 in y, DOP853 exp_decay). The reference
  jit-compiles its step, and XLA on the CPU contracts a multiply and the
  add after it into one fused multiply-add (the stage sums, y + h dy, its
  small dots), where torch rounds each op. DOP853's error estimate is a sum
  of stages cancelling to ~1e-11 of their size, so the error norms differ
  at most step attempts: by at most 1e-6 relative where the controller
  sizes the next step from them, by more (6e-4 at DOP853's first step, 0.97
  in the cannon's steps) only where the norm is so small that the growth
  is capped at 10. The next step moves by an eighth (DOP853) to a third
  (RK23) of that and the times carry it;
  with the reference run op by op (``jax.disable_jit``) the gaps fall to
  4.2e-10 in t and 1.4e-10 in y, and the runs on 1-element states repeat
  it bit for bit;
* the stiff solvers' LU solves (LAPACK through torch against XLA's LU)
  round in other orders as well, within the same bounds (8.4e-10 in t,
  1.2e-10 in y at worst).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu
from sparse_tpu import integrate as jintegrate

import sparse_tpu_torch as st
from sparse_tpu_torch import hostsync, integrate

RK = ["RK23", "RK45", "DOP853"]


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(out, ref, ytol=5e-9):
    assert out.status == ref.status and out.success == ref.success
    assert out.nfev == ref.nfev and out.njev == ref.njev and out.nlu == ref.nlu
    assert out.t.shape == ref.t.shape
    np.testing.assert_allclose(out.t, ref.t, rtol=5e-8, atol=1e-300)
    y, yr = _np(out.y), _np(ref.y)
    assert y.shape == yr.shape
    np.testing.assert_allclose(y, yr, rtol=ytol, atol=ytol * np.abs(yr).max())


def _both(fun, *args, **kw):
    return integrate.solve_ivp(fun, *args, **kw), jintegrate.solve_ivp(fun, *args, **kw)


def exp_decay(t, y):
    return -0.5 * y


def lotka(t, y):
    a, b, c, d = 1.5, 1.0, 3.0, 1.0
    return np.array([float(a * y[0] - b * y[0] * y[1]), float(-c * y[1] + d * y[0] * y[1])])


@pytest.mark.parametrize("method", RK)
def test_exp_decay(method):
    _same(*_both(exp_decay, (0, 10), [2.0, 4.0], method=method, rtol=1e-8, atol=1e-10))


@pytest.mark.parametrize("method", RK)
def test_lotka_volterra_t_eval(method):
    out, ref = _both(lotka, (0, 10), [10.0, 5.0], method=method,
                     t_eval=np.linspace(0, 10, 31), rtol=1e-7, atol=1e-9)
    _same(out, ref)


@pytest.mark.parametrize("method", RK)
def test_dense_output(method):
    out, ref = _both(exp_decay, (0, 5), [1.0], method=method, dense_output=True, rtol=1e-9,
                     atol=1e-11)
    _same(out, ref)
    tq = np.linspace(0, 5, 17)
    np.testing.assert_allclose(_np(out.sol(tq)), _np(ref.sol(tq)), rtol=1e-10)
    np.testing.assert_allclose(_np(out.sol(1.3)), _np(ref.sol(1.3)), rtol=1e-10)


@pytest.mark.parametrize("method", RK)
def test_complex_oscillator(method):
    _same(*_both(lambda t, y: -1j * y, (0, 2 * np.pi), np.array([1.0 + 0j, 0.5 - 0.25j]),
                 method=method, rtol=1e-9, atol=1e-11))


def test_complex_sparse_rhs_dop853():
    """y' = -i H y with H a seeded symmetric sparse matrix in complex128,
    each package's own CSR product (the quantum evolution's shape)."""
    rng = np.random.default_rng(5)
    S = sp.random(40, 40, 0.15, random_state=rng)
    S = ((S + S.T) * 0.5).tocsr().astype(np.complex128)
    H, Hj = st.csr_array(S), sparse_tpu.csr_array(S)
    y0 = (rng.standard_normal(40) + 1j * rng.standard_normal(40)) / 9
    out = integrate.solve_ivp(lambda t, y: -1j * (H @ y), (0, 1.5), y0, method="DOP853",
                              rtol=1e-10, atol=1e-12)
    ref = jintegrate.solve_ivp(lambda t, y: -1j * (Hj @ y), (0, 1.5), y0, method="DOP853",
                               rtol=1e-10, atol=1e-12)
    _same(out, ref)
    assert out.y.dtype == torch.complex128


def test_event_terminal_and_backward():
    def hit_ground(t, y):
        return y[0]

    hit_ground.terminal = True
    hit_ground.direction = -1

    def cannon(t, y):
        return np.array([float(y[1]), -9.8])

    out, ref = _both(cannon, (0, 100), [0.0, 10.0], events=hit_ground, rtol=1e-9, atol=1e-11)
    assert out.status == 1
    _same(out, ref)
    np.testing.assert_allclose(out.t_events[0], ref.t_events[0], rtol=1e-12)
    np.testing.assert_allclose(_np(out.y_events[0]), _np(ref.y_events[0]), rtol=1e-10,
                               atol=1e-12)
    _same(*_both(exp_decay, (10, 0), [2 * np.exp(-5)], rtol=1e-9, atol=1e-11))


def test_args_and_vectorized():
    _same(*_both(lambda t, y, k: -k * y, (0, 1), [1.0], args=(2.0,), rtol=1e-9, atol=1e-11))
    _same(*_both(lambda t, y: -0.5 * y, (0, 2), [1.0, 3.0], vectorized=True, rtol=1e-8))


def test_one_counted_fetch_a_step_attempt():
    """Past the setup's three fetches (y0, f0 and f1), an explicit method
    reads the host once a step attempt: the error norm."""
    hostsync.HOST_SYNCS = 0
    out = integrate.solve_ivp(exp_decay, (0, 10), np.ones(8), method="DOP853", rtol=1e-8,
                              atol=1e-10)
    attempts = (out.nfev - 2) // integrate.DOP853.n_stages
    assert hostsync.HOST_SYNCS == 3 + attempts


def _error_norms(monkeypatch):
    """Record each step attempt's error norm in both packages."""
    seen = {"port": [], "ref": []}
    for cls in (integrate.RungeKutta, integrate.DOP853):
        def attempt(self, *a, _orig=cls.__dict__["_attempt"]):
            out = _orig(self, *a)
            seen["port"].append(float(out[3]))
            return out
        monkeypatch.setattr(cls, "_attempt", attempt)
    build = jintegrate.RungeKutta._build_step_core

    def build_recording(self):
        core = build(self)

        def recording(*a):
            out = core(*a)
            seen["ref"].append(float(out[3]))
            return out
        return recording
    monkeypatch.setattr(jintegrate.RungeKutta, "_build_step_core", build_recording)
    return seen


@pytest.mark.parametrize("method,t_span,y0", [("DOP853", (0, 10), [2.0, 4.0]),
                                              ("RK45", (0, 10), [2.0, 4.0]),
                                              ("RK45", (10, 0), [2 * np.exp(-5)])])
def test_error_norm_gap_where_the_controller_reads_it(monkeypatch, method, t_span, y0):
    """The error norms of the two packages agree to 2e-6 relative wherever
    the next step is sized from them (the tolerances of ``_same`` rest on
    it); below (0.9 / 10)^(order + 1) the growth is capped at 10 and the
    norm's last digits move nothing."""
    seen = _error_norms(monkeypatch)
    _both(exp_decay, t_span, y0, method=method, rtol=1e-8 if len(y0) > 1 else 1e-9,
          atol=1e-10 if len(y0) > 1 else 1e-11)
    port, ref = np.array(seen["port"]), np.array(seen["ref"])
    assert port.shape == ref.shape and port.size > 5
    cls = getattr(integrate, method)
    used = ref > (0.9 / 10) ** (cls.error_estimator_order + 1)
    assert used.sum() >= port.size - 2
    assert np.all(np.abs(port - ref)[used] <= 2e-6 * ref[used])


@pytest.mark.parametrize("method,y0", [("DOP853", [1.0]), ("RK45", [1.0]), ("RK23", [1.0])])
def test_op_by_op_reference_repeats_bit_for_bit(method, y0):
    """With the reference run op by op (no fused multiply-adds of a jit),
    a 1-element state's step control equals the port's bit for bit."""
    import jax

    out = integrate.solve_ivp(exp_decay, (0, 5), y0, method=method, rtol=1e-9, atol=1e-11)
    with jax.disable_jit():
        ref = jintegrate.solve_ivp(exp_decay, (0, 5), y0, method=method, rtol=1e-9, atol=1e-11)
    assert out.nfev == ref.nfev and np.array_equal(out.t, ref.t)
    assert np.array_equal(_np(out.y), _np(ref.y))


# -- BDF and Radau --------------------------------------------------------------
def _rober(stack):
    def f(t, y):
        return stack([-0.04 * y[0] + 1e4 * y[1] * y[2],
                      0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                      3e7 * y[1] ** 2])
    return f


@pytest.mark.parametrize("method", ["BDF", "Radau"])
def test_stiff_robertson(method):
    import jax.numpy as jnp

    kw = dict(method=method, rtol=1e-6, atol=1e-9)
    out = integrate.solve_ivp(_rober(torch.stack), (0, 100.0), np.array([1.0, 0, 0]), **kw)
    ref = jintegrate.solve_ivp(_rober(jnp.stack), (0, 100.0), np.array([1.0, 0, 0]), **kw)
    _same(out, ref)


@pytest.mark.parametrize("method", ["BDF", "Radau"])
def test_stiff_sparse_jacobian_and_dense_output(method):
    n = 40
    A = sp.diags([np.full(n - 1, 40.0), np.full(n, -80.0), np.full(n - 1, 40.0)],
                 [-1, 0, 1]).tocsr()
    As, Aj = st.csr_array(A), sparse_tpu.csr_array(A)
    y0 = np.sin(np.linspace(0, np.pi, n))
    kw = dict(method=method, rtol=1e-8, atol=1e-10, dense_output=True)
    out = integrate.solve_ivp(lambda t, y: As @ y, (0, 1.0), y0, jac=As, **kw)
    ref = jintegrate.solve_ivp(lambda t, y: Aj @ y, (0, 1.0), y0, jac=Aj, **kw)
    _same(out, ref)
    assert out.njev <= 1  # a constant Jacobian is never re-evaluated
    ts = np.linspace(0.1, 0.9, 5)
    np.testing.assert_allclose(_np(out.sol(ts)), _np(ref.sol(ts)), rtol=1e-10, atol=1e-14)


def test_bdf_numerical_jacobian_events_and_complex():
    def hit_half(t, y):
        return float(y[0]) - 0.5

    hit_half.terminal = True
    out, ref = _both(lambda t, y: -y, (0, 10.0), np.array([1.0]), method="BDF",
                     events=hit_half, rtol=1e-8, atol=1e-10)
    assert out.status == 1
    _same(out, ref)
    np.testing.assert_allclose(out.t_events[0], ref.t_events[0], rtol=1e-12)
    n = 16
    rng = np.random.default_rng(0)
    H = sp.random(n, n, 0.3, random_state=rng)
    H = ((H + H.T) * 0.5).tocsr()
    Hc = (-1j) * H.astype(np.complex128)
    Hs, Hj = st.csr_array(Hc), sparse_tpu.csr_array(Hc)
    y0 = rng.standard_normal(n) + 0j
    kw = dict(method="BDF", rtol=1e-8, atol=1e-10)
    _same(integrate.solve_ivp(lambda t, y: Hs @ y, (0, 1.0), y0, jac=Hs, **kw),
          jintegrate.solve_ivp(lambda t, y: Hj @ y, (0, 1.0), y0, jac=Hj, **kw))


def test_radau_callable_jacobian_t_eval():
    def f(t, y):
        return np.array([float(y[1]), float(-y[0] - 10.0 * y[1] * (y[0] ** 2 - 1))])

    def jac(t, y):
        y0, y1 = float(y[0]), float(y[1])
        return np.array([[0.0, 1.0], [-1.0 - 20.0 * y0 * y1, -10.0 * (y0**2 - 1)]])

    out, ref = _both(f, (0, 5.0), np.array([2.0, 0.0]), method="Radau", jac=jac,
                     t_eval=np.linspace(0, 5, 11), rtol=1e-7, atol=1e-9)
    assert out.njev > 1
    _same(out, ref)


def test_heat_equation_bdf_mode_decay():
    """examples/heat_implicit.py's problem at n = 8: the mode-1 decay of
    both packages, each within 1e-4 of exp(-lambda_1 t)."""
    n = 8
    A = sp.diags([np.full(n * n - n, -1.0), np.full(n * n - 1, -1.0), np.full(n * n, 4.0),
                  np.full(n * n - 1, -1.0), np.full(n * n - n, -1.0)], [-n, -1, 0, 1, n]).tolil()
    for i in range(1, n):
        A[i * n, i * n - 1] = A[i * n - 1, i * n] = 0.0
    L = (-(n + 1) ** 2) * A.tocsr()
    Ls, Lj = st.csr_array(L), sparse_tpu.csr_array(L)
    x = np.linspace(0, 1, n + 2)[1:-1]
    X, Y = np.meshgrid(x, x, indexing="ij")
    y0 = (np.sin(np.pi * X) * np.sin(np.pi * Y)).ravel()
    kw = dict(method="BDF", rtol=1e-6, atol=1e-9)
    out = integrate.solve_ivp(lambda t, y: Ls @ y, (0.0, 0.1), y0, jac=Ls, **kw)
    ref = jintegrate.solve_ivp(lambda t, y: Lj @ y, (0.0, 0.1), y0, jac=Lj, **kw)
    _same(out, ref)
    lam1 = 4 * (n + 1) ** 2 * (1 - np.cos(np.pi / (n + 1)))
    decay = float(_np(out.y)[:, -1] @ y0 / (y0 @ y0))
    assert abs(decay / np.exp(-lam1 * 0.1) - 1) <= 1e-4
