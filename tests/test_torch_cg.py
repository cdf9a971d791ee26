"""sparse_tpu_torch fused CG and linalg.cg against sparse_tpu, on the CPU.

The port's ``cg_dia_fused`` and ``cg_dia_fused_onepass`` run their
kernels' plain versions here; they are held against sparse_tpu's with its
Pallas kernels in interpret mode, over tests/test_cg_fused.py's cases.
Both run the same recurrence in f32; their dot products sum in different
orders, so the iterates agree to f32 rounding amplified over the
iterations: 1e-4 absolute on solutions of norm ~1-10, the reference tests'
own tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu
from sparse_tpu import linalg as jlinalg
from sparse_tpu.config import settings as jax_settings
from sparse_tpu.kernels.cg_dia import cg_dia_fused as jax_cg_dia_fused
from sparse_tpu.models.poisson import laplacian_2d_dia

import sparse_tpu_torch as st
from sparse_tpu_torch import linalg
from sparse_tpu_torch.kernels.cg_dia import cg_dia_fused, cg_dia_fused_onepass


@pytest.fixture(autouse=True)
def _cpu():
    old = (st.settings.device, st.settings.fused_cg, jax_settings.fused_cg)
    st.settings.device = "cpu"
    yield
    st.settings.device, st.settings.fused_cg, jax_settings.fused_cg = old


def _lap(n):
    planes, offsets = laplacian_2d_dia(n)
    return np.array(planes), offsets


def _port(data, offsets, b, x0, m, iters):
    x, r, rho = cg_dia_fused(
        torch.from_numpy(data), offsets, torch.from_numpy(b),
        None if x0 is None else torch.from_numpy(x0), m, iters=iters,
    )
    return x.numpy(), r.numpy(), float(rho)


@pytest.mark.parametrize("n,iters", [(16, 50), (40, 30)])
def test_cg_dia_fused_matches_reference(n, iters):
    data, offsets = _lap(n)
    N = n * n
    b = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    xj, rj, rhoj = jax_cg_dia_fused(jnp.asarray(data), offsets, jnp.asarray(b), None, N,
                                    iters=iters, interpret=True)
    x, r, rho = _port(data, offsets, b, None, N, iters)
    assert x.dtype == np.float32
    np.testing.assert_allclose(x, np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(r, np.asarray(rj), atol=1e-4)
    assert rho == pytest.approx(float(rhoj), rel=1e-3, abs=1e-8)


def test_cg_dia_fused_nonzero_x0():
    n = 16
    data, offsets = _lap(n)
    N = n * n
    rng = np.random.default_rng(1)
    b = rng.standard_normal(N).astype(np.float32)
    x0 = rng.standard_normal(N).astype(np.float32)
    xj = jax_cg_dia_fused(jnp.asarray(data), offsets, jnp.asarray(b), jnp.asarray(x0), N,
                          iters=40, interpret=True)[0]
    x = _port(data, offsets, b, x0, N, 40)[0]
    np.testing.assert_allclose(x, np.asarray(xj), atol=1e-4)


def test_cg_dia_fused_junk_dia_tail_slots():
    """scipy-ignored out-of-band slots must not leak into the solve
    (tests/test_cg_fused.py:53-79's regression)."""
    m, offsets = 600, (-1, 0, 1)
    rng = np.random.default_rng(3)
    off = rng.uniform(0.5, 1.0, m).astype(np.float32)
    data = np.zeros((3, m), dtype=np.float32)
    data[0, :] = off
    data[1, :] = 4.0
    data[2, 1:] = off[:-1]
    data[0, m - 1] = 1e6  # junk
    data[2, 0] = -1e6
    A = sp.dia_matrix((data, offsets), shape=(m, m)).tocsr()
    b = rng.standard_normal(m).astype(np.float32)
    xj = jax_cg_dia_fused(jnp.asarray(data), offsets, jnp.asarray(b), None, m,
                          iters=80, tile=1024, interpret=True)[0]
    x = _port(data, offsets, b, None, m, 80)[0]
    assert np.linalg.norm(A @ x - b) < 1e-2
    np.testing.assert_allclose(x, np.asarray(xj), atol=1e-4)


def test_cg_dia_fused_multi_tile():
    """2500 rows: three reference tiles, ten port blocks, band 50."""
    m = 2500
    offsets = (-50, -1, 0, 1, 50)
    A = sp.diags(
        [np.full(m - 50, -1.0), np.full(m - 1, -1.0), np.full(m, 4.2),
         np.full(m - 1, -1.0), np.full(m - 50, -1.0)],
        offsets, shape=(m, m), format="dia",
    )
    data = A.data.astype(np.float32)
    b = np.random.default_rng(5).standard_normal(m).astype(np.float32)
    xj = jax_cg_dia_fused(jnp.asarray(data), offsets, jnp.asarray(b), None, m,
                          iters=120, tile=1024, interpret=True)[0]
    x = _port(data, offsets, b, None, m, 120)[0]
    assert np.linalg.norm(A.tocsr() @ x - b) < 1e-2
    np.testing.assert_allclose(x, np.asarray(xj), atol=1e-4)


def test_state_threading_equals_one_long_run():
    data, offsets = _lap(12)
    N = 144
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(N).astype(np.float32))
    d = torch.from_numpy(data)
    x_long = cg_dia_fused(d, offsets, b, None, N, iters=30)[0].clone()
    state = None
    for k in (7, 13, 10):
        x, _, _, state = cg_dia_fused(d, offsets, b, None, N, iters=k, state=state, return_state=True)
    assert torch.equal(x, x_long)  # same operations in the same order


def _pde_f32(n):
    diag_a = np.full(n * n - 1, -1.0, np.float32)
    diag_a[n - 1 :: n] = 0.0
    diag_g = np.full(n * (n - 1), -1.0, np.float32)
    diag_c = np.full(n * n, 4.0, np.float32)
    return [diag_g, diag_a, diag_c, diag_a, diag_g], [-n, -1, 0, 1, n]


@pytest.mark.parametrize("fmt", ["dia", "csr"])
@pytest.mark.parametrize("path", ["force", False, "callback"])
def test_linalg_cg_matches_reference(fmt, path):
    """Same iteration count as sparse_tpu.linalg.cg on each path, x within
    2e-4 (f32 sums in other orders; test_cg_fused.py's tolerance)."""
    n = 24
    diagonals, offsets = _pde_f32(n)
    b = np.random.default_rng(0).random(n * n).astype(np.float32)
    Aj = sparse_tpu.diags(diagonals, offsets, dtype=np.float32)
    At = st.diags(diagonals, offsets, dtype=np.float32)
    if fmt == "csr":
        Aj, At = Aj.tocsc().T.tocsr(), At.tocsc().T.tocsr()
    kw = dict(tol=1e-4, maxiter=400)
    if path == "callback":
        seen_j, seen_t = [], []
        kw_j = dict(kw, callback=lambda x: seen_j.append(1))
        kw_t = dict(kw, callback=lambda x: seen_t.append(1))
    else:
        jax_settings.fused_cg = st.settings.fused_cg = path
        kw_j = kw_t = kw
    xj, itj = jlinalg.cg(Aj, b, **kw_j)
    xt, itt = linalg.cg(At, b, **kw_t)
    assert itt == itj
    if path == "callback":
        assert len(seen_t) == len(seen_j) == itt
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=2e-4, atol=2e-4)
    assert np.linalg.norm((At @ xt).numpy() - b) < 1e-3


def test_linalg_cg_fused_respects_x0_and_maxiter():
    n = 16
    diagonals, offsets = _pde_f32(n)
    A = st.diags(diagonals, offsets, dtype=np.float32)
    xtrue = np.random.default_rng(1).random(n * n).astype(np.float32)
    b = (A @ xtrue).numpy()
    st.settings.fused_cg = "force"
    x, iters = linalg.cg(A, b, x0=xtrue + 1e-6, tol=1e-3, maxiter=400, conv_test_iters=5)
    assert iters <= 5
    x2, iters2 = linalg.cg(A, b, tol=1e-30, maxiter=7)
    assert iters2 == 7


def test_fused_gates_and_breakdown_flag():
    from sparse_tpu_torch.linalg import _try_fused_cg

    n = 8
    diagonals, offsets = _pde_f32(n)
    A32 = st.diags(diagonals, offsets, dtype=np.float32)
    b = torch.ones(n * n)
    st.settings.fused_cg = True  # on the CPU only "force" fuses
    assert _try_fused_cg(A32, b, None, 1e-6, 50, 25) is None
    st.settings.fused_cg = "force"
    assert _try_fused_cg(A32.astype(torch.float64), b.double(), None, 1e-6, 50, 25) is None
    bad = b.clone()
    bad[3] = float("nan")
    x, iters, rho, info = _try_fused_cg(A32, bad, None, 1e-6, 50, 25)
    assert info == -1 and iters == 25 and not np.isfinite(rho)
    x, iters, rho, info = _try_fused_cg(A32, b, None, 1e-3, 200, 25)
    assert info == 0 and rho < 1e-6


def test_fused_band_gate_is_the_reference_gate_on_cpu():
    """On the CPU a band past pallas_max_band leaves the fused path, as in
    sparse_tpu (on the card the kernels take any band)."""
    from sparse_tpu_torch.linalg import _try_fused_cg

    m, offs = 9100, [-9000, -1, 0, 1, 9000]
    diagonals = [np.full(m - abs(o), -1.0 if o else 4.5, np.float32) for o in offs]
    A = st.diags(diagonals, offs, dtype=np.float32)
    st.settings.fused_cg = "force"
    assert _try_fused_cg(A, torch.ones(m), None, 1e-6, 50, 25) is None
    x, iters = linalg.cg(A, np.ones(m, np.float32), tol=1e-4, maxiter=200)
    r = np.ones(m) - sp.dia_matrix((A.data.numpy(), np.asarray(A.offsets)), shape=(m, m)) @ x.numpy()
    assert np.linalg.norm(r) < 1e-3


def test_f64_solve_takes_device_loop_like_reference():
    n = 12
    diagonals, offsets = _pde_f32(n)
    diagonals = [d.astype(np.float64) for d in diagonals]
    b = np.random.default_rng(2).random(n * n)
    jax_settings.fused_cg = st.settings.fused_cg = "force"
    xj, itj = jlinalg.cg(sparse_tpu.diags(diagonals, offsets), b, tol=1e-10)
    xt, itt = linalg.cg(st.diags(diagonals, offsets), b, tol=1e-10)
    assert itt == itj and xt.dtype == torch.float64
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-9)


def test_linear_operator_algebra():
    n = 10
    diagonals, offsets = _pde_f32(n)
    A = st.diags([d.astype(np.float64) for d in diagonals], offsets).tocsr()
    op = linalg.aslinearoperator(A)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n * n))
    Ax = A @ x
    torch.testing.assert_close((op @ x), Ax)
    torch.testing.assert_close(((op + op) @ x), 2 * Ax)
    torch.testing.assert_close(((op - 2 * op) @ x), -Ax)
    torch.testing.assert_close(((op * op) @ x), A @ Ax)
    torch.testing.assert_close(((op ** 2) @ x), A @ Ax)
    torch.testing.assert_close(op.T @ x, Ax)  # symmetric
    torch.testing.assert_close((op ** 0) @ x, x)
    ident = linalg.IdentityOperator((n * n, n * n), dtype=torch.float64)
    xs, iters = linalg.cg(op, x, M=ident, tol=1e-10)
    torch.testing.assert_close(A @ xs, x, rtol=1e-7, atol=1e-7)


# ---------------------------------------------------------------------------
# one-pass (Chronopoulos-Gear) CG and the bf16 plane stream
# ---------------------------------------------------------------------------
def _jax_onepass(data, offsets, b, x0, m, iters, **kw):
    from sparse_tpu.kernels.cg_dia import cg_dia_fused_onepass as jax_onepass

    out = jax_onepass(jnp.asarray(data), offsets, jnp.asarray(b),
                      None if x0 is None else jnp.asarray(x0), m, iters=iters, tile=1024,
                      interpret=True, **kw)
    return [np.asarray(v) for v in out]


def _onepass(data, offsets, b, x0, m, iters, **kw):
    x, r, rho = cg_dia_fused_onepass(
        torch.from_numpy(data), offsets, torch.from_numpy(b),
        None if x0 is None else torch.from_numpy(x0), m, iters=iters, **kw,
    )
    return x.numpy(), r.numpy(), float(rho)


def _residual(data, offsets, x, b):
    N = b.shape[0]
    return np.linalg.norm(sp.dia_matrix((data.astype(np.float64), offsets), shape=(N, N)) @ x - b)


def test_onepass_matches_reference_f64():
    """Same recurrence in f64, dots in other orders: x, r, rho at rtol 1e-10
    after 10 iterations."""
    n = 16
    data, offsets = _lap(n)
    data = data.astype(np.float64)
    N = n * n
    b = np.random.default_rng(7).standard_normal(N)
    xj, rj, rhoj = _jax_onepass(data, offsets, b, None, N, 10)
    x, r, rho = _onepass(data, offsets, b, None, N, 10)
    assert x.dtype == np.float64
    np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-10 * np.abs(xj).max())
    np.testing.assert_allclose(r, rj, rtol=1e-10, atol=1e-10 * np.abs(rj).max())
    assert rho == pytest.approx(float(rhoj), rel=1e-10)


@pytest.mark.parametrize("n", [16, 40])
def test_onepass_converges_like_twopass(n):
    """tests/test_cg_fused.py:103-120's hold, 150 iterations in f32: the
    one-pass true residual within 4x the two-pass one (or 1e-3), for the
    port and the reference alike."""
    data, offsets = _lap(n)
    N = n * n
    b = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    x1 = _onepass(data, offsets, b, None, N, 150)[0]
    x2 = _port(data, offsets, b, None, N, 150)[0]
    xj = _jax_onepass(data, offsets, b, None, N, 150)[0]
    r1, r2, rj = (_residual(data, offsets, v, b) for v in (x1, x2, xj))
    assert r1 < max(4 * r2, 1e-3)
    assert rj < max(4 * r2, 1e-3)


def test_onepass_nonzero_x0_multi_block():
    """tests/test_cg_fused.py:123-135: n = 50 (2500 rows: ten port blocks,
    three reference tiles), a random x0, 150 iterations; both residuals
    below 1e-2."""
    n = 50
    data, offsets = _lap(n)
    N = n * n
    rng = np.random.default_rng(4)
    b = rng.standard_normal(N).astype(np.float32)
    x0 = rng.standard_normal(N).astype(np.float32)
    x = _onepass(data, offsets, b, x0, N, 150)[0]
    xj = _jax_onepass(data, offsets, b, x0, N, 150)[0]
    assert _residual(data, offsets, x, b) < 1e-2
    assert _residual(data, offsets, xj, b) < 1e-2


def test_onepass_first_iterations_track_reference_f32():
    data, offsets = _lap(16)
    N = 256
    b = np.random.default_rng(8).standard_normal(N).astype(np.float32)
    xj, rj, _ = _jax_onepass(data, offsets, b, None, N, 20)
    x, r, _ = _onepass(data, offsets, b, None, N, 20)
    np.testing.assert_allclose(x, xj, atol=1e-4)
    np.testing.assert_allclose(r, rj, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_onepass_zero_rhs_guards(dtype):
    """b = 0: rho = mu = 0 from the start, so alpha and beta must collapse
    to 0 (not NaN) through every iteration, in both packages."""
    data, offsets = _lap(12)
    data = data.astype(dtype)
    b = np.zeros(144, dtype)
    x, r, rho = _onepass(data, offsets, b, None, 144, 15)
    xj, _, rhoj = _jax_onepass(data, offsets, b, None, 144, 15)
    assert np.all(x == 0) and np.all(r == 0) and rho == 0.0
    assert np.all(xj == 0) and float(rhoj) == 0.0


def test_onepass_converged_state_stays_frozen():
    """Run far past convergence: once rho reaches 0 the guards keep x finite."""
    data, offsets = _lap(4)
    b = np.random.default_rng(1).standard_normal(16)
    x, _, rho = _onepass(data.astype(np.float64), offsets, b, None, 16, 120)
    assert np.all(np.isfinite(x)) and np.isfinite(rho)
    assert _residual(data, offsets, x, b) < 1e-10


@pytest.mark.parametrize("fn", ["onepass", "twopass"])
def test_bf16_planes_give_f32_result(fn):
    """The Laplacian's values are exact in bf16: the bf16 plane stream
    (widened at the load) gives the f32 planes' x bit for bit
    (tests/test_cg_fused.py:138-161)."""
    n = 24
    data, offsets = _lap(n)
    N = n * n
    assert np.array_equal(data, torch.from_numpy(data).to(torch.bfloat16).float().numpy())
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(N).astype(np.float32))
    run = cg_dia_fused_onepass if fn == "onepass" else cg_dia_fused
    x32 = run(torch.from_numpy(data), offsets, b, None, N, iters=100)[0]
    xbf = run(torch.from_numpy(data), offsets, b, None, N, iters=100, plane_dtype=torch.bfloat16)[0]
    assert torch.equal(x32, xbf)


def test_bf16_planes_round_inexact_values():
    """Values not exact in bf16 are rounded in the stream, as the
    reference's plane_dtype does: the result moves."""
    m = 64
    rng = np.random.default_rng(2)
    data = np.stack([np.full(m, -1.1), np.full(m, 4.3), np.full(m, -1.1)]).astype(np.float32)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    x32 = cg_dia_fused(torch.from_numpy(data), (-1, 0, 1), b, None, m, iters=5)[0]
    xbf = cg_dia_fused(torch.from_numpy(data), (-1, 0, 1), b, None, m, iters=5,
                       plane_dtype=torch.bfloat16)[0]
    rounded = torch.from_numpy(data).to(torch.bfloat16).float()
    xr = cg_dia_fused(rounded, (-1, 0, 1), b, None, m, iters=5)[0]
    assert not torch.equal(x32, xbf) and torch.equal(xbf, xr)
