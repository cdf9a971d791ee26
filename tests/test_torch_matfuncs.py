"""sparse_tpu_torch's norms, powers, matrix functions and LaplacianNd
against sparse_tpu's, on the CPU (the norm / onenormest / matrix_power /
expm_multiply cases of tests/test_linalg_extras.py, funm_multiply_krylov,
and tests/test_laplaciannd_lgmres.py's operator).

The same seeded scipy inputs go through ``sparse_tpu.linalg`` (JAX on the
CPU, x64 on) and ``sparse_tpu_torch.linalg``. Tolerances:

* norms and the exact 1-norm: 1e-12 relative (column sums in another
  order);
* matrix_power on integer-valued matrices, the operator 1-norm estimate
  and its certificate column, LaplacianNd's matrices, products and
  closed-form eigenpairs: equal;
* expm_multiply and funm_multiply_krylov in f64: 1e-10 relative (the same
  (m, s), the same terms; products summed in other orders).
"""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

import sparse_tpu
from sparse_tpu import linalg as jlinalg

import sparse_tpu_torch as st
from sparse_tpu_torch import linalg

from .utils.sample import sample_csr


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _signed(m, n, density, seed):
    s = sample_csr(m, n, density=density, seed=seed)
    s.data -= 0.5
    return s


@pytest.mark.parametrize("ord_", [None, "fro", 1, -1, np.inf, -np.inf])
def test_norm_matrix_matches(ord_):
    s = _signed(23, 17, 0.3, 60)
    got = float(linalg.norm(st.csr_array(s), ord=ord_))
    ref = float(np.asarray(jlinalg.norm(sparse_tpu.csr_array(s), ord=ord_)))
    assert abs(got - ref) <= 1e-12 * ref
    assert abs(got - sla.norm(s, ord=ord_)) <= 1e-12 * ref


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("ord_", [None, 1, np.inf])
def test_norm_axis_matches(axis, ord_):
    s = _signed(12, 9, 0.4, 61)
    got = linalg.norm(st.csr_array(s), ord=ord_, axis=axis).numpy()
    ref = np.asarray(jlinalg.norm(sparse_tpu.csr_array(s), ord=ord_, axis=axis))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)


def test_norm_inf_axis_empty_line_and_errors():
    A = st.csr_array(sp.csr_matrix(np.array([[0.0, -2.0, 0.0], [0.0, 0.0, 0.0],
                                             [1.0, 0.0, 3.0]])))
    np.testing.assert_array_equal(linalg.norm(A, ord=np.inf, axis=0).numpy(), [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(linalg.norm(A, ord=np.inf, axis=1).numpy(), [2.0, 0.0, 3.0])
    with pytest.raises(ValueError):
        linalg.norm(A, ord=3)
    with pytest.raises(TypeError):
        linalg.norm(np.eye(3))


def test_onenormest_exact_and_certificate_match():
    s = _signed(30, 30, 0.2, 70)
    A, jA = st.csr_array(s), sparse_tpu.csr_array(s)
    exact = sla.norm(s, ord=1)
    assert abs(linalg.onenormest(A) - jlinalg.onenormest(jA)) <= 1e-12 * exact
    est, v, w = linalg.onenormest(A, compute_v=True, compute_w=True)
    _, jv, _ = jlinalg.onenormest(jA, compute_v=True, compute_w=True)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert abs(est - exact) <= 1e-12 * exact
    assert abs(float(w.abs().sum()) - exact) <= 1e-12 * exact


@pytest.mark.parametrize("which", ["random", "diag"])
def test_onenormest_operator_estimate_equals_reference(which):
    """The Higham/Hager estimate on an operator: the same probes, the same
    estimate and certificate column as the reference."""
    if which == "random":
        M = _signed(30, 30, 0.2, 70).toarray()
    else:
        M = np.diag([1.0, 100.0, 3.0])
    n = M.shape[0]
    Mt = torch.tensor(M)
    op = linalg.LinearOperator((n, n), matvec=lambda x: Mt @ x, rmatvec=lambda x: Mt.T @ x,
                               dtype=torch.float64)
    jop = jlinalg.LinearOperator((n, n), matvec=lambda x: M @ np.asarray(x),
                                 rmatvec=lambda x: M.T @ np.asarray(x), dtype=np.float64)
    est, v, w = linalg.onenormest(op, compute_v=True, compute_w=True)
    jest, jv, _ = jlinalg.onenormest(jop, compute_v=True, compute_w=True)
    assert abs(est - jest) <= 1e-12 * jest
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert abs(est - float(w.abs().sum())) <= 1e-12 * est
    exact = np.abs(M).sum(axis=0).max()
    assert exact / 3 <= est <= exact * (1 + 1e-12)


@pytest.mark.parametrize("p", [0, 1, 2, 3, 5])
def test_matrix_power_exact_on_integers(p):
    """Integer-valued entries: every product sum is exact, so both
    packages and numpy agree bit for bit."""
    s = sample_csr(15, 15, density=0.2, seed=72)
    s.data = np.round(s.data * 4) - 2
    got = linalg.matrix_power(st.csr_array(s), p).toarray().numpy()
    ref = np.asarray(jlinalg.matrix_power(sparse_tpu.csr_array(s), p).toarray())
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.linalg.matrix_power(s.toarray(), p))


def test_matrix_power_edges():
    s = sample_csr(8, 8, density=0.3, seed=75)
    A = st.csr_array(s)
    with pytest.raises(TypeError):
        linalg.matrix_power(A, 2.5)
    with pytest.raises(ValueError):
        linalg.matrix_power(A, -1)
    with pytest.raises(ValueError):
        linalg.matrix_power(st.csr_array(sample_csr(3, 4, 0.5, seed=73)), 2)
    with pytest.raises(TypeError):
        linalg.matrix_power(s.toarray(), 2)
    P1 = linalg.matrix_power(A, 1)
    assert P1 is not A and P1.data.data_ptr() != A.data.data_ptr()
    np.testing.assert_array_equal(P1.toarray().numpy(), s.toarray())


@pytest.mark.parametrize("t", [1.0, 0.3, -0.7, 25.0])
def test_expm_multiply_vector_matches(t):
    """t = 25 takes several stages (s > 1)."""
    s = _signed(40, 40, 0.1, 62)
    v = np.linspace(-1, 1, 40)
    got = linalg.expm_multiply(st.csr_array(s), v, t=t)
    ref = jlinalg.expm_multiply(sparse_tpu.csr_array(s), v, t=t)
    assert got.dtype == torch.float64
    assert _rel(got, ref) <= 1e-10
    assert _rel(got, sla.expm_multiply(t * s.tocsc(), v)) <= 1e-8


def test_expm_multiply_matrix_rhs_matches():
    s = _signed(30, 30, 0.2, 64)
    B = np.random.default_rng(65).standard_normal((30, 3))
    got = linalg.expm_multiply(st.csr_array(s), B)
    assert tuple(got.shape) == (30, 3)
    assert _rel(got, jlinalg.expm_multiply(sparse_tpu.csr_array(s), B)) <= 1e-10


def test_expm_multiply_complex_evolution_matches():
    """e^{-iHt} psi for a Hermitian H: unitary, and the reference's."""
    s = sample_csr(30, 30, density=0.2, seed=63)
    H = ((s + s.T) / 2).tocsr().astype(np.complex128)
    psi0 = np.zeros(30, dtype=np.complex128)
    psi0[0] = 1.0
    got = linalg.expm_multiply(st.csr_array(H), psi0, t=-0.5j)
    assert got.dtype == torch.complex128
    assert _rel(got, jlinalg.expm_multiply(sparse_tpu.csr_array(H), psi0, t=-0.5j)) <= 1e-10
    assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-8
    # a complex t on a real operator makes the result complex
    real = linalg.expm_multiply(st.csr_array(s), np.ones(30), t=0.5j)
    assert real.dtype == torch.complex128
    assert _rel(real, sla.expm_multiply(0.5j * s.tocsc().astype(complex), np.ones(30))) <= 1e-8


def test_expm_multiply_time_grid_matches():
    s = _signed(20, 20, 0.15, 74)
    v = np.linspace(-1, 1, 20)
    got = linalg.expm_multiply(st.csr_array(s), v, start=0.0, stop=1.0, num=5)
    ref = jlinalg.expm_multiply(sparse_tpu.csr_array(s), v, start=0.0, stop=1.0, num=5)
    assert tuple(got.shape) == (5, 20)
    assert _rel(got, ref) <= 1e-10
    got = linalg.expm_multiply(st.csr_array(s), v, start=0.2, stop=1.0, num=4, endpoint=False)
    ref = jlinalg.expm_multiply(sparse_tpu.csr_array(s), v, start=0.2, stop=1.0, num=4,
                                endpoint=False)
    assert _rel(got, ref) <= 1e-10
    with pytest.raises(ValueError):
        linalg.expm_multiply(st.csr_array(s), v, t=2.0, start=0.0, stop=1.0, num=3)
    with pytest.raises(ValueError):
        linalg.expm_multiply(st.csr_array(s), v, start=0.0, stop=1.0)


def test_expm_multiply_stages_and_frozen_terms():
    """Each stage is one device loop that stops on the two-term test: the
    terms it takes are the reference's; a zero operator returns B."""
    s = _signed(40, 40, 0.1, 62)
    stats = {}
    linalg.expm_multiply(st.csr_array(s), np.ones(40), t=25.0, _stats=stats)
    mdeg, nstage, _ = stats["stages"][0]
    assert len(stats["stages"]) == nstage > 1 and all(0 < st_[2] <= mdeg
                                                      for st_ in stats["stages"])
    Z = st.csr_array(sp.csr_matrix((5, 5)))
    np.testing.assert_array_equal(linalg.expm_multiply(Z, np.arange(5.0)).numpy(), np.arange(5.0))


def test_expm_multiply_operator_sign_cancellation():
    """A @ ones == 0 for [[2, -2], [-2, 2]]: the estimate must not be 0."""
    M = np.array([[2.0, -2.0], [-2.0, 2.0]])
    Mt = torch.tensor(M)
    op = linalg.LinearOperator((2, 2), matvec=lambda x: Mt @ x, rmatvec=lambda x: Mt.T @ x,
                               dtype=torch.float64)
    got = linalg.expm_multiply(op, np.array([1.0, 0.0]))
    assert _rel(got, scipy.linalg.expm(M) @ np.array([1.0, 0.0])) <= 1e-10


@pytest.mark.parametrize("assume_a", ["general", "hermitian"])
def test_funm_multiply_krylov_matches(assume_a):
    s = _signed(50, 50, 0.1, 77)
    if assume_a == "hermitian":
        s = ((s + s.T) * 0.5).tocsr()
    b = np.random.default_rng(78).standard_normal(50)
    kw = dict(assume_a=assume_a, t=0.5, restart_every_m=10, rtol=1e-12)
    got = linalg.funm_multiply_krylov(scipy.linalg.expm, st.csr_array(s), b, **kw)
    ref = jlinalg.funm_multiply_krylov(scipy.linalg.expm, sparse_tpu.csr_array(s), b, **kw)
    assert _rel(got, ref) <= 1e-10
    assert _rel(got, sla.expm_multiply(0.5 * s.tocsc(), b)) <= 1e-9
    with pytest.raises(ValueError):
        linalg.funm_multiply_krylov(scipy.linalg.expm, st.csr_array(s), b, assume_a="spd")


GRIDS = [(6,), (4, 5), (3, 1, 4), (1, 5), (2, 3)]


@pytest.mark.parametrize("bc", ["dirichlet", "neumann", "periodic"])
@pytest.mark.parametrize("grid", GRIDS, ids=["x".join(map(str, g)) for g in GRIDS])
def test_laplaciannd_views_agree(grid, bc):
    """toarray, tosparse, matvec/matmat and the closed-form eigenpairs
    agree (integer stencils: every sum exact), size-1 axes included; the
    eigenpairs are the reference's."""
    L = linalg.LaplacianNd(grid, boundary_conditions=bc, dtype=np.float64)
    J = jlinalg.LaplacianNd(grid, boundary_conditions=bc, dtype=np.float64)
    n = int(np.prod(grid))
    dense = L.toarray().numpy()
    np.testing.assert_array_equal(L.tosparse().toarray().numpy(), dense)
    x = np.random.default_rng(n).integers(-5, 6, n).astype(np.float64)
    X = np.random.default_rng(n + 1).integers(-5, 6, (n, 3)).astype(np.float64)
    np.testing.assert_array_equal(L.matvec(x).numpy(), dense @ x)
    np.testing.assert_array_equal(L.rmatvec(x).numpy(), dense @ x)
    np.testing.assert_array_equal((L @ X).numpy(), dense @ X)
    np.testing.assert_array_equal(L.eigenvalues(), J.eigenvalues())
    np.testing.assert_array_equal(L.eigenvalues(2), J.eigenvalues(2))
    assert L.eigenvalues(0).size == 0
    np.testing.assert_array_equal(L.eigenvectors(), J.eigenvectors())
    np.testing.assert_array_equal(L.eigenvectors(3), J.eigenvectors(3))
    w, V = L.eigenvalues(), L.eigenvectors()
    np.testing.assert_allclose(dense @ V, V * w[None, :], atol=1e-12)
    if 1 not in grid:  # scipy's convention differs on a size-1 axis only
        np.testing.assert_array_equal(
            dense, sla.LaplacianNd(grid, boundary_conditions=bc, dtype=np.float64).toarray())


@pytest.mark.parametrize("bc", ["dirichlet", "neumann", "periodic"])
def test_laplaciannd_matches_reference(bc):
    """The reference's matrix and products, on a grid with a size-1 axis."""
    grid = (3, 1, 4)
    L = linalg.LaplacianNd(grid, boundary_conditions=bc, dtype=np.float64)
    J = jlinalg.LaplacianNd(grid, boundary_conditions=bc, dtype=np.float64)
    np.testing.assert_array_equal(L.toarray().numpy(), np.asarray(J.toarray()))
    x = np.random.default_rng(7).integers(-5, 6, 12).astype(np.float64)
    np.testing.assert_array_equal(L.matvec(x).numpy(), np.asarray(J.matvec(x)))


def test_laplaciannd_dtype_and_scipy():
    """scipy's surface: the default dtype int8, a float operator's
    tosparse in its own dtype; the dirichlet matrix is scipy's."""
    L = linalg.LaplacianNd((3, 4), boundary_conditions="dirichlet")
    assert L.dtype == torch.int8 and L.toarray().dtype == torch.int8
    assert L.tosparse().dtype == torch.float64
    L32 = linalg.LaplacianNd((3, 4), boundary_conditions="dirichlet", dtype=np.float32)
    assert L32.tosparse().dtype == torch.float32
    np.testing.assert_array_equal(
        L.toarray().numpy(),
        sla.LaplacianNd((3, 4), boundary_conditions="dirichlet").toarray())
    with pytest.raises(ValueError):
        linalg.LaplacianNd((3,), boundary_conditions="robin")
