"""sparse_tpu_torch's direct solvers against sparse_tpu's, on the CPU
(mirrors tests/test_direct.py).

The same seeded scipy matrices go through ``sparse_tpu.linalg`` (JAX on
the CPU, x64 on) and ``sparse_tpu_torch.linalg``. Tolerances:

* the native factorizations (ILU(0), IC(0), the Gilbert-Peierls LU and
  ILUT) are the same C code on the same arrays: their factor arrays and
  permutations are equal, ``assert_array_equal``;
* solves, inverses and exponentials in f64 agree to 1e-10 relative (the
  blocked substitutions sum in other orders: the port's segment sums run
  in row order, the reference's scatter-adds in its own);
* the dense LU is LAPACK's getrf in both: the same pivots, factors to
  1e-12.
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
from sparse_tpu_torch import _direct, linalg, native

from .test_direct import _dense_ilu0, _gen, _gp_matrix, _tri
from .utils.sample import sample_vec


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


@pytest.fixture
def sparse_lu_forced(monkeypatch):
    """The sparse branch for small matrices in both packages (their dense
    ceiling shrunk to 50); the production crossover stays 8192."""
    from sparse_tpu import _direct as jdirect

    monkeypatch.setattr(jdirect, "DENSE_DIRECT_MAX_N", 50)
    monkeypatch.setattr(_direct, "DENSE_DIRECT_MAX_N", 50)
    if native.lib() is None:
        pytest.skip("the native library cannot be built here (no g++)")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _both(name, S, *args, **kw):
    return (getattr(linalg, name)(st.csr_array(S), *args, **kw),
            getattr(jlinalg, name)(sparse_tpu.csr_array(S), *args, **kw))


@pytest.mark.parametrize("which", ["lower", "upper", "eye"])
def test_spbandwidth_and_is_sptriangular_match(which):
    S = {"lower": _tri(20, lower=True), "upper": _tri(20, lower=False),
         "eye": sp.identity(5, format="csr")}[which]
    for name in ("spbandwidth", "is_sptriangular"):
        out, ref = _both(name, S)
        assert out == ref


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("nrhs", [0, 3])
def test_spsolve_triangular_matches(lower, nrhs):
    n = 300  # past one block of 64: the chain of steps
    T = _tri(n, lower=lower, seed=1)
    b = (sample_vec(n, seed=2) if nrhs == 0
         else np.stack([sample_vec(n, seed=2 + i) for i in range(nrhs)], axis=1))
    out, ref = _both("spsolve_triangular", T, b, lower=lower, block=64)
    assert tuple(out.shape) == b.shape and out.dtype == torch.float64
    assert _rel(out, ref) <= 1e-10
    assert _rel(out, sla.spsolve_triangular(T.tocsr(), b, lower=lower)) <= 1e-10


@pytest.mark.parametrize("unit", [True, False])
def test_spsolve_triangular_unit_diagonal(unit):
    """unit_diagonal=True ignores the stored diagonal (here all ones, so
    both settings solve the same system)."""
    n = 120
    T = _tri(n, lower=True, seed=3, unit=True)
    b = sample_vec(n, seed=4)
    out, ref = _both("spsolve_triangular", T, b, lower=True, unit_diagonal=unit, block=50)
    assert _rel(out, ref) <= 1e-10
    assert _rel(out, sla.spsolve_triangular(T.tocsr(), b, lower=True, unit_diagonal=unit)) <= 1e-10


def test_spsolve_triangular_rejects_wrong_shape_and_singular():
    T = _tri(10, lower=True, seed=5).toarray()
    T[3, 3] = 0.0
    with pytest.raises(np.linalg.LinAlgError):
        linalg.spsolve_triangular(st.csr_array(sp.csr_matrix(T)), np.ones(10), lower=True)
    with pytest.raises(ValueError):
        linalg.spsolve_triangular(st.csr_array(sp.csr_matrix(np.ones((4, 4)))), np.ones(4))


def test_dense_splu_matches_reference_and_perm_convention():
    n = 60
    S = _gen(n)
    lu, jlu = _both("splu", S)
    assert lu._mode == "dense" and lu.shape == (n, n) and lu.nnz == S.nnz
    np.testing.assert_array_equal(lu.perm_r, jlu.perm_r)
    np.testing.assert_allclose(lu.L.toarray().numpy(), np.asarray(jlu.L.toarray()), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(lu.U.toarray().numpy(), np.asarray(jlu.U.toarray()), rtol=0,
                               atol=1e-12)
    b = sample_vec(n, seed=7)
    for trans in ("N", "T", "H"):
        assert _rel(lu.solve(b, trans=trans), jlu.solve(b, trans=trans)) <= 1e-10
    # scipy's SuperLU convention: (L @ U)[perm_r] == A
    L, U = lu.L.toarray().numpy(), lu.U.toarray().numpy()
    np.testing.assert_allclose((L @ U)[lu.perm_r], S.toarray(), rtol=1e-12, atol=1e-12)


def test_dense_splu_complex_rhs_and_complex_matrix():
    n = 30
    S = _gen(n, seed=30)
    rng = np.random.default_rng(31)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    lu, jlu = _both("splu", S)
    assert _rel(lu.solve(b), jlu.solve(b)) <= 1e-10
    M = (sp.random(40, 40, 0.2, random_state=rng)
         + sp.random(40, 40, 0.2, random_state=rng) * 1j).toarray()
    np.fill_diagonal(M, 4.0 + 1j)
    Z = sp.csr_matrix(M)
    bz = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    zlu, jzlu = _both("splu", Z)
    for trans in ("N", "T", "H"):
        x = zlu.solve(bz, trans=trans).numpy()
        assert _rel(x, jzlu.solve(bz, trans=trans)) <= 1e-10
    assert _rel(Z @ zlu.solve(bz).numpy(), bz) <= 1e-12


def test_sparse_splu_factors_equal_reference(sparse_lu_forced):
    """The native LU: the same C code on the same CSC arrays."""
    S = _gp_matrix(144)
    lu, jlu = _both("splu", S)
    assert lu._mode == jlu._mode == "sparse"
    for mine, theirs in zip((*lu._Lcsc, *lu._Ucsc), (*jlu._Lcsc, *jlu._Ucsc)):
        np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(lu.perm_r, jlu.perm_r)
    np.testing.assert_array_equal(lu.perm_c, jlu.perm_c)
    L, U = lu.L.toarray().numpy(), lu.U.toarray().numpy()
    np.testing.assert_allclose((L @ U)[lu.perm_r], S.toarray(), atol=1e-10)
    b = np.random.default_rng(0).standard_normal(144)
    B = np.random.default_rng(1).standard_normal((144, 3))
    for trans in ("N", "T", "H"):
        assert _rel(lu.solve(b, trans=trans), jlu.solve(b, trans=trans)) <= 1e-10
    assert _rel(lu.solve(B), jlu.solve(B)) <= 1e-10
    assert _rel(S @ lu.solve(B).numpy(), B) <= 1e-12


def test_sparse_splu_complex_rhs_and_singular(sparse_lu_forced):
    S = _gp_matrix(80, seed=9)
    lu = linalg.splu(st.csr_array(S))
    rng = np.random.default_rng(2)
    bz = rng.standard_normal(80) + 1j * rng.standard_normal(80)
    assert _rel(S @ lu.solve(bz).numpy(), bz) <= 1e-12
    Sd = S.toarray()
    Sd[:, 17] = 0.0
    with pytest.raises(RuntimeError, match="singular"):
        linalg.splu(st.csr_array(sp.csr_matrix(Sd)))


def test_splu_rcm_raises_naming_the_roadmap_item(sparse_lu_forced):
    """permc_spec='RCM' (once a NotImplementedError naming the roadmap
    item, now csgraph's reverse Cuthill-McKee): on tests/test_direct.py's
    scrambled banded matrix the RCM order, the factor arrays and so the
    fill equal the reference's, the fill falls below half NATURAL's, and
    solves in both directions stay plain A x = b; scipy's COLAMD/MMD names
    are taken as NATURAL."""
    from sparse_tpu import csgraph as jcsgraph

    from sparse_tpu_torch import csgraph

    rng = np.random.default_rng(4)
    n = 400
    offs = (-12, -5, 0, 5, 12)
    band = sp.diags([rng.standard_normal(n - abs(k)) for k in offs], offs)
    band = (band + sp.eye(n) * 6).tocsr()
    p = rng.permutation(n)
    S = band[p][:, p].tocsr()
    np.testing.assert_array_equal(csgraph.reverse_cuthill_mckee(st.csr_array(S)),
                                  jcsgraph.reverse_cuthill_mckee(sparse_tpu.csr_array(S)))
    lu_nat, lu_rcm = (linalg.splu(st.csr_array(S), permc_spec=spec) for spec in ("NATURAL", "RCM"))
    ref = jlinalg.splu(sparse_tpu.csr_array(S), permc_spec="RCM")
    fill = lambda lu: lu._Lcsc[2].size + lu._Ucsc[2].size  # noqa: E731
    assert fill(lu_rcm) == fill(ref) and fill(lu_rcm) < fill(lu_nat) / 2
    for mine, theirs in zip((*lu_rcm._Lcsc, *lu_rcm._Ucsc), (*ref._Lcsc, *ref._Ucsc)):
        np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(lu_rcm.perm_r, ref.perm_r)
    np.testing.assert_array_equal(lu_rcm.perm_c, ref.perm_c)
    b = rng.standard_normal(n)
    for lu in (lu_nat, lu_rcm):
        assert _rel(S @ lu.solve(b).numpy(), b) <= 1e-12
        assert _rel(S.T @ lu.solve(b, trans="T").numpy(), b) <= 1e-12
        LU = (lu.L @ lu.U).toarray().numpy()
        np.testing.assert_allclose(LU[lu.perm_r], S.toarray()[:, lu.perm_c], atol=1e-10)
    np.testing.assert_allclose(lu_rcm.solve(b).numpy(), np.asarray(ref.solve(b)), rtol=1e-10)
    colamd = linalg.splu(st.csr_array(S), permc_spec="COLAMD")
    np.testing.assert_array_equal(lu_nat._Lcsc[2], colamd._Lcsc[2])


def test_splu_above_ceiling_sparse_and_ceiling_errors(monkeypatch):
    if native.lib() is None:
        pytest.skip("the native library cannot be built here (no g++)")
    lu = linalg.splu(st.eye(9000))
    assert lu._mode == "sparse"
    b = np.arange(9000, dtype=np.float64)
    np.testing.assert_array_equal(lu.solve(b).numpy(), b)
    with pytest.raises(ValueError, match="dense ceiling"):
        linalg.inv(st.eye(9000))
    monkeypatch.setattr(native, "splu_host", lambda *a, **k: None)
    with pytest.raises(ValueError, match="ceiling"):
        linalg.splu(st.eye(9000))


def test_ilu0_and_ic0_values_equal_reference():
    """The native ILU(0) / IC(0): the factor arrays of both packages are
    equal, and equal the pattern-restricted dense definitions."""
    from sparse_tpu import native as jnative

    S = _gen(60, seed=21)
    indptr, col, data = S.indptr.astype(np.int64), S.indices.astype(np.int64), S.data
    np.testing.assert_array_equal(native.ilu0_host(indptr, col, data, 60),
                                  jnative.ilu0_host(indptr, col, data, 60))
    ilu, jilu = _both("spilu", S)
    np.testing.assert_array_equal(ilu.L.toarray().numpy(), np.asarray(jilu.L.toarray()))
    np.testing.assert_array_equal(ilu.U.toarray().numpy(), np.asarray(jilu.U.toarray()))
    Lref, Uref = _dense_ilu0(S)
    np.testing.assert_allclose(ilu.L.toarray().numpy(), Lref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ilu.U.toarray().numpy(), Uref, rtol=1e-10, atol=1e-12)
    b = sample_vec(60, seed=23)
    assert _rel(ilu.solve(b), jilu.solve(b)) <= 1e-10
    assert _rel(ilu.solve(b), np.linalg.solve(Uref, np.linalg.solve(Lref, b))) <= 1e-10

    T = ((_gen(40, seed=27) + _gen(40, seed=27).T) * 0.5 + sp.identity(40) * 5).tocsr()
    icf, jicf = _both("ic0", T)
    np.testing.assert_array_equal(icf.L.toarray().numpy(), np.asarray(jicf.L.toarray()))
    low = sp.tril(T).tocsr()
    np.testing.assert_array_equal(
        native.ic0_host(low.indptr, low.indices, low.data, 40),
        jnative.ic0_host(low.indptr, low.indices, low.data, 40))
    bt = sample_vec(40, seed=28)
    assert _rel(icf.solve(bt), jicf.solve(bt)) <= 1e-10


def test_ilu0_numpy_fallbacks_equal_the_native_code(monkeypatch):
    """Without the library the numpy loops run the same recurrences."""
    if native.lib() is None:
        pytest.skip("the native library cannot be built here (no g++)")
    S = _gen(50, seed=22)
    T = ((S + S.T) * 0.5 + sp.identity(50) * 5).tocsr()
    low = sp.tril(T).tocsr()
    args = (S.indptr, S.indices, S.data, 50)
    largs = (low.indptr, low.indices, low.data, 50)
    native_ilu, native_ic = native.ilu0_host(*args), native.ic0_host(*largs)
    monkeypatch.setattr(native, "lib", lambda: None)
    np.testing.assert_allclose(native.ilu0_host(*args), native_ilu, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(native.ic0_host(*largs), native_ic, rtol=1e-13, atol=1e-15)


def test_spilu_drop_tol_and_nnz_match_reference():
    S = _gen(80, seed=25)
    full, jfull = _both("spilu", S)
    dropped, jdropped = _both("spilu", S, drop_tol=0.2)
    assert (full.nnz, dropped.nnz) == (jfull.nnz, jdropped.nnz)
    assert dropped.L.nnz + dropped.U.nnz < full.L.nnz + full.U.nnz
    b = sample_vec(80, seed=26)
    assert _rel(dropped.solve(b), jdropped.solve(b)) <= 1e-10


def test_spilu_fill_factor_ilut_equals_reference(sparse_lu_forced):
    m = 20
    ex = np.ones(m)
    T1 = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1])
    T2 = sp.diags([-100 * ex[:-1], 200 * ex, -100 * ex[:-1]], [-1, 0, 1])
    S = (sp.kron(sp.identity(m), T1) + sp.kron(T2, sp.identity(m))).tocsr()
    ilut, jilut = _both("spilu", S, drop_tol=1e-3, fill_factor=10)
    assert type(ilut).__name__ == "SuperLU" and ilut._mode == "sparse"
    for mine, theirs in zip((*ilut._Lcsc, *ilut._Ucsc), (*jilut._Lcsc, *jilut._Ucsc)):
        np.testing.assert_array_equal(mine, theirs)
    b = np.random.default_rng(3).standard_normal(m * m)
    assert _rel(ilut.solve(b), jilut.solve(b)) <= 1e-10
    # without the library the fill_factor path falls back to ILU(0)
    from unittest import mock

    with mock.patch.object(native, "ilut_host", lambda *a, **k: None):
        assert type(linalg.spilu(st.csr_array(S), fill_factor=10)).__name__ == "SpILU"


def test_spilu_preconditions_cg():
    n = 48
    g = sp.diags([np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.0)], [-1, 0, 1])
    S = (sp.kron(sp.identity(n), g) + sp.kron(g, sp.identity(n))).tocsr()
    A = st.csr_array(S)
    b = sample_vec(n * n, seed=5)
    _, plain = linalg.cg(A, b, tol=1e-8, maxiter=2000)
    ilu = linalg.spilu(A)
    M = linalg.LinearOperator(A.shape, matvec=ilu.solve, dtype=torch.float64)
    x, pre = linalg.cg(A, b, tol=1e-8, maxiter=2000, M=M)
    assert pre < plain / 2, (pre, plain)
    assert _rel(S @ x.numpy(), b) <= 1e-6


def test_tridiagonal_ilu_solve_is_the_inverse():
    """tests/test_direct.py's million-row case at 10^5 rows: the ILU(0) of
    a tridiagonal matrix is its exact LU, so the solve is S^-1 b."""
    n = 10**5
    S = sp.diags([np.full(n - 1, -1.0), np.full(n, 4.0), np.full(n - 1, -1.0)], [-1, 0, 1],
                 format="csr")
    x = linalg.spilu(st.csr_array(S)).solve(np.ones(n))
    assert tuple(x.shape) == (n,)
    assert _rel(S @ x.numpy(), np.ones(n)) <= 1e-14


def test_factorized_inv_expm_match_reference():
    S = _gen(40, seed=10)
    b = sample_vec(40, seed=11)
    assert _rel(linalg.factorized(st.csr_array(S))(b),
                jlinalg.factorized(sparse_tpu.csr_array(S))(b)) <= 1e-10
    inv, jinv = _both("inv", _gen(30, seed=12))
    assert inv.format == jinv.format == "csr"
    assert _rel(inv.toarray(), jinv.toarray()) <= 1e-10
    E_s = (sp.random(25, 25, 0.2, random_state=np.random.default_rng(13)) * 0.5).tocsr()
    E, jE = _both("expm", E_s)
    assert E.format == "csr"
    assert _rel(E.toarray(), jE.toarray()) <= 1e-10
    assert _rel(E.toarray(), scipy.linalg.expm(E_s.toarray())) <= 1e-10


def test_triangular_plan_caps_the_block_and_sorts_rows():
    """nb is capped at 2^28 / (n itemsize) (the tiles stay within 256 MiB);
    each block's off-diagonal entries are sorted by row, its segment
    offsets relative to the block."""
    n = 10**6
    p = _direct._PreparedTriangular(n, np.arange(n), np.arange(n), np.ones(n), lower=True,
                                    unit_diagonal=False, dtype=torch.float32, device="cpu")
    assert p.nb == 67 and p.K == (n + 66) // 67
    rng = np.random.default_rng(3)
    T = sp.tril(sp.random(200, 200, 0.1, random_state=rng), -1).tocoo()
    p = _direct._PreparedTriangular(200, T.row, T.col, T.data, lower=True, unit_diagonal=True,
                                    block=32, device="cpu")
    for k in range(p.K):
        s, e = p._pos[k], p._pos[k + 1]
        seg = p._seg[k].numpy()
        assert seg[0] == 0 and seg[-1] == e - s and np.all(np.diff(seg) >= 0)
