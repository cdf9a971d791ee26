"""sparse_tpu_torch's eigensolvers against sparse_tpu's, on the CPU
(mirrors tests/test_eigsh.py, tests/test_eigen_extra.py and the svds cases
of tests/test_linalg_extras.py).

The same seeded scipy matrices go through ``sparse_tpu.linalg`` (JAX on
the CPU, x64 on) and ``sparse_tpu_torch.linalg``. Both run the same
algorithm from the same ``default_rng(0)`` start vector; their products and
dot products sum in other orders, so the tolerances are:

* eigsh, svds, eigs in f64: eigenvalues / singular values to 1e-8
  relative, each against the other package and the dense oracle;
* lobpcg: to the dense oracle at its own convergence tolerance (the two
  ``eigh`` implementations may pick other signs for the Ritz vectors, so
  the iterates differ before convergence);
* the basis dtype rule: the port's basis is result_type(A, v0, float32)
  (the reference's production rule, without x64); an f32 operator is held
  against the reference's f64 basis to 1e-4 relative, an f32 tolerance.
"""

import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

import sparse_tpu
from sparse_tpu import linalg as jlinalg

import sparse_tpu_torch as st
from sparse_tpu_torch import hostsync, linalg

from .test_eigen_extra import _nonsym, _spd
from .test_eigsh import _sym
from .utils.sample import sample_csr


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


@pytest.mark.parametrize("which", ["LM", "SM", "LA", "SA"])
def test_eigsh_extremal_matches(which):
    n, k = 60, 4
    s = _sym(n, seed=40)
    w, V = linalg.eigsh(st.csr_array(s), k=k, which=which, tol=1e-9)
    jw, _ = jlinalg.eigsh(sparse_tpu.csr_array(s), k=k, which=which, tol=1e-9)
    assert isinstance(w, np.ndarray) and V.dtype == torch.float64 and tuple(V.shape) == (n, k)
    assert _rel(np.sort(w), np.sort(np.asarray(jw))) <= 1e-8
    dense = np.linalg.eigvalsh(s.toarray())
    key = {"LM": np.argsort(np.abs(dense))[-k:], "SM": np.argsort(np.abs(dense))[:k],
           "LA": np.arange(n - k, n), "SA": np.arange(k)}[which]
    assert _rel(np.sort(w), np.sort(dense[key])) <= 1e-8
    R = s @ V.numpy() - V.numpy() * w[None, :]
    assert np.linalg.norm(R, axis=0).max() <= 1e-6 * np.abs(w).max()


def test_eigsh_values_only_and_laplacian():
    s = _sym(40, seed=41)
    w = linalg.eigsh(st.csr_array(s), k=3, return_eigenvectors=False, tol=1e-9)
    jw = jlinalg.eigsh(sparse_tpu.csr_array(s), k=3, return_eigenvectors=False, tol=1e-9)
    assert _rel(np.sort(w), np.sort(np.asarray(jw))) <= 1e-8
    n = 32
    L = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    w = linalg.eigsh(st.csr_array(L), k=1, which="LA", return_eigenvectors=False, tol=1e-10)
    assert abs(w[0] - (2 - 2 * np.cos(np.pi * n / (n + 1)))) <= 1e-9


@pytest.mark.parametrize("mtx", ["banded.mtx", "graph.mtx"])
def test_eigsh_products_within_twice_arpack(mtx):
    """Thick restart keeps the locked Ritz block: at k = 6 the products
    stay within 2x of ARPACK's, and the values are the reference's."""
    path = os.path.join(os.path.dirname(__file__), "..", "testdata", mtx)
    s = scipy.io.mmread(path).tocsr().astype(np.float64)
    s = (0.5 * (s + s.T)).tocsr()
    n = s.shape[0]
    k = min(6, n - 2)
    count = {"arpack": 0, "ours": 0}

    def arpack_mv(x):
        count["arpack"] += 1
        return s @ x

    w_sp = sla.eigsh(sla.LinearOperator(s.shape, matvec=arpack_mv, dtype=s.dtype), k=k,
                     which="LM", return_eigenvectors=False)
    st_s = st.csr_array(s)

    def ours_mv(x):
        count["ours"] += 1
        return st_s @ x

    op = linalg.LinearOperator(s.shape, matvec=ours_mv, dtype=torch.float64)
    w = linalg.eigsh(op, k=k, which="LM", tol=1e-8, return_eigenvectors=False)
    jw = jlinalg.eigsh(sparse_tpu.csr_array(s), k=k, which="LM", tol=1e-8,
                       return_eigenvectors=False)
    assert _rel(np.sort(w), np.sort(w_sp)) <= 1e-6
    assert _rel(np.sort(w), np.sort(np.asarray(jw))) <= 1e-8
    assert count["ours"] <= 2 * max(count["arpack"], 1), count


def test_eigsh_one_fetch_a_cycle():
    """A cycle runs on the device and the host reads alphas and betas once."""
    s = _sym(200, seed=44)
    A = st.csr_array(s)
    A.prepare()
    stats = {}
    hostsync.HOST_SYNCS = 0
    linalg.eigsh(A, k=4, which="LA", maxiter=50, _stats=stats)
    assert stats["cycles"] > 1 and hostsync.HOST_SYNCS == stats["cycles"]


def test_eigsh_complex_hermitian_matches():
    """A complex Hermitian operator needs a complex basis."""
    n = 50
    rng = np.random.default_rng(54)
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    H = (M + M.conj().T) / 2
    Hs = sp.csr_array(np.where(np.abs(H) > 1.2, H, 0))
    Hs = ((Hs + Hs.conj().T) / 2).tocsr()
    w, V = linalg.eigsh(st.csr_array(Hs), k=4, which="LA", tol=1e-9)
    jw, _ = jlinalg.eigsh(sparse_tpu.csr_array(Hs), k=4, which="LA", tol=1e-9)
    assert V.dtype == torch.complex128
    assert _rel(np.sort(w), np.sort(np.asarray(jw))) <= 1e-8
    assert _rel(np.sort(w), np.linalg.eigvalsh(Hs.toarray())[-4:]) <= 1e-8
    Vr = V.numpy()
    for i in range(4):
        assert np.linalg.norm(Hs @ Vr[:, i] - w[i] * Vr[:, i]) < 1e-6


def test_eigsh_breakdown_redo_matches():
    """Three distinct eigenvalues: the Krylov space is invariant after three
    steps, so the cycle breaks down and is redone step by step with random
    restart vectors from the same generator as the reference's."""
    d = np.repeat([1.0, 2.0, 5.0], [20, 20, 10])
    s = sp.diags(d).tocsr()
    hostsync.HOST_SYNCS = 0
    w, V = linalg.eigsh(st.csr_array(s), k=3, which="LA", tol=1e-10)
    assert hostsync.HOST_SYNCS > 10  # the redo fetches once a step
    jw, _ = jlinalg.eigsh(sparse_tpu.csr_array(s), k=3, which="LA", tol=1e-10)
    np.testing.assert_allclose(np.sort(w), np.sort(np.asarray(jw)), rtol=1e-10)
    np.testing.assert_allclose(np.sort(w), [5.0, 5.0, 5.0], rtol=1e-10)
    R = s @ V.numpy() - V.numpy() * w[None, :]
    assert np.abs(R).max() <= 1e-8


def test_eigsh_f32_basis_rule():
    """An f32 operator gets an f32 basis here (the reference, with x64 on,
    an f64 one); an f64 start vector widens it."""
    s = _sym(60, seed=40).astype(np.float32)
    w, V = linalg.eigsh(st.csr_array(s), k=4, which="LA", tol=1e-5)
    jw, jV = jlinalg.eigsh(sparse_tpu.csr_array(s), k=4, which="LA", tol=1e-5)
    assert V.dtype == torch.float32 and np.asarray(jV).dtype == np.float64
    assert _rel(np.sort(w), np.sort(np.asarray(jw))) <= 1e-4
    v0 = np.random.default_rng(5).standard_normal(60)
    _, V64 = linalg.eigsh(st.csr_array(s), k=4, which="LA", v0=v0, tol=1e-5)
    assert V64.dtype == torch.float64


@pytest.mark.parametrize("shape", [(60, 40), (40, 60), (80, 80)])
def test_svds_matches(shape):
    s = sample_csr(*shape, density=0.2, seed=66)
    k = 4
    U, sig, Vh = linalg.svds(st.csr_array(s), k=k)
    jsig = jlinalg.svds(sparse_tpu.csr_array(s), k=k, return_singular_vectors=False)
    assert isinstance(sig, np.ndarray)
    assert _rel(sig, np.asarray(jsig)) <= 1e-8
    ref = np.sort(sla.svds(s, k=k, return_singular_vectors=False))[::-1]
    assert _rel(sig, ref) <= 1e-8
    A = s.toarray()
    np.testing.assert_allclose(A @ Vh.numpy().T, U.numpy() * sig[None, :], atol=1e-8)
    np.testing.assert_allclose(U.numpy().T @ A, sig[:, None] * Vh.numpy(), atol=1e-8)


def test_svds_values_only_dense_rule_and_errors():
    s = sample_csr(50, 30, density=0.3, seed=69)
    sig = linalg.svds(st.csr_array(s), k=3, return_singular_vectors=False)
    assert _rel(sig, np.asarray(jlinalg.svds(sparse_tpu.csr_array(s), k=3,
                                             return_singular_vectors=False))) <= 1e-8
    small = sample_csr(12, 10, density=0.5, seed=70)  # n <= the basis: the dense SVD
    assert _rel(linalg.svds(st.csr_array(small), k=3)[1],
                np.linalg.svd(small.toarray(), compute_uv=False)[:3]) <= 1e-12
    with pytest.raises(ValueError):
        linalg.svds(st.csr_array(sample_csr(5, 1, density=1.0, seed=67)), k=6)
    with pytest.raises(ValueError):
        linalg.svds(st.csr_array(sample_csr(5, 5, 0.5, seed=68)), k=0)
    with pytest.raises(NotImplementedError):
        linalg.svds(st.csr_array(s), k=2, which="SM")


def test_svds_rank_deficient():
    """Past rank(A): exact zeros and zeroed vectors, both orientations."""
    rng = np.random.default_rng(71)
    dense = rng.normal(size=(20, 3)) @ rng.normal(size=(3, 8))  # rank 3
    ref = np.linalg.svd(dense, compute_uv=False)[:5]
    U, s, _ = linalg.svds(st.csr_array(sp.csr_array(dense)), k=5)
    np.testing.assert_allclose(s, ref, rtol=1e-9, atol=1e-9)
    assert np.all(s[3:] == 0.0) and np.all(U.numpy()[:, 3:] == 0.0)
    Un = U.numpy()[:, :3]
    np.testing.assert_allclose(Un.T @ Un, np.eye(3), atol=1e-9)
    _, s2, _ = linalg.svds(st.csr_array(sp.csr_array(dense.T)), k=5)
    np.testing.assert_allclose(s2, ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("largest", [True, False])
def test_lobpcg_matches(largest):
    n, m = (200, 4) if largest else (150, 3)
    S = _spd(n, seed=0 if largest else 2)
    X = np.random.default_rng(1 if largest else 3).standard_normal((n, m))
    lam, V = linalg.lobpcg(st.csr_array(S), X, tol=1e-6, maxiter=200, largest=largest)
    jlam, _ = jlinalg.lobpcg(sparse_tpu.csr_array(S), X, tol=1e-6, maxiter=200,
                             largest=largest)
    assert isinstance(lam, np.ndarray) and V.shape == (n, m)
    ref = np.sort(sla.eigsh(S, k=m, which="LA" if largest else "SA")[0])
    assert _rel(np.sort(lam), ref) <= 1e-6
    assert _rel(np.sort(lam), np.sort(np.asarray(jlam))) <= 1e-6
    R = S @ V - V * lam[None, :]
    assert np.linalg.norm(R, axis=0).max() <= 1e-3 * np.abs(lam).max()


def test_lobpcg_histories_constraints_and_errors():
    S = _spd(100, seed=4)
    X = np.random.default_rng(5).standard_normal((100, 2))
    Y = np.random.default_rng(6).standard_normal((100, 1))
    _, V, lh, rh = linalg.lobpcg(st.csr_array(S), X, Y=Y, maxiter=30, tol=1e-8,
                                   retLambdaHistory=True, retResidualNormsHistory=True)
    assert len(lh) == len(rh) and lh[0].shape == (2,)
    Yq = np.linalg.qr(Y)[0]
    assert np.abs(Yq.T @ V).max() <= 1e-10
    A = st.csr_array(_spd(50))
    with pytest.raises(NotImplementedError):
        linalg.lobpcg(A, np.ones((50, 2)), B=A)
    with pytest.raises(ValueError):
        linalg.lobpcg(A, np.ones((50, 20)))


def test_eigs_matches_reference():
    """The same Krylov-Schur cycles from the same start vector."""
    S = _nonsym(60, seed=4)
    vals = linalg.eigs(st.csr_array(S), k=3, return_eigenvectors=False)
    jvals = jlinalg.eigs(sparse_tpu.csr_array(S), k=3, return_eigenvectors=False)
    assert _rel(np.sort(np.abs(vals)), np.sort(np.abs(np.asarray(jvals)))) <= 1e-8


@pytest.mark.parametrize("which,k,scale", [("LM", 4, 1.0), ("LR", 3, 1.0), ("LM", 3, 1e6)])
def test_eigs_matches_arpack(which, k, scale):
    """tests/test_eigen_extra.py's cases against scipy's ARPACK; the
    |lambda| ~ 1e6 one selects Ritz values by a relative threshold, not by
    values equal between two LAPACK paths."""
    n = {1.0: 160, 1e6: 100}[scale] if which == "LM" else 120
    S = (_nonsym(n, seed={("LM", 1.0): 4, ("LR", 1.0): 5, ("LM", 1e6): 6}[(which, scale)])
         * scale).tocsr()
    vals, vecs = linalg.eigs(st.csr_array(S), k=k, which=which)
    ref = sla.eigs(S.astype(np.complex128), k=k, which=which, return_eigenvectors=False)
    key = np.abs if which == "LM" else np.real
    assert _rel(np.sort(key(vals)), np.sort(key(ref))) <= 1e-8
    for i in range(k):
        assert np.linalg.norm(S @ vecs[:, i] - vals[i] * vecs[:, i]) <= 1e-6 * abs(vals[i])


def test_eigs_complex_operator_and_errors():
    rng = np.random.default_rng(8)
    S = (sp.random(80, 80, 0.1, random_state=rng) * (1 + 1j)
         + sp.diags(np.linspace(1, 5, 80))).tocsr()
    vals = linalg.eigs(st.csr_array(S), k=3, return_eigenvectors=False)
    ref = sla.eigs(S, k=3, return_eigenvectors=False)
    assert _rel(np.sort(np.abs(vals)), np.sort(np.abs(ref))) <= 1e-8
    with pytest.raises(ValueError):
        linalg.eigs(st.csr_array(_nonsym(10)), k=9)
    with pytest.raises(linalg.ArpackNoConvergence) as err:
        linalg.eigs(st.csr_array(_nonsym(200, seed=9)), k=6, ncv=8, maxiter=1, tol=1e-14)
    assert isinstance(err.value, linalg.ArpackError)
