"""Adjoint products and segment sums of sparse_tpu_torch, on the CPU.

``csc_array @ x``, ``A.T @ x`` and a sparse operator's ``rmatvec`` run on
a CSR of the transpose (plan-cached), so they take the row-wise DIA, SELL,
ELL or segment paths; the reference sums the same products by column
(``jax.ops.segment_sum``). The orders differ, so f64 results agree to a
few ulps: 1e-12 relative. The segment paths and duplicate summation sum
sorted segments with ``coords.segment_sum``; they are held against numpy
and against sparse_tpu at 1e-12.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu

import sparse_tpu_torch as st
from sparse_tpu_torch import linalg, plan_cache
from sparse_tpu_torch.ops.coords import segment_sum

from .test_torch_solvers import convection_diffusion
from .utils.sample import sample_csr


@pytest.fixture(autouse=True)
def _cpu():
    old = (st.settings.device, st.settings.spmv_mode, st.settings.plan_cache)
    st.settings.device = "cpu"
    yield
    st.settings.device, st.settings.spmv_mode, st.settings.plan_cache = old


def _skewed(m, seed=7):
    """A few near-dense rows among sparse ones: 'auto' packs it as SELL,
    and its transpose (near-dense columns) too."""
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(1.2, m) * 4 + 1).astype(int), m // 4)
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, m, rows.shape[0])
    G = sp.coo_matrix((rng.standard_normal(rows.shape[0]), (rows, cols)), shape=(m, m)).tocsr()
    return (G + G[:, ::-1].T + sp.identity(m)).tocsr()


def _complex(m, n, seed):
    s = sample_csr(m, n, density=0.2, seed=seed).astype(np.complex128)
    s.data = s.data * np.exp(1j * np.random.default_rng(seed).uniform(0, 2 * np.pi, s.nnz))
    return s


MATRICES = {
    "random": lambda: sample_csr(80, 70, density=0.3, seed=1),
    "banded": lambda: convection_diffusion(12),
    "skewed": lambda: _skewed(400),
    "complex": lambda: _complex(50, 60, 4),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """The matrix, y, x and sparse_tpu's A.T @ y, rmatvec(y) and CSC @ x
    (computed once a worker: they do not depend on the port's mode)."""
    s = MATRICES[name]()
    m, n = s.shape
    rng = np.random.default_rng(5)
    y = rng.standard_normal(m) + (1j * rng.standard_normal(m) if s.dtype.kind == "c" else 0)
    x = rng.standard_normal(n)
    Aj = sparse_tpu.csr_array(s)
    want = (np.asarray(Aj.T @ y), np.asarray(sparse_tpu.linalg.aslinearoperator(Aj).rmatvec(y)),
            np.asarray(sparse_tpu.csr_array(s).tocsc() @ x))
    return s, y, x, want


@pytest.mark.parametrize("mode", ["auto", "segment", "ell", "sell"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_adjoint_products_match_reference(name, mode):
    s, y, x, (want_t, want_h, want_c) = _case(name)
    st.settings.spmv_mode = mode
    A = st.csr_array(s)
    for got, want in ((A.T @ y, want_t), (linalg.aslinearoperator(A).rmatvec(y), want_h),
                      (A.tocsc() @ x, want_c)):
        assert got.numpy().dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    # the conjugate transpose, against scipy
    np.testing.assert_allclose(linalg.aslinearoperator(A).rmatvec(y).numpy(),
                               s.conj().T @ y, rtol=1e-12, atol=1e-12)


def test_transposed_csr_is_cached_and_held():
    """``A.T`` is one cached view and its CSR form one cached object, so
    ``A.T @ x`` builds it once; an operator holds its own across solves
    even with the plan cache off."""
    s = _skewed(300)
    A = st.csr_array(s)
    x = np.ones(300)
    assert A.T is A.T
    A.T @ x
    csr_t = plan_cache.lookup(A.T, "csr")
    assert csr_t is not None and csr_t.format == "csr"
    before = plan_cache.stats()["misses"]
    A.T @ x
    assert plan_cache.lookup(A.T, "csr") is csr_t
    assert plan_cache.stats()["misses"] == before
    op = linalg.aslinearoperator(A)
    op.rmatvec(x)
    assert op._transpose() is csr_t  # shared with A.T @ x through the cache
    st.settings.plan_cache = False
    B = st.csr_array(s)
    op = linalg.aslinearoperator(B)
    op.rmatvec(x)
    held = op._transpose()
    op.rmatvec(x)
    assert op._transpose() is held
    np.testing.assert_allclose(op.rmatvec(x).numpy(), s.T @ x, rtol=1e-12)


@pytest.mark.parametrize("fmt", ["csc", "coo", "dia"])
def test_rmatvec_of_other_formats(fmt):
    s = convection_diffusion(9)
    A = getattr(st.csr_array(s), "to" + fmt)()
    op = linalg.aslinearoperator(A)
    y = np.random.default_rng(2).standard_normal(81)
    np.testing.assert_allclose(op.rmatvec(torch.from_numpy(y)).numpy(), s.T @ y, rtol=1e-12)
    assert op._transpose().format == ("dia" if fmt == "dia" else "csr")


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128, np.int64])
def test_segment_sum(dtype):
    rng = np.random.default_rng(1)
    offsets = np.array([0, 3, 3, 3, 10, 11, 20])
    vals = (rng.standard_normal(20) * 10).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        vals = vals + 1j * rng.standard_normal(20)
    want = np.array([vals[a:b].sum() for a, b in zip(offsets[:-1], offsets[1:])])
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(offsets))
    assert got.dtype == torch.from_numpy(vals).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6 if dtype == np.float32 else 1e-12)
    lanes = np.stack([vals, 2 * vals])
    got2 = segment_sum(torch.from_numpy(lanes), torch.from_numpy(offsets), axis=1)
    np.testing.assert_allclose(got2.numpy(), np.stack([want, 2 * want]),
                               rtol=1e-6 if dtype == np.float32 else 1e-12)


def test_segment_paths_match_reference():
    """spmv_mode 'segment': y = A x, C = A B and the batched product over
    one pattern, with empty rows."""
    from sparse_tpu_torch.batch import BatchedCSR, SparsityPattern

    s = sample_csr(60, 50, density=0.1, seed=8)
    s[5] = 0
    s.eliminate_zeros()
    rng = np.random.default_rng(9)
    x, X = rng.standard_normal(50), rng.standard_normal((50, 3))
    st.settings.spmv_mode = "segment"
    A = st.csr_array(s)
    np.testing.assert_allclose((A @ x).numpy(), s @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose((A @ X).numpy(), s @ X, rtol=1e-12, atol=1e-12)
    vals = np.stack([s.data, 2 * s.data])
    bc = BatchedCSR(SparsityPattern.from_csr(s), torch.from_numpy(vals))
    Y = bc.matvec(torch.from_numpy(np.stack([x, x])))
    np.testing.assert_allclose(Y.numpy(), np.stack([s @ x, 2 * (s @ x)]), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
def test_coo_many_duplicates_sum_like_reference(dtype):
    """Entries repeated three times and more collapse to one summed value,
    as in sparse_tpu."""
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 5, 120)
    cols = rng.integers(0, 4, 120)
    vals = rng.standard_normal(120).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        vals = vals + 1j * rng.standard_normal(120)
    Aj = sparse_tpu.coo_array((vals, (rows, cols)), shape=(5, 4)).tocsr()
    At = st.coo_array((vals, (rows, cols)), shape=(5, 4)).tocsr()
    assert At.nnz == 20
    np.testing.assert_array_equal(np.asarray(Aj.indices), At.indices.numpy())
    tol = 1e-5 if dtype == np.float32 else 1e-13
    np.testing.assert_allclose(At.data.numpy(), np.asarray(Aj.data), rtol=tol, atol=tol)
