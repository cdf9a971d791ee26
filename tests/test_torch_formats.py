"""sparse_tpu_torch formats and construction against sparse_tpu, on the CPU.

The same numpy inputs (seeded) go to both packages. Construction and
conversion move values without arithmetic, so buffers must be identical:
same values, same index dtype.
"""

import glob
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu
import sparse_tpu_torch as st

TESTDATA = os.path.join(os.path.dirname(__file__), "..", "testdata")


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


def _same(jax_arr, torch_arr):
    """Identical buffers: dtype and every element."""
    a, b = np.asarray(jax_arr), torch_arr.cpu().numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _same_compressed(A_jax, A_torch):
    assert tuple(A_jax.shape) == tuple(A_torch.shape)
    _same(A_jax.indptr, A_torch.indptr)
    _same(A_jax.indices, A_torch.indices)
    _same(A_jax.data, A_torch.data)


def pde_diagonals(nxs: int, dtype=np.float64):
    """examples/pde.py:40-56 with nx = ny = nxs + 2."""
    nx = nxs + 2
    dx = 1.0 / (nx - 1)
    a, g = 1.0 / dx**2, 1.0 / dx**2
    n = nxs * nxs
    diag_a = np.full(n - 1, a, dtype=dtype)
    diag_a[nxs - 1 :: nxs] = 0.0
    diag_g = np.full(n - nxs, g, dtype=dtype)
    diag_c = np.full(n, -2.0 * a - 2.0 * g, dtype=dtype)
    return [diag_g, diag_a, diag_c, diag_a, diag_g], [-nxs, -1, 0, 1, nxs], n


@pytest.mark.parametrize("nxs", [34, 7])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pde_build_identical_buffers(nxs, dtype):
    diagonals, offsets, n = pde_diagonals(nxs, dtype)
    Aj = sparse_tpu.diags(diagonals, offsets, shape=(n, n)).tocsc().T.tocsr()
    At = st.diags(diagonals, offsets, shape=(n, n)).tocsc().T.tocsr()
    assert At.format == "csr" and At.device.type == "cpu"
    _same_compressed(Aj, At)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(TESTDATA, "*.mtx"))),
                         ids=os.path.basename)
def test_mmread_identical(path):
    cj, ct = sparse_tpu.io.mmread(path), st.io.mmread(path)
    assert tuple(cj.shape) == tuple(ct.shape)
    _same(cj.row, ct.row)
    _same(cj.col, ct.col)
    _same(cj.data, ct.data)
    _same_compressed(cj.tocsr(), ct.tocsr())
    _same_compressed(cj.tocsc(), ct.tocsc())


@pytest.mark.parametrize("m,n,density", [(30, 30, 0.2), (17, 41, 0.3), (50, 9, 0.5), (8, 8, 0.0)])
def test_csr_csc_transpose_roundtrip(m, n, density):
    s = sp.random(m, n, density=density, format="csr", random_state=np.random.default_rng(m * n))
    parts = {"indptr": s.indptr, "indices": s.indices, "data": s.data}
    Aj = sparse_tpu.csr_array.from_parts(s.data, s.indices, s.indptr, s.shape)
    At = st.from_numpy_parts("csr", parts, s.shape)
    _same_compressed(Aj.tocsc(), At.tocsc())
    _same_compressed(Aj.T.tocsr(), At.T.tocsr())
    _same_compressed(Aj.tocsc().T.tocsr(), At.tocsc().T.tocsr())
    _same_compressed(Aj.tocsc().tocsr(), At.tocsc().tocsr())
    np.testing.assert_array_equal(np.asarray(Aj.toarray()), At.toarray().numpy())
    np.testing.assert_array_equal(s.toarray(), At.tocsc().toarray().numpy())


def test_coo_duplicates_sum_like_reference():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 12, 80)
    cols = rng.integers(0, 9, 80)
    vals = rng.standard_normal(80)
    Aj = sparse_tpu.coo_array((vals, (rows, cols)), shape=(12, 9)).tocsr()
    At = st.coo_array((vals, (rows, cols)), shape=(12, 9)).tocsr()
    assert At.nnz < 80  # duplicates collapsed
    _same(Aj.indptr, At.indptr)
    _same(Aj.indices, At.indices)
    # duplicates sum in the same (sorted) order; 1 ulp of slack for the
    # two packages' scatter-add kernels
    np.testing.assert_allclose(np.asarray(Aj.data), At.data.numpy(), rtol=1e-15, atol=1e-15)


def test_dense_constructor_and_dia_roundtrip():
    rng = np.random.default_rng(4)
    d = rng.standard_normal((9, 13)) * (rng.random((9, 13)) < 0.3)
    _same_compressed(sparse_tpu.csr_array(d), st.csr_array(d))
    _same_compressed(sparse_tpu.csc_array(d), st.csc_array(d))
    Dj, Dt = sparse_tpu.dia_array(d), st.dia_array(d)
    np.testing.assert_array_equal(Dj.offsets, Dt.offsets)
    _same(Dj.data, Dt.data)
    _same_compressed(Dj.tocsr(), Dt.tocsr())
    _same_compressed(Dj.tocsc(), Dt.tocsc())
    np.testing.assert_array_equal(np.asarray(Dj.toarray()), Dt.toarray().numpy())


@pytest.mark.parametrize("m,n,offs", [(50, 50, [-5, -1, 0, 1, 5]), (40, 60, [-3, 0, 2, 10]),
                                      (60, 40, [-7, 0, 1])])
def test_dia_transpose_and_junk_slots(m, n, offs):
    # dense-random planes hold junk in slots scipy ignores
    data = np.random.default_rng(m + n).standard_normal((len(offs), n))
    Dj = sparse_tpu.dia_array((data, offs), shape=(m, n))
    Dt = st.dia_array((data, offs), shape=(m, n))
    assert Dj.nnz == Dt.nnz
    Tj, Tt = Dj.T, Dt.T
    np.testing.assert_array_equal(Tj.offsets, Tt.offsets)
    _same(Tj.data, Tt.data)
    np.testing.assert_array_equal(Tt.toarray().numpy(), sp.dia_matrix((data, offs), shape=(m, n)).T.toarray())
    _same_compressed(Dj.tocsr(), Dt.tocsr())
    _same_compressed(Dj.tocsc(), Dt.tocsc())


def test_banded_detection_planes_match():
    diagonals, offsets, n = pde_diagonals(9)
    Aj = sparse_tpu.diags(diagonals, offsets, shape=(n, n)).tocsc().T.tocsr()
    At = st.diags(diagonals, offsets, shape=(n, n)).tocsc().T.tocsr()
    pj, oj = Aj._maybe_dia()
    pt, ot = At._maybe_dia()
    assert oj == ot == tuple(offsets)
    _same(pj, pt)


def test_constructors_eye_identity_spdiags():
    for k in (-2, 0, 3):
        np.testing.assert_array_equal(
            np.asarray(sparse_tpu.eye(5, 7, k=k).toarray()), st.eye(5, 7, k=k).toarray().numpy()
        )
    _same_compressed(sparse_tpu.identity(6), st.identity(6))
    data = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(
        np.asarray(sparse_tpu.spdiags(data, [0, -1, 2], 4, 4).toarray()),
        st.spdiags(data, [0, -1, 2], 4, 4).toarray().numpy(),
    )
    A = st.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(5, 5), dtype=torch.float32)
    assert A.dtype == torch.float32
    assert st.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(5, 5), dtype=np.float32).dtype == torch.float32


def test_empty_matrices():
    for cls in (st.csr_array, st.csc_array, st.coo_array):
        A = cls((4, 3))
        assert A.nnz == 0 and tuple(A.toarray().shape) == (4, 3)
    A = st.csr_array((4, 3))
    np.testing.assert_array_equal((A @ np.ones(3)).numpy(), np.zeros(4))
    np.testing.assert_array_equal(A.tocsc().tocsr().indptr.numpy(), np.zeros(5, np.int32))


def test_dimension_mismatch_raises():
    A = st.csr_array(np.eye(4))
    with pytest.raises(ValueError, match="dimension mismatch"):
        A @ np.ones(5)
