"""sparse_tpu_torch's BSR, DOK and LIL formats against sparse_tpu's on the
CPU (mirrors tests/test_bsr.py and tests/test_dok_lil.py).

The same seeded scipy matrices go into both packages. Structures (block
counts, block positions, stored blocks, dict keys, row lists) are equal
exactly; f64 products agree to 1e-12 relative (the port sums each block
row in order, the reference's segment sum its own way).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu

import sparse_tpu_torch as st

from .test_bsr import _block_matrix
from .utils.sample import sample_csr


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


def _pair(m=7, n=5, density=0.3, seed=80):
    s = sample_csr(m, n, density=density, seed=seed)
    s.data -= 0.4
    return st.csr_array(s), sparse_tpu.csr_array(s), s


def _same_bsr(B, Bj):
    assert B.blocksize == Bj.blocksize and B.shape == Bj.shape
    np.testing.assert_array_equal(B.indptr.numpy(), np.asarray(Bj.indptr))
    np.testing.assert_array_equal(B.indices.numpy(), np.asarray(Bj.indices))
    np.testing.assert_array_equal(B.data.numpy(), np.asarray(Bj.data))


@pytest.mark.parametrize("blocksize", [(1, 1), (2, 3), (5, 2), None])
def test_tobsr_equals_reference(blocksize):
    R, C = blocksize or (3, 3)
    s = sample_csr(6 * R * 2, 4 * C, density=0.3, seed=91)
    s.data -= 0.4
    B, Bj = st.csr_array(s).tobsr(blocksize), sparse_tpu.csr_array(s).tobsr(blocksize)
    _same_bsr(B, Bj)
    np.testing.assert_array_equal(B.toarray(), s.toarray())
    if blocksize is not None:
        assert B.blocksize == s.tobsr(blocksize).blocksize
    Bc = B.tocsr()
    np.testing.assert_array_equal(Bc.toarray().numpy(), s.toarray())


def test_blocksize_estimation_equals_reference():
    _, dense = _block_matrix(mb=6, nb=6, R=3, C=3, density=0.5, seed=95)
    _same_bsr(st.csr_array(dense).tobsr(), sparse_tpu.csr_array(dense).tobsr())
    assert st.csr_array(dense).tobsr().blocksize == (3, 3)
    s = sample_csr(12, 12, density=0.08, seed=96)
    assert st.csr_array(s).tobsr().blocksize == (1, 1)


@pytest.mark.parametrize("seed", [90, 92])
def test_bsr_products_transpose_and_conversions(seed):
    ref, dense = _block_matrix(seed=seed)
    parts = (np.asarray(ref.data), ref.indices.copy(), ref.indptr.copy())
    B, Bj = st.bsr_array(parts, shape=ref.shape), sparse_tpu.bsr_array(parts, shape=ref.shape)
    _same_bsr(B, Bj)
    x = np.linspace(-1, 1, dense.shape[1])
    X = np.arange(dense.shape[1] * 3, dtype=np.float64).reshape(-1, 3)
    for v in (x, X):
        y, yj = (B @ v).numpy(), np.asarray(Bj @ v)
        np.testing.assert_allclose(y, yj, rtol=1e-12, atol=1e-12 * np.abs(yj).max())
        np.testing.assert_allclose(y, dense @ v, rtol=1e-12, atol=1e-12 * np.abs(yj).max())
    with pytest.raises(ValueError):
        B @ np.ones(3)
    _same_bsr(B.T, Bj.T)
    for conv in ("tocoo", "tocsc", "tocsr"):
        np.testing.assert_array_equal(getattr(B, conv)().toarray().numpy(),
                                      np.asarray(getattr(Bj, conv)().toarray()))
    assert B.nnz == Bj.nnz and B.count_nonzero() == Bj.count_nonzero()
    via = st.from_numpy_parts("bsr", dict(data=parts[0], indices=parts[1], indptr=parts[2],
                                          blocksize=ref.blocksize), ref.shape)
    _same_bsr(via, Bj)


def test_bsr_unary_scalar_and_validation():
    ref, dense = _block_matrix(seed=93)
    B = st.bsr_array((np.asarray(ref.data), ref.indices.copy(), ref.indptr.copy()),
                     shape=ref.shape)
    np.testing.assert_array_equal((-B).toarray(), -dense)
    np.testing.assert_array_equal(abs(B).toarray(), np.abs(dense))
    assert B.astype(np.float32).dtype == torch.float32
    np.testing.assert_array_equal((B + B.tocsr()).toarray().numpy(), 2 * dense)
    np.testing.assert_array_equal(B.multiply(B).toarray().numpy(), dense * dense)
    assert float(B.sum()) == pytest.approx(dense.sum(), rel=1e-14)
    assert st.issparse(B) and st.isspmatrix_bsr(B) and B.asformat("bsr") is B
    with pytest.raises(ValueError):
        st.bsr_array((np.asarray(ref.data), ref.indices.copy(), ref.indptr.copy()),
                     shape=ref.shape, blocksize=(1, 1))
    A = st.csr_array(sample_csr(6, 6, density=0.5, seed=94))
    for bad in ((4, 2), (0, 2)):
        with pytest.raises(ValueError):
            A.tobsr(blocksize=bad)
    np.testing.assert_array_equal(st.bsr_array(dense, blocksize=(2, 3)).toarray(), dense)


def test_bsr_repeats_bit_for_bit():
    """A product sums each block row in order: the same bits twice."""
    s = sp.random(300, 300, 0.05, random_state=np.random.default_rng(9), format="csr")
    B = st.csr_array(s).tobsr((3, 3))
    x = torch.tensor(np.random.default_rng(1).standard_normal(300))
    assert torch.equal(B @ x, B @ x)


# -- DOK and LIL ------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["todok", "tolil"])
def test_staging_formats_equal_reference(fmt):
    A, Aj, s = _pair(seed=82)
    F, Fj = getattr(A, fmt)(), getattr(Aj, fmt)()
    assert F.nnz == Fj.nnz and F.shape == Fj.shape and F.dtype == Fj.dtype
    np.testing.assert_array_equal(F.toarray(), Fj.toarray())
    if fmt == "todok":
        assert dict(F.items()) == dict(Fj.items())
    else:
        assert F.rows == Fj.rows and F.data == Fj.data
    for i in range(s.shape[0]):
        for j in range(s.shape[1]):
            assert F[i, j] == Fj[i, j]
    assert F[-1, -1] == Fj[-1, -1]
    x = np.arange(s.shape[1], dtype=np.float64)
    np.testing.assert_allclose((F @ x).numpy(), np.asarray(Fj @ x), rtol=1e-12)
    np.testing.assert_array_equal((F + A).toarray().numpy(), np.asarray((Fj + Aj).toarray()))
    np.testing.assert_array_equal(F.multiply(F).toarray().numpy(),
                                  np.asarray(Fj.multiply(Fj).toarray()))
    assert float(F.sum()) == pytest.approx(float(np.asarray(Fj.sum())), rel=1e-14)
    np.testing.assert_array_equal(F.T.toarray(), Fj.T.toarray())
    np.testing.assert_array_equal(F.tocsr().toarray().numpy(), s.toarray())
    for conv in ("tocoo", "tocsc"):
        np.testing.assert_array_equal(getattr(F, conv)().toarray().numpy(), s.toarray())
    assert st.issparse(F) and A.asformat(fmt[2:]).format == fmt[2:]
    with pytest.raises(IndexError):
        F[99, 0]


@pytest.mark.parametrize("fmt", ["todok", "tolil"])
def test_staging_unary_ops_and_edits(fmt):
    s = sp.csr_array(np.array([[1.0, -2.0], [0.0, 3.0]]))
    A, Aj = st.csr_array(s), sparse_tpu.csr_array(s)
    F, Fj = getattr(A, fmt)(), getattr(Aj, fmt)()
    np.testing.assert_array_equal((-F).toarray(), (-Fj).toarray())
    np.testing.assert_array_equal(abs(F).toarray(), abs(Fj).toarray())
    assert F.astype(np.float32).dtype == np.float32
    np.testing.assert_array_equal(F.astype(np.float32).toarray(), Fj.astype(np.float32).toarray())
    np.testing.assert_array_equal((F - F).toarray().numpy(), np.zeros((2, 2)))
    assert F.count_nonzero() == 3 and F.copy().toarray().tolist() == F.toarray().tolist()
    F[0, 0] = Fj[0, 0] = 3.5
    F[0, 1] = Fj[0, 1] = 0.0
    np.testing.assert_array_equal(F.toarray(), Fj.toarray())


def test_dok_incremental_build_and_duplicates():
    rng = np.random.default_rng(81)
    D, Dj = st.dok_array((4, 6)), sparse_tpu.dok_array((4, 6))
    for _ in range(30):
        i, j, v = rng.integers(0, 4), rng.integers(0, 6), float(rng.normal())
        D[i, j] = Dj[i, j] = v
    assert dict(D.items()) == dict(Dj.items())
    np.testing.assert_array_equal(D.tocsr().toarray().numpy(), D.toarray())
    C = st.coo_array((np.array([2.0, 3.0]), (np.array([1, 1]), np.array([1, 1]))), shape=(3, 3))
    assert C.todok()[1, 1] == 5.0


def test_lil_rows_and_shape_overrides():
    A, Aj, s = _pair(seed=82)
    L, Lj = A.tolil(), Aj.tolil()
    np.testing.assert_array_equal(L[2], Lj[2])
    newrow = np.zeros(s.shape[1])
    newrow[::2] = 2.0
    L[2] = Lj[2] = newrow
    L[0, 4] = Lj[0, 4] = 9.0
    L[0, 1] = Lj[0, 1] = 9.0
    assert L.rows == Lj.rows and L.data == Lj.data
    dense = np.arange(9.0).reshape(3, 3)
    for cls in (st.dok_array, st.lil_array):
        with pytest.raises(ValueError):
            cls(dense, shape=(2, 2))
    assert st.lil_array(dense, shape=(5, 3)).nnz == 8
    D = st.dok_array(dense, shape=(5, 4))
    assert D.shape == (5, 4) and D.nnz == 8


def test_round_trips_at_scale_are_exact():
    """10^5 entries through todok/tolil and back (chip_smoke phase 13d's
    check, smaller)."""
    rng = np.random.default_rng(12)
    s = sp.random(2000, 3000, 10**5 / 6e6, random_state=rng, format="csr")
    A = st.csr_array(s)
    for fmt in ("todok", "tolil"):
        back = getattr(A, fmt)().tocsr()
        assert torch.equal(back.indptr.to(torch.int64), A.indptr.to(torch.int64))
        assert torch.equal(back.indices.to(torch.int64), A.indices.to(torch.int64))
        assert torch.equal(back.data, A.data)
