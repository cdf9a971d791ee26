"""Constructors, assembly, conversions and IO of sparse_tpu_torch against
sparse_tpu, on the CPU.

``kron``, ``kronsum``, ``bmat`` and the stacks, ``tril``/``triu``,
``find``, ``random`` (equal for the same seed: both draw with numpy),
``mmwrite``/``mmread`` and ``save_npz``/``load_npz`` across the two
packages, and ``models.poisson.laplacian_2d_csr``. Assembly involves no
sums except where duplicates meet, so values agree exactly (rtol 0)
unless a test says otherwise. The conversions that sum duplicates
(``coo_to_dense``, ``csr_to_dense``, ``dia._coo_to_dia``) repeat bit for
bit.
"""

import numpy as np
import pytest
import scipy.io as sci_io
import scipy.sparse as sp
import torch

import sparse_tpu

import sparse_tpu_torch as st
from sparse_tpu_torch.dia import _coo_to_dia
from sparse_tpu_torch.models import laplacian_2d_csr
from sparse_tpu_torch.ops.conv import coo_to_dense, csr_to_dense

from .utils.common import test_mtx_files
from .utils.sample import sample_csr


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


def _np(x):
    if isinstance(x, st.base.SparseArray):
        return x.toarray().numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.todense() if hasattr(x, "todense") else x)


def _equal(got, ref, rtol=0.0):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape and g.dtype == r.dtype, (g.shape, r.shape, g.dtype, r.dtype)
    assert np.abs(g - r).max(initial=0.0) <= rtol * max(float(np.abs(r).max(initial=0)), 1.0)


def _both(s):
    return sparse_tpu.csr_array(s), st.csr_array(s)


# -- conversions that sum duplicates ------------------------------------------
@pytest.fixture(scope="module")
def repeated_coo():
    """A 64 x 64 COO holding every entry 100 times, in seeded random order."""
    rng = np.random.default_rng(3)
    r, c = np.divmod(np.arange(64 * 64), 64)
    order = rng.permutation(100 * 64 * 64)
    rows, cols = np.tile(r, 100)[order], np.tile(c, 100)[order]
    vals = rng.standard_normal(rows.shape[0])
    return rows, cols, vals


@pytest.mark.parametrize("conv", ["coo_to_dense", "csr_to_dense", "coo_to_dia"])
def test_duplicate_summing_conversions_repeat_bit_for_bit(repeated_coo, conv):
    rows, cols, vals = (torch.from_numpy(a) for a in repeated_coo)
    if conv == "coo_to_dense":
        run = lambda: coo_to_dense(rows, cols, vals, (64, 64))  # noqa: E731
    elif conv == "csr_to_dense":
        # rows grouped, columns within a row left in their random order
        order = torch.argsort(rows, stable=True)
        indptr = torch.searchsorted(rows[order], torch.arange(65, dtype=rows.dtype))
        run = lambda: csr_to_dense(indptr, cols[order], vals[order], (64, 64))  # noqa: E731
    else:
        coo = st.coo_array((vals, (rows, cols)), shape=(64, 64))
        run = lambda: _coo_to_dia(coo)[0]  # noqa: E731
    a, b = run(), run()
    assert torch.equal(a, b)
    ref = np.zeros((64, 64))
    np.add.at(ref, (repeated_coo[0], repeated_coo[1]), repeated_coo[2])
    if conv == "coo_to_dia":  # plane k holds offset k - 63 at column j
        j = np.arange(64)
        ref = np.stack([np.where((j - o >= 0) & (j - o < 64), ref[(j - o) % 64, j], 0.0)
                        for o in range(-63, 64)])
    assert np.allclose(a.numpy(), ref, rtol=1e-12, atol=1e-12)


# -- kron / kronsum / bmat / triangles / find ---------------------------------
@pytest.mark.parametrize("fmt", [None, "csr", "csc"])
@pytest.mark.parametrize("filename", test_mtx_files[:3])
def test_kron(filename, fmt):
    j = sparse_tpu.io.mmread(filename)
    t = st.io.mmread(filename)
    jb, tb = _both(sample_csr(3, 4, density=0.5, seed=1))
    got, ref = st.kron(t, tb, format=fmt), sparse_tpu.kron(j, jb, format=fmt)
    assert got.format == (fmt or "coo")
    _equal(got, ref)


def test_kron_empty_and_dense_operands():
    got = st.kron(st.csr_array((3, 4)), st.eye(2))
    assert got.shape == (6, 8) and got.nnz == 0
    d = np.array([[1.0, 0.0], [2.0, 3.0]])
    _equal(st.kron(d, d), sparse_tpu.kron(d, d))


@pytest.mark.parametrize("fmt", [None, "csr"])
def test_kronsum(fmt):
    a, b = sample_csr(4, 4, density=0.5, seed=137), sample_csr(3, 3, density=0.5, seed=138)
    got = st.kronsum(st.csr_array(a), st.csr_array(b), format=fmt)
    _equal(got, sparse_tpu.kronsum(sparse_tpu.csr_array(a), sparse_tpu.csr_array(b), format=fmt))
    _equal(got, sp.kronsum(a, b).toarray())
    with pytest.raises(ValueError, match="square"):
        st.kronsum(st.csr_array(np.ones((2, 3))), st.csr_array(a))


@pytest.mark.parametrize("fmt", [None, "csr", "csc"])
def test_bmat_and_stacks(fmt):
    a = sample_csr(3, 4, density=0.5, seed=132)
    b = sample_csr(3, 2, density=0.5, seed=133)
    c = sample_csr(5, 4, density=0.5, seed=134)
    (ja, ta), (jb, tb), (jc, tc) = _both(a), _both(b), _both(c)
    _equal(st.bmat([[ta, tb], [tc, None]], format=fmt),
           sparse_tpu.bmat([[ja, jb], [jc, None]], format=fmt))
    _equal(st.vstack([ta, tc], format=fmt), sparse_tpu.vstack([ja, jc], format=fmt))
    _equal(st.hstack([ta, tb], format=fmt), sparse_tpu.hstack([ja, jb], format=fmt))
    _equal(st.block_diag([ta, tb], format=fmt), sparse_tpu.block_diag([ja, jb], format=fmt))
    _equal(st.block_diag([ta, tb]), sp.block_diag([a, b]).toarray())
    with pytest.raises(ValueError):
        st.bmat([[ta, st.csr_array(sample_csr(2, 2, seed=136))]])
    with pytest.raises(ValueError):
        st.bmat([[ta, None], [None, None]])


@pytest.mark.parametrize("k", [-2, 0, 1])
@pytest.mark.parametrize("fn", ["tril", "triu"])
def test_tril_triu(fn, k):
    s = sample_csr(8, 10, density=0.4, seed=131)
    ja, ta = _both(s)
    _equal(getattr(st, fn)(ta, k=k, format="csr"), getattr(sparse_tpu, fn)(ja, k=k, format="csr"))
    _equal(getattr(st, fn)(ta, k=k), getattr(sp, fn)(s, k=k).toarray())


def test_find_coalesces_duplicates():
    r, c = np.array([0, 0, 1, 2]), np.array([1, 1, 0, 2])
    v = np.array([1.0, -1.0, 2.0, 3.0])
    got = st.find(st.coo_array((v, (r, c)), shape=(3, 3)))
    ref = sparse_tpu.find(sparse_tpu.coo_array((v, (r, c)), shape=(3, 3)))
    for g, w in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(w))


# -- random -----------------------------------------------------------------
@pytest.mark.parametrize("m,n,density,fmt", [(20, 30, 0.1, "coo"), (50, 40, 0.05, "csr"),
                                             (9000, 8000, 1e-6, "csr")])
@pytest.mark.parametrize("dtype", [None, np.float32])
def test_random_equal_for_the_same_seed(m, n, density, fmt, dtype):
    """Both packages draw with numpy's default_rng: the same matrix (the
    last size takes the sample-and-deduplicate branch past 2**26 slots)."""
    got = st.random(m, n, density=density, format=fmt, dtype=dtype, random_state=7)
    ref = sparse_tpu.random(m, n, density=density, format=fmt, dtype=dtype, random_state=7)
    assert got.nnz == ref.nnz == int(round(density * m * n))
    g, r = got.tocoo(), ref.tocoo()
    assert np.array_equal(g.row.numpy(), np.asarray(r.row))
    assert np.array_equal(g.col.numpy(), np.asarray(r.col))
    assert np.array_equal(g.data.numpy(), np.asarray(r.data))


def test_rand_random_array_and_samplers():
    _equal(st.rand(6, 5, 0.4, random_state=3), sparse_tpu.rand(6, 5, 0.4, random_state=3))
    got = st.random_array((6, 5), density=0.4, rng=3, format="csr",
                          data_sampler=lambda size: np.arange(size, dtype=float))
    ref = sparse_tpu.random_array((6, 5), density=0.4, rng=3, format="csr",
                                  data_sampler=lambda size: np.arange(size, dtype=float))
    assert got.format == "csr"
    _equal(got, ref)
    with pytest.raises(ValueError):
        st.random(3, 3, density=1.5)


# -- IO across the packages -------------------------------------------------
@pytest.mark.parametrize("dt", [np.float64, np.complex128])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_mmwrite_mmread_across_packages(tmp_path, writer, dt):
    s = sample_csr(7, 9, density=0.3, dtype=dt, seed=139)
    path = str(tmp_path / "m.mtx")
    if writer == "port":
        st.io.mmwrite(path, st.csr_array(s), comment="written by sparse_tpu_torch")
    else:
        sparse_tpu.io.mmwrite(path, sparse_tpu.csr_array(s))
    _equal(st.io.mmread(path), sparse_tpu.io.mmread(path))
    _equal(st.io.mmread(path), sci_io.mmread(path).toarray())
    _equal(st.io.mmread(path), s.toarray(), rtol=1e-15)  # 16 significant digits


@pytest.mark.parametrize("filename", test_mtx_files)
def test_mmread_native_and_numpy_parsers_agree(filename, monkeypatch):
    from sparse_tpu_torch import native

    got = st.io.mmread(filename)
    _equal(got, sparse_tpu.io.mmread(filename))
    monkeypatch.setattr(native, "lib", lambda: None)
    _equal(st.io.mmread(filename), got)


@pytest.mark.parametrize("symmetry", ["general", "symmetric", "skew-symmetric"])
def test_mmread_array_bodies(tmp_path, symmetry, monkeypatch):
    from sparse_tpu_torch import native

    d = np.array([[1.0, 2.0, 0.0], [2.0, 0.0, 5.0], [0.0, 5.0, 6.0]])
    if symmetry == "skew-symmetric":
        d = np.array([[0.0, -2.0, 0.0], [2.0, 0.0, -5.0], [0.0, 5.0, 0.0]])
    path = str(tmp_path / "a.mtx")
    sci_io.mmwrite(path, d, symmetry=symmetry)
    _equal(st.io.mmread(path), d)
    _equal(st.io.mmread(path), sparse_tpu.io.mmread(path))
    monkeypatch.setattr(native, "lib", lambda: None)
    _equal(st.io.mmread(path), d)


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "dia"])
@pytest.mark.parametrize("writer", ["port", "reference", "scipy"])
def test_npz_across_packages(tmp_path, writer, fmt):
    s = sample_csr(7, 9, density=0.3, seed=139).asformat(fmt)
    path = str(tmp_path / "m.npz")
    if writer == "port":
        st.save_npz(path, st.csr_array(s).asformat(fmt))
    elif writer == "reference":
        sparse_tpu.save_npz(path, sparse_tpu.csr_array(s.tocsr()).asformat(fmt))
    else:
        sp.save_npz(path, s)
        if fmt == "dia":  # neither package reads scipy's DIA layout
            for pkg in (st, sparse_tpu):
                with pytest.raises(ValueError, match="unsupported sparse npz format"):
                    pkg.load_npz(path)
            return
    got = st.load_npz(path)
    assert got.format == (fmt if fmt != "dia" else "coo")
    _equal(got, s.toarray())
    if writer == "port":
        _equal(sparse_tpu.load_npz(path), s.toarray())
        assert np.allclose(sp.load_npz(path).toarray(), s.toarray(), rtol=0, atol=0)


# -- surface ----------------------------------------------------------------
def test_predicates_aliases_and_index_helpers():
    a = st.csr_array(sample_csr(5, 6, density=0.4, seed=0))
    assert st.issparse(a) and st.isspmatrix(a) and st.is_sparse_matrix(a)
    assert not st.issparse(np.ones(3))
    assert st.isspmatrix_csr(a) and st.isspmatrix_csc(a.tocsc())
    assert st.isspmatrix_coo(a.tocoo()) and st.isspmatrix_dia(a.todia())
    assert not (st.isspmatrix_bsr(a) or st.isspmatrix_dok(a) or st.isspmatrix_lil(a))
    assert st.eye_array is st.eye and st.diags_array is st.diags and st.block_array is st.bmat
    assert issubclass(st.SparseEfficiencyWarning, st.SparseWarning)
    for args in (dict(maxval=10), dict(maxval=2**40), dict(arrays=(np.zeros(3, np.int64),)),
                 dict(arrays=(np.zeros(3, np.int64),), check_contents=True)):
        assert st.get_index_dtype(**args) == sparse_tpu.get_index_dtype(**args)
    ix, ip = st.safely_cast_index_arrays(a, np.int8)
    assert ix.dtype == ip.dtype == torch.int8
    assert torch.equal(ix.long(), a.indices.long())
    with pytest.raises(ValueError):
        st.safely_cast_index_arrays(st.csr_array(sp.identity(300, format="csr")), np.int8)
    with pytest.raises(NotImplementedError):
        st.expand_dims(a, 0)


def test_swapaxes_permute_dims():
    s = sample_csr(4, 6, density=0.5, seed=2)
    a = st.csr_array(s)
    _equal(st.swapaxes(a, 0, 1), s.T.toarray())
    _equal(st.swapaxes(a, 1, 1), s.toarray())
    _equal(st.permute_dims(a), s.T.toarray())
    _equal(st.permute_dims(a, (0, 1)), s.toarray())
    for bad in (lambda: st.swapaxes(a, 0, 2), lambda: st.permute_dims(a, (0, 2))):
        with pytest.raises(ValueError):
            bad()


def test_coo_tensordot():
    rng = np.random.default_rng(7)
    A = sp.random(6, 5, 0.4, random_state=rng, format="coo")
    B = sp.random(5, 7, 0.5, random_state=rng, format="coo")
    C = sp.random(6, 5, 0.5, random_state=rng, format="coo")
    a, b, c = (st.coo_array((M.data, (M.row, M.col)), shape=M.shape) for M in (A, B, C))
    Ad, Bd, Cd = A.toarray(), B.toarray(), C.toarray()
    for got, want in ((a.tensordot(b, axes=1), np.tensordot(Ad, Bd, axes=1)),
                      (a.tensordot(b, axes=([1], [0])), np.tensordot(Ad, Bd, axes=([1], [0]))),
                      (a.tensordot(c.T, axes=([0], [1])), np.tensordot(Ad, Cd.T, axes=([0], [1]))),
                      (a.tensordot(c, axes=2), np.tensordot(Ad, Cd, axes=2)),
                      (a.tensordot(c.T, axes=([0, 1], [1, 0])),
                       np.tensordot(Ad, Cd.T, axes=([0, 1], [1, 0]))),
                      (a.tensordot(np.arange(5.0), axes=1), np.tensordot(Ad, np.arange(5.0), 1))):
        assert np.allclose(_np(got), want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        a.tensordot(b, axes=([0, 1], [0]))
    with pytest.raises(ValueError):
        a.tensordot(np.ones((6, 1)), axes=2)


# -- the kron Laplacian ----------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_laplacian_2d_csr(dtype):
    """kron(l1, I) + kron(I, l1) as the reference builds it, and its A @ x
    equal bit for bit to the pde.py-shaped 5-point operator's (both are
    small integers on the same five offsets, through the DIA path)."""
    from sparse_tpu.models.poisson import laplacian_2d_csr as ref_laplacian

    n = 9
    got = laplacian_2d_csr(n, dtype)
    ref = ref_laplacian(n, dtype)
    assert isinstance(got, st.csr_array) and got.nnz == ref.nnz == 5 * n * n - 4 * n
    assert np.array_equal(got.indptr.numpy(), np.asarray(ref.indptr))
    assert np.array_equal(got.indices.numpy(), np.asarray(ref.indices))
    _equal(got, ref)
    N = n * n
    a = np.full(N - 1, -1.0)
    a[n - 1::n] = 0.0
    pde = st.diags([np.full(N - n, -1.0), a, np.full(N, 4.0), a, np.full(N - n, -1.0)],
                   [-n, -1, 0, 1, n], shape=(N, N), dtype=dtype).tocsc().T.tocsr()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(N).astype(dtype))
    assert torch.equal(got @ x, pde @ x)
