"""Elementwise ops, reductions, SDDMM, ``x @ A`` and the ``SparseArray``
methods of sparse_tpu_torch against sparse_tpu, on the CPU.

The same seeded numpy inputs go through both packages. Structural
results (nnz, index arrays, argmin/argmax, flags) must be equal;
values agree to 1e-12 relative in f64 (the port sums in sorted order
where the reference scatters, so the last bits may differ), and exactly
where no sum is involved (max, min, products of two entries).
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu

import sparse_tpu_torch as st

from .utils.common import test_mtx_files
from .utils.sample import sample_csr, sample_dense

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


def _np(x):
    """Host numpy of a tensor, a sparse array of either package, or an array."""
    if isinstance(x, st.base.SparseArray):
        x = x.toarray()
    elif hasattr(x, "todense") and not isinstance(x, np.ndarray):
        x = x.todense()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _close(got, ref, rtol=RTOL):
    """Equal NaN positions, the rest within ``rtol`` of the largest entry."""
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    assert np.array_equal(np.isnan(g), np.isnan(r))
    g, r = np.nan_to_num(g, nan=0.0), np.nan_to_num(r, nan=0.0)
    scale = max(float(np.abs(r).max(initial=0.0)), 1.0)
    assert np.abs(g - r).max(initial=0.0) <= rtol * scale


def _pair(s, fmt="csr"):
    """(reference, port) arrays from the same scipy CSR buffers."""
    j = sparse_tpu.csr_array.from_parts(s.data.copy(), s.indices.copy(), s.indptr.copy(), s.shape)
    t = st.csr_array.from_parts(*(torch.from_numpy(a.copy()) for a in (s.data, s.indices,
                                                                        s.indptr)), s.shape)
    return j.asformat(fmt), t.asformat(fmt)


def _int_pair(m, n, density, seed, fmt="csr"):
    """test_reductions.py's operands: small integers, negatives and
    explicit zeros."""
    s = sp.random(m, n, density=density, random_state=seed, format="csr")
    s.data = np.round(s.data * 10 - 5)
    return (*_pair(s, fmt), s)


# -- elementwise ------------------------------------------------------------
@pytest.mark.parametrize("op", ["add", "sub", "multiply", "maximum", "minimum"])
@pytest.mark.parametrize("filename", test_mtx_files)
def test_binary_ops_on_testdata(filename, op):
    """A op B with B a seeded random matrix of A's shape."""
    s = sparse_tpu.io.mmread(filename).tocsr()
    s = sp.csr_matrix((np.asarray(s.data), np.asarray(s.indices), np.asarray(s.indptr)),
                      shape=s.shape)
    o = sample_csr(*s.shape, density=0.3, seed=7)
    (ja, ta), (jb, tb) = _pair(s), _pair(o)
    fn = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
          "multiply": lambda a, b: a.multiply(b), "maximum": lambda a, b: a.maximum(b),
          "minimum": lambda a, b: a.minimum(b)}[op]
    ref, got = fn(ja, jb), fn(ta, tb)
    assert got.nnz == ref.nnz
    assert np.array_equal(got.indices.numpy(), np.asarray(ref.indices))
    assert np.array_equal(got.indptr.numpy(), np.asarray(ref.indptr))
    _close(got, ref)


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "dia"])
def test_add_multiply_sum_diagonal_per_format(fmt):
    s = sample_csr(14, 14, density=0.3, seed=81)
    ja, ta = _pair(s, fmt)
    jb, tb = _pair(sample_csr(14, 14, density=0.3, seed=82), fmt)
    _close(ta + tb, ja + jb)
    _close(ta.multiply(tb), ja.multiply(jb))
    _close(ta * 2.5, ja * 2.5)
    for axis in (None, 0, 1):
        _close(ta.sum(axis=axis), ja.sum(axis=axis))
    for k in (-2, 0, 3):
        _close(ta.diagonal(k=k), ja.diagonal(k=k))


@pytest.mark.parametrize("other", ["col", "row", "vec", "scalar11", "full"])
def test_multiply_dense_broadcasts(other):
    s = sample_csr(40, 23, density=0.3, seed=0)
    ja, ta = _pair(s)
    rng = np.random.default_rng(0)
    d = {"col": rng.standard_normal((40, 1)), "row": rng.standard_normal((1, 23)),
         "vec": rng.standard_normal(23), "scalar11": np.full((1, 1), 2.5),
         "full": rng.standard_normal((40, 23))}[other]
    got = ta.multiply(d)
    assert isinstance(got, st.csr_array) and got.nnz == s.nnz
    _close(got, ja.multiply(d))
    with pytest.raises(ValueError, match="inconsistent shapes"):
        ta.multiply(np.ones((3, 2)))


def test_add_scalar_and_dense():
    s = sample_csr(9, 7, density=0.4, seed=3)
    ja, ta = _pair(s)
    _close(ta + 0, ja + 0)
    with pytest.raises(NotImplementedError):
        ta + 1.0
    d = sample_dense(9, 7, seed=4)
    _close(ta + d, ja + d)
    _close(d - ta, d - ja)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_sum_mean(axis):
    s = sample_csr(17, 13, density=0.3, seed=86)
    ja, ta = _pair(s)
    _close(ta.sum(axis=axis), ja.sum(axis=axis))
    _close(ta.mean(axis=axis), ja.mean(axis=axis))


@pytest.mark.parametrize("name", ["sqrt", "sin", "expm1", "log1p", "tan", "tanh", "sinh",
                                  "arcsin", "arcsinh", "arctan", "arctanh", "deg2rad",
                                  "rad2deg", "trunc", "ceil", "floor", "rint", "sign"])
def test_zero_preserving_ufuncs(name):
    s = sample_csr(11, 9, density=0.4, seed=88)
    s.data = s.data * 1.8 - 0.9  # in (-0.9, 0.9): inside every domain
    ja, ta = _pair(s)
    _close(getattr(ta, name)(), getattr(ja, name)(), rtol=1e-14)


def test_power_neg_abs_conj():
    s = sample_csr(15, 12, density=0.3, dtype=np.complex128, seed=83)
    ja, ta = _pair(s)
    for fn in (lambda a: a.power(2), lambda a: -a, abs, lambda a: a.conj(),
               lambda a: a.conjugate()):
        _close(fn(ta), fn(ja))


def test_union_add_makes_one_fetch():
    from sparse_tpu_torch import hostsync

    _, ta = _pair(sample_csr(30, 30, density=0.2, seed=5))
    _, tb = _pair(sample_csr(30, 30, density=0.2, seed=6))
    hostsync.HOST_SYNCS = 0
    ta + tb
    assert hostsync.HOST_SYNCS == 1


# -- reductions -------------------------------------------------------------
CASES = [(1, 1, 0.0, 0), (3, 5, 0.2, 1), (7, 4, 0.5, 2), (6, 6, 0.9, 3), (8, 3, 1.0, 4),
         (2, 9, 0.1, 5)]


@pytest.mark.parametrize("m,n,density,seed", CASES)
@pytest.mark.parametrize("name", ["max", "min", "nanmax", "nanmin", "argmax", "argmin"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_reductions(m, n, density, seed, name, axis):
    ja, ta, _ = _int_pair(m, n, density, seed)
    ref, got = getattr(ja, name)(axis=axis), getattr(ta, name)(axis=axis)
    assert np.array_equal(_np(got).ravel(), _np(ref).ravel())


def _nan_cases():
    yield sp.csr_matrix(np.array([[-5.0, np.nan]]))
    yield sp.csr_matrix((np.array([-5.0, np.nan]), np.array([0, 1]), np.array([0, 2])),
                        shape=(1, 3))
    yield sp.csr_matrix(np.array([[np.nan, np.nan]]))
    yield sp.csr_matrix((np.array([np.nan]), np.array([0]), np.array([0, 1])), shape=(1, 2))
    yield sp.csr_matrix((np.array([0.0, -3.0]), np.array([0, 1]), np.array([0, 2])),
                        shape=(1, 3))
    yield sp.csr_matrix((np.array([-3.0, 0.0]), np.array([1, 2]), np.array([0, 2])),
                        shape=(1, 3))
    yield sp.csr_matrix((np.array([0.0, np.nan]), np.array([0, 1]), np.array([0, 2])),
                        shape=(1, 3))
    yield sp.csr_matrix(np.array([[np.inf, np.nan], [-np.inf, np.nan]]))


@pytest.mark.parametrize("case", range(8))
def test_nan_inf_and_zero_semantics(case):
    s = list(_nan_cases())[case]
    ja, ta = _pair(s)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in ("nanmax", "nanmin", "argmax", "argmin", "max", "min"):
            for axis in (None, 0, 1):
                ref, got = getattr(ja, name)(axis=axis), getattr(ta, name)(axis=axis)
                np.testing.assert_equal(_np(got).astype(float).ravel(),
                                        _np(ref).astype(float).ravel(), err_msg=f"{name} {axis}")


@pytest.mark.parametrize("dense", [np.array([[-128, -1], [3, 0]], dtype=np.int8),
                                   np.array([[2**53, 2**53 + 1], [-2**53 - 1, -2**53]])])
def test_arg_reductions_exact_integers(dense):
    s = sp.csr_matrix(dense)
    ja, ta = _pair(s)
    for name in ("argmax", "argmin"):
        for axis in (None, 0, 1):
            assert np.array_equal(_np(getattr(ta, name)(axis=axis)).ravel(),
                                  _np(getattr(ja, name)(axis=axis)).ravel())


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "dia"])
def test_trace_nonzero_count(fmt):
    ja, ta, s = _int_pair(6, 7, 0.5, 11, fmt)
    for off in (-2, 0, 3):
        assert float(ta.trace(offset=off)) == float(ja.trace(offset=off))
    (gr, gc), (wr, wc) = ta.nonzero(), ja.nonzero()
    assert np.array_equal(gr.numpy(), wr) and np.array_equal(gc.numpy(), wc)
    assert ta.count_nonzero() == ja.count_nonzero()


def test_reductions_on_noncanonical_coo():
    r, c, v = np.array([0, 0]), np.array([0, 0]), np.array([1.0, 2.0])
    ja, ta = (p.coo_array((v, (r, c)), shape=(1, 2)) for p in (sparse_tpu, st))
    assert float(ta.max()) == float(ja.max()) == 3.0
    assert float(ta.min()) == float(ja.min()) == 0.0
    assert ta.argmax() == ja.argmax() == 0


def test_reduction_errors():
    _, ta, _ = _int_pair(3, 3, 0.5, 7)
    for name in ("max", "min", "nanmax", "nanmin", "argmax", "argmin"):
        with pytest.raises(ValueError):
            getattr(ta, name)(axis=1, out=np.zeros(3))
    for bad in (1.0, np.nan):
        with pytest.raises(NotImplementedError):
            ta.maximum(bad)
    with pytest.raises(ValueError):
        st.csr_array((0, 3), device="cpu").max()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_maximum_minimum(seed):
    ja, ta, _ = _int_pair(7, 6, 0.5, seed)
    jb, tb, _ = _int_pair(7, 6, 0.3, seed + 100)
    for name in ("maximum", "minimum"):
        ref, got = getattr(ja, name)(jb), getattr(ta, name)(tb)
        assert got.nnz == ref.nnz
        _close(got, ref, rtol=0.0)
    _close(ta.maximum(-2.0), ja.maximum(-2.0), rtol=0.0)
    _close(ta.minimum(3.0), ja.minimum(3.0), rtol=0.0)


# -- canonical form and in-place edits --------------------------------------
@pytest.mark.parametrize("k", [-2, 0, 1])
@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_setdiag(k, fmt):
    ja, ta, _ = _int_pair(5, 6, 0.4, 50, fmt)
    ta.T  # a cached plan, dropped by the in-place edit
    for vals in (7.5, np.arange(3, dtype=float) + 1):
        ja.setdiag(vals, k=k)
        ta.setdiag(vals, k=k)
        _close(ta, ja, rtol=0.0)
        _close(ta.T, ja.T, rtol=0.0)
    assert ta.format == fmt


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_operator_adjoint_follows_in_place_edits(fmt, cache, monkeypatch):
    """aslinearoperator(A) holds A^T for its adjoint products; each
    in-place edit of A rebuilds it, so rmatvec stays A^T x (scipy's
    recomputed A.H), plan cache on or off. Integer values: exact."""
    monkeypatch.setattr(st.settings, "plan_cache", cache)
    _, ta, s = _int_pair(7, 7, 0.4, 70, fmt)
    s = s.tolil()
    op = st.linalg.aslinearoperator(ta)
    x = np.arange(7, dtype=float) - 3
    edits = (lambda a: a.setdiag(0.0), lambda a: a.setdiag(2.5, k=1),
             lambda a: a.setdiag(np.arange(1.0, 6.0), k=-2))
    for edit in (lambda a: None, *edits):
        edit(ta)
        edit(s)
        _close(op.rmatvec(torch.from_numpy(x)), s.T @ x, rtol=0.0)
        _close(op.matvec(torch.from_numpy(x)), s @ x, rtol=0.0)
    ta.eliminate_zeros()
    _close(op.rmatvec(torch.from_numpy(x)), s.T @ x, rtol=0.0)


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_reshape_resize(order, fmt):
    ja, ta, _ = _int_pair(6, 4, 0.5, 60, fmt)
    got, ref = ta.reshape((8, 3), order=order), ja.reshape((8, 3), order=order)
    assert got.format == fmt
    _close(got, ref, rtol=0.0)
    ja.resize((4, 9))
    ta.resize((4, 9))
    assert ta.shape == (4, 9)
    _close(ta, ja, rtol=0.0)


def test_eliminate_zeros_sum_duplicates_check_format():
    ja, ta, _ = _int_pair(5, 5, 0.8, 30)
    ja.eliminate_zeros()
    ta.eliminate_zeros()
    assert ta.nnz == ja.nnz
    _close(ta, ja, rtol=0.0)
    ta.check_format()
    ta.sort_indices(), ta.prune(), ta.sum_duplicates()
    _close(ta.sorted_indices(), ta, rtol=0.0)
    r, c, v = np.array([2, 0, 2, 0]), np.array([1, 3, 1, 3]), np.array([1.0, 2.0, 4.0, 8.0])
    A = st.coo_array((v, (r, c)), shape=(3, 4))
    assert not A.has_canonical_format
    A.sum_duplicates()
    assert A.has_canonical_format and A.nnz == 2
    assert A.row.tolist() == [0, 2] and A.col.tolist() == [3, 1] and A.data.tolist() == [10.0, 5.0]
    for bad in ((np.ones(2), np.array([4, 1]), np.array([0, 2, 2, 2, 2])),
                (np.ones(2), np.array([1, 0]), np.array([0, 2, 2, 2, 2])),
                (np.ones(2), np.array([0, 1]), np.array([0, 2, 1, 2, 2]))):
        B = st.csr_array.from_parts(*(torch.from_numpy(a) for a in bad), (4, 5))
        with pytest.raises(ValueError):
            B.check_format()


def test_not_yet_ported_formats_raise():
    """tobsr, todok and tolil once raised, naming the roadmap item that
    ports them; now each converts, to the reference's format and values
    (explicit zeros and all)."""
    ja, ta, s = _int_pair(4, 4, 0.5, 1)
    for name in ("tobsr", "todok", "tolil"):
        out, ref = getattr(ta, name)(), getattr(ja, name)()
        assert out.format == ref.format == name[2:]
        np.testing.assert_array_equal(np.asarray(out.toarray()), np.asarray(ref.toarray()))
        np.testing.assert_array_equal(np.asarray(out.toarray()), s.toarray())


# -- SDDMM and x @ A --------------------------------------------------------
@pytest.mark.parametrize("kdim", [1, 3, 8])
@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_sddmm(fmt, kdim, monkeypatch):
    from sparse_tpu_torch.ops import sddmm

    monkeypatch.setattr(sddmm, "CHUNK", 7)  # several chunks at this size
    s = sample_csr(20, 15, density=0.3, seed=90)
    ja, ta = _pair(s, fmt)
    C, D = sample_dense(20, kdim, seed=91), sample_dense(kdim, 15, seed=92)
    got = ta.sddmm(C, D)
    assert got.format == fmt and got.nnz == s.nnz
    _close(got, ja.sddmm(C, D))
    _close(got, s.multiply(C @ D).toarray())


def test_sddmm_complex():
    s = sample_csr(12, 10, density=0.4, dtype=np.complex128, seed=93)
    ja, ta = _pair(s)
    C = sample_dense(12, 4, dtype=np.complex128, seed=94)
    D = sample_dense(4, 10, dtype=np.complex128, seed=95)
    _close(ta.sddmm(C, D), ja.sddmm(C, D))


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "dia"])
@pytest.mark.parametrize("ndim", [1, 2])
def test_rmatmul(fmt, ndim):
    """x @ A (and X @ A) run as (A^T x^T)^T on the plan-cached transpose."""
    s = sample_csr(30, 25, density=0.25, seed=96)
    ja, ta = _pair(s, fmt)
    x = sample_dense(30, 1, seed=97)[:, 0] if ndim == 1 else sample_dense(4, 30, seed=97)
    got = x @ ta
    assert tuple(got.shape) == ((25,) if ndim == 1 else (4, 25))
    _close(got, x @ ja)
    assert torch.equal(got, x @ ta)


@pytest.mark.parametrize("filename", test_mtx_files)
def test_rmatmul_on_testdata(filename):
    j = sparse_tpu.io.mmread(filename).tocsr()
    t = st.io.mmread(filename).tocsr()
    x = sample_dense(j.shape[0], 1, seed=98)[:, 0]
    _close(x @ t, x @ j)
