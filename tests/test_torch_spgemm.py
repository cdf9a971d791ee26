"""SpGEMM of sparse_tpu_torch against sparse_tpu, on the CPU.

Both packages take the native Gustavson for host f32/f64 products (it
adds in f64 and rounds once) and the ESC elsewhere; with the reference's
``native_spgemm`` off and the port's native library patched away both
take the ESC. The same seeded numpy inputs go
through both. Tolerances: f64 1e-12 relative to the largest entry of the
result, f32 1e-5; integer-valued inputs (the banded all-ones operator of
``examples/spgemm_microbenchmark.py``) agree exactly, as do two runs of
one product.
"""

import numpy as np
import pytest
import scipy.io as sci_io
import scipy.sparse as sp
import torch

import sparse_tpu
from sparse_tpu.config import settings as jsettings

import sparse_tpu_torch as st
from sparse_tpu_torch import hostsync, native
from sparse_tpu_torch.ops import spgemm

from .utils.common import test_mtx_files
from .utils.sample import sample_csr

TOL = {np.float32: 1e-5, np.float64: 1e-12, np.complex128: 1e-12, np.int64: 0.0}


@pytest.fixture(autouse=True)
def _cpu():
    old = (st.settings.device, jsettings.native_spgemm)
    st.settings.device = "cpu"
    yield
    st.settings.device, jsettings.native_spgemm = old


def _use(path, monkeypatch):
    """Both packages on the native Gustavson (where it applies) or both on
    the ESC: the port has no library to call for the ESC."""
    on = path == "native"
    jsettings.native_spgemm = on
    if not on:
        monkeypatch.setattr(native, "lib", lambda: None)
    elif native.lib() is None:
        pytest.skip("no g++ here: the native library cannot be built")


@pytest.fixture(params=["native", "esc"])
def path(request, monkeypatch):
    _use(request.param, monkeypatch)
    return request.param


# (dtype, path): the native Gustavson serves host f32/f64 only, so complex
# products take the ESC on either setting
DTYPE_PATHS = [(np.float32, "native"), (np.float64, "native"), (np.float64, "esc"),
               (np.complex128, "esc")]


def _dense(A):
    return A.toarray().numpy() if isinstance(A, st.csr_array) else np.asarray(A.todense())


def _close(got, ref, dt):
    """Equal within TOL[dt] of the largest entry (exactly for integers)."""
    g, r = _dense(got), _dense(ref)
    assert g.shape == r.shape
    scale = max(float(np.abs(r).max(initial=0.0)), 1.0)
    assert np.abs(g - r).max(initial=0.0) <= TOL[dt] * scale


def _pair(s):
    return sparse_tpu.csr_array(s), st.csr_array(s)


def banded(n, nnz_per_row=11, fmt="csr"):
    """examples/spgemm_microbenchmark.py's A: ones on nnz_per_row diagonals."""
    offs = [x - nnz_per_row // 2 for x in range(nnz_per_row)]
    return (sparse_tpu.diags([1] * nnz_per_row, offs, shape=(n, n), format=fmt, dtype=np.float64),
            st.diags([1] * nnz_per_row, offs, shape=(n, n), format=fmt, dtype=np.float64))


@pytest.mark.parametrize("dt,path_", DTYPE_PATHS)
@pytest.mark.parametrize("filename", test_mtx_files)
def test_spgemm_matches_reference_on_testdata(filename, dt, path_, monkeypatch):
    """A @ A (A @ A^T for the rectangular file) on every fixture file."""
    _use(path_, monkeypatch)
    s = sci_io.mmread(filename).tocsr().astype(dt)
    o = s if s.shape[0] == s.shape[1] else s.T.tocsr()
    ref = sparse_tpu.csr_array(s) @ sparse_tpu.csr_array(o)
    got = st.csr_array(s) @ st.csr_array(o)
    assert got.dtype == torch.from_numpy(np.zeros(0, dt)).dtype
    _close(got, ref, dt)
    got.check_format()


@pytest.mark.parametrize("fmt_a,fmt_b", [("csr", "csr"), ("csr", "csc"), ("coo", "csr"),
                                         ("csc", "coo"), ("dia", "csr"), ("dia", "dia")])
def test_spgemm_operand_formats(fmt_a, fmt_b, path):
    """Every format pair goes through the CSR product; the banded operands
    are integer-valued, so the results agree exactly."""
    s = sample_csr(40, 40, density=0.15, seed=52)
    jb, tb = banded(40, 5)
    ja = sparse_tpu.csr_array(s).asformat(fmt_a) if fmt_a != "dia" else jb.todia()
    ta = st.csr_array(s).asformat(fmt_a) if fmt_a != "dia" else tb.todia()
    ref, got = ja @ jb.asformat(fmt_b), ta @ tb.asformat(fmt_b)
    assert isinstance(got, st.csr_array)
    _close(got, ref, np.float64 if fmt_a != "dia" else np.int64)


@pytest.mark.parametrize("n,w", [(100, 11), (37, 3), (6, 11)])
def test_spgemm_banded_microbenchmark(n, w, path):
    """spgemm_microbenchmark.py's C = A @ B: equal to the reference and to
    the closed form C[i, j] = #{k : |i-k| <= w/2, |k-j| <= w/2, 0 <= k < n}."""
    ja, ta = banded(n, w)
    ref, got = ja @ ja.copy(), ta @ ta.copy()
    _close(got, ref, np.int64)
    h = w // 2
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    closed = np.clip(np.minimum(i, j) + h, None, n - 1) - np.clip(np.maximum(i, j) - h, 0, None) + 1
    assert np.array_equal(_dense(got), np.maximum(closed, 0).astype(np.float64))


@pytest.mark.parametrize("dt,path_", DTYPE_PATHS[:3])
@pytest.mark.parametrize("m,k,n,density", [(23, 17, 29, 0.3), (60, 5, 60, 0.2), (1, 40, 1, 0.5),
                                           (50, 50, 50, 0.02)])
def test_spgemm_random_and_rectangular(m, k, n, density, dt, path_, monkeypatch):
    _use(path_, monkeypatch)
    sa = sample_csr(m, k, density=density, dtype=dt, seed=50)
    sb = sample_csr(k, n, density=density, dtype=dt, seed=51)
    (ja, ta), (jb, tb) = _pair(sa), _pair(sb)
    _close(ta @ tb, ja @ jb, dt)


def test_spgemm_mixed_dtypes(path):
    sa = sample_csr(23, 17, density=0.3, dtype=np.float32, seed=50)
    sb = sample_csr(17, 29, density=0.3, dtype=np.complex128, seed=51)
    got = st.csr_array(sa) @ st.csr_array(sb)
    assert got.dtype == torch.complex128
    _close(got, sparse_tpu.csr_array(sa) @ sparse_tpu.csr_array(sb), np.complex128)


def test_spgemm_galerkin_chain(path):
    """R @ (A @ P), the multigrid triple product."""
    A = sample_csr(40, 40, density=0.15, seed=52)
    P = sample_csr(40, 12, density=0.3, seed=53)
    R = P.T.tocsr()
    got = st.csr_array(R) @ (st.csr_array(A) @ st.csr_array(P))
    ref = sparse_tpu.csr_array(R) @ (sparse_tpu.csr_array(A) @ sparse_tpu.csr_array(P))
    _close(got, ref, np.float64)


@pytest.mark.parametrize("shapes", [((5, 7), (7, 3)), ((0, 4), (4, 6)), ((4, 0), (0, 3))])
def test_spgemm_empty(shapes, path):
    a, b = (st.csr_array(s) for s in shapes)
    got = a @ b
    assert got.shape == (shapes[0][0], shapes[1][1]) and got.nnz == 0
    assert got.indptr.shape[0] == shapes[0][0] + 1


def test_spgemm_disjoint_structure_is_empty(path):
    """Nonzeros whose columns meet only empty rows of B expand to nothing."""
    a = st.csr_array(sp.csr_matrix(([1.0, 2.0], ([0, 1], [0, 0])), shape=(2, 2)))
    b = st.csr_array(sp.csr_matrix(([3.0], ([1], [1])), shape=(2, 2)))
    assert (a @ b).nnz == 0


def test_spgemm_duplicates_in_inputs(path):
    """COO operands holding repeated (row, col) pairs: the duplicates sum
    before the product, as in the reference."""
    rng = np.random.default_rng(9)
    r, c = rng.integers(0, 12, 60), rng.integers(0, 12, 60)
    v = rng.standard_normal(60)
    ja = sparse_tpu.coo_array((v, (r, c)), shape=(12, 12))
    ta = st.coo_array((v, (r, c)), shape=(12, 12))
    _close(ta @ ta, ja @ ja, np.float64)
    dense = sp.coo_matrix((v, (r, c)), shape=(12, 12)).toarray()
    assert np.allclose(_dense(ta @ ta), dense @ dense, rtol=1e-12, atol=1e-12)


def test_spgemm_dimension_mismatch():
    with pytest.raises(ValueError, match="dimension mismatch"):
        st.csr_array(np.ones((3, 4))) @ st.csr_array(np.ones((3, 4)))


def test_esc_repeats_and_makes_two_fetches(monkeypatch):
    """The ESC on CPU tensors: two counted host fetches a product (the
    expansion total and the unique count), the same bits twice, int32
    indices at this size."""
    monkeypatch.setattr(native, "lib", lambda: None)
    s = sample_csr(300, 300, density=0.05, dtype=np.float32, seed=3)
    A = st.csr_array(s)
    hostsync.HOST_SYNCS = 0
    C1 = A @ A
    assert hostsync.HOST_SYNCS == 2
    C2 = A @ A
    assert C1.indices.dtype == C1.indptr.dtype == torch.int32
    for a, b in ((C1.data, C2.data), (C1.indices, C2.indices), (C1.indptr, C2.indptr)):
        assert torch.equal(a, b)
    ref = s.astype(np.float64) @ s.astype(np.float64)
    assert np.allclose(_dense(C1), ref.toarray(), rtol=1e-5, atol=1e-6)


def test_native_path_only_for_cpu_tensors(monkeypatch):
    """A tensor off the CPU never reaches the native library: the check
    returns before any buffer is read (meta tensors stand in for the card
    here)."""
    def boom(*a, **k):
        raise AssertionError("native library reached")

    monkeypatch.setattr(native, "spgemm_host", boom)
    parts = [torch.zeros(3, dtype=torch.int32, device="meta"),
             torch.zeros(2, dtype=torch.int32, device="meta"),
             torch.zeros(2, dtype=torch.float32, device="meta")]
    assert spgemm._native_spgemm(*parts, *parts, 2, 2, torch.float32) is None


def test_native_unavailable_falls_back_to_esc(monkeypatch):
    """Without a native library (no g++), a host product takes the ESC,
    as the reference does, with the same result."""
    s = sample_csr(30, 30, density=0.2, seed=4)
    want = st.csr_array(s) @ st.csr_array(s)
    monkeypatch.setattr(native, "lib", lambda: None)
    hostsync.HOST_SYNCS = 0
    got = st.csr_array(s) @ st.csr_array(s)
    assert hostsync.HOST_SYNCS == 2  # the ESC ran
    _close(got, want, np.float64)
