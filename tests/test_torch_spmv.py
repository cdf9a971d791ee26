"""sparse_tpu_torch SpMV against sparse_tpu, on the CPU.

The port's prepared DIA SpMV runs its kernel's plain version here (CPU
tensors); it is held against sparse_tpu's Pallas kernel in interpret mode
(``dia_spmv_pallas_v2``) and against its XLA formulation
(``dia_spmv_xla``). Both sum the same D products per row in the same
order, so the f64 tolerance is a few ulps (1e-12) and the f32 tolerance
the reference tests' own (1e-5).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu
import sparse_tpu_torch as st
from sparse_tpu.config import settings as jax_settings
from sparse_tpu.kernels.dia_spmv import dia_spmv_pallas_v2
from sparse_tpu.ops.dia_spmv import dia_spmv_xla
from sparse_tpu_torch.kernels import dia_spmv as K
from sparse_tpu_torch.ops.dia_spmv import dia_spmv_torch

from .utils.sample import sample_csr

# tests/test_dia_spmv.py's cases, plus its multi-tile and wide-matrix ones
CASES = [
    (50, 50, [-5, -1, 0, 1, 5]),
    (40, 60, [-3, 0, 2, 10]),
    (60, 40, [-7, 0, 1]),
    (7, 7, [0]),
    (300, 300, [-17, -1, 0, 1, 17]),
    (2500, 2500, [-70, -1, 0, 1, 70]),
    (100, 2000, [0, 5]),
]


@pytest.fixture(autouse=True)
def _cpu():
    old = (st.settings.device, st.settings.spmv_mode)
    st.settings.device = "cpu"
    yield
    st.settings.device, st.settings.spmv_mode = old


def _prepared(data, offs, shape, x):
    return K.PreparedDia(torch.from_numpy(data), offs, shape)(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("m,n,offs", CASES)
def test_packed_plain_matches_pallas_interpret_f32(m, n, offs):
    rng = np.random.default_rng(m * 3 + n)
    data = rng.standard_normal((len(offs), n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(dia_spmv_pallas_v2(data, tuple(offs), x, (m, n), tile=1024, interpret=True))
    got = _prepared(data, offs, (m, n), x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, sp.dia_matrix((data, offs), shape=(m, n)) @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,n,offs", CASES)
def test_packed_plain_matches_xla_f64(m, n, offs):
    rng = np.random.default_rng(m + n)
    data = rng.standard_normal((len(offs), n))
    x = rng.standard_normal(n)
    want = np.asarray(dia_spmv_xla(data, tuple(offs), x, (m, n)))
    np.testing.assert_allclose(_prepared(data, offs, (m, n), x), want, rtol=1e-12, atol=1e-12)
    got = dia_spmv_torch(torch.from_numpy(data), tuple(offs), torch.from_numpy(x), (m, n))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_dia_pack_masks_junk_rows_like_reference():
    from sparse_tpu.kernels.dia_spmv import dia_pack as jax_pack, dia_plan as jax_plan

    m, offs = 600, (-1, 0, 1)
    data = np.random.default_rng(3).standard_normal((3, m)).astype(np.float32)
    data[0, m - 1] = 1e6  # slots scipy ignores
    data[2, 0] = -1e6
    pj = jax_plan(offs, (m, m), tile=1024)
    want = np.asarray(jax_pack(data, pj)).reshape(3, -1)[:, :m]
    pt = K.dia_plan(offs, (m, m))
    got = K.dia_pack(torch.from_numpy(data), pt).reshape(3, -1)
    np.testing.assert_array_equal(got[:, :m].numpy(), want)
    assert not got[:, m:].any()  # padded rows are exactly zero


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_csr_banded_path(mode):
    s = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(64, 64), format="csr")
    x = np.random.default_rng(2).standard_normal(64)
    st.settings.spmv_mode = mode
    old = jax_settings.spmv_mode
    jax_settings.spmv_mode = mode
    try:
        want = np.asarray(sparse_tpu.csr_array(s) @ x)
    finally:
        jax_settings.spmv_mode = old
    A = st.csr_array(s)
    assert A._maybe_dia() is not None
    np.testing.assert_allclose((A @ x).numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose((A @ x).numpy(), s @ x, rtol=1e-12)


@pytest.mark.parametrize("mode", ["auto", "ell", "segment", "pallas"])
def test_csr_unbanded_paths(mode):
    s = sample_csr(80, 70, density=0.3, seed=1)
    x = np.random.default_rng(3).standard_normal(70)
    X = np.random.default_rng(4).standard_normal((70, 3))
    st.settings.spmv_mode = mode
    A = st.csr_array(s)
    assert A._maybe_dia() is None  # ~every entry is a distinct diagonal
    Aj = sparse_tpu.csr_array(s)
    np.testing.assert_allclose((A @ x).numpy(), np.asarray(Aj @ x), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose((A @ X).numpy(), np.asarray(Aj @ X), rtol=1e-12, atol=1e-12)


def test_sell_mode_waits_for_slice_2():
    """Slice 2 ported the mode: 'sell' now runs the prepared SELL operator
    and gives sparse_tpu's product."""
    from sparse_tpu_torch import plan_cache

    st.settings.spmv_mode = "sell"
    s = sample_csr(20, 20, density=0.3, seed=2)
    A = st.csr_array(s)
    x = np.random.default_rng(6).standard_normal(20)
    old = jax_settings.spmv_mode
    jax_settings.spmv_mode = "sell"
    try:
        want = np.asarray(sparse_tpu.csr_array(s) @ x)
    finally:
        jax_settings.spmv_mode = old
    np.testing.assert_allclose((A @ x).numpy(), want, rtol=1e-12, atol=1e-12)
    assert plan_cache.lookup(A, "sell") is not None


@pytest.mark.parametrize("mode", ["auto", "segment"])
def test_dia_array_dot(mode):
    offs = [-2, 0, 3]
    data = np.random.default_rng(0).standard_normal((3, 30))
    x = np.random.default_rng(1).standard_normal(30)
    st.settings.spmv_mode = mode
    want = np.asarray(sparse_tpu.dia_array((data, offs), shape=(30, 30)) @ x)
    got = st.dia_array((data, offs), shape=(30, 30)) @ x
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_csc_dot_and_mtx_spmv():
    import glob
    import os

    here = os.path.join(os.path.dirname(__file__), "..", "testdata")
    for path in sorted(glob.glob(os.path.join(here, "*.mtx"))):
        Aj = sparse_tpu.io.mmread(path).tocsr()
        At = st.io.mmread(path).tocsr()
        x = np.random.default_rng(5).standard_normal(At.shape[1])
        np.testing.assert_allclose((At @ x).numpy(), np.asarray(Aj @ x), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose((At.tocsc() @ x).numpy(), np.asarray(Aj @ x), rtol=1e-12, atol=1e-12)


def test_prepared_plan_is_cached_and_shared():
    from sparse_tpu_torch import plan_cache

    s = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(40, 40), format="csr")
    A = st.csr_array(s)
    x = np.ones(40)
    A @ x
    before = plan_cache.stats()
    A @ x
    after = plan_cache.stats()
    assert after["hits"] == before["hits"] + 1 and after["misses"] == before["misses"]


def test_wrapper_takes_plain_path_only_for_cpu_tensors():
    plan = K.dia_plan((0,), (4, 4))
    planes = K.dia_pack(torch.ones((1, 4)), plan)
    before = K.dia_spmv_packed.launches
    y = K.dia_spmv_packed(planes, K.dia_pad_x(torch.arange(4.0), plan), plan)
    np.testing.assert_array_equal(y[:4].numpy(), [0.0, 1.0, 2.0, 3.0])
    assert K.dia_spmv_packed.launches == before  # plain version: no launch
    meta = torch.empty(planes.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.dia_spmv_packed(meta, torch.empty((plan.m_pad,), device="meta"), plan)


class _Owner:
    """A plan-cache key (any weak-referenceable object)."""


def test_prepared_spmv_gates_only_on_the_cpu():
    """On the CPU the reference's gates hold: past pallas_max_band, or at a
    dtype with no kernel, the caller runs the plain dia_spmv (None). Off the
    CPU there is no band gate: a band past 8192 goes to the kernel wrapper
    (which raises here, off CUDA), and a dtype with no kernel raises."""
    m, offs = 9100, (-9000, 0, 9000)
    assert offs[-1] > st.settings.pallas_max_band
    data, x = torch.ones((3, m)), torch.ones(m)
    assert K.cached_prepared_spmv(_Owner(), data, offs, (m, m), x) is None
    assert K.cached_prepared_spmv(_Owner(), data.half(), (0,), (m, m), x.half()) is None
    dm, xm = torch.empty((3, m), device="meta"), torch.empty((m,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.cached_prepared_spmv(_Owner(), dm, offs, (m, m), xm)
    with pytest.raises(TypeError, match="no CUDA kernel"):
        K.cached_prepared_spmv(_Owner(), dm.half(), offs, (m, m), xm.half())


def test_wide_band_csr_matches_reference_on_cpu():
    """A band past pallas_max_band takes the plain path on the CPU, as in
    sparse_tpu, and gives the same product."""
    m = 9100
    s = sp.diags([1.0, -2.0, 3.0], [-9000, 0, 9000], shape=(m, m), format="csr")
    x = np.random.default_rng(8).standard_normal(m)
    A = st.csr_array(s)
    assert A._maybe_dia() is not None
    np.testing.assert_allclose((A @ x).numpy(), np.asarray(sparse_tpu.csr_array(s) @ x),
                               rtol=1e-12, atol=1e-12)
