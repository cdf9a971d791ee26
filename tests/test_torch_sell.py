"""sparse_tpu_torch's SELL-C-sigma path against sparse_tpu, on the CPU.

The port's ``sell_pack`` must give the reference's pack exactly (plan,
index and value planes, ``pos``, ``srcs``) over tests/test_sell_spmv.py's
geometry grid and edge cases. The slab path's plain versions, run on a
reference pack carried across by ``interop``, are held against the Pallas
kernel in interpret mode (f32, the reference tests' 1e-5), the XLA slab
formulation (f64: both sum the same products in plane order, 1e-12) and
scipy. (The card's chunk layout has its own tests,
tests/test_torch_sell_chunks.py.) ``csr_array @ x`` must agree with sparse_tpu in every ``spmv_mode``
with the plan cache on and off, and ``linalg.cg`` on a skewed SPD matrix
must take the reference's iterations.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu
from sparse_tpu import linalg as jlinalg
from sparse_tpu import plan_cache as jplan_cache
from sparse_tpu.config import settings as jax_settings
from sparse_tpu.kernels.sell_spmv import sell_pack as jax_sell_pack
from sparse_tpu.kernels.sell_spmv import sell_spmv_pallas
from sparse_tpu.ops.spmv import csr_spmv_sell as jax_csr_spmv_sell

import bench
import chip_smoke
import sparse_tpu_torch as st
from sparse_tpu_torch import linalg, plan_cache
from sparse_tpu_torch.config import Settings
from sparse_tpu_torch.interop import from_numpy_parts, prepared_csr_from_numpy
from sparse_tpu_torch.kernels import sell_spmv as K

from .utils.sample import sample_csr

MODES = ("segment", "ell", "sell", "pallas", "auto")


def powerlaw_csr(m=300, seed=5, dtype=np.float64):
    """tests/test_sell_spmv.py's power-law profile with one near-dense row."""
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(1.0, m) * 3 + 1).astype(int), m - 1)
    deg[0] = m - 1
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, m, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0])
    if np.issubdtype(dtype, np.complexfloating):
        vals = vals + 1j * rng.standard_normal(rows.shape[0])
    return sp.coo_matrix((vals.astype(dtype), (rows, cols)), shape=(m, m)).tocsr()


def _cases():
    """tests/test_sell_spmv.py's awkward shapes."""
    return {
        "random_f64": sample_csr(37, 29, density=0.25, seed=1),
        "random_f32": sample_csr(23, 31, dtype=np.float32, seed=2),
        "c64": sample_csr(19, 19, dtype=np.complex64, seed=3),
        "powerlaw": powerlaw_csr(120, seed=4),
        "zero_nnz": sp.csr_matrix((7, 5), dtype=np.float64),
        "empty_rows": sp.csr_matrix(
            (np.array([1.0, 2.0]), np.array([1, 3]), np.array([0, 0, 2, 2, 2, 2])), shape=(5, 4)
        ),
        "dup_cols": sp.csr_matrix(
            (np.array([1.0, 2.0, 4.0]), np.array([1, 1, 0]), np.array([0, 2, 3, 3])), shape=(3, 3)
        ),
    }


CASES = _cases()


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(st.settings, "device", "cpu")
    monkeypatch.setattr(st.settings, "spmv_mode", "auto")
    monkeypatch.setattr(jax_settings, "spmv_mode", "auto")


def _assert_same_pack(ref, got):
    (pj, sj, posj, srcj), (pt, stt, post, srct) = ref, got
    assert pj._key() == pt._key() and pj.nnz == pt.nnz
    assert len(sj) == len(stt) == len(srcj) == len(srct)
    for (ij, vj), (it, vt), a, b in zip(sj, stt, srcj, srct):
        for want, have in ((ij, it), (vj, vt), (a, b)):
            want = np.asarray(want)
            assert have.numpy().dtype == want.dtype
            np.testing.assert_array_equal(have.numpy(), want)
    assert post.numpy().dtype == np.asarray(posj).dtype
    np.testing.assert_array_equal(post.numpy(), np.asarray(posj))


@pytest.mark.parametrize("C,sigma,max_slabs", [(4, 0, 16), (8, 32, 16), (8, 64, 3), (16, 1000, 16),
                                               (8, 4096, 16)])
@pytest.mark.parametrize("label", ["powerlaw", "empty_rows", "zero_nnz", "dup_cols", "random_f32"])
def test_sell_pack_equals_reference(label, C, sigma, max_slabs):
    s = CASES[label] if label != "powerlaw" else powerlaw_csr(130, seed=9)
    args = (s.indptr, s.indices, s.data, s.shape)
    kw = dict(C=C, sigma=sigma, max_slabs=max_slabs, with_srcs=True)
    _assert_same_pack(jax_sell_pack(*args, **kw), K.sell_pack(*args, **kw))


def test_sell_pack_pow2_quantization_matches():
    """More distinct chunk widths than max_slabs: widths round up to powers
    of two, in both packages alike."""
    s = powerlaw_csr(300, seed=5)
    ref = jax_sell_pack(s.indptr, s.indices, s.data, s.shape, max_slabs=3, with_srcs=True)
    got = K.sell_pack(s.indptr, s.indices, s.data, s.shape, max_slabs=3, with_srcs=True)
    widths = [k for k, _, _ in got[0].slab_meta]
    assert all(k & (k - 1) == 0 for k in widths) and len(widths) > 3
    _assert_same_pack(ref, got)


def _carried(s, dtype, **kw):
    """The reference's pack of ``s`` at ``dtype`` and the port's
    PreparedCSR over the same buffers."""
    plan, slabs, pos = jax_sell_pack(s.indptr, s.indices, s.data.astype(dtype), s.shape, **kw)
    prep = prepared_csr_from_numpy(
        plan.slab_meta, (plan.m, plan.n, plan.C, plan.sigma, plan.zero_rows, plan.nnz),
        [(np.asarray(i), np.asarray(v)) for i, v in slabs], np.asarray(pos),
    )
    return (plan, slabs, pos), prep


@pytest.mark.parametrize("seed", [6, 7])
def test_sell_plain_matches_pallas_interpret_f32(seed):
    s = powerlaw_csr(90, seed=seed)
    (plan, slabs, pos), prep = _carried(s, np.float32)
    x = np.random.default_rng(1).standard_normal(s.shape[1]).astype(np.float32)
    want = np.asarray(sell_spmv_pallas(plan, slabs, pos, x, interpret=True))
    xt = torch.from_numpy(x)
    for got in (prep.matvec_plain(xt), K.sell_spmv(prep.plan, prep.slabs, prep.pos, xt)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(want, (s.astype(np.float32) @ x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("label", ["powerlaw", "empty_rows", "dup_cols", "random_f64"])
def test_sell_plain_matches_xla_f64_and_scipy(label):
    s = CASES[label]
    (plan, slabs, pos), prep = _carried(s, np.float64, C=4, sigma=16)
    x = np.random.default_rng(2).standard_normal(s.shape[1])
    want = np.asarray(jax_csr_spmv_sell(slabs, pos, x, plan.zero_rows))
    got = prep(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, s @ x, rtol=1e-12, atol=1e-12)


def _port_and_ref(s):
    parts = {"indptr": s.indptr, "indices": s.indices, "data": s.data}
    return (from_numpy_parts("csr", parts, s.shape),
            sparse_tpu.csr_array.from_parts(s.data, s.indices, s.indptr, s.shape))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cache_on", [True, False], ids=["cache", "nocache"])
def test_spmv_mode_parity(mode, cache_on, monkeypatch):
    """Every mode x every awkward shape x cache on/off: the port's
    ``A @ x`` and ``A @ B`` equal sparse_tpu's."""
    monkeypatch.setattr(st.settings, "spmv_mode", mode)
    monkeypatch.setattr(st.settings, "plan_cache", cache_on)
    monkeypatch.setattr(jax_settings, "spmv_mode", mode)
    monkeypatch.setattr(jax_settings, "plan_cache", cache_on)
    for label, s in CASES.items():
        At, Aj = _port_and_ref(s)
        rng = np.random.default_rng(11)
        x = rng.standard_normal(s.shape[1])
        if np.issubdtype(s.dtype, np.complexfloating):
            x = (x + 1j * rng.standard_normal(s.shape[1])).astype(s.dtype)
        tol = 1e-12 if s.dtype == np.float64 else 2e-5
        want = np.asarray(Aj @ x)
        for rep in range(2):  # the second call takes the cached plan
            np.testing.assert_allclose((At @ x).numpy(), want, rtol=tol, atol=tol,
                                       err_msg=f"{label} mode={mode} cache={cache_on} rep={rep}")
        Bm = rng.standard_normal((s.shape[1], 4))
        np.testing.assert_allclose((At @ Bm).numpy(), np.asarray(Aj @ Bm), rtol=tol, atol=tol,
                                   err_msg=f"{label} spmm mode={mode} cache={cache_on}")


def test_auto_mode_routes_skewed_to_sell():
    """'auto' packs a SELL plan for a skewed profile and keeps ELL for a
    tight one, as sparse_tpu does."""
    skewed = st.csr_array(powerlaw_csr(100, seed=8))
    skewed_j = sparse_tpu.csr_array(powerlaw_csr(100, seed=8))
    x = np.random.default_rng(2).standard_normal(100)
    np.testing.assert_allclose((skewed @ x).numpy(), np.asarray(skewed_j @ x), rtol=1e-12, atol=1e-12)
    assert plan_cache.lookup(skewed, "sell") is not None
    assert jplan_cache.lookup(skewed_j, "sell") is not None

    tight = st.csr_array(sample_csr(40, 40, density=0.2, seed=3))
    tight @ np.random.default_rng(3).standard_normal(40)
    assert tight._ell is not None
    assert plan_cache.lookup(tight, "sell") is None


def test_sell_mode_takes_the_prepared_operator():
    """'sell' packs every matrix with nonzeros; _spmm runs the slab SpMM
    when ELL declines."""
    st.settings.spmv_mode = "sell"
    s = powerlaw_csr(80, seed=10)
    A = st.csr_array(s)
    x = np.random.default_rng(4).standard_normal(80)
    np.testing.assert_allclose((A @ x).numpy(), s @ x, rtol=1e-12, atol=1e-12)
    prep = plan_cache.lookup(A, "sell")
    assert isinstance(prep, K.PreparedCSR)
    X = np.random.default_rng(5).standard_normal((80, 3))
    np.testing.assert_allclose((A @ X).numpy(), s @ X, rtol=1e-12, atol=1e-12)


def test_sell_mode_env_roundtrip(monkeypatch):
    monkeypatch.setenv("SPARSE_TPU_TORCH_SPMV_MODE", "sell")
    monkeypatch.setenv("SPARSE_TPU_TORCH_SELL_C", "16")
    monkeypatch.setenv("SPARSE_TPU_TORCH_SELL_SIGMA", "0")
    s = Settings()
    assert (s.spmv_mode, s.sell_chunk, s.sell_sigma, s.sell_max_slabs) == ("sell", 16, 0, 16)
    monkeypatch.delenv("SPARSE_TPU_TORCH_SPMV_MODE")
    monkeypatch.delenv("SPARSE_TPU_TORCH_SELL_C")
    monkeypatch.delenv("SPARSE_TPU_TORCH_SELL_SIGMA")
    s = Settings()
    assert (s.spmv_mode, s.sell_chunk, s.sell_sigma) == ("auto", 8, 4096)


def test_prepare_api(monkeypatch):
    """prepare() warms the mode's SELL plan (only with the plan cache on)
    and leaves the ambient mode alone."""
    st.settings.spmv_mode = "sell"
    A = st.csr_array(powerlaw_csr(80, seed=10))
    assert A.prepare() is A
    assert plan_cache.lookup(A, "sell") is not None
    st.settings.spmv_mode = "segment"
    B = st.csr_array(powerlaw_csr(80, seed=11))
    B.prepare(mode="sell")
    assert st.settings.spmv_mode == "segment"
    assert plan_cache.lookup(B, "sell") is not None
    monkeypatch.setattr(st.settings, "plan_cache", False)
    before = plan_cache.stats()["misses"]
    st.csr_array(powerlaw_csr(80, seed=12)).prepare(mode="sell")
    assert plan_cache.stats()["misses"] == before  # nothing packed


def test_sell_plan_dies_with_matrix():
    import gc

    st.settings.spmv_mode = "sell"
    s = powerlaw_csr(50, seed=13)
    A = st.csr_array(s)
    x = np.random.default_rng(5).standard_normal(50)
    A @ x
    A2 = A * 2.0
    assert plan_cache.lookup(A2, "sell") is None
    np.testing.assert_allclose((A2 @ x).numpy(), 2 * (s @ x), rtol=1e-10)
    before = plan_cache.stats()["size"]
    del A, A2
    gc.collect()
    assert plan_cache.stats()["size"] < before


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------
def test_wrappers_take_plain_path_only_for_cpu_tensors():
    """CPU tensors run the plain versions (no launch counted); off the CPU
    the chunk wrappers launch or raise, and the slab pack raises."""
    s = powerlaw_csr(60, seed=3)
    plan, slabs, pos = K.sell_pack(s.indptr, s.indices, s.data, s.shape)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(60))
    ch = K.sell_chunk_pack(*(torch.from_numpy(a) for a in (s.indptr, s.indices, s.data)), s.shape)
    before = (K.sell_chunk_spmv.launches, K.sell_chunk_spmv_batched.launches)
    y = K.sell_spmv(plan, slabs, pos, x)
    Y = K.sell_spmv_batched(plan, [it for it, _ in slabs], [vt[None] for _, vt in slabs], pos, x[None])
    yc = K.sell_chunk_spmv(ch, ch.val, x)
    Yc = K.sell_chunk_spmv_batched(ch, ch.val[:, None], x[None])
    assert (K.sell_chunk_spmv.launches, K.sell_chunk_spmv_batched.launches) == before
    for got in (Y[0], yc, Yc[0]):
        np.testing.assert_allclose(got.numpy(), y.numpy(), rtol=1e-12, atol=1e-12)
    it, vt = slabs[0]
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        K.sell_spmv(plan, ((meta(it), meta(vt)),), pos, meta(x))
    with pytest.raises(ValueError, match="CUDA"):
        K.sell_spmv_batched(plan, [meta(it)], [meta(vt[None])], pos, meta(x[None]))
    with pytest.raises(ValueError, match="CUDA"):
        K.sell_chunk_spmv(ch, meta(ch.val), meta(x), K.SellWorkspace(ch, ch.val.dtype))
    with pytest.raises(ValueError, match="CUDA"):
        K.sell_chunk_spmv_batched(ch, meta(ch.val[:, None]), meta(x[None]),
                                  K.SellWorkspace(ch, ch.val.dtype, 1))


def test_dtype_without_kernel_raises_off_the_cpu():
    """On the card a dtype with no kernel raises rather than run plain
    torch; mixed real operands promote."""
    assert K.kernel_dtype(torch.float32, torch.float64, "x") == torch.float64
    for dt in (torch.complex64, torch.float16):
        with pytest.raises(TypeError, match="no CUDA kernel"):
            K.kernel_dtype(dt, dt, "SELL SpMV")
    s = powerlaw_csr(40, seed=2, dtype=np.complex64)
    prep = K.PreparedCSR(s.indptr, s.indices, s.data, s.shape)
    with pytest.raises(TypeError, match="no CUDA kernel"):
        prep(torch.empty((40,), dtype=torch.complex64, device="meta"))


# ---------------------------------------------------------------------------
# CG on a general (non-banded) matrix
# ---------------------------------------------------------------------------
def test_skewed_degree_csr_is_the_reference_matrix():
    a, b = chip_smoke.skewed_degree_csr(3000), bench.skewed_degree_csr(3000)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def test_cg_on_skewed_matrix_matches_reference():
    """'auto' routes the skewed SPD matrix to SELL in both packages; in f64
    the iterates and the iteration count agree."""
    s = chip_smoke.skewed_degree_csr(2000).astype(np.float64)
    b = np.random.default_rng(3).standard_normal(2000)
    A = st.csr_array(s)
    xt, it_t = linalg.cg(A, b, tol=1e-8, maxiter=500)
    assert plan_cache.lookup(A, "sell") is not None
    xj, it_j = jlinalg.cg(sparse_tpu.csr_array(s), b, tol=1e-8, maxiter=500)
    assert it_t == it_j < 500
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-10)
    assert np.linalg.norm(s @ xt.numpy() - b) < 1e-7
