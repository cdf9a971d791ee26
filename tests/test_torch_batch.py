"""sparse_tpu_torch.batch against sparse_tpu.batch, on the CPU.

Batched operators: ``BatchedCSR.matvec``/``matmat`` in every ``spmv_mode``
equal sparse_tpu's on the same value stack, and the batched SELL kernel's
plain version, on the reference's pattern pack carried across, equals the
Pallas batched kernel in interpret mode (f32, 1e-5). Masked Krylov: a
batch of one reproduces the port's ``linalg.cg`` and the reference's
batched solvers (f64 1e-10, f32 1e-4: the same recurrences, dot products
summed in another order); masked lanes take the reference's per-lane
iteration counts; a converged lane stays frozen.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sparse_tpu import batch as jbatch
from sparse_tpu.config import settings as jax_settings
from sparse_tpu.kernels.sell_spmv import sell_spmv_pallas_batched

import sparse_tpu_torch as st
from sparse_tpu_torch import linalg, plan_cache
from sparse_tpu_torch.batch import (
    BatchedCSR,
    BatchedDIA,
    SparsityPattern,
    batched_bicgstab,
    batched_cg,
    batched_gmres,
    make_batched_operator,
)
from sparse_tpu_torch.interop import batched_csr_from_numpy
from sparse_tpu_torch.kernels import sell_spmv as K
from sparse_tpu_torch.ops import spmv as spmv_ops


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(st.settings, "device", "cpu")
    monkeypatch.setattr(st.settings, "spmv_mode", "auto")
    monkeypatch.setattr(jax_settings, "spmv_mode", "auto")


def _tridiag_stack(n=48, B=4, dtype=np.float64, seed=0):
    """tests/test_batch.py's B SPD systems over one tridiagonal pattern."""
    rng = np.random.default_rng(seed)
    e = np.ones(n)
    base = sp.diags([-e[:-1], 3.0 * e, -e[:-1]], [-1, 0, 1], format="csr")
    mats = []
    for _ in range(B):
        A = base.copy()
        A.setdiag(3.0 + rng.random(n))
        A.sort_indices()
        mats.append(A.tocsr().astype(dtype))
    rhs = rng.standard_normal((B, n)).astype(dtype)
    return mats, rhs


def _skewed(n=60, seed=3):
    """tests/test_batch.py's skewed pattern with an empty row and a wide row."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.zeros(8, np.int64), np.arange(2, n - 3, 2), np.full(6, n - 2, np.int64)])
    cols = rng.integers(0, n, rows.shape[0])
    G = sp.coo_matrix((rng.random(rows.shape[0]), (rows, cols)), shape=(n, n)).tocsr()
    A = (G + G.T) * 0.5
    A = A + sp.diags(np.asarray(np.abs(A).sum(axis=1)).ravel() + 1.0)
    A = A.tocsr()
    A.sort_indices()
    return A


def _both(mats, dtype=None):
    vals = np.stack([m.data for m in mats])
    if dtype is not None:
        vals = vals.astype(dtype)
    p = mats[0]
    return (batched_csr_from_numpy(p.indptr, p.indices, p.shape, vals),
            jbatch.BatchedCSR(jbatch.SparsityPattern.from_csr(p), vals))


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["segment", "sell", "pallas", "auto"])
def test_batched_csr_modes_match_reference(monkeypatch, mode):
    monkeypatch.setattr(st.settings, "spmv_mode", mode)
    monkeypatch.setattr(jax_settings, "spmv_mode", mode)
    A = _skewed()
    mats = []
    for i in range(3):
        m = A.copy()
        m.data = m.data * (1.0 + i)
        mats.append(m)
    bt, bj = _both(mats, np.float32)
    X = np.random.default_rng(2).standard_normal((3, A.shape[0])).astype(np.float32)
    Y = bt.matvec(X)
    assert Y.dtype == torch.float32
    np.testing.assert_allclose(Y.numpy(), np.asarray(bj.matvec(X)), rtol=1e-5, atol=1e-5)
    for i in range(3):
        np.testing.assert_allclose(Y[i].numpy(), (mats[i] @ X[i]).astype(np.float32),
                                   rtol=2e-5, atol=1e-5)
    X3 = np.random.default_rng(3).standard_normal((3, A.shape[0], 2)).astype(np.float32)
    np.testing.assert_allclose(bt.matmat(X3).numpy(), np.asarray(bj.matmat(X3)), rtol=1e-5, atol=1e-5)


def test_batched_plain_matches_pallas_interpret_f32():
    """The batched SELL kernel's plain version on the reference's pattern
    pack and packed value planes == the Pallas batched kernel."""
    A = _skewed(n=90, seed=5)
    vals = np.stack([A.data * (1.0 + 0.5 * i) for i in range(4)]).astype(np.float32)
    pat = jbatch.SparsityPattern.from_csr(A)
    pack = pat.sell_pack()
    vplanes = pack.pack_values(vals)
    X = np.random.default_rng(4).standard_normal((4, 90)).astype(np.float32)
    want = np.asarray(sell_spmv_pallas_batched(pack.plan, pack.idx_slabs, vplanes, pack.pos, X,
                                               interpret=True))
    plan = K.SellPlan(pack.plan.m, pack.plan.n, pack.plan.C, pack.plan.sigma,
                      pack.plan.slab_meta, pack.plan.zero_rows, pack.plan.nnz)
    idx = [torch.from_numpy(np.array(i)) for i in pack.idx_slabs]
    vt = [torch.from_numpy(np.array(v)) for v in vplanes]
    pos, Xt = torch.from_numpy(np.array(pack.pos)), torch.from_numpy(X)
    for got in (spmv_ops.csr_spmv_sell_batched(idx, vt, pos, Xt, plan.zero_rows),
                K.sell_spmv_batched(plan, idx, vt, pos, Xt)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the port's own pattern pack repacks the values identically
    bt = batched_csr_from_numpy(A.indptr, A.indices, A.shape, vals)
    mine = bt._packed(torch.float32)[1]
    for a, b in zip(mine, vplanes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_batched_csr_spmm_and_dense_stack():
    mats, _ = _tridiag_stack(B=2, n=20)
    bc = BatchedCSR.from_stack(mats)
    X = np.random.default_rng(4).standard_normal((2, 20, 3))
    Y = bc.matmat(X).numpy()
    for i in range(2):
        np.testing.assert_allclose(Y[i], mats[i] @ X[i], rtol=1e-12)
    dense = make_batched_operator(np.stack([m.toarray() for m in mats]))
    np.testing.assert_allclose(dense.matmat(X).numpy(), Y, rtol=1e-12)
    np.testing.assert_allclose((bc @ X[:, :, 0]).numpy(), Y[:, :, 0], rtol=1e-12)


def test_batched_dia_matches_csr_path():
    mats, _ = _tridiag_stack(B=3, n=32)
    bc = BatchedCSR.from_stack(mats)
    bd = bc.todia()
    assert isinstance(bd, BatchedDIA) and len(bd.offsets) == 3
    X = np.random.default_rng(5).standard_normal((3, 32))
    np.testing.assert_allclose(bd.matvec(X).numpy(), bc.matvec(X).numpy(), rtol=1e-12)
    np.testing.assert_allclose(bd.lane(1).toarray().numpy(), mats[1].toarray())
    with pytest.raises(ValueError):
        BatchedCSR.from_stack([_skewed()]).todia(max_diags=4)


def test_pattern_mismatch_rejected():
    mats, _ = _tridiag_stack(B=2, n=16)
    with pytest.raises(ValueError, match="different sparsity pattern"):
        BatchedCSR.from_stack([mats[0], sp.eye(16, format="csr")])
    with pytest.raises(ValueError, match="values must be"):
        BatchedCSR(SparsityPattern.from_csr(mats[0]), np.ones((2, 5)))


def test_pattern_pack_cached_once():
    """One pattern object, one SELL pack, shared by every batch over it."""
    mats, _ = _tridiag_stack(B=2, n=24)
    pattern = SparsityPattern.from_csr(mats[0])
    vals = np.stack([m.data for m in mats])
    before = plan_cache.stats()
    bc1 = BatchedCSR(pattern, vals)
    bc2 = bc1.with_values(vals * 2.0)
    X = np.random.default_rng(0).standard_normal((2, 24))
    bc1.matvec(X)
    bc2.matvec(X)
    bc1.matvec(X)
    after = plan_cache.stats()
    assert after["misses"] - before["misses"] == 1  # the pattern pack
    assert after["hits"] - before["hits"] == 2
    np.testing.assert_allclose(bc2.matvec(X).numpy(), 2 * bc1.matvec(X).numpy(), rtol=1e-12)


def test_lane_view_and_block_operator():
    mats, rhs = _tridiag_stack(B=3, n=24)
    bc = BatchedCSR.from_stack(mats)
    lane = bc.lane(1)
    assert isinstance(lane, st.csr_array)
    np.testing.assert_allclose(lane.toarray().numpy(), mats[1].toarray())
    L = linalg.make_linear_operator(bc)
    assert L.shape == (72, 72)
    x, _ = linalg.cg(L, rhs.reshape(-1), tol=1e-10, maxiter=300)
    X = x.numpy().reshape(3, 24)
    for i in range(3):
        np.testing.assert_allclose(mats[i] @ X[i], rhs[i], rtol=1e-8, atol=1e-8)


def test_batched_kernel_dtype_gate():
    """A complex batch on the card raises (no kernel); on the CPU it runs."""
    A = _skewed(n=30, seed=1)
    vals = (A.data + 1j * A.data)[None].astype(np.complex64)
    bt = batched_csr_from_numpy(A.indptr, A.indices, A.shape, vals)
    X = np.ones((1, 30), dtype=np.complex64)
    np.testing.assert_allclose(bt.matvec(X)[0].numpy(), (A @ X[0]) * (1 + 1j), rtol=1e-5)
    with pytest.raises(TypeError, match="no CUDA kernel"):
        K.kernel_dtype(bt.dtype, torch.complex64, "batched SELL SpMV")


# ---------------------------------------------------------------------------
# batch-of-1 parity
# ---------------------------------------------------------------------------
def _tols(dtype):
    return dict(rtol=1e-4, atol=1e-5) if dtype == np.float32 else dict(rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_b1_cg_parity(dtype):
    mats, rhs = _tridiag_stack(B=1, dtype=dtype, seed=7)
    tol = 1e-6 if dtype == np.float32 else 1e-12
    bt, bj = _both(mats)
    Xb, info = batched_cg(bt, rhs, tol=tol, maxiter=400)
    Xj, info_j = jbatch.batched_cg(bj, rhs, tol=tol, maxiter=400)
    xu, iu = linalg.cg(st.csr_array(mats[0]), rhs[0], tol=tol, maxiter=400)
    assert int(info.iters[0]) == iu == int(np.asarray(info_j.iters)[0])
    assert bool(info.converged[0])
    np.testing.assert_allclose(Xb[0].numpy(), xu.numpy(), **_tols(dtype))
    np.testing.assert_allclose(Xb[0].numpy(), np.asarray(Xj)[0], **_tols(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_b1_bicgstab_parity(dtype):
    mats, rhs = _tridiag_stack(B=1, dtype=dtype, seed=8)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    bt, bj = _both(mats)
    Xb, info = batched_bicgstab(bt, rhs, tol=tol, maxiter=400)
    Xj, info_j = jbatch.batched_bicgstab(bj, rhs, tol=tol, maxiter=400)
    assert int(info.iters[0]) == int(np.asarray(info_j.iters)[0])
    np.testing.assert_allclose(Xb[0].numpy(), np.asarray(Xj)[0], **_tols(dtype))
    np.testing.assert_allclose(mats[0] @ Xb[0].numpy(), rhs[0], rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_b1_gmres_parity(dtype):
    mats, rhs = _tridiag_stack(B=1, dtype=dtype, seed=9)
    tol = 1e-5 if dtype == np.float32 else 1e-10
    bt, bj = _both(mats)
    Xb, info = batched_gmres(bt, rhs, tol=tol)
    Xj, info_j = jbatch.batched_gmres(bj, rhs, tol=tol)
    assert int(info.iters[0]) == int(np.asarray(info_j.iters)[0])
    assert bool(info.converged[0]) == bool(np.asarray(info_j.converged)[0])
    np.testing.assert_allclose(Xb[0].numpy(), np.asarray(Xj)[0], **_tols(dtype))


def test_b1_gmres_complex():
    rng = np.random.default_rng(11)
    n = 32
    hop = rng.random(n - 1) + 1j * rng.random(n - 1)
    H = sp.diags([np.conj(hop), np.full(n, 4.0 + 0j), hop], [-1, 0, 1]).tocsr()
    H.sort_indices()
    zb = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    bt, bj = _both([H])
    Xb, info = batched_gmres(bt, zb[None, :], tol=1e-9)
    Xj, info_j = jbatch.batched_gmres(bj, zb[None, :], tol=1e-9)
    assert int(info.iters[0]) == int(np.asarray(info_j.iters)[0])
    np.testing.assert_allclose(Xb[0].numpy(), np.asarray(Xj)[0], rtol=1e-7, atol=1e-9)


# ---------------------------------------------------------------------------
# masked lanes
# ---------------------------------------------------------------------------
def test_masked_lanes_match_reference_iters():
    """An already-converged lane (b = 0), a normal lane and one that never
    converges: per-lane iteration counts equal the reference's and the
    unbatched solves'."""
    mats, rhs = _tridiag_stack(B=3, seed=12)
    rhs = rhs.copy()
    rhs[0] = 0.0
    tols = np.array([1e-10, 1e-10, 1e-300])
    bt, bj = _both(mats)
    kw = dict(tol=tols, maxiter=40, conv_test_iters=5)
    Xb, info = batched_cg(bt, rhs, **kw)
    Xj, info_j = jbatch.batched_cg(bj, rhs, **kw)
    np.testing.assert_array_equal(info.iters.numpy(), np.asarray(info_j.iters))
    np.testing.assert_array_equal(info.converged.numpy(), np.asarray(info_j.converged))
    np.testing.assert_allclose(Xb.numpy(), np.asarray(Xj), rtol=1e-10, atol=1e-12)
    for i in range(3):
        _, iu = linalg.cg(st.csr_array(mats[i]), rhs[i], tol=float(tols[i]), maxiter=40,
                          conv_test_iters=5)
        assert int(info.iters[i]) == iu
    assert int(info.iters[2]) == 40 and not bool(info.converged[2])


def test_converged_lane_result_is_frozen():
    mats, rhs = _tridiag_stack(B=2, seed=13)
    tols = np.array([1e-8, 1e-300])  # lane 1 runs to maxiter
    bt, _ = _both(mats)
    b1, _ = _both(mats[:1])
    X2, info2 = batched_cg(bt, rhs, tol=tols, maxiter=60, conv_test_iters=5)
    X1, info1 = batched_cg(b1, rhs[:1], tol=1e-8, maxiter=60, conv_test_iters=5)
    assert int(info2.iters[0]) == int(info1.iters[0]) < 60
    assert torch.equal(X2[0], X1[0])


def test_bicgstab_maxiter_lane():
    mats, rhs = _tridiag_stack(B=2, seed=14)
    tols = np.array([1e-8, 1e-300])
    bt, bj = _both(mats)
    _X, info = batched_bicgstab(bt, rhs, tol=tols, maxiter=60, conv_test_iters=4)
    _Xj, info_j = jbatch.batched_bicgstab(bj, rhs, tol=tols, maxiter=60, conv_test_iters=4)
    np.testing.assert_array_equal(info.iters.numpy(), np.asarray(info_j.iters))
    assert int(info.iters[1]) == 60 and not bool(info.converged[1])
    assert bool(info.converged[0]) and int(info.iters[0]) < 60


def test_batched_cg_on_skewed_pattern_sell_path():
    """A skewed pattern (the SELL kernel's path on the card) through
    batched_cg: each lane equals its lone solve bit for bit, in f32 and
    f64 (the same SpMV sums; dot products whose value does not depend on
    the reduction order)."""
    A = _skewed(n=80, seed=9)
    rng = np.random.default_rng(1)
    d = rng.random(3)
    on_diag = A.indices == np.repeat(np.arange(80), np.diff(A.indptr))
    rhs = rng.standard_normal((3, 80))
    for dtype in (np.float32, np.float64):
        vals = np.stack([A.data + di * on_diag for di in d]).astype(dtype)
        bt = batched_csr_from_numpy(A.indptr, A.indices, A.shape, vals)
        b = rhs.astype(dtype)
        tol = 1e-5 if dtype == np.float32 else 1e-10
        Xb, info = batched_cg(bt, b, tol=tol, maxiter=200)
        for i in range(3):
            xu, iu = linalg.cg(bt.lane(i), b[i], tol=tol, maxiter=200)
            assert int(info.iters[i]) == iu < 200
            assert torch.equal(Xb[i], xu)
