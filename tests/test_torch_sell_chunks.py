"""The card's chunked SELL layout (``sell_chunk_pack``) and its plain
products, on the CPU.

The pack, built in torch ops, must order rows as the reference's
``sell_pack(C=32, sigma=0, max_slabs=10**9)`` does (one stable descending
degree sort) and give each 32-row chunk the same width; every nonzero must
land in exactly one slot, pad slots hold index 0 and value 0, and the work
list must cover every slot of every chunk once. The plain chunk SpMV (the
kernels' twin) is held against ``sparse_tpu``'s ``PreparedCSR.matvec_xla``
and scipy (f64 1e-12; f32 1e-5 of sum |a x| per row); each batched lane
equals the single-matrix product bit for bit, and the layout built from a
reference slab pack (``from_parts``/``interop`` on the card) gives the same
y as the layout built from CSR.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sparse_tpu import linalg as jlinalg
from sparse_tpu.kernels.sell_spmv import PreparedCSR as JPreparedCSR
from sparse_tpu.kernels.sell_spmv import sell_pack as jax_sell_pack

import chip_smoke
import sparse_tpu as jsparse
import sparse_tpu_torch as st
from sparse_tpu_torch import linalg
from sparse_tpu_torch.batch import SparsityPattern, batched_cg
from sparse_tpu_torch.interop import prepared_csr_from_numpy
from sparse_tpu_torch.kernels import sell_spmv as K
from sparse_tpu_torch.ops import spmv as spmv_ops

from .utils.sample import sample_csr

R = K.CHUNK_ROWS


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(st.settings, "device", "cpu")


def _cases():
    return {
        "powerlaw": chip_smoke.powerlaw_csr(300, 5),
        "powerlaw_small": chip_smoke.powerlaw_csr(70, 9),
        "skewed": chip_smoke.skewed_degree_csr(3000).astype(np.float64),
        "random": sample_csr(37, 29, density=0.25, seed=1),
        "empty_rows": sp.csr_matrix(
            (np.array([1.0, 2.0]), np.array([1, 3]), np.array([0, 0, 2, 2, 2, 2])), shape=(5, 4)
        ),
        "dup_cols": sp.csr_matrix(
            (np.array([1.0, 2.0, 4.0]), np.array([1, 1, 0]), np.array([0, 2, 3, 3])), shape=(3, 3)
        ),
        "zero_nnz": sp.csr_matrix((7, 5), dtype=np.float64),
    }


CASES = _cases()
NONEMPTY = [k for k in CASES if CASES[k].nnz]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pack(s, seg=None, dtype=None, with_src=False):
    data = s.data if dtype is None else s.data.astype(dtype)
    return K.sell_chunk_pack(_t(s.indptr), _t(s.indices), _t(data), s.shape, seg=seg,
                             with_src=with_src)


def _widths(ch):
    return ((ch.cptr[1:] - ch.cptr[:-1]) // R).numpy()


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("label", list(CASES))
def test_chunk_pack_row_order_and_widths_equal_sell_pack(label):
    """The reference's pack at C = 32, one global window and no width cap
    holds the rows of each slab in its degree order, slabs by ascending
    width: read back in descending width it is the chunk layout's perm, and
    each row's slab width is its chunk's width."""
    s = CASES[label]
    m = s.shape[0]
    plan, slabs, pos = jax_sell_pack(s.indptr, s.indices, s.data, s.shape, C=32, sigma=0,
                                     max_slabs=10**9)
    pos = np.asarray(pos)
    at = np.full(sum(r for _, r, _ in plan.slab_meta) + plan.zero_rows, -1)
    at[pos] = np.arange(m)
    parts, width_of = [], np.zeros(m, dtype=np.int64)
    off = 0
    for K_, R_, pad in plan.slab_meta:
        rows = at[off : off + R_ - pad]
        parts.append(rows)
        width_of[rows] = K_
        off += R_
    perm_ref = np.concatenate(parts[::-1] + [at[off:]]).astype(np.int64)
    ch = _pack(s)
    np.testing.assert_array_equal(ch.perm.numpy(), perm_ref)
    np.testing.assert_array_equal(_widths(ch)[np.arange(m) // R], width_of[perm_ref])
    assert ch.slots == R * int(_widths(ch).sum()) and ch.nchunks == -(-m // R)
    assert ch.idx.dtype == ch.perm.dtype == torch.int32


@pytest.mark.parametrize("label", list(CASES))
def test_every_nonzero_in_one_slot_and_pads_zero(label):
    s = CASES[label]
    ch = _pack(s, with_src=True)
    src, idx, val = ch.src.numpy(), ch.idx.numpy(), ch.val.numpy()
    real = src >= 0
    np.testing.assert_array_equal(np.sort(src[real]), np.arange(s.nnz))
    assert not idx[~real].any() and not val[~real].any()
    np.testing.assert_array_equal(idx[real], s.indices[src[real]])
    np.testing.assert_array_equal(val[real], s.data[src[real]])
    # slot k of chunk c's lane r holds the k-th nonzero of row perm[32c + r]
    slot = np.nonzero(real)[0]
    c = np.searchsorted(ch.cptr.numpy(), slot, side="right") - 1
    k, lane = divmod(slot - ch.cptr.numpy()[c], R)
    row = ch.perm.numpy()[c * R + lane]
    np.testing.assert_array_equal(src[slot], s.indptr[row] + k)


@pytest.mark.parametrize("seg", [1, 5, 64, 256])
@pytest.mark.parametrize("label", ["powerlaw", "skewed", "empty_rows", "zero_nnz"])
def test_work_list_covers_every_slot_once(label, seg):
    """Chunk-major, segments in order, each at most ``seg`` slots a row, at
    least one a chunk; split chunks own disjoint partial rows."""
    ch = _pack(CASES[label], seg=seg)
    w = ch.work.numpy()
    widths = _widths(ch)
    assert ch.work.dtype == torch.int32 and w.shape == (ch.nwork, 4)
    np.testing.assert_array_equal(np.unique(w[:, 0]), np.arange(ch.nchunks))
    assert np.all(np.diff(w[:, 0]) >= 0)
    taken, parts = np.zeros(ch.nchunks, dtype=np.int64), []
    for c, sg, nseg, pbase in w:
        assert sg == taken[c] and nseg == max(1, -(-widths[c] // seg))
        k0, k1 = sg * seg, min((sg + 1) * seg, widths[c])
        assert k0 < k1 or widths[c] == 0
        taken[c] += 1
        if nseg > 1:
            parts.append(pbase + sg)
        else:
            assert pbase == -1
    np.testing.assert_array_equal(taken, np.maximum(1, -(-widths // seg)))
    np.testing.assert_array_equal(np.sort(parts), np.arange(ch.npart))


# ---------------------------------------------------------------------------
# the plain products
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seg", [3, 256])
@pytest.mark.parametrize("label", NONEMPTY)
def test_chunk_plain_f64_matches_reference_and_scipy(label, seg):
    s = CASES[label]
    x = np.random.default_rng(2).standard_normal(s.shape[1])
    ch = _pack(s, seg=seg)
    y = K.sell_chunk_spmv(ch, ch.val, _t(x)).numpy()
    want = np.asarray(JPreparedCSR(s.indptr, s.indices, s.data, s.shape).matvec_xla(x))
    np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y, s @ x, rtol=1e-12, atol=1e-12)


def test_zero_nnz_chunk_product_is_zero():
    s = CASES["zero_nnz"]
    ch = _pack(s)
    y = K.sell_chunk_spmv(ch, ch.val, torch.ones(5, dtype=torch.float64))
    assert ch.slots == 0 and torch.equal(y, torch.zeros(7, dtype=torch.float64))


@pytest.mark.parametrize("label", ["powerlaw", "skewed", "random", "dup_cols"])
def test_chunk_plain_f32_within_sum_bound(label):
    """f32: within 1e-5 of sum_j |a_ij x_j| of the reference's XLA product
    and of scipy in f64, row by row."""
    s = CASES[label]
    s32 = s.astype(np.float32)
    x = np.random.default_rng(3).standard_normal(s.shape[1]).astype(np.float32)
    ch = _pack(s32)
    y = K.sell_chunk_spmv(ch, ch.val, _t(x)).numpy()
    assert y.dtype == np.float32
    mag = abs(s) @ np.abs(x).astype(np.float64)
    want = np.asarray(JPreparedCSR(s32.indptr, s32.indices, s32.data, s32.shape).matvec_xla(x))
    for ref in (want, s @ x.astype(np.float64)):
        assert np.all(np.abs(y - ref) <= 1e-5 * mag)


def test_chunk_spmm_matches_scipy():
    s = CASES["powerlaw"]
    Bm = np.random.default_rng(4).standard_normal((300, 3))
    ch = _pack(s, seg=7)
    np.testing.assert_allclose(spmv_ops.csr_spmm_chunks(ch, ch.val, _t(Bm)).numpy(), s @ Bm,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seg", [1, 4, 256])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_lanes_equal_single_bit_for_bit(dtype, seg):
    """Three value stacks over one pattern: each batched lane equals the
    single-matrix product of its values bit for bit."""
    s = CASES["skewed"]
    ch = K.sell_chunk_pack(_t(s.indptr), _t(s.indices), None, s.shape, seg=seg, with_src=True)
    rng = np.random.default_rng(5)
    V = np.stack([s.data * (1 + rng.random(s.nnz)) for _ in range(3)]).astype(dtype)
    X = rng.standard_normal((3, s.shape[1])).astype(dtype)
    vals = ch.pack_values(_t(V))
    Y = K.sell_chunk_spmv_batched(ch, vals, _t(X))
    assert Y.shape == (3, s.shape[0]) and Y.dtype == torch.from_numpy(X).dtype
    for b in range(3):
        lone = _pack(sp.csr_matrix((V[b], s.indices, s.indptr), shape=s.shape), seg=seg)
        assert torch.equal(lone.val, vals[:, b])
        assert torch.equal(Y[b], K.sell_chunk_spmv(lone, lone.val, _t(X[b])))


def test_pattern_chunks_are_every_lanes_layout():
    """``SparsityPattern.sell_chunks`` (plan-cached) equals the chunk layout
    a lone lane's CSR packs, index slots, perm and work list alike."""
    s = CASES["powerlaw"]
    pat = SparsityPattern.from_csr(s)
    ch = pat.sell_chunks("cpu")
    assert pat.sell_chunks("cpu") is ch and ch.val is None
    lone = _pack(s)
    for a in ("perm", "cptr", "idx", "work"):
        assert torch.equal(getattr(ch, a), getattr(lone, a))
    assert torch.equal(ch.pack_values(_t(s.data[None]))[:, 0], lone.val)


# ---------------------------------------------------------------------------
# from_parts / interop: the layout from a reference slab pack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C,sigma,max_slabs", [(8, 4096, 16), (4, 16, 3), (32, 0, 10**9),
                                               (16, 64, 16)])
@pytest.mark.parametrize("label", ["powerlaw", "empty_rows", "dup_cols"])
def test_chunks_from_slabs_equal_direct_pack(label, C, sigma, max_slabs):
    """The layout ``PreparedCSR.from_parts`` builds on the card from the
    reference's slabs (carried across by ``interop``) is the layout of the
    CSR, and gives the same y bit for bit; the slab product agrees."""
    s = CASES[label]
    plan, slabs, pos = jax_sell_pack(s.indptr, s.indices, s.data, s.shape, C=C, sigma=sigma,
                                     max_slabs=max_slabs)
    prep = prepared_csr_from_numpy(
        plan.slab_meta, (plan.m, plan.n, plan.C, plan.sigma, plan.zero_rows, plan.nnz),
        [(np.asarray(i), np.asarray(v)) for i, v in slabs], np.asarray(pos),
    )
    ch = K.chunks_from_slabs(prep.plan, prep.slabs, prep.pos)
    direct = _pack(s)
    for a in ("perm", "cptr", "idx", "val", "work"):
        assert torch.equal(getattr(ch, a), getattr(direct, a)), a
    x = _t(np.random.default_rng(6).standard_normal(s.shape[1]))
    y = K.sell_chunk_spmv(ch, ch.val, x)
    assert torch.equal(y, K.sell_chunk_spmv(direct, direct.val, x))
    np.testing.assert_allclose(y.numpy(), prep(x).numpy(), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the slice as a whole: CG over the chunk layout
# ---------------------------------------------------------------------------
def test_cg_over_chunk_layout_matches_reference():
    """f64 CG whose SpMV is the chunk product takes the reference's
    iterations and its x (1e-10)."""
    s = chip_smoke.skewed_degree_csr(2000).astype(np.float64)
    b = np.random.default_rng(3).standard_normal(2000)
    ch = _pack(s, seg=16)
    A = linalg.LinearOperator(s.shape, matvec=lambda v: K.sell_chunk_spmv(ch, ch.val, v),
                              dtype=torch.float64)
    xt, it_t = linalg.cg(A, _t(b), tol=1e-8, maxiter=500)
    xj, it_j = jlinalg.cg(jsparse.csr_array(s), b, tol=1e-8, maxiter=500)
    assert it_t == it_j < 500
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_cg_over_chunk_layout_equals_lone_solves(dtype):
    """batched_cg through the batched chunk product: each lane takes the
    iterations and the x of linalg.cg through the single-matrix product."""
    s = chip_smoke.skewed_degree_csr(1500)
    ch = K.sell_chunk_pack(_t(s.indptr), _t(s.indices), None, s.shape, seg=8, with_src=True)
    rng = np.random.default_rng(7)
    on_diag = s.indices == np.repeat(np.arange(1500), np.diff(s.indptr))
    V = np.stack([s.data + d * on_diag for d in rng.random(3)]).astype(dtype)
    vals = ch.pack_values(_t(V))
    b = rng.standard_normal((3, 1500)).astype(dtype)
    tol = 1e-4 if dtype == np.float32 else 1e-10
    X, info = batched_cg(lambda Z: K.sell_chunk_spmv_batched(ch, vals, Z), _t(b), tol=tol,
                         maxiter=300)
    for i in range(3):
        vi = vals[:, i].contiguous()
        Ai = linalg.LinearOperator(s.shape, matvec=lambda v, vi=vi: K.sell_chunk_spmv(ch, vi, v),
                                   dtype=vi.dtype)
        xu, iu = linalg.cg(Ai, _t(b[i]), tol=tol, maxiter=300)
        assert int(info.iters[i]) == iu < 300
        assert torch.equal(X[i], xu)
