"""sparse_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; without a card every test here skips. On a machine with
one:  python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st
from sparse_tpu_torch import linalg
from sparse_tpu_torch.kernels import cg_dia as C
from sparse_tpu_torch.kernels import dia_spmv as D

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = st.settings.device
    st.settings.device = "cuda"
    yield
    st.settings.device = old


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,offs", [(50, 50, [-5, -1, 0, 1, 5]), (40, 60, [-3, 0, 2, 10]),
                                      (60, 40, [-7, 0, 1]), (100, 2000, [0, 5]),
                                      (2500, 2500, [-70, -1, 0, 1, 70])])
def test_dia_spmv_kernel_equals_plain(m, n, offs, dtype):
    """Same products summed in the same order with rounded operations: equal."""
    rng = np.random.default_rng(m + n)
    data = torch.tensor(rng.standard_normal((len(offs), n)), dtype=dtype, device="cuda")
    x = torch.tensor(rng.standard_normal(n), dtype=dtype, device="cuda")
    plan = D.dia_plan(offs, (m, n))
    planes, xpad = D.dia_pack(data, plan), D.dia_pad_x(x, plan)
    before = D.dia_spmv_packed.launches
    y = D.dia_spmv_packed(planes, xpad, plan)
    assert D.dia_spmv_packed.launches == before + 1
    torch.testing.assert_close(y, D.dia_spmv_packed_plain(planes, xpad, plan), rtol=0, atol=0)


def test_cg_kernels_equal_plain_and_repeat_bit_identically():
    n = 64
    m = n * n
    diag = [np.full(m - n, -1.0), np.full(m - 1, -1.0), np.full(m, 4.0),
            np.full(m - 1, -1.0), np.full(m - n, -1.0)]
    A = st.diags(diag, [-n, -1, 0, 1, n], dtype=np.float32)
    b = torch.rand(m, device="cuda")
    x1 = C.cg_dia_fused(A.data, (-n, -1, 0, 1, n), b, None, m, iters=60)[0].clone()
    x2 = C.cg_dia_fused(A.data, (-n, -1, 0, 1, n), b, None, m, iters=60)[0].clone()
    assert torch.equal(x1, x2)
    xc = C.cg_dia_fused(A.data.cpu(), (-n, -1, 0, 1, n), b.cpu(), None, m, iters=60)[0]
    torch.testing.assert_close(x1.cpu(), xc, rtol=1e-4, atol=1e-4)


def test_linalg_cg_on_card_uses_kernels():
    n = 48
    m = n * n
    diag = [np.full(m - n, -1.0), np.full(m - 1, -1.0), np.full(m, 4.0),
            np.full(m - 1, -1.0), np.full(m - n, -1.0)]
    A = st.diags(diag, [-n, -1, 0, 1, n], dtype=np.float32).tocsc().T.tocsr()
    b = torch.rand(m, device="cuda")
    before = (C.cg_kernel_a.launches, D.dia_spmv_packed.launches)
    bnorm = float(torch.linalg.vector_norm(b))
    x, iters = linalg.cg(A, b, tol=1e-3 * bnorm)
    assert C.cg_kernel_a.launches == before[0] + iters
    r = b - A @ x
    assert D.dia_spmv_packed.launches == before[1] + 1
    # f32: the true residual may sit above the recursive one by rounding
    assert float(torch.linalg.vector_norm(r)) < 1e-2 * bnorm


def test_wide_band_runs_the_kernels():
    """A band past the reference's pallas_max_band (a TPU VMEM limit) still
    launches the DIA kernel and the fused CG on the card."""
    m, offs = 20000, [-9000, -1, 0, 1, 9000]
    assert offs[-1] > st.settings.pallas_max_band
    diagonals = [np.full(m - abs(o), -1.0 if o else 4.5, np.float32) for o in offs]
    A = st.diags(diagonals, offs, dtype=np.float32).tocsc().T.tocsr()
    x = torch.rand(m, device="cuda")
    before = (D.dia_spmv_packed.launches, C.cg_kernel_a.launches, C.cg_kernel_b.launches)
    y = A @ x
    assert D.dia_spmv_packed.launches == before[0] + 1
    dia = A._maybe_dia()
    from sparse_tpu_torch.ops.dia_spmv import dia_spmv_torch

    torch.testing.assert_close(y, dia_spmv_torch(dia[0], dia[1], x, A.shape), rtol=1e-6, atol=1e-5)
    b = torch.rand(m, device="cuda")
    bnorm = float(torch.linalg.vector_norm(b))
    xs, iters = linalg.cg(A, b, tol=1e-4 * bnorm, maxiter=500)
    assert iters < 500
    assert C.cg_kernel_a.launches == before[1] + iters
    assert C.cg_kernel_b.launches == before[2] + iters
    assert float(torch.linalg.vector_norm(b - A @ xs)) < 1e-3 * bnorm


def test_dtype_without_kernel_raises_on_card():
    """A banded product at a dtype with no kernel raises on the card rather
    than run the plain version there."""
    A = st.diags([np.ones(64, np.complex64)], [0], dtype=np.complex64)
    with pytest.raises(TypeError, match="no CUDA kernel"):
        A @ torch.ones(64, dtype=torch.complex64, device="cuda")


# ---------------------------------------------------------------------------
# chunked SELL kernels (csrc/sell_spmv.cu)
# ---------------------------------------------------------------------------
def _sell_case(name):
    import chip_smoke

    return chip_smoke.sell_edge_cases()[name] if name != "skewed" else \
        chip_smoke.skewed_degree_csr(20000).astype(np.float64)


def _chunks(s, dtype, itype, seg=None, with_src=False):
    from sparse_tpu_torch.kernels import sell_spmv as S

    t = lambda a, dt=None: torch.tensor(np.asarray(a), dtype=dt, device="cuda")  # noqa: E731
    return S.sell_chunk_pack(t(s.indptr), t(s.indices, itype), t(s.data, dtype), s.shape, seg=seg,
                             with_src=with_src)


SELL_CASES = ["powerlaw", "empty_rows", "dup_cols", "random", "zero_nnz", "skewed"]


@pytest.mark.parametrize("itype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seg", [3, None])
@pytest.mark.parametrize("name", SELL_CASES)
def test_sell_chunk_kernel_vs_plain(name, seg, dtype, itype):
    """One launch per product, equal to the plain version bit for bit (the
    same sums in the same order), repeats equal (tickets rearmed)."""
    from sparse_tpu_torch.kernels import sell_spmv as S

    s = _sell_case(name)
    ch = _chunks(s, dtype, itype, seg)
    assert ch.idx.dtype == itype
    ws = S.SellWorkspace(ch, dtype)
    x = torch.tensor(np.random.default_rng(1).standard_normal(s.shape[1]), dtype=dtype,
                     device="cuda")
    before = S.sell_chunk_spmv.launches
    y = S.sell_chunk_spmv(ch, ch.val, x, ws)
    torch.cuda.synchronize()
    assert S.sell_chunk_spmv.launches == before + (1 if s.shape[0] else 0)
    assert torch.equal(y, S.sell_chunk_spmv_plain(ch, ch.val, x))
    assert torch.equal(y, S.sell_chunk_spmv(ch, ch.val, x, ws))


@pytest.mark.parametrize("lanes", [1, 3, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["powerlaw", "skewed", "empty_rows"])
def test_sell_chunk_batched_kernel_vs_plain(name, dtype, lanes):
    """One launch per batched product, equal to its plain version and, lane
    by lane, to the single-matrix kernel bit for bit (70 lanes: two lane
    groups)."""
    from sparse_tpu_torch.kernels import sell_spmv as S

    s = _sell_case(name)
    ch = _chunks(s, dtype, torch.int32, seg=5, with_src=True)
    rng = np.random.default_rng(2)
    V = torch.tensor(s.data[None] * (1 + rng.random((lanes, s.nnz))), dtype=dtype, device="cuda")
    X = torch.tensor(rng.standard_normal((lanes, s.shape[1])), dtype=dtype, device="cuda")
    vals = ch.pack_values(V)
    before = S.sell_chunk_spmv_batched.launches
    Y = S.sell_chunk_spmv_batched(ch, vals, X, S.SellWorkspace(ch, dtype, lanes))
    torch.cuda.synchronize()
    assert S.sell_chunk_spmv_batched.launches == before + 1
    assert torch.equal(Y, S.sell_chunk_spmv_batched_plain(ch, vals, X))
    ws1 = S.SellWorkspace(ch, dtype)
    for b in range(lanes):
        assert torch.equal(Y[b], S.sell_chunk_spmv(ch, vals[:, b].contiguous(), X[b], ws1))


def test_sell_complex_raises_on_card():
    import scipy.sparse as sp

    from sparse_tpu_torch.batch import BatchedCSR

    st.settings.spmv_mode = "sell"
    try:
        s = sp.random(50, 50, density=0.2, random_state=1, format="csr").astype(np.complex64)
        A = st.csr_array(s)
        with pytest.raises(TypeError, match="no CUDA kernel"):
            A @ torch.ones(50, dtype=torch.complex64, device="cuda")
        bc = BatchedCSR(s, torch.tensor(np.stack([s.data, s.data]), device="cuda"))
        with pytest.raises(TypeError, match="no CUDA kernel"):
            bc.matvec(torch.ones((2, 50), dtype=torch.complex64, device="cuda"))
    finally:
        st.settings.spmv_mode = "auto"


def _skewed_csr(m):
    import chip_smoke

    return chip_smoke.skewed_degree_csr(m)


def test_auto_skewed_matrix_launches_sell_kernel():
    """``A @ x`` is one launch of the chunk kernel, y in row order."""
    from sparse_tpu_torch import plan_cache
    from sparse_tpu_torch.kernels import sell_spmv as S

    s = _skewed_csr(20000)
    A = st.csr_array(s)
    x = torch.rand(20000, device="cuda")
    before = S.sell_chunk_spmv.launches
    y = A @ x
    prep = plan_cache.lookup(A, "sell")
    assert prep is not None and prep.chunks is not None and prep.slabs is None
    assert S.sell_chunk_spmv.launches == before + 1
    want = s.astype(np.float64) @ x.double().cpu().numpy()
    mag = abs(s).astype(np.float64) @ x.double().cpu().numpy()
    rowlen = np.diff(s.indptr) + 2
    err = np.abs(y.double().cpu().numpy() - want)
    assert np.all(err <= rowlen * np.finfo(np.float32).eps * mag)


def test_from_parts_and_interop_build_chunks_on_card():
    """A slab pack carried to the card becomes the chunk layout of its CSR:
    the same y bit for bit as the operator packed from the CSR."""
    from sparse_tpu_torch.interop import prepared_csr_from_numpy
    from sparse_tpu_torch.kernels import sell_spmv as S

    s = _sell_case("powerlaw")
    plan, slabs, pos = S.sell_pack(s.indptr, s.indices, s.data, s.shape, C=4, sigma=16,
                                   max_slabs=3, device="cpu")
    prep = prepared_csr_from_numpy(plan.slab_meta, (plan.m, plan.n, plan.C, plan.sigma,
                                                    plan.zero_rows, plan.nnz),
                                   [(i.numpy(), v.numpy()) for i, v in slabs], pos.numpy())
    direct = S.PreparedCSR(s.indptr, s.indices, s.data, s.shape)
    assert prep.chunks is not None and prep.slabs is None
    x = torch.tensor(np.random.default_rng(3).standard_normal(s.shape[1]), device="cuda")
    assert torch.equal(prep(x), direct(x))
    np.testing.assert_allclose(prep(x).cpu().numpy(), s @ x.cpu().numpy(), rtol=1e-12,
                               atol=1e-12)


def test_batched_cg_launches_batched_kernel():
    from sparse_tpu_torch.batch import BatchedCSR, batched_cg
    from sparse_tpu_torch.kernels import sell_spmv as S

    s = _skewed_csr(4096)
    rng = np.random.default_rng(0)
    diag = s.indices == np.repeat(np.arange(4096), np.diff(s.indptr))
    vals = np.stack([s.data + np.float32(d) * diag for d in rng.random(4)]).astype(np.float32)
    bc = BatchedCSR(s, torch.tensor(vals, device="cuda"))
    b = torch.tensor(rng.standard_normal((4, 4096)), dtype=torch.float32, device="cuda")
    tol = 1e-5 * torch.linalg.vector_norm(b, dim=1)
    before = S.sell_chunk_spmv_batched.launches
    bc.matvec(b)
    assert S.sell_chunk_spmv_batched.launches == before + 1
    X, info = batched_cg(bc, b, tol=tol, maxiter=2000)
    assert bool(info.converged.all())
    for i in range(4):
        xu, iu = linalg.cg(bc.lane(i), b[i], tol=float(tol[i]), maxiter=2000)
        assert int(info.iters[i]) == iu
        assert torch.equal(X[i], xu)  # the same SpMV sums and dots, lane by lane


# ---------------------------------------------------------------------------
# column-indexed DIA SpMV and the one-pass CG (csrc/dia_spmv.cu, csrc/cg_dia.cu)
# ---------------------------------------------------------------------------
DIRECT_CASES = [(50, 50, [-5, -1, 0, 1, 5]), (40, 60, [-3, 0, 2, 10]), (60, 40, [-7, 0, 1]),
                (7, 7, [0]), (300, 300, [-17, -1, 0, 1, 17]), (100, 2000, [0, 5]),
                (2500, 2500, [-70, -1, 0, 1, 70])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,offs", DIRECT_CASES)
def test_dia_spmv_direct_kernel_equals_plain(m, n, offs, dtype):
    """The same products summed in the same order with rounded operations:
    equal bit for bit."""
    rng = np.random.default_rng(m * 7 + n)
    data = torch.tensor(rng.standard_normal((len(offs), n)), dtype=dtype, device="cuda")
    x = torch.tensor(rng.standard_normal(n), dtype=dtype, device="cuda")
    before = D.dia_spmv_direct.launches
    y = D.dia_spmv_direct(data, offs, x, (m, n))
    assert D.dia_spmv_direct.launches == before + 1
    assert torch.equal(y, D.dia_spmv_direct_plain(data, offs, x, (m, n)))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.float16])
def test_direct_and_onepass_raise_on_dtype_without_kernel(dtype):
    data = torch.ones((3, 64), dtype=dtype, device="cuda")
    x = torch.ones(64, dtype=dtype, device="cuda")
    with pytest.raises(TypeError, match="no CUDA kernel"):
        D.dia_spmv_direct(data, (-1, 0, 1), x, (64, 64))
    with pytest.raises(TypeError, match="no CUDA kernel"):
        C.cg_dia_fused_onepass(data, (-1, 0, 1), x, None, 64, iters=2)


def _lap_state(n, dtype, seed):
    from sparse_tpu_torch.models import laplacian_2d_dia

    planes, offs = laplacian_2d_dia(n, dtype=dtype, device="cuda")
    plan = D.dia_plan(offs, (n * n, n * n))
    packed = D.dia_pack(planes, plan)
    rng = np.random.default_rng(seed)
    vec = lambda: C._pad_vec(torch.tensor(rng.standard_normal(n * n), dtype=dtype, device="cuda"),
                             plan)
    sc = torch.tensor([2.0, 1.5, 0.7, 0.9], dtype=dtype, device="cuda")
    return planes, offs, plan, packed, vec, sc


@pytest.mark.parametrize("dtype,pdt", [(torch.float32, None), (torch.float32, torch.bfloat16),
                                       (torch.float64, None)])
def test_cgcg_kernel_equals_plain_after_one_iteration(dtype, pdt):
    """From the same state: the vectors equal bit for bit; the two dots are
    sums in another order, within 4 eps of the sum of |terms|."""
    _, _, plan, packed, vec, sc = _lap_state(64, dtype, seed=3)
    planes = packed if pdt is None else packed.to(pdt)
    r, w, s, p, x = vec(), vec(), vec(), vec(), vec()
    outs = []
    for fn in (C.cgcg_kernel, C.cgcg_kernel_plain):
        pk, xk, sck = p.clone(), x.clone(), sc.clone()
        ro, wo, so = torch.zeros_like(r), torch.zeros_like(r), torch.zeros_like(r)
        if fn is C.cgcg_kernel:
            before = C.cgcg_kernel.launches
            fn(planes, r, w, s, pk, xk, ro, wo, so, sck, plan, C.CgWorkspace(plan, dtype, "cuda"))
            assert C.cgcg_kernel.launches == before + 1
        else:
            fn(planes, r, w, s, pk, xk, ro, wo, so, sck, plan)
        outs.append((pk, xk, ro, wo, so, sck))
    for a, b in zip(outs[0][:5], outs[1][:5]):
        assert torch.equal(a, b)
    (_, _, ro, wo, *_), sck, scp = outs[1], outs[0][5], outs[1][5]
    eps = torch.finfo(dtype).eps
    B, mp = plan.B, plan.m_pad
    rr_mag = float((ro[B : B + mp].double() ** 2).sum())
    wr_mag = float((wo[B : B + mp].double() * ro[B : B + mp].double()).abs().sum())
    assert abs(float(sck[C.RHO]) - float(scp[C.RHO])) <= 4 * eps * rr_mag
    assert abs(float(sck[C.MU]) - float(scp[C.MU])) <= 4 * eps * wr_mag
    assert torch.equal(sck[[C.RHO_PREV, C.ALPHA_PREV]], scp[[C.RHO_PREV, C.ALPHA_PREV]])


def test_onepass_on_card_repeats_bf16_equals_f32_and_tracks_cpu():
    n = 64
    planes, offs, *_ = _lap_state(n, torch.float32, seed=0)
    b = torch.rand(n * n, device="cuda")
    before = C.cgcg_kernel.launches
    x1 = C.cg_dia_fused_onepass(planes, offs, b, None, n * n, iters=60)[0].clone()
    assert C.cgcg_kernel.launches == before + 60
    x2 = C.cg_dia_fused_onepass(planes, offs, b, None, n * n, iters=60)[0].clone()
    assert torch.equal(x1, x2)  # no float atomics
    xb = C.cg_dia_fused_onepass(planes, offs, b, None, n * n, iters=60,
                                plane_dtype=torch.bfloat16)[0]
    assert torch.equal(x1, xb)  # the Laplacian's values are exact in bf16
    xt = C.cg_dia_fused(planes, offs, b, None, n * n, iters=60)[0].clone()
    xtb = C.cg_dia_fused(planes, offs, b, None, n * n, iters=60, plane_dtype=torch.bfloat16)[0]
    assert torch.equal(xt, xtb)
    xc = C.cg_dia_fused_onepass(planes.cpu(), offs, b.cpu(), None, n * n, iters=60)[0]
    torch.testing.assert_close(x1.cpu(), xc, rtol=1e-4, atol=1e-4)


def test_flagship_step_runs_direct_kernel_without_host_sync():
    from sparse_tpu_torch.models import cg_dia, poisson_cg_state_dia

    n = 64
    (planes, x, b, p, rho), step = poisson_cg_state_dia(n, device="cuda")
    before = D.dia_spmv_direct.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, r, p, rho = cg_dia(step, planes, x, b, p, rho, iters=50)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert D.dia_spmv_direct.launches == before + 50
    xc = cg_dia(step, planes.cpu(), torch.zeros(n * n), b.cpu(), torch.zeros(n * n),
                torch.zeros(()), iters=50)[0]
    torch.testing.assert_close(x.cpu(), xc, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the windowed and the wide one-pass kernels (csrc/cg_dia.cu)
# ---------------------------------------------------------------------------
#: a span of 32,768 rows (the 3-D Laplacian's at 128^3): the window fits a
#: block's shared memory in f32, not in f64
F32_ONLY_BAND = (300_000, (-16_384, -1, 0, 1, 16_384))
ONEPASS_CASES = [(4096, (-64, -1, 0, 1, 64)), (1_000_000, (-1000, -1, 0, 1, 1000)),
                 (999_999, (1, 2)), (777_777, (-3, -1)), (600_001, (-1030, 7)), F32_ONLY_BAND]


def _onepass_launch(kernel, m, offsets, dtype, pdt):
    """One launch of ``kernel`` and of the plain version from one random
    state; returns both outputs and the launch count it moved."""
    rng = np.random.default_rng(m)
    plan = D.dia_plan(offsets, (m, m))
    data = torch.tensor(rng.standard_normal((len(offsets), m)), dtype=dtype, device="cuda")
    packed = D.dia_pack(data, plan)
    planes = packed if pdt is None else packed.to(pdt)
    vec = lambda: C._pad_vec(torch.tensor(rng.standard_normal(m), dtype=dtype, device="cuda"),
                             plan)
    r, w, s, p, x = vec(), vec(), vec(), vec(), vec()
    sc = torch.tensor([2.0, 1.5, 0.7, 0.9], dtype=dtype, device="cuda")
    ws = C.CgWorkspace(plan, dtype, "cuda")
    outs, moved = [], None
    for fn in (kernel, C.cgcg_kernel_plain):
        pk, xk, sck = p.clone(), x.clone(), sc.clone()
        ro, wo, so = torch.zeros_like(r), torch.zeros_like(r), torch.zeros_like(r)
        if fn is kernel:
            before = kernel.launches
            fn(planes, r, w, s, pk, xk, ro, wo, so, sck, plan, ws)
            torch.cuda.synchronize()
            moved = kernel.launches - before
        else:
            fn(planes, r, w, s, pk, xk, ro, wo, so, sck, plan)
        outs.append((pk, xk, ro, wo, so, sck))
    return outs, moved, plan, ws


@pytest.mark.parametrize("dtype,pdt", [(torch.float32, None), (torch.float32, torch.bfloat16),
                                       (torch.float64, None)])
@pytest.mark.parametrize("m,offsets", ONEPASS_CASES)
@pytest.mark.parametrize("which", ["window", "wide"])
def test_onepass_kernels_equal_plain_bit_for_bit(which, m, offsets, dtype, pdt):
    """Both kernels over one-sided bands, a band without a main diagonal,
    ragged m, several tiles a block and a band whose window fits in f32
    only (the windowed wrapper refuses it in f64): p, x, r', w', s' equal
    the plain version bit for bit, one launch counted; the dots within (kt
    + 20) eps of the sum of |terms|, kt the terms a thread sums in
    sequence."""
    kernel = C.cgcg_kernel_wide if which == "wide" else C.cgcg_kernel
    if which == "window" and offsets == F32_ONLY_BAND[1]:
        ws = C.CgWorkspace(D.dia_plan(offsets, (m, m)), dtype, "cuda")
        assert ws.window(pdt or dtype)[0].fits == (dtype == torch.float32)
        if dtype == torch.float64:
            with pytest.raises(ValueError, match="cgcg_kernel_wide takes this band"):
                _onepass_launch(kernel, m, offsets, dtype, pdt)
            return
    outs, moved, plan, ws = _onepass_launch(kernel, m, offsets, dtype, pdt)
    assert moved == 1
    for a, b in zip(outs[0][:5], outs[1][:5]):
        assert torch.equal(a, b)
    (_, _, ro, wo, *_), sck, scp = outs[1], outs[0][5], outs[1][5]
    B, mp = plan.B, plan.m_pad
    if which == "wide":
        kt = -(-mp // (ws.nblocks * 256))
    else:
        kt = ws.window(pdt or dtype)[0].terms_per_thread
    eps = torch.finfo(dtype).eps
    for slot, terms in ((C.RHO, ro[B : B + mp].double() ** 2),
                        (C.MU, wo[B : B + mp].double() * ro[B : B + mp].double())):
        exact, mag = float(terms.sum()), float(terms.abs().sum())
        assert abs(float(sck[slot]) - exact) <= (kt + 20) * eps * mag
    assert torch.equal(sck[[C.RHO_PREV, C.ALPHA_PREV]], scp[[C.RHO_PREV, C.ALPHA_PREV]])


def test_wide_band_onepass_runs_the_wide_kernel_only():
    """A band whose window exceeds a block's shared memory: the windowed
    wrapper refuses it, cg_dia_fused_onepass runs the wide kernel (its
    counter moves by the iteration count, the windowed one's not at all)
    and tracks the CPU."""
    m, offs = 200_000, (-40_000, -1, 0, 1, 40_000)
    diagonals = [np.full(m - abs(o), -1.0 if o else 4.5, np.float32) for o in offs]
    A = st.diags(diagonals, offs, dtype=np.float32)
    plan = D.dia_plan(offs, (m, m))
    ws = C.CgWorkspace(plan, torch.float32, "cuda")
    assert not ws.window(torch.float32)[0].fits
    z = torch.zeros(plan.m_pad + 2 * plan.B, device="cuda")
    with pytest.raises(ValueError, match="cgcg_kernel_wide takes this band"):
        C.cgcg_kernel(D.dia_pack(A.data, plan), z, z, z, z, z, z, z, z, torch.zeros(4, device="cuda"),
                      plan, ws)
    b = torch.rand(m, device="cuda")
    before = (C.cgcg_kernel.launches, C.cgcg_kernel_wide.launches)
    x = C.cg_dia_fused_onepass(A.data, offs, b, None, m, iters=40)[0]
    assert (C.cgcg_kernel.launches, C.cgcg_kernel_wide.launches) == (before[0], before[1] + 40)
    xc = C.cg_dia_fused_onepass(A.data.cpu(), offs, b.cpu(), None, m, iters=40)[0]
    torch.testing.assert_close(x.cpu(), xc, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,offs,windowed", [
    (1_000_000, (-1000, -1, 0, 1, 1000), True),  # 3 tiles a block, span 2000
    (F32_ONLY_BAND[0], F32_ONLY_BAND[1], False),  # fits; 3 tiles a block, span 32,768
    (262_144, (-4096, -64, -1, 0, 1, 64, 4096), False),  # fits; 1 tile a block, span 8192
])
def test_onepass_takes_the_window_by_rows_per_span(m, offs, windowed):
    """cg_dia_fused_onepass takes the windowed kernel where its window fits
    and a block owns at least WINDOW_MIN_RATIO spans of rows, else the wide
    kernel (only one counter moves, by the iteration count), and tracks the
    CPU either way."""
    diagonals = [np.full(m - abs(o), -1.0 if o else 2.0 * len(offs), np.float32) for o in offs]
    A = st.diags(diagonals, offs, dtype=np.float32)
    ws = C.CgWorkspace(D.dia_plan(offs, (m, m)), torch.float32, "cuda")
    geo = ws.window(torch.float32)[0]
    assert geo.fits and geo.windowed == windowed
    b = torch.rand(m, device="cuda")
    before = (C.cgcg_kernel.launches, C.cgcg_kernel_wide.launches)
    x = C.cg_dia_fused_onepass(A.data, offs, b, None, m, iters=40)[0]
    moved = (C.cgcg_kernel.launches - before[0], C.cgcg_kernel_wide.launches - before[1])
    assert moved == ((40, 0) if windowed else (0, 40))
    xc = C.cg_dia_fused_onepass(A.data.cpu(), offs, b.cpu(), None, m, iters=40)[0]
    torch.testing.assert_close(x.cpu(), xc, rtol=1e-4, atol=1e-4)


def _banded_nonsym(nx):
    """chip_smoke's upwind convection-diffusion operator at nx^2, f32."""
    import chip_smoke

    diagonals, offsets, n = chip_smoke.convection_diffusion_diagonals(nx, nx)
    return st.diags(diagonals, offsets, shape=(n, n), dtype=np.float32).tocsc().T.tocsr()


@pytest.mark.parametrize("which", ["skewed", "banded"])
def test_adjoint_product_repeats_bit_for_bit(which):
    """A.T @ x and rmatvec run on the transpose's CSR through a kernel,
    with a fixed summation order: two calls agree bit for bit."""
    from sparse_tpu_torch.kernels import sell_spmv as S

    A = st.csr_array(_skewed_csr(2**16)) if which == "skewed" else _banded_nonsym(300)
    counter = S.sell_chunk_spmv if which == "skewed" else D.dia_spmv_packed
    x = torch.rand(A.shape[0], device="cuda")
    y1 = A.T @ x
    before = counter.launches
    y2 = A.T @ x
    assert counter.launches == before + 1
    assert torch.equal(y1, y2)
    assert torch.equal(linalg.aslinearoperator(A).rmatvec(x), y1)
    # the same product on the CPU (the kernels' plain versions)
    Ac = st.csr_array((A.data.cpu(), A.indices.cpu(), A.indptr.cpu()), shape=A.shape, device="cpu")
    yc = Ac.T @ x.cpu()
    torch.testing.assert_close(y1.cpu(), yc, rtol=1e-5, atol=1e-5 * float(yc.abs().max()))
    s = A.tocsc()  # the same matrix as CSC: its product runs on its own CSR
    assert torch.equal(s @ x, s @ x)


def test_segment_mode_repeats_bit_for_bit():
    """spmv_mode 'segment' sums each row with segment_reduce: two products
    agree bit for bit (a scatter-add would not)."""
    st.settings.spmv_mode = "segment"
    try:
        A = st.csr_array(_skewed_csr(2**16))
        x = torch.rand(A.shape[1], device="cuda")
        X = torch.rand((A.shape[1], 3), device="cuda")
        assert torch.equal(A @ x, A @ x)
        assert torch.equal(A @ X, A @ X)
    finally:
        st.settings.spmv_mode = "auto"


def test_duplicate_summation_repeats_bit_for_bit():
    """A COO with every entry repeated hundreds of times: the summed CSR
    values agree bit for bit across two conversions."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 300, 300_000)
    cols = rng.integers(0, 200, 300_000)
    vals = rng.standard_normal(300_000).astype(np.float32)
    a = st.coo_array((vals, (rows, cols)), shape=(300, 200)).tocsr()
    b = st.coo_array((vals, (rows, cols)), shape=(300, 200)).tocsr()
    assert a.nnz == b.nnz < 300_000
    assert torch.equal(a.data, b.data)


def test_bicg_repeats_bit_for_bit():
    """bicg calls rmatvec every iteration: two solves give the same x."""
    A = _banded_nonsym(200)
    b = torch.rand(A.shape[0], device="cuda")
    x1, i1 = linalg.bicg(A, b, tol=0.0, maxiter=150)
    x2, i2 = linalg.bicg(A, b, tol=0.0, maxiter=150)
    assert i1 == i2 == 150 and torch.equal(x1, x2)


def _same_csr(a, b):
    return all(torch.equal(u, v) for u, v in ((a.indptr, b.indptr), (a.indices, b.indices),
                                              (a.data, b.data)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("which", ["banded", "random"])
def test_spgemm_repeats_bit_for_bit(which, dtype):
    """The ESC on the card: a stable sort and in-order segment sums, so two
    products agree bit for bit, and with the CPU's ESC to rounding."""
    from sparse_tpu_torch import hostsync, native

    if which == "banded":
        A = st.diags([1] * 11, list(range(-5, 6)), shape=(3000, 3000), format="csr", dtype=dtype)
    else:
        A = st.random(2000, 2000, density=0.01, format="csr", random_state=3, dtype=dtype)
    hostsync.HOST_SYNCS = 0
    C1 = A @ A
    assert hostsync.HOST_SYNCS == 2
    assert _same_csr(C1, A @ A)
    Ac = st.csr_array((A.data.cpu(), A.indices.cpu(), A.indptr.cpu()), shape=A.shape,
                      device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "lib", lambda: None)  # the ESC on the host too
        Cc = Ac @ Ac
    assert torch.equal(C1.indices.cpu(), Cc.indices) and torch.equal(C1.indptr.cpu(), Cc.indptr)
    torch.testing.assert_close(C1.data.cpu(), Cc.data, rtol=1e-5 if dtype == np.float32 else 1e-12,
                               atol=0)


@pytest.mark.parametrize("fmt", ["csr", "csc", "dia"])
def test_rmatmul_repeats_bit_for_bit(fmt):
    """x @ A runs as (A^T x)^T on the plan-cached transpose's CSR, through
    a kernel: two calls agree bit for bit."""
    A = _banded_nonsym(300).asformat(fmt)
    x = torch.rand(A.shape[0], device="cuda")
    before = D.dia_spmv_packed.launches
    y1 = x @ A
    y2 = x @ A
    assert D.dia_spmv_packed.launches >= before + 2
    assert torch.equal(y1, y2)
    X = torch.rand((3, A.shape[0]), device="cuda")
    assert torch.equal(X @ A, X @ A)


@pytest.mark.parametrize("conv", ["coo_to_dense", "csr_to_dense", "coo_to_dia"])
def test_fixed_conversions_repeat_bit_for_bit(conv):
    """The conversions that sum duplicates, on a 64 x 64 COO holding every
    entry 100 times: the same bits twice on the card."""
    from sparse_tpu_torch.dia import _coo_to_dia
    from sparse_tpu_torch.ops.conv import coo_to_dense, csr_to_dense

    g = torch.Generator(device="cuda").manual_seed(3)
    r = torch.arange(64 * 64, device="cuda").repeat(100) // 64
    c = torch.arange(64 * 64, device="cuda").repeat(100) % 64
    perm = torch.randperm(r.shape[0], device="cuda", generator=g)
    r, c = r[perm], c[perm]
    v = torch.randn(r.shape, device="cuda", generator=g, dtype=torch.float64)
    if conv == "coo_to_dense":
        run = lambda: coo_to_dense(r, c, v, (64, 64))  # noqa: E731
    elif conv == "csr_to_dense":
        order = torch.argsort(r, stable=True)
        indptr = torch.searchsorted(r[order], torch.arange(65, device="cuda"))
        run = lambda: csr_to_dense(indptr, c[order], v[order], (64, 64))  # noqa: E731
    else:
        coo = st.coo_array((v, (r, c)), shape=(64, 64))
        run = lambda: _coo_to_dia(coo)[0]  # noqa: E731
    assert torch.equal(run(), run())


def test_cuda_tensors_never_reach_the_native_library(monkeypatch):
    """f32/f64 products of CUDA tensors take the ESC, never the host
    Gustavson, though the library is there."""
    from sparse_tpu_torch import native

    def boom(*a, **k):
        raise AssertionError("native library reached from the card")

    monkeypatch.setattr(native, "spgemm_host", boom)
    monkeypatch.setattr(native, "lib", boom)
    A = st.random(500, 500, density=0.02, format="csr", random_state=1, dtype=np.float64)
    C = A @ A
    assert C.device.type == "cuda" and C.nnz > 0


def test_core_ops_on_card_match_the_cpu():
    """Union add, intersection multiply, reductions and the MIS on the card
    against the same calls on CPU tensors."""
    from sparse_tpu_torch.models import laplacian_2d_csr

    L = laplacian_2d_csr(40, np.float32)
    Lc = laplacian_2d_csr(40, np.float32, device="cpu")
    for f in (lambda a: (a + a.T).toarray(), lambda a: a.multiply(a).toarray(),
              lambda a: a.sum(axis=0), lambda a: a.max(axis=1), lambda a: a.argmin(axis=0),
              lambda a: a.diagonal(1), lambda a: a.mis_tropical(k=2, seed=4)):
        assert torch.equal(f(L).cpu(), f(Lc))


def _convection_diffusion_csr(nx: int, device="cuda"):
    """The 5-point upwind convection-diffusion stencil (cell Peclet number
    0.5) on an nx x nx grid, f32."""
    import scipy.sparse as sp

    n = nx * nx
    west, east = np.full(n - 1, -1.5), np.full(n - 1, -1.0)
    west[nx - 1:: nx] = 0.0
    east[nx - 1:: nx] = 0.0
    S = sp.diags([np.full(n - nx, -1.5), west, np.full(n, 5.0), east, np.full(n - nx, -1.0)],
                 [-nx, -1, 0, 1, nx], format="csr")
    return st.csr_array(S.astype(np.float32), device=device)


@pytest.mark.parametrize("which", ["spilu", "splu"])
def test_triangular_graph_equals_the_loop_bit_for_bit(which, monkeypatch):
    """The captured K-step graph replays the loop's kernels in the loop's
    order: the same bits. The first apply runs the loop, the second
    captures."""
    from sparse_tpu_torch import _direct

    A = _convection_diffusion_csr(40)
    if which == "splu":
        monkeypatch.setattr(_direct, "DENSE_DIRECT_MAX_N", 100)
        A = A.astype(torch.float64)
    fac = linalg.spilu(A) if which == "spilu" else linalg.splu(A)
    plan = fac._Lsolve if which == "spilu" else fac._Lprep
    b = torch.rand(A.shape[0], device="cuda", dtype=A.dtype)
    first = fac.solve(b)
    assert plan._graphs[1] is False  # applied once, by the loop
    second = fac.solve(b)
    assert plan._graphs[1] is not False  # captured
    third = fac.solve(b)
    loop = plan.apply(b[:, None], graph=False)
    graph = plan.apply(b[:, None], graph=True)
    assert torch.equal(first, second) and torch.equal(second, third)
    assert torch.equal(loop, graph)
    r = torch.linalg.vector_norm((A @ third).double() - b.double()) / torch.linalg.vector_norm(b)
    assert float(r) < (1e-10 if which == "splu" else 1.0)


def test_eigsh_and_svds_repeat_bit_for_bit():
    A = _convection_diffusion_csr(30)
    S = (A + A.T).tocsr()
    w1, V1 = linalg.eigsh(S, k=4, maxiter=60)
    w2, V2 = linalg.eigsh(S, k=4, maxiter=60)
    assert np.array_equal(w1, w2) and torch.equal(V1, V2)
    out1, out2 = linalg.svds(A, k=3, maxiter=60), linalg.svds(A, k=3, maxiter=60)
    assert np.array_equal(out1[1], out2[1])
    assert torch.equal(out1[0], out2[0]) and torch.equal(out1[2], out2[2])


def test_eigsh_cycles_wait_on_the_card_only_at_their_fetch(monkeypatch):
    """Past the layout's build (the first call), eigsh syncs only in its
    counted fetches, one a cycle: the start vector and the restart's
    coefficients go up through pinned memory (``hostsync.upload``)."""
    from sparse_tpu_torch import hostsync

    A = _convection_diffusion_csr(30)
    S = (A + A.T).tocsr()
    w1, V1 = linalg.eigsh(S, k=4, maxiter=60)
    real = hostsync.fetch

    def fetch(x):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(x)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(hostsync, "fetch", fetch)
    stats = {}
    hostsync.HOST_SYNCS = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        w2, V2 = linalg.eigsh(S, k=4, maxiter=60, _stats=stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert stats["cycles"] > 1 and hostsync.HOST_SYNCS == stats["cycles"]
    assert np.array_equal(w1, w2) and torch.equal(V1, V2)


def test_expm_multiply_on_the_kernel_equals_the_plain_path():
    """The DIA kernel's products against the CPU's plain ones: within the
    f32 rounding of the series, eps e^{||tA||_1} ||B||."""
    from sparse_tpu_torch.kernels import dia_spmv as D

    A = _convection_diffusion_csr(50)
    Ac = _convection_diffusion_csr(50, device="cpu")
    B = torch.rand(A.shape[0], device="cuda")
    t = 0.7
    before = D.dia_spmv_packed.launches
    F = linalg.expm_multiply(A, B, t=t)
    assert D.dia_spmv_packed.launches > before
    Fc = linalg.expm_multiply(Ac, B.cpu(), t=t)
    a1 = float(linalg.norm(Ac, ord=1)) * t
    bound = float(np.finfo(np.float32).eps) * np.exp(a1) * float(torch.linalg.vector_norm(B))
    assert float(torch.linalg.vector_norm(F.cpu() - Fc)) <= bound


# -- slice 9: the remaining formats and application modules --------------------------
def test_bsr_product_repeats_and_matches_the_cpu():
    """The BSR product sums each block row in order: bit for bit on a
    repeat, and equal to the same product on CPU tensors within f64
    rounding."""
    import scipy.sparse as sp

    s = sp.random(3000, 3000, 0.002, random_state=np.random.default_rng(3), format="csr")
    B = st.csr_array(s).tobsr((3, 3))
    x = torch.tensor(np.random.default_rng(4).standard_normal(3000), device="cuda")
    y = B @ x
    assert y.device.type == "cuda" and torch.equal(y, B @ x)
    torch.testing.assert_close(y.cpu(), torch.tensor(s @ x.cpu().numpy()), rtol=1e-12, atol=1e-12)
    assert torch.equal(B.tocsr().toarray().cpu(), torch.tensor(s.toarray()))


def test_dop853_waits_on_the_card_only_at_its_fetches(monkeypatch):
    """The stacked-real quantum evolution on the card through the DIA
    kernel: one counted fetch a step attempt past the setup's three, every
    other sync an error, and a repeat bit for bit."""
    from sparse_tpu_torch import hostsync, integrate, quantum

    n = 12
    adj = np.zeros((n, n))
    adj[np.arange(n), (np.arange(n) + 1) % n] = 1
    adj = adj + adj.T
    drv = quantum.HamiltonianDriver(graph=adj, dtype=np.float32)
    Hd = drv.hamiltonian
    Hc = quantum.HamiltonianMIS(graph=adj, poly=drv.ip, dtype=np.float32).hamiltonian
    nst = Hc.shape[0]

    def rhs(t, y):
        yr, yi = y[:nst], y[nst:]
        return torch.cat([t * (Hc @ yi) + (1 - t) * (Hd @ yi), -(t * (Hc @ yr) + (1 - t) * (Hd @ yr))])

    y0 = torch.zeros((2 * nst,), device="cuda")
    y0[nst - 1] = 1.0
    rhs(0.0, y0)  # the layouts
    real = hostsync.fetch

    def fetch(x):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(x)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(hostsync, "fetch", fetch)
    outs = []
    for _ in range(2):
        hostsync.HOST_SYNCS = 0
        before = D.dia_spmv_packed.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = integrate.solve_ivp(rhs, (0.0, 1.0), y0, method="DOP853", rtol=1e-5, atol=1e-7)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert hostsync.HOST_SYNCS == 3 + (out.nfev - 2) // integrate.DOP853.n_stages
        assert D.dia_spmv_packed.launches > before
        outs.append(out)
    assert torch.equal(outs[0].y, outs[1].y)


def test_csgraph_relaxations_repeat_and_match_the_cpu():
    """scatter_reduce's amin/amax are order-independent: the card's
    distances, predecessors and labels equal the CPU's exactly."""
    import scipy.sparse as sp

    from sparse_tpu_torch import csgraph

    rng = np.random.default_rng(7)
    G = sp.random(400, 400, 0.02, random_state=rng, format="csr")
    G.data = rng.uniform(0.5, 2.0, G.nnz)
    Gc, Gg = st.csr_array(G, device="cpu"), st.csr_array(G)
    for fn, kw in ((csgraph.dijkstra, dict(indices=[0, 5], return_predecessors=True)),
                   (csgraph.bellman_ford, dict(return_predecessors=True)),
                   (csgraph.connected_components, {}),
                   (csgraph.breadth_first_order, dict(i_start=0))):
        card, again, cpu = fn(Gg, **kw), fn(Gg, **kw), fn(Gc, **kw)
        for a, b, c in zip(card, again, cpu):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_bdf_heat_on_card_matches_the_cpu():
    from sparse_tpu_torch import integrate
    from sparse_tpu_torch.models.poisson import laplacian_2d_csr_host

    n = 16
    x = np.linspace(0, 1, n + 2)[1:-1]
    y0 = (np.sin(np.pi * x)[:, None] * np.sin(np.pi * x)[None, :]).ravel()
    sols = []
    for dev in ("cuda", "cpu"):
        L = (laplacian_2d_csr_host(n, device=dev) * (-(n + 1) ** 2)).tocsr()
        sols.append(integrate.solve_ivp(lambda t, y, L=L: L @ y, (0.0, 0.1), y0, method="BDF",
                                        jac=L, rtol=1e-6, atol=1e-9, device=dev))
    card, cpu = sols
    assert card.nfev == cpu.nfev and card.nlu == cpu.nlu
    np.testing.assert_allclose(card.y.cpu().numpy(), cpu.y.numpy(), rtol=1e-9, atol=1e-12)
