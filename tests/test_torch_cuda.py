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
