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
