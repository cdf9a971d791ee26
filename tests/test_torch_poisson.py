"""sparse_tpu_torch.models.poisson against sparse_tpu.models.poisson, on the CPU.

The operators must equal the reference's exactly. The CG loops are fed the
reference's own state (numpy, through ``utils.as_tensor``), since
``torch.Generator`` and ``jax.random`` give other numbers from one seed.
Both run the same f32 recurrence with dots summed in other orders: x is
held at 1e-4 absolute (solutions of norm ~1-10) after 50 iterations, the
tolerance of tests/test_cg_fused.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_tpu.models import poisson as jp

import sparse_tpu_torch as st
from sparse_tpu_torch.models import poisson as tp
from sparse_tpu_torch.utils import as_tensor


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


def _np(tree):
    return [np.array(v) for v in tree]


@pytest.mark.parametrize("n", [1, 5, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_laplacian_2d_dia_equals_reference(n, dtype):
    pj, oj = jp.laplacian_2d_dia(n, dtype=getattr(jnp, dtype))
    pt, ot = tp.laplacian_2d_dia(n, dtype=getattr(torch, dtype))
    assert ot == oj
    assert pt.dtype == getattr(torch, dtype) and pt.device.type == "cpu"
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


@pytest.mark.parametrize("n", [3, 16])
def test_laplacian_2d_ell_equals_reference(n):
    cj, vj = jp.laplacian_2d_ell(n)
    ct, vt = tp.laplacian_2d_ell(n)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_laplacian_2d_csr_host_equals_reference():
    Aj = jp.laplacian_2d_csr_host(9)
    At = tp.laplacian_2d_csr_host(9)
    assert At.shape == Aj.shape
    np.testing.assert_array_equal(At.indptr.numpy(), np.asarray(Aj.indptr))
    np.testing.assert_array_equal(At.indices.numpy(), np.asarray(Aj.indices))
    np.testing.assert_array_equal(At.data.numpy(), np.asarray(Aj.data))
    np.testing.assert_array_equal(At.toarray().numpy(), np.asarray(Aj.toarray()))


@pytest.mark.parametrize("n", [9, 16])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_cg_dia_matches_reference(n, use_pallas):
    """The port's step (SpMV through dia_spmv_direct's plain version) on
    the reference's poisson_cg_state_dia(n) state, against the reference's
    step through dia_spmv_xla or dia_spmv_pallas (interpret mode)."""
    iters = 50
    state_j, _ = jp.poisson_cg_state_dia(n)
    step_j = jp.make_cg_step_dia((-n, -1, 0, 1, n), n, use_pallas=use_pallas)
    xj, rj, pj_, rhoj = _np(jp.cg_dia(step_j, *state_j, iters=iters))
    state = [as_tensor(v) for v in _np(state_j)]
    step = tp.make_cg_step_dia((-n, -1, 0, 1, n), n)
    x, r, p, rho = tp.cg_dia(step, *state, iters=iters)
    assert x.dtype == torch.float32 and x.shape == (n * n,)
    np.testing.assert_allclose(x.numpy(), xj, atol=1e-4)
    np.testing.assert_allclose(r.numpy(), rj, atol=1e-4)
    np.testing.assert_allclose(p.numpy(), pj_, atol=1e-4)
    assert float(rho) == pytest.approx(float(rhoj), rel=1e-3, abs=1e-8)


def test_cg_dia_solves_reference_state():
    """120 steps on the reference's state at n = 16 bring the true
    residual below 1e-5 of ||b||."""
    n = 16
    state_j, step_j = jp.poisson_cg_state_dia(n)
    planes, x0, b, p0, rho0 = _np(state_j)
    state = [as_tensor(v) for v in (planes, x0, b, p0, rho0)]
    step = tp.make_cg_step_dia((-n, -1, 0, 1, n), n)
    x = tp.cg_dia(step, *state, iters=120)[0]
    res = b.astype(np.float64) - tp.dia_spmv_torch(
        torch.from_numpy(planes).double(), (-n, -1, 0, 1, n), x.double(), (n * n, n * n)).numpy()
    assert np.linalg.norm(res) / np.linalg.norm(b) < 1e-5


def test_poisson_cg_state_dia_port():
    """Shapes, dtypes and device of the port's own state; b = A xtrue for
    the seed's standard-normal xtrue; the same seed gives the same b."""
    n = 12
    N = n * n
    (planes, x0, b, p0, rho0), step = tp.poisson_cg_state_dia(n, seed=3)
    assert planes.shape == (5, N) and x0.shape == b.shape == p0.shape == (N,)
    assert rho0.shape == () and float(rho0) == 0.0 and float(x0.abs().max()) == 0.0
    gen = torch.Generator().manual_seed(3)
    xtrue = torch.randn((N,), generator=gen)
    torch.testing.assert_close(b, tp.dia_spmv_torch(planes, (-n, -1, 0, 1, n), xtrue, (N, N)))
    assert torch.equal(b, tp.poisson_cg_state_dia(n, seed=3)[0][2])
    assert not torch.equal(b, tp.poisson_cg_state_dia(n, seed=4)[0][2])
    x = tp.cg_dia(step, planes, x0, b, p0, rho0, iters=60)[0]
    torch.testing.assert_close(x, xtrue, rtol=1e-3, atol=1e-3)


def test_cg_ell_matches_reference():
    n, iters = 16, 50
    state_j = _np(jp.poisson_cg_state(n))
    xj, rj, pj_, rhoj = _np(jp.cg_ell(*[jnp.asarray(v) for v in state_j], iters=iters))
    state = [as_tensor(v) for v in state_j]
    x, r, p, rho = tp.cg_ell(*state, iters=iters)
    np.testing.assert_allclose(x.numpy(), xj, atol=1e-4)
    np.testing.assert_allclose(r.numpy(), rj, atol=1e-4)
    assert float(rho) == pytest.approx(float(rhoj), rel=1e-3, abs=1e-8)
    # one step: XLA fuses r - alpha * q into one rounding, torch rounds
    # twice; with |alpha q| ~ 10 that is ~1e-6, held at 1e-5
    one = tp.cg_step_ell(*state)
    one_j = _np(jp.cg_step_ell(*[jnp.asarray(v) for v in state_j]))
    for a, b in zip(one, one_j):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


def test_poisson_cg_state_port():
    n = 10
    idx, val, x0, r0, p0, rho0 = tp.poisson_cg_state(n, seed=2)
    assert idx.shape == val.shape == (n * n, 5)
    assert float(x0.abs().max()) == float(p0.abs().max()) == float(rho0) == 0.0
    # 40 iterations: CG on this well-conditioned operator reaches an exact
    # zero rho soon after, and then, as in the reference, 0 / 0 in alpha
    x = tp.cg_ell(idx, val, x0, r0, p0, rho0, iters=40)[0]
    xtrue = torch.randn((n * n,), generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(x, xtrue, rtol=1e-3, atol=1e-3)


def test_models_default_to_settings_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st.settings.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.laplacian_2d_dia(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.poisson_cg_state_dia(4)
    assert tp.laplacian_2d_dia(4, device="cpu")[0].device.type == "cpu"
