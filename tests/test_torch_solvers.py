"""sparse_tpu_torch's Krylov solvers against sparse_tpu's, on the CPU.

The same seeded numpy systems go through ``sparse_tpu.linalg.X`` (JAX on
the CPU, x64 on) and ``sparse_tpu_torch.linalg.X``. Both run the same
recurrence; their SpMV and dot products sum in different orders (the
port's adjoint products run on a CSR of the transpose, its f32 dots
accumulate in f64), so:

* f64: ||x_torch - x_jax|| <= 1e-9 ||x_jax|| and equal iteration counts;
* f32: 1e-4 relative, counts free.

Systems: tests/test_solvers.py's ``_spd``, tests/test_solvers_extra.py's
``_sym_indefinite`` and ``_nonsym``, and a banded nonsymmetric
convection-diffusion operator, whose adjoint products take the DIA route.
lsqr, lsmr, lgmres and gcrotmk are in tests/test_torch_lsq.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu
from sparse_tpu import linalg as jlinalg

import sparse_tpu_torch as st
from sparse_tpu_torch import hostsync, linalg

from .test_solvers import _spd
from .test_solvers_extra import _nonsym, _sym_indefinite
from .utils.sample import sample_csr, sample_vec


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


def convection_diffusion(nx: int, gamma: float = 0.5) -> sp.csr_matrix:
    """The 5-point upwind convection-diffusion stencil on an nx x nx grid,
    scaled by h^2: centre 4 + 2 gamma, west and south -1 - gamma, east and
    north -1 (cell Peclet number gamma), Dirichlet boundaries."""
    n = nx * nx
    west = np.full(n - 1, -1.0 - gamma)
    east = np.full(n - 1, -1.0)
    west[nx - 1 :: nx] = 0.0
    east[nx - 1 :: nx] = 0.0
    return sp.diags(
        [np.full(n - nx, -1.0 - gamma), west, np.full(n, 4.0 + 2 * gamma), east,
         np.full(n - nx, -1.0)],
        [-nx, -1, 0, 1, nx], format="csr",
    )


SYSTEMS = {
    "spd": lambda: _spd(60, seed=0),
    "indef": lambda: _sym_indefinite(60, seed=0),
    "nonsym": lambda: _nonsym(80, seed=1),
    "banded": lambda: convection_diffusion(10),
}


def _jacobi(S):
    return sp.diags(1.0 / S.diagonal()).tocsr()


def _both(name, S, b, **kw):
    """(port output, reference output) of solver ``name`` on scipy ``S``;
    a scipy matrix under an ``M``, ``M1`` or ``M2`` key becomes each
    package's own csr_array."""
    mk = {k: kw.pop(k) for k in ("M", "M1", "M2") if sp.issparse(kw.get(k))}
    ref = getattr(jlinalg, name)(sparse_tpu.csr_array(S), b, **kw,
                                 **{k: sparse_tpu.csr_array(v) for k, v in mk.items()})
    out = getattr(linalg, name)(st.csr_array(S), b, **kw,
                                **{k: st.csr_array(v) for k, v in mk.items()})
    return out, ref


def _close(x, xref, rtol):
    x, xref = np.asarray(x), np.asarray(xref)
    assert x.dtype == xref.dtype
    assert np.linalg.norm(x - xref) <= rtol * np.linalg.norm(xref)


# (solver, system, keyword arguments): every case in f64
PARITY = [
    ("cgs", "nonsym", dict(tol=1e-10)),
    ("cgs", "banded", dict(tol=1e-10)),
    ("bicg", "nonsym", dict(tol=1e-10)),
    ("bicg", "banded", dict(tol=1e-10)),
    ("bicg", "nonsym", dict(tol=1e-10, x0="x0")),
    ("bicgstab", "nonsym", dict(tol=1e-10)),
    ("bicgstab", "banded", dict(tol=1e-10)),
    ("gmres", "nonsym", dict(tol=1e-10, restart=10)),
    ("gmres", "banded", dict(tol=1e-10)),
    ("gmres", "banded", dict(tol=1e-10, x0="x0", M="jacobi")),
    ("gmres", "nonsym", dict(tol=1e-10, M="identity")),
    ("tfqmr", "nonsym", dict(tol=1e-10)),
    ("tfqmr", "banded", dict(tol=1e-10, M="jacobi")),
    ("qmr", "nonsym", dict(tol=1e-10)),
    ("qmr", "banded", dict(tol=1e-10, M1="jacobi")),
    ("minres", "indef", dict(tol=1e-10, maxiter=240)),
    ("minres", "spd", dict(tol=1e-10, M="jacobi", x0="x0")),
    ("minres", "indef", dict(tol=1e-10, shift=0.37, maxiter=360)),
    ("spsolve", "spd", dict(tol=1e-10)),
]


def _resolve(S, kw, dtype=np.float64):
    kw = dict(kw)
    n = S.shape[0]
    for key in ("M", "M1"):
        if kw.get(key) == "jacobi":
            kw[key] = _jacobi(S).astype(dtype)
    if kw.get("x0") == "x0":
        kw["x0"] = sample_vec(n, seed=5).astype(dtype)
    return kw


@pytest.mark.parametrize("name,system,kw", PARITY,
                         ids=[f"{s}-{m}-{'-'.join(k)}" for s, m, k in PARITY])
def test_solver_matches_reference_f64(name, system, kw):
    S = SYSTEMS[system]()
    b = sample_vec(S.shape[0], seed=3)
    identity = kw.get("M") == "identity"
    kw = _resolve(S, kw)
    if identity:
        n = S.shape[0]
        ref = jlinalg.gmres(sparse_tpu.csr_array(S), b,
                            **{**kw, "M": jlinalg.IdentityOperator((n, n), dtype=np.float64)})
        out = linalg.gmres(st.csr_array(S), b,
                           **{**kw, "M": linalg.IdentityOperator((n, n), dtype=torch.float64)})
    else:
        out, ref = _both(name, S, b, **kw)
    if name == "spsolve":
        _close(out, ref, 1e-9)
        return
    assert out[1] == ref[1] > 0
    _close(out[0], ref[0], 1e-9)
    # and it solves the system
    shift = kw.get("shift", 0.0)
    res = b - (S - shift * sp.identity(S.shape[0])) @ out[0].numpy()
    assert np.linalg.norm(res) <= 1e-6 * np.linalg.norm(b)


@pytest.mark.parametrize("name", ["cgs", "bicg", "bicgstab", "gmres", "tfqmr", "qmr"])
def test_solver_matches_reference_f32(name):
    S = convection_diffusion(12).astype(np.float32)
    b = sample_vec(S.shape[0], seed=4).astype(np.float32)
    out, ref = _both(name, S, b, tol=1e-4 * float(np.linalg.norm(b)), maxiter=300)
    assert out[0].dtype == torch.float32
    _close(out[0], ref[0], 1e-4)


@pytest.mark.parametrize("name,per_iteration", [
    ("cgs", False), ("bicg", False), ("bicgstab", False), ("gmres", False),
    ("tfqmr", True), ("qmr", True), ("minres", True),
])
def test_callback_cadence(name, per_iteration):
    """minres, tfqmr and qmr call back once per iteration with the iterate
    (an eager loop, equal bit for bit to the chunked one); cgs, bicg and
    bicgstab once, on the final x; gmres once per restart cycle: the
    reference's contracts."""
    S = SYSTEMS["indef" if name == "minres" else "nonsym"]()
    b = sample_vec(S.shape[0], seed=3)
    kw = dict(tol=1e-10, maxiter=240) if name == "minres" else dict(tol=1e-10)
    if name == "gmres":
        kw["restart"] = 3
    A = st.csr_array(S)
    seen = []
    x, iters = getattr(linalg, name)(A, b, callback=lambda xk: seen.append(xk.clone()), **kw)
    x_plain, iters_plain = getattr(linalg, name)(A, b, **kw)
    assert iters == iters_plain > 0 and torch.equal(x, x_plain)
    if per_iteration:
        assert len(seen) == iters
    elif name == "gmres":
        assert len(seen) == -(-iters // 3)
    else:
        assert len(seen) == 1
    assert torch.equal(seen[-1], x)


@pytest.mark.parametrize("name", ["cgs", "bicg", "bicgstab", "gmres", "tfqmr", "qmr", "minres"])
def test_zero_rhs(name):
    """b = 0: x = 0 with the reference's iteration count, and no NaN."""
    S = SYSTEMS["indef" if name == "minres" else "nonsym"]()
    b = np.zeros(S.shape[0])
    (x, iters), (xr, iters_r) = _both(name, S, b, tol=1e-8)
    assert iters == iters_r
    assert bool(torch.all(x == 0)) and np.all(np.asarray(xr) == 0)


def test_minres_indefinite_preconditioner_raises():
    S = _sym_indefinite(30, seed=5)
    n = S.shape[0]
    b = sample_vec(n, seed=6)
    neg = -sp.identity(n, format="csr")
    with pytest.raises(ValueError, match="indefinite"):
        jlinalg.minres(sparse_tpu.csr_array(S), b, M=sparse_tpu.csr_array(neg))
    with pytest.raises(ValueError, match="indefinite"):
        linalg.minres(st.csr_array(S), b, M=st.csr_array(neg))


def test_gmres_complex_operator_real_rhs():
    """tests/test_gmres_lsqr.py:149's case: a real b with a complex A makes
    the Krylov basis complex."""
    n = 40
    rng = np.random.default_rng(50)
    s = sample_csr(n, n, density=0.15, seed=51).astype(np.complex128)
    s.data = s.data * np.exp(1j * rng.uniform(0, 2 * np.pi, s.nnz))
    s = (s + n * sp.identity(n)).tocsr()
    b = np.ones(n)
    (x, iters), (xr, iters_r) = _both("gmres", s, b, tol=1e-10)
    assert x.dtype == torch.complex128 and iters == iters_r > 0
    _close(x, xr, 1e-9)
    assert np.linalg.norm(s @ x.numpy() - b) < 1e-6


def test_gmres_one_fetch_per_cycle():
    """tests/test_gmres_lsqr.py:101's bound: one host fetch per restart
    cycle with work, plus one for the converged-on-entry cycle."""
    n, restart = 80, 10
    s = (sample_csr(n, n, density=0.1, seed=40) + n * sp.identity(n)).tocsr()
    y = s @ sample_vec(n, seed=41)
    hostsync.HOST_SYNCS = 0
    x, iters = linalg.gmres(st.csr_array(s), y, restart=restart, tol=1e-10)
    assert iters > 0
    assert hostsync.HOST_SYNCS <= -(-iters // restart) + 1
    assert np.allclose(s @ x.numpy(), y, atol=1e-6)


def test_device_loop_freezes_past_the_stop():
    """Past the stop condition a chunk's iterations keep every tensor of
    the state, the counter included: the count and x do not depend on
    how many iterations a chunk runs."""
    S = _sym_indefinite(60, seed=0)
    b = sample_vec(60, seed=3)
    A = st.csr_array(S)
    old = hostsync.CHECK_EVERY
    try:
        outs = []
        for every in (1, 7, 64):
            hostsync.CHECK_EVERY = every
            hostsync.HOST_SYNCS = 0
            x, iters = linalg.minres(A, b, tol=1e-8, maxiter=240)
            # one fetch of ||b|| and b1sq before the loop, then one a chunk
            assert hostsync.HOST_SYNCS <= 1 + -(-iters // every) + 1
            outs.append((x, iters))
    finally:
        hostsync.CHECK_EVERY = old
    assert outs[0][1] == outs[1][1] == outs[2][1]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][0], outs[2][0])


def test_spsolve_banded_f32_takes_the_fused_cg():
    """spsolve is cg: on a banded f32 operator it runs the fused CG (here
    its kernels' plain versions, under fused_cg='force')."""
    from sparse_tpu_torch.kernels import cg_dia

    nx = 12
    S = (convection_diffusion(nx, 0.0)).astype(np.float32)
    b = sample_vec(nx * nx, seed=7).astype(np.float32)
    old = st.settings.fused_cg
    st.settings.fused_cg = "force"
    calls = []
    real = cg_dia.cg_dia_fused

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    try:
        cg_dia.cg_dia_fused = spy
        x = linalg.spsolve(st.csr_array(S), b, tol=1e-5)
    finally:
        cg_dia.cg_dia_fused = real
        st.settings.fused_cg = old
    assert calls
    assert np.linalg.norm(S @ x.numpy() - b) < 1e-4 * np.linalg.norm(b) * 10
