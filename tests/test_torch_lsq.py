"""sparse_tpu_torch's lsqr, lsmr, lgmres and gcrotmk against sparse_tpu's,
on the CPU (tests/test_torch_solvers.py has the other solvers).

f64 throughout: x to 1e-9 relative with equal iteration counts, and every
scalar of the lsqr 10-tuple and the lsmr 8-tuple to 1e-8 relative. The
scalar tuples are compared on solves that stop before rounding takes
over: past that point (the 40-column system has exhausted its Krylov
space by iteration ~10), x, anorm, arnorm and their kin follow rounding
noise in either package, and a 1e-15 change of b moves them by 1e-4 or
more in the reference alone.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu
from sparse_tpu import linalg as jlinalg

import sparse_tpu_torch as st
from sparse_tpu_torch import hostsync, linalg

from .test_laplaciannd_lgmres import _nonsym as _lgmres_system
from .test_solvers_extra import _nonsym
from .test_torch_solvers import convection_diffusion
from .utils.sample import sample_csr, sample_vec


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


SYSTEMS = {
    "nonsym": lambda: _nonsym(80, seed=1),
    "banded": lambda: convection_diffusion(10),
    "rect": lambda: sample_csr(90, 40, density=0.2, seed=30).tocsr(),
}


def _both(name, S, b, **kw):
    ref = getattr(jlinalg, name)(sparse_tpu.csr_array(S), b, **kw)
    out = getattr(linalg, name)(st.csr_array(S), b, **kw)
    return out, ref


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
@pytest.mark.parametrize("system,kw", [
    ("nonsym", {}),
    ("banded", dict(limit=30)),
    ("rect", dict(limit=6)),
    ("rect", dict(limit=6, damp=0.5)),
], ids=["nonsym", "banded-30", "rect-6", "rect-6-damped"])
def test_tuple_matches_reference(name, system, kw):
    S = SYSTEMS[system]()
    b = sample_vec(S.shape[0], seed=2)
    kw = dict(kw)
    if "limit" in kw:
        kw["iter_lim" if name == "lsqr" else "maxiter"] = kw.pop("limit")
    out, ref = _both(name, S, b, **kw)
    assert len(out) == len(ref) == (10 if name == "lsqr" else 8)
    assert out[1:3] == ref[1:3] and out[2] > 0
    assert _rel(out[0], ref[0]) <= 1e-9
    for got, want in zip(out[3:10 if name == "lsqr" else 8], ref[3:]):
        if name == "lsqr" and isinstance(got, torch.Tensor):  # var
            continue
        assert isinstance(got, float)
        assert got == pytest.approx(float(want), rel=1e-8, abs=1e-300)


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
def test_converged_least_squares_matches_reference(name):
    """tests/test_gmres_lsqr.py:65's overdetermined system solved to
    atol = btol = 1e-12: the minimizer to 1e-9, the stop reason equal."""
    S = SYSTEMS["rect"]()
    b = sample_vec(90, seed=31)
    out, ref = _both(name, S, b, atol=1e-12, btol=1e-12)
    assert out[1] == ref[1]
    assert _rel(out[0], ref[0]) <= 1e-9


def test_lsqr_calc_var():
    S = SYSTEMS["rect"]()
    b = sample_vec(90, seed=31)
    out, ref = _both("lsqr", S, b, iter_lim=6, calc_var=True)
    assert out[9].shape == (40,) and bool(torch.any(out[9] != 0))
    assert _rel(out[9], ref[9]) <= 1e-9


def test_lsmr_warm_start():
    S = SYSTEMS["banded"]()
    b = sample_vec(100, seed=2)
    x0 = sample_vec(100, seed=9)
    out, ref = _both("lsmr", S, b, x0=x0, maxiter=30)
    assert out[1:3] == ref[1:3]
    assert _rel(out[0], ref[0]) <= 1e-9
    for got, want in zip(out[3:], ref[3:]):
        assert got == pytest.approx(float(want), rel=1e-8)


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
def test_zero_rhs(name):
    S = SYSTEMS["nonsym"]()
    out, ref = _both(name, S, np.zeros(80))
    assert bool(torch.all(out[0] == 0))
    assert tuple(out[1:3]) == tuple(ref[1:3]) == (0, 0)
    assert [float(v) for v in out[3:9 if name == "lsqr" else 8]] == \
        [float(v) for v in ref[3:9 if name == "lsqr" else 8]]


def test_lsqr_complex_operator_real_rhs():
    """tests/test_gmres_lsqr.py:166's case."""
    n = 30
    rng = np.random.default_rng(52)
    s = sample_csr(n, n, density=0.2, seed=53).astype(np.complex128)
    s.data = s.data * np.exp(1j * rng.uniform(0, 2 * np.pi, s.nnz))
    s = (s + n * sp.identity(n)).tocsr()
    b = np.ones(n)
    out, ref = _both("lsqr", s, b, atol=1e-10, btol=1e-10)
    assert out[0].dtype == torch.complex128 and out[1:3] == ref[1:3]
    assert _rel(out[0], ref[0]) <= 1e-9
    assert np.linalg.norm(s @ out[0].numpy() - b) < 1e-5


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
def test_fetches_per_check(name):
    """One host fetch before each chunk of CHECK_EVERY iterations and one
    that ends the loop: at most ceil(itn / CHECK_EVERY) + 1 (a torch loop
    cannot stop on the device, so the reference's single fetch becomes one
    a chunk)."""
    m, n = 80, 50
    s = sample_csr(m, n, density=0.2, seed=42)
    y = sample_vec(m, seed=43)
    old = hostsync.CHECK_EVERY
    try:
        for every in (4, 32):
            hostsync.CHECK_EVERY = every
            hostsync.HOST_SYNCS = 0
            out = getattr(linalg, name)(st.csr_array(s), y)
            assert out[2] > every
            assert hostsync.HOST_SYNCS <= -(-out[2] // every) + 1
    finally:
        hostsync.CHECK_EVERY = old


@pytest.mark.parametrize("name,system,kw", [
    ("lgmres", "lgmres", dict(inner_m=15)),
    ("gcrotmk", "lgmres", dict(m=15, k=5)),
    ("lgmres", "banded", dict(inner_m=5, outer_k=2, x0="x0", M="jacobi")),
    ("gcrotmk", "banded", dict(m=5, k=2, truncate="oldest")),
    ("gcrotmk", "banded", dict(m=5, k=2, truncate="smallest")),
], ids=["lgmres", "gcrotmk", "lgmres-x0-M", "gcrotmk-oldest", "gcrotmk-smallest"])
def test_augmented_matches_reference(name, system, kw):
    """tests/test_laplaciannd_lgmres.py:59's system, and the banded one
    with short cycles, so the recycled space fills and is truncated;
    ``callback`` once an outer cycle."""
    S = _lgmres_system(120, seed=40) if system == "lgmres" else SYSTEMS[system]()
    n = S.shape[0]
    b = S @ sample_vec(n, seed=41)
    kw = dict(kw)
    ref_kw, out_kw = dict(kw), dict(kw)
    if kw.get("x0") == "x0":
        ref_kw["x0"] = out_kw["x0"] = sample_vec(n, seed=5)
    if kw.get("M") == "jacobi":
        J = sp.diags(1.0 / S.diagonal()).tocsr()
        ref_kw["M"], out_kw["M"] = sparse_tpu.csr_array(J), st.csr_array(J)
    seen = []
    x, info = getattr(linalg, name)(st.csr_array(S), b, tol=1e-10, callback=seen.append, **out_kw)
    xr, info_r = getattr(jlinalg, name)(sparse_tpu.csr_array(S), b, tol=1e-10, **ref_kw)
    assert info == info_r == 0 and seen
    assert _rel(x, xr) <= 1e-9
    assert np.linalg.norm(S @ x.numpy() - b) <= 1e-9 * np.linalg.norm(b)


def test_gcrotmk_rejects_bad_truncate():
    S = SYSTEMS["nonsym"]()
    with pytest.raises(ValueError, match="truncate"):
        linalg.gcrotmk(st.csr_array(S), np.ones(80), truncate="newest")


def test_lstsq_cuts_like_the_reference():
    """The minimum-norm y of a rank-deficient block: the reduced QR plus a
    host SVD cut at eps * max(n, K) * sigma_max equals jnp.linalg.lstsq."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    AZ = rng.standard_normal((200, 6))
    AZ[:, 4] = AZ[:, 0] + AZ[:, 1]  # rank 5
    AZ[:, 5] = 1e-17 * rng.standard_normal(200)  # below the cut
    r = rng.standard_normal(200)
    y = linalg._lstsq_min_norm(torch.from_numpy(AZ), torch.from_numpy(r)).numpy()
    want = np.asarray(jnp.linalg.lstsq(jnp.asarray(AZ), jnp.asarray(r))[0])
    np.testing.assert_allclose(y, want, rtol=1e-9, atol=1e-12)
