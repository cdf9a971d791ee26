"""sparse_tpu_torch.quantum against sparse_tpu.quantum on the CPU (mirrors
tests/test_quantum.py).

Independent sets and Hamiltonians are integers, so both packages' sets,
independence polynomials and Hamiltonians are equal exactly, and the
port's native and numpy level expansions are equal exactly. A cycle-10
evolution under y' = -i H y (DOP853, complex128) agrees within the
integrate parity bounds (tests/test_torch_integrate.py: 1e-7 in t, 1e-8 in
y) and keeps the norm to 1e-7.
"""

import networkx as nx
import numpy as np
import pytest
import torch

from sparse_tpu import integrate as jintegrate
from sparse_tpu import quantum as jquantum

import sparse_tpu_torch as st
from sparse_tpu_torch import integrate, native, quantum

from .test_quantum import GRAPHS


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


@pytest.mark.parametrize("graph", GRAPHS + [nx.cycle_graph(12), nx.erdos_renyi_graph(70, 0.9,
                                                                                      seed=4)])
def test_sets_and_polynomial_equal_reference(graph, monkeypatch):
    n = graph.number_of_nodes()
    assert quantum.independence_polynomial(graph) == jquantum.independence_polynomial(graph)
    native_on = native.lib() is not None
    sets = queues = jsets = jqueues = None
    for k in range(1, n + 1):
        sets, queues = quantum.enumerate_independent_sets(graph, k, sets, queues)
        jsets, jqueues = jquantum.enumerate_independent_sets(graph, k, jsets, jqueues)
        np.testing.assert_array_equal(sets, jsets)
        np.testing.assert_array_equal(queues, jqueues)
        if native_on and k > 1:  # the numpy expansion gives the same level
            comp = quantum._comp_gt_masks(quantum._adjacency(graph))
            prev = quantum.enumerate_independent_sets(graph, k - 1)
            plain = quantum._expand_level(*prev, comp, n, native=False)
            nat = quantum._expand_level(*prev, comp, n, native=True)
            for a, b in zip(plain, nat):
                np.testing.assert_array_equal(a, b)
        if sets.shape[0] == 0 or quantum.popcount(queues).sum() == 0:
            break


@pytest.mark.parametrize("graph", [nx.cycle_graph(7), nx.erdos_renyi_graph(9, 0.35, seed=1),
                                   nx.path_graph(6), nx.erdos_renyi_graph(70, 0.9, seed=4)])
def test_hamiltonians_equal_reference(graph):
    """The last graph's 70 nodes take two words a set: the subset lookup's
    structured search (one word searches the words themselves)."""
    drv = quantum.HamiltonianDriver(graph=graph, dtype=np.complex128)
    jdrv = jquantum.HamiltonianDriver(graph=graph, dtype=np.complex128)
    assert drv.ip == jdrv.ip and drv.nstates == jdrv.nstates
    H = drv.hamiltonian
    assert H.dtype == torch.complex128
    np.testing.assert_array_equal(H.toarray().numpy(), np.asarray(jdrv.hamiltonian.toarray()))
    np.testing.assert_array_equal(H.indptr.numpy(), np.asarray(jdrv.hamiltonian.indptr))
    np.testing.assert_array_equal(H.indices.numpy(), np.asarray(jdrv.hamiltonian.indices))
    mis = quantum.HamiltonianMIS(graph=graph, poly=drv.ip, energies=(2.0, 1.0))
    jmis = jquantum.HamiltonianMIS(graph=graph, poly=jdrv.ip, energies=(2.0, 1.0))
    np.testing.assert_array_equal(mis.hamiltonian.toarray().numpy(),
                                  np.asarray(jmis.hamiltonian.toarray()))
    assert mis.optimum == jmis.optimum and mis.minimum_energy == jmis.minimum_energy
    state = np.random.default_rng(3).standard_normal(drv.nstates) + 0j
    state /= np.linalg.norm(state)
    for fn in ("cost_function", "optimum_overlap", "approximation_ratio"):
        assert getattr(mis, fn)(torch.tensor(state)) == getattr(jmis, fn)(state)
    scaled = quantum.HamiltonianDriver(energies=(3.0,), graph=graph)
    np.testing.assert_array_equal(scaled.hamiltonian.toarray().numpy(),
                                  3.0 * drv.hamiltonian.toarray().numpy().astype(np.complex64))


def test_distributed_paths_raise_naming_the_roadmap_item():
    for kw in (dict(mesh=object()), dict(dist_shards=4)):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            quantum.HamiltonianDriver(graph=nx.cycle_graph(4), **kw)


def test_cycle10_evolution_equals_reference():
    g = nx.cycle_graph(10)
    drv = quantum.HamiltonianDriver(graph=g, dtype=np.complex128)
    jdrv = jquantum.HamiltonianDriver(graph=g, dtype=np.complex128)
    mis = quantum.HamiltonianMIS(graph=g, poly=drv.ip, dtype=np.complex128)
    jmis = jquantum.HamiltonianMIS(graph=g, poly=jdrv.ip, dtype=np.complex128)
    H, C = drv.hamiltonian, mis.hamiltonian
    Hj, Cj = jdrv.hamiltonian, jmis.hamiltonian
    y0 = np.zeros(drv.nstates, dtype=np.complex128)
    y0[-1] = 1.0
    kw = dict(method="DOP853", rtol=1e-9, atol=1e-11)
    out = integrate.solve_ivp(lambda t, y: -1j * (t * (C @ y) + (1 - t) * (H @ y)), (0, 1.0),
                              y0, **kw)
    ref = jintegrate.solve_ivp(lambda t, y: -1j * (t * (Cj @ y) + (1 - t) * (Hj @ y)),
                               (0, 1.0), y0, **kw)
    assert out.nfev == ref.nfev and out.t.shape == ref.t.shape
    np.testing.assert_allclose(out.t, ref.t, rtol=1e-7)
    y, yr = out.y.numpy(), np.asarray(ref.y)
    np.testing.assert_allclose(y, yr, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.linalg.norm(y, axis=0), 1.0, rtol=1e-7)
    final = y[:, -1]
    assert abs(mis.optimum_overlap(final) - jmis.optimum_overlap(yr[:, -1])) <= 1e-8
