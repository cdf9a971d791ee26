"""sparse_tpu_torch.csgraph against sparse_tpu.csgraph on the CPU (mirrors
tests/test_csgraph.py).

Every entry of ``csgraph.__all__`` runs on the same seeded scipy graphs in
both packages. The relaxations take the same sweeps over the same edges
with order-independent min/max reductions, and the host algorithms are the
same numpy code, so labels, distances, predecessors, orders, trees, flows
and matchings are equal, ``assert_array_equal``; the Laplacians (one
product of three factors a stored entry) agree to 1e-15 relative.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu
from sparse_tpu import csgraph as jcg

import sparse_tpu_torch as st
from sparse_tpu_torch import csgraph as cg
from sparse_tpu_torch import hostsync

from .test_csgraph import _rand_graph


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


def _host(x):
    """A comparable host form of a csgraph result."""
    if isinstance(x, (tuple, list)):
        return [_host(v) for v in x]
    if isinstance(x, (cg.MaximumFlowResult, jcg.MaximumFlowResult)):
        return [x.flow_value, _host(x.flow)]
    if isinstance(x, np.ma.MaskedArray):
        return [np.asarray(x.data), np.ma.getmaskarray(x)]
    if hasattr(x, "toarray"):
        x = x.toarray()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _equal(a, b):
    a, b = _host(a), _host(b)
    if isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
        return
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _both(fn, G, *args, **kw):
    """``fn`` of each package on its own array of the scipy graph ``G``."""
    return (getattr(cg, fn)(st.csr_array(G), *args, **kw),
            getattr(jcg, fn)(sparse_tpu.csr_array(G), *args, **kw))


def _path_graph(n):
    return sp.diags([np.ones(n - 1)], [1], shape=(n, n), format="csr")


def _flow_graph():
    rng = np.random.default_rng(11)
    G = sp.random(12, 12, 0.3, random_state=rng, format="csr")
    G.setdiag(0)
    G.eliminate_zeros()
    G.data = rng.integers(1, 9, G.nnz).astype(np.int64)
    return G


CASES = {
    "bellman_ford": [
        (_rand_graph(directed=True), dict(return_predecessors=True)),
        (_rand_graph(directed=False), dict(directed=False, return_predecessors=True)),
        (_rand_graph(seed=7, negative=True), dict(indices=[0, 3], return_predecessors=True)),
        (_rand_graph(seed=8), dict(indices=2, unweighted=True)),
    ],
    "dijkstra": [
        (_rand_graph(seed=2), dict(indices=0, return_predecessors=True)),
        (_rand_graph(seed=2, directed=False), dict(directed=False)),
        (_rand_graph(seed=3), dict(indices=[1, 4], min_only=True, return_predecessors=True)),
        (_rand_graph(seed=4), dict(limit=1.5, return_predecessors=True)),
        (_rand_graph(seed=5), dict(unweighted=True, indices=[0, 9])),
    ],
    "floyd_warshall": [(_rand_graph(n=18, seed=3), dict(return_predecessors=True)),
                       (_rand_graph(n=12, seed=9), dict(directed=False))],
    "johnson": [(_rand_graph(seed=7, negative=True), dict(return_predecessors=True))],
    "shortest_path": [(_rand_graph(n=15, seed=4), dict(method=m)) for m in
                      ("auto", "FW", "BF", "D", "J")]
                     + [(_rand_graph(n=15, seed=4), dict(indices=0)),
                        (_rand_graph(n=15, seed=4), dict(method="FW", indices=[1, 2],
                                                         return_predecessors=True))],
    "connected_components": [
        (sp.block_diag([sp.random(6, 6, 0.6, random_state=np.random.default_rng(5))
                        + sp.identity(6) for _ in range(3)], format="csr"), {}),
        (_rand_graph(n=30, density=0.04, seed=12), dict(directed=False)),
    ],
    "breadth_first_order": [(_rand_graph(n=20, seed=6, directed=False), dict(i_start=0,
                                                                             directed=False)),
                            (_rand_graph(n=20, seed=6), dict(i_start=3))],
    "breadth_first_tree": [(_rand_graph(n=20, seed=6, directed=False), dict(i_start=0,
                                                                            directed=False))],
    "depth_first_order": [(_rand_graph(n=15, seed=7, directed=False), dict(i_start=0,
                                                                           directed=False))],
    "depth_first_tree": [(_rand_graph(n=15, seed=7), dict(i_start=1))],
    "minimum_spanning_tree": [(_rand_graph(n=16, seed=10, directed=False), {})],
    "reverse_cuthill_mckee": [(_rand_graph(n=30, density=0.1, seed=13, directed=False), {})],
    "structural_rank": [(_rand_graph(n=14, density=0.12, seed=14), {})],
    "maximum_bipartite_matching": [(_rand_graph(n=14, density=0.15, seed=15), {}),
                                   (_rand_graph(n=14, density=0.15, seed=15),
                                    dict(perm_type="column"))],
    "maximum_flow": [(_flow_graph(), dict(source=0, sink=11)),
                     (_flow_graph(), dict(source=2, sink=7, method="edmonds_karp"))],
    "min_weight_full_bipartite_matching": [
        (sp.csr_matrix(np.random.default_rng(16).uniform(1, 5, (5, 7))), {}),
        (sp.csr_matrix(np.random.default_rng(17).uniform(1, 5, (6, 4))), dict(maximize=True)),
    ],
    "yen": [(_rand_graph(n=12, density=0.35, seed=18), dict(source=0, sink=7, K=4,
                                                          return_predecessors=True))],
    "csgraph_to_dense": [(_rand_graph(n=9, seed=19), dict(null_value=np.inf))],
    "csgraph_to_masked": [(_rand_graph(n=9, seed=19), {})],
}


@pytest.mark.parametrize("fn,case", [(fn, i) for fn, cases in CASES.items()
                                      for i in range(len(cases))])
def test_graph_entry_equals_reference(fn, case):
    G, kw = CASES[fn][case]
    _equal(*_both(fn, G, **kw))


def test_dense_and_masked_constructors_and_paths():
    G = _rand_graph(n=10, seed=20)
    D = G.toarray()
    D[2, 3] = np.inf
    D[4, 5] = np.nan
    for fn, kw in (("csgraph_from_dense", {}), ("csgraph_from_dense", dict(null_value=None)),
                   ("csgraph_masked_from_dense", dict(null_value=0))):
        _equal(getattr(cg, fn)(D, **kw), getattr(jcg, fn)(D, **kw))
    M = jcg.csgraph_masked_from_dense(G.toarray())
    _equal(cg.csgraph_from_masked(M), jcg.csgraph_from_masked(M))
    d, pred = jcg.floyd_warshall(sparse_tpu.csr_array(G), return_predecessors=True)
    _equal(*_both("construct_dist_matrix", G, pred))
    _, p0 = jcg.dijkstra(sparse_tpu.csr_array(G), indices=0, return_predecessors=True)
    _equal(*_both("reconstruct_path", G, p0))


@pytest.mark.parametrize("kw", [{}, dict(normed=True), dict(return_diag=True),
                                dict(normed=True, return_diag=True, use_out_degree=True),
                                dict(symmetrized=True, dtype=np.float32)])
def test_laplacian(kw):
    L, Lj = _both("laplacian", _rand_graph(n=14, seed=21), **kw)
    L, Lj = _host(L), _host(Lj)
    if not isinstance(Lj, list):
        L, Lj = [L], [Lj]
    for a, b in zip(L, Lj):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-15 if a.dtype == np.float64 else 1e-7)


@pytest.mark.parametrize("kind", ["scipy", "dense"])
def test_host_graph_inputs(kind):
    """scipy and dense numpy graphs: the relaxations upload their edges to
    settings.device; results equal the reference's."""
    G = _rand_graph(n=20, seed=22, directed=False)
    g = G if kind == "scipy" else G.toarray()
    for fn, kw in (("bellman_ford", dict(return_predecessors=True)),
                   ("dijkstra", dict(indices=[0, 3])), ("connected_components", {}),
                   ("floyd_warshall", {}), ("laplacian", dict(normed=True))):
        out, ref = getattr(cg, fn)(g, **kw), getattr(jcg, fn)(g, **kw)
        if fn == "laplacian":
            np.testing.assert_allclose(_host(out), _host(ref), rtol=1e-15)
        else:
            _equal(out, ref)


def test_negative_cycles_and_bad_weights_raise():
    C = sp.csr_matrix(np.array([[0, 1.0, 0], [0, 0, 1.0], [-3.0, 0, 0]]))
    with pytest.raises(cg.NegativeCycleError):
        cg.bellman_ford(st.csr_array(C))
    with pytest.raises(cg.NegativeCycleError):
        cg.floyd_warshall(st.csr_array(C))
    with pytest.raises(ValueError, match="non-negative"):
        cg.dijkstra(st.csr_array(sp.csr_matrix(np.array([[0, -1.0], [0, 0]]))))
    with pytest.raises(NotImplementedError):
        cg.connected_components(st.csr_array(C), connection="strong")
    assert sorted(cg.__all__) == sorted(jcg.__all__)


def test_dijkstra_high_diameter_falls_back_to_the_host_heap():
    """A 100-vertex path needs 99 sweeps, past the 64-sweep bound: both
    packages warn and take the host heap, with equal results."""
    G = _path_graph(100)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        d, p = cg.dijkstra(st.csr_array(G), indices=0, return_predecessors=True)
    assert any("host binary-heap" in str(r.message) for r in rec)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dj, pj = jcg.dijkstra(sparse_tpu.csr_array(G), indices=0, return_predecessors=True)
    np.testing.assert_array_equal(d, dj)
    np.testing.assert_array_equal(p, pj)
    np.testing.assert_array_equal(d, np.arange(100.0))


def test_grid_closed_forms_repeat_and_count_fetches():
    """The chip's grid check at 30^2: breadth-first order and the corner
    distances are |di| + |dj|, two components with the middle column's
    edges cut, a repeat bit for bit, and one fetch a device_while chunk
    plus the results'."""
    n = 30
    e = np.ones(n * n - 1)
    e[n - 1::n] = 0
    G = sp.diags([e, np.ones(n * n - n)], [1, n], shape=(n * n, n * n), format="csr")
    G = (G + G.T).tocsr()
    G.eliminate_zeros()
    A = st.csr_array(G)
    ii, jj = np.divmod(np.arange(n * n), n)
    corners = [0, n - 1, n * n - n, n * n - 1]
    hostsync.HOST_SYNCS = 0
    d = cg.dijkstra(A, indices=corners)
    sweeps = 2 * (n - 1) + 1
    assert hostsync.HOST_SYNCS == 1 + -(-sweeps // hostsync.CHECK_EVERY) + 1 + 1
    want = np.stack([np.abs(ii - ii[c]) + np.abs(jj - jj[c]) for c in corners]).astype(float)
    np.testing.assert_array_equal(d, want)
    np.testing.assert_array_equal(cg.dijkstra(A, indices=corners), d)
    order, pred = cg.breadth_first_order(A, 0, directed=False)
    np.testing.assert_array_equal(np.sort(want[0][order]), want[0][order])
    assert cg.connected_components(A)[0] == 1
    cut = G.tolil()
    for i in range(n):
        cut[i * n + n // 2 - 1, i * n + n // 2] = cut[i * n + n // 2, i * n + n // 2 - 1] = 0
    ncomp, labels = cg.connected_components(st.csr_array(cut.tocsr()))
    assert ncomp == 2 and (labels == (jj >= n // 2)).all()
