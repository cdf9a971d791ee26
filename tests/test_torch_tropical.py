"""The tropical SpMV and the MIS of sparse_tpu_torch against sparse_tpu,
on the CPU.

The tournament is integer (or exact float) comparison only, and both
packages draw the MIS priorities with numpy's ``default_rng(seed)``, so
every result must be exactly equal: the tuples, the MIS flags and the
aggregation columns. The MIS loop runs chunks of rounds between host
fetches (``hostsync.device_while``); the chunk length must not change
the flags.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_tpu

import sparse_tpu_torch as st
from sparse_tpu_torch import hostsync

from .utils.sample import sample_csr


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


def _both(a):
    a = a.tocsr()
    return (sparse_tpu.csr_array((a.data, a.indices, a.indptr), shape=a.shape),
            st.csr_array((a.data, a.indices, a.indptr), shape=a.shape))


def _sym_graph(n, density, seed):
    """A symmetric pattern with self-loops: the MIS strength graph's shape."""
    s = sample_csr(n, n, density=density, seed=seed)
    a = (s + s.T + sp.identity(n)).tocsr()
    a.data[:] = 1.0
    return a


def _grid(n):
    """The n*n 5-point Laplacian's pattern (chip_smoke's MIS graph, small)."""
    l1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    return (sp.kron(l1, sp.identity(n)) + sp.kron(sp.identity(n), l1)).tocsr()


@pytest.mark.parametrize("case", ["random", "ties", "empty_rows", "ints"])
def test_tropical_spmv(case):
    rng = np.random.default_rng(4)
    if case == "random":
        s, x = sample_csr(20, 20, density=0.25, seed=110), rng.integers(0, 8, (20, 3)) * 1.0
    elif case == "ties":
        s = sp.csr_matrix(np.array([[1.0, 1.0, 1.0], [0, 1.0, 1.0], [0, 0, 1.0]]))
        x = np.array([[2.0, 5.0, 0.0], [2.0, 5.0, 1.0], [2.0, 4.0, 9.0]])
    elif case == "empty_rows":
        s = sp.csr_matrix((np.ones(2), np.array([0, 2]), np.array([0, 1, 1, 2])), shape=(3, 3))
        x = np.arange(9.0).reshape(3, 3)
    else:
        s = sample_csr(30, 17, density=0.2, seed=111)
        x = rng.integers(-5, 5, (17, 2)).astype(np.int32)
    j, t = _both(s)
    got = t.tropical_spmv(x)
    assert got.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(got.numpy(), np.asarray(j.tropical_spmv(x)))


@pytest.mark.parametrize("graph,k,seed", [("sym", 1, 0), ("sym", 2, 3), ("sym", 1, 5),
                                          ("grid", 1, 0), ("grid", 2, 1)])
def test_mis_flags_equal(graph, k, seed):
    a = _sym_graph(60, 0.08, 200 + seed) if graph == "sym" else _grid(9)
    j, t = _both(a)
    flags = t.mis_tropical(k=k, seed=seed)
    assert flags.dtype == torch.int32
    assert np.array_equal(flags.numpy(), np.asarray(j.mis_tropical(k=k, seed=seed)))
    if k == 1:  # an independent set, and maximal
        member = flags.numpy() == 2
        adj = a.copy()
        adj.setdiag(0)
        adj.eliminate_zeros()
        assert not (adj[member][:, member]).nnz
        assert (adj[~member][:, member].getnnz(axis=1) > 0).all()


def test_mis_invalid_nodes_and_aggregation():
    a = _sym_graph(50, 0.08, 11)
    j, t = _both(a)
    invalid = np.zeros(50, bool)
    invalid[:10] = True
    flags = t.mis_tropical(k=1, invalid=invalid)
    assert (flags[:10] == -1).all()
    assert np.array_equal(flags.numpy(), np.asarray(j.mis_tropical(k=1, invalid=invalid)))
    flags2 = t.mis_tropical(k=2)
    cols, n_coarse = t.mis_aggregate_cols(flags2)
    ref_cols, ref_n = j.mis_aggregate_cols(np.asarray(j.mis_tropical(k=2)))
    assert np.array_equal(cols.numpy(), np.asarray(ref_cols))
    assert int(n_coarse) == int(ref_n) == int((flags2 == 2).sum())


@pytest.mark.parametrize("every", [1, 3, 64])
def test_mis_chunk_length_does_not_change_flags(every, monkeypatch):
    """Rounds past the stop are frozen: the flags do not depend on how many
    rounds a chunk runs, and each chunk costs one counted fetch."""
    a = _sym_graph(80, 0.06, 9)
    _, t = _both(a)
    want = t.mis_tropical(k=1, seed=2)
    monkeypatch.setattr(hostsync, "CHECK_EVERY", every)
    hostsync.HOST_SYNCS = 0
    got = t.mis_tropical(k=1, seed=2)
    assert torch.equal(got, want)
    assert hostsync.HOST_SYNCS >= 2


def test_mis_stall_fails_loud():
    """Without self-loops no node can win its own neighbourhood: the loop
    ends on the first round with no progress and raises."""
    _, t = _both(sp.csr_matrix((np.ones(2), np.array([1, 0]), np.array([0, 1, 2])), shape=(2, 2)))
    with pytest.raises(RuntimeError, match="no progress"):
        t.mis_tropical(k=1)
