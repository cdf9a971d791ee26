"""Rydberg-atom MIS Hamiltonians (``sparse_tpu/quantum.py``).

The independent sets of the graph are enumerated level by level with a
bitset BFS on the host (sets are [S, W] uint64 words; one level's
expansion is a nonzero, two gathers and a bitwise and, or the native
``ind_sets_expand`` of ``csrc/host_native.cc``). The transition
Hamiltonian (``HamiltonianDriver``) links each size-k set to its k
subsets of size k - 1 and is assembled as U + U^T through the COO -> CSR
sort on ``settings.device`` (or ``device=``); the MIS cost Hamiltonian is
diagonal. Sets and Hamiltonians
are integers, so they equal the reference's exactly. The evolution
y' = -i H y runs through ``sparse_tpu_torch.integrate.solve_ivp``.
"""

from __future__ import annotations

import numpy as np

from .csr import csr_array
from .utils import host_array


def _not_distributed(what: str):
    raise NotImplementedError(
        f"{what} needs the distributed package, which is not ported to sparse_tpu_torch yet "
        "(ROADMAP queue 1 item 8)")


# ---------------------------------------------------------------------------
# Bitset helpers (the IntSet<N, T> analog)
# ---------------------------------------------------------------------------
def _num_words(n: int) -> int:
    return max((n + 63) // 64, 1)


def _bit_planes(n: int):
    """[n, W] uint64: row u has only bit u set."""
    W = _num_words(n)
    out = np.zeros((n, W), dtype=np.uint64)
    u = np.arange(n)
    out[u, u // 64] = np.uint64(1) << (u % 64).astype(np.uint64)
    return out


def _bits_to_bool(sets: np.ndarray, n: int) -> np.ndarray:
    """[S, W] uint64 -> [S, n] bool membership matrix."""
    S, W = sets.shape
    shifts = np.arange(64, dtype=np.uint64)
    expanded = (sets[:, :, None] >> shifts[None, None, :]) & np.uint64(1)
    return expanded.reshape(S, W * 64)[:, :n].astype(bool)


def popcount(sets: np.ndarray) -> np.ndarray:
    """Per-set cardinality."""
    return np.bitwise_count(sets).sum(axis=1).astype(np.int64)


def _adjacency(graph) -> np.ndarray:
    """Accept an nx.Graph or a dense 0/1 adjacency matrix."""
    if hasattr(graph, "number_of_nodes"):
        import networkx as nx

        return np.asarray(nx.to_numpy_array(graph)) != 0
    a = np.asarray(graph) != 0
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError("adjacency matrix must be square")
    return a


def _comp_gt_masks(adj: np.ndarray) -> np.ndarray:
    """[n, W]: row u = bitmask of {v : v > u, (u,v) not an edge}, the
    candidate-extension sets in the complement graph."""
    n = adj.shape[0]
    comp = ~adj
    np.fill_diagonal(comp, False)
    gt = np.triu(np.ones((n, n), dtype=bool), k=1)
    allowed = comp & gt  # [n, n] bool
    W = _num_words(n)
    out = np.zeros((n, W), dtype=np.uint64)
    planes = _bit_planes(n)  # [n, W]
    # bit planes are disjoint single-bit rows, so integer sum == bitwise OR
    for w in range(W):
        out[:, w] = allowed.astype(np.uint64) @ planes[:, w]
    return out


# ---------------------------------------------------------------------------
# Level-by-level enumeration
# ---------------------------------------------------------------------------
def enumerate_independent_sets(
    graph, k: int, prev_sets=None, prev_queues=None, comp_gt=None
):
    """All independent sets of size k, given the size-(k-1) level.

    Returns (sets [S_k, W] uint64, queues [S_k, W] uint64), expanded in
    (parent, extension-node) order, the reference's, so state indices line
    up. Level-driving callers pass the precomputed ``comp_gt`` masks so the
    O(n^2) complement-graph build runs once, not once per level.
    """
    from . import native as _native

    native = _native.lib() is not None
    if k <= 0:
        raise ValueError("k must be positive")
    if comp_gt is None:
        adj = _adjacency(graph)
        n = adj.shape[0]
        comp_gt = _comp_gt_masks(adj)
    else:
        n = comp_gt.shape[0]
    if k == 1:
        return _bit_planes(n), comp_gt.copy()
    if prev_sets is None:
        sets, queues = _bit_planes(n), comp_gt.copy()
        for kk in range(2, k + 1):
            sets, queues = _expand_level(sets, queues, comp_gt, n, native)
        return sets, queues
    return _expand_level(prev_sets, prev_queues, comp_gt, n, native)


def _expand_level(sets, queues, comp_gt, n, native=False):
    if native:
        from . import native as _native

        out = _native.expand_level(sets, queues, comp_gt, n)
        if out is not None:
            return out
    B = _bits_to_bool(queues, n)  # [S, n] candidate-extension membership
    i_idx, u_idx = np.nonzero(B)  # row-major: parent order, then node order
    planes = _bit_planes(n)
    new_sets = sets[i_idx] | planes[u_idx]
    new_queues = queues[i_idx] & comp_gt[u_idx]
    return new_sets, new_queues


def sets_to_sizes(queues, graph=None) -> np.ndarray:
    return popcount(queues)


def independence_polynomial(graph):
    """[#independent sets of size k for k = 0..]."""
    adj = _adjacency(graph)
    n = adj.shape[0]
    comp_gt = _comp_gt_masks(adj)
    ip = [1]
    sets = queues = None
    for k in range(1, n + 1):
        sets, queues = enumerate_independent_sets(adj, k, sets, queues, comp_gt)
        if sets.shape[0] == 0:
            break
        ip.append(int(sets.shape[0]))
        if popcount(queues).sum() == 0:
            break
    return ip


# ---------------------------------------------------------------------------
# Set-index lookup
# ---------------------------------------------------------------------------
def _lex_order(sets: np.ndarray) -> np.ndarray:
    return np.lexsort(sets.T[::-1])


def _lookup(sorted_sets: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Indices into sorted_sets for each query row (all must be present).
    Single-word sets (n <= 64) search the words themselves, which order as
    the rows do and search ~6x faster than the structured view several
    words need."""
    W = sorted_sets.shape[1]
    if W == 1:
        sv, qv = sorted_sets[:, 0], queries[:, 0]
    else:
        dt = [("", np.uint64)] * W
        sv = np.ascontiguousarray(sorted_sets).view(dt).ravel()
        qv = np.ascontiguousarray(queries).view(dt).ravel()
    pos = np.searchsorted(sv, qv)
    if not np.array_equal(sv[pos], qv):
        raise RuntimeError("subset lookup failed: predecessor set missing")
    return pos


# ---------------------------------------------------------------------------
# Hamiltonians
# ---------------------------------------------------------------------------
class HamiltonianDriver:
    """Off-diagonal transition Hamiltonian over the independent-set basis.

    The state order is the reference's: enumeration index o (the null state
    0, then the size-1 sets, ...) is flipped to nstates - 1 - o, so the
    all-ones ground state sits last.
    """

    def __init__(self, energies: tuple = (1,), graph=None, dtype=np.complex64, mesh=None,
                 dist_shards=None, device=None):
        """``mesh`` (the 2-D replicated subset lookup) and ``dist_shards``
        (the samplesort build) raise: they come with the distributed
        package. ``device``: where the Hamiltonian lives (default
        ``settings.device``)."""
        if mesh is not None:
            _not_distributed("HamiltonianDriver(mesh=...)")
        if dist_shards:
            _not_distributed("HamiltonianDriver(dist_shards=...)")
        self.energies = energies
        adj = _adjacency(graph)
        n = adj.shape[0]
        self.ip = [1]
        rows_u, cols_u = [], []
        sets = queues = None  # the size-(k-1) level
        offset, prev_offset = 1, 0
        planes = _bit_planes(n)
        comp_gt = _comp_gt_masks(adj)
        for k in range(1, n + 1):
            new_sets, new_queues = enumerate_independent_sets(adj, k, sets, queues, comp_gt)
            if new_sets.shape[0] == 0:
                break
            S = new_sets.shape[0]
            self.ip.append(S)
            if k == 1:
                # predecessors of singletons: the null state 0
                rows_u.append(offset + np.arange(S, dtype=np.int64))
                cols_u.append(np.zeros(S, dtype=np.int64))
            else:
                # each set links to its k subsets of size k-1
                i_idx, node_idx = np.nonzero(_bits_to_bool(new_sets, n))
                removed = new_sets[i_idx] & ~planes[node_idx]
                order = _lex_order(sets)
                pred_idx = prev_offset + order[_lookup(sets[order], removed)]
                rows_u.append(offset + i_idx.astype(np.int64))
                cols_u.append(pred_idx.astype(np.int64))
            sets, queues = new_sets, new_queues
            prev_offset = offset
            offset += S
            if popcount(queues).sum() == 0:
                break
        self.nstates = int(np.sum(self.ip))
        rows = np.concatenate(rows_u) if rows_u else np.zeros(0, np.int64)
        cols = np.concatenate(cols_u) if cols_u else np.zeros(0, np.int64)
        # flip to the reference's final ordering
        rows = (self.nstates - 1) - rows
        cols = (self.nstates - 1) - cols
        from .coo import coo_array

        upper = coo_array((np.ones(rows.shape[0], dtype=dtype), (rows, cols)),
                          shape=(self.nstates, self.nstates), device=device).tocsr()
        self._hamiltonian = upper + upper.T.tocsr()

    @property
    def hamiltonian(self) -> csr_array:
        if self.energies[0] == 1:
            return self._hamiltonian
        return self._hamiltonian * self.energies[0]


class HamiltonianMIS:
    """Diagonal MIS-cost Hamiltonian."""

    def __init__(self, graph=None, poly=None, energies=(1, 1), dtype=np.complex64, device=None):
        if energies == (1, 1):
            energies = (1,)
        self.energies = energies
        adj = _adjacency(graph)
        self.n = adj.shape[0]
        self.optimization = "max"
        self._is_diagonal = True
        if poly is None:
            poly = independence_polynomial(adj)
        self.nstates = int(np.sum(poly))
        self.dtype = dtype
        levels = np.arange(len(poly))
        C = np.flip(np.repeat(levels, poly)).astype(dtype)
        enum_states = np.arange(self.nstates)
        self._hamiltonian = csr_array((C, (enum_states, enum_states)),
                                      shape=(self.nstates, self.nstates), device=device)

    @property
    def hamiltonian(self) -> csr_array:
        if self.energies[0] == 1:
            return self._hamiltonian
        return self._hamiltonian * self.energies[0]

    @property
    def _diagonal_hamiltonian(self):
        """The costs as host numpy [nstates, 1] (every state is stored)."""
        return host_array(self.hamiltonian.data).reshape(-1, 1)

    @property
    def optimum(self):
        return np.max(self._diagonal_hamiltonian.real)

    @property
    def minimum_energy(self):
        return np.min(self._diagonal_hamiltonian.real)

    def cost_function(self, state):
        """<s|C|s>; accepts [n] or [n, 1] states (host values or tensors)."""
        state = host_array(state).ravel()
        diag = self._diagonal_hamiltonian.ravel()
        return float(np.real(np.vdot(state, diag * state)))

    def optimum_overlap(self, state):
        """sum_i <s|opt_i><opt_i|s> over the optimum states."""
        state = host_array(state).ravel()
        diag = self._diagonal_hamiltonian.ravel()
        mask = (diag == self.optimum).astype(float)
        return float(np.real(np.vdot(state, mask * state)))

    def approximation_ratio(self, state):
        return self.cost_function(state) / self.optimum


# the reference's aliases
LegateHamiltonianDriver = HamiltonianDriver
LegateHamiltonianMIS = HamiltonianMIS
