"""scipy.sparse.csgraph's surface (``sparse_tpu/csgraph.py``).

Every distance and label routine is a semiring relaxation: a fixed-shape
scatter-min over all edges (the (min, +) edge relaxation), iterated on the
device until a fixpoint. A sweep is ``scatter_reduce`` with ``amin`` (and
``amax`` for the predecessors), which are order-independent, so a repeated
call gives the same bits on the card. The reference's ``lax.while_loop``
is ``hostsync.device_while``: chunks of sweeps, each sweep past the
fixpoint frozen, one counted fetch a chunk. The inherently sequential
orderings and searches (the high-diameter Dijkstra heap, DFS, the MST,
RCM, matchings, max flow, yen) run on host numpy, as in the reference.
Results come back as host numpy, as the reference's do.
"""

from __future__ import annotations

import numpy as np
import torch

from . import hostsync
from .base import SparseArray
from .coverage import track_provenance
from .utils import as_tensor, host_array, resolve_device

__all__ = [
    "NegativeCycleError",
    "bellman_ford",
    "breadth_first_order",
    "breadth_first_tree",
    "connected_components",
    "construct_dist_matrix",
    "csgraph_from_dense",
    "csgraph_from_masked",
    "csgraph_masked_from_dense",
    "csgraph_to_dense",
    "csgraph_to_masked",
    "maximum_bipartite_matching",
    "maximum_flow",
    "MaximumFlowResult",
    "min_weight_full_bipartite_matching",
    "yen",
    "depth_first_order",
    "depth_first_tree",
    "dijkstra",
    "floyd_warshall",
    "johnson",
    "laplacian",
    "minimum_spanning_tree",
    "reconstruct_path",
    "reverse_cuthill_mckee",
    "shortest_path",
    "structural_rank",
]

_NO_PRED = -9999


class NegativeCycleError(Exception):
    """scipy.sparse.csgraph.NegativeCycleError."""


def _nverts(csgraph):
    return csgraph.shape[0] if hasattr(csgraph, "shape") else np.asarray(csgraph).shape[0]


def _graph_coo(csgraph, directed=True, unweighted=False):
    """(row, col, w, n) host arrays; an undirected graph gets both edge
    directions (the minimum weight wins on duplicates downstream)."""
    if hasattr(csgraph, "tocoo"):  # a port array or scipy sparse
        G = csgraph.tocoo()
        row = host_array(G.row).astype(np.int64)
        col = host_array(G.col).astype(np.int64)
        w = host_array(G.data).astype(np.float64)
        n = G.shape[0]
    else:
        D = np.asarray(csgraph, dtype=np.float64)
        n = D.shape[0]
        row, col = np.nonzero(D)
        w = D[row, col]
    if unweighted:
        w = np.ones_like(w)
    if not directed:
        row, col = np.concatenate([row, col]), np.concatenate([col, row])
        w = np.concatenate([w, w])
    return row, col, w, int(n)


def _graph_edges(csgraph, directed=True, unweighted=False):
    """(row, col, w, n) on the device: a port array's own COO where it
    lives (int64 coordinates, float64 weights), any other graph's host
    edges uploaded to ``settings.device``."""
    if not isinstance(csgraph, SparseArray):
        row, col, w, n = _graph_coo(csgraph, directed, unweighted)
        dev = resolve_device()
        return (as_tensor(row, dev), as_tensor(col, dev), as_tensor(w, dev), n)
    G = csgraph.tocoo()
    row, col = G.row.to(torch.int64), G.col.to(torch.int64)
    w = torch.ones_like(G.data, dtype=torch.float64) if unweighted else G.data.to(torch.float64)
    if not directed:
        row, col, w = torch.cat([row, col]), torch.cat([col, row]), torch.cat([w, w])
    return row, col, w, int(G.shape[0])


@track_provenance
def laplacian(csgraph, normed=False, return_diag=False, use_out_degree=False, *, copy=True,
              form="array", dtype=None, symmetrized=False):
    """Graph Laplacian L = D - A (scipy.sparse.csgraph.laplacian) on the
    graph's device. ``copy`` is accepted and ignored; only
    ``form='array'`` is implemented."""
    if form != "array":
        raise NotImplementedError(
            f"laplacian: form={form!r} not implemented (only 'array'); wrap the result with "
            "aslinearoperator for the operator form")
    from .csr import csr_array
    from .module import diags

    if isinstance(csgraph, SparseArray):
        A = csgraph.tocsr()
    elif hasattr(csgraph, "tocsr"):  # scipy sparse
        A = csr_array(csgraph.tocsr())
    else:
        A = csr_array(np.asarray(csgraph))
    if symmetrized:
        A = (A + A.T.tocsr()).tocsr()
    deg = host_array(A.sum(axis=1 if use_out_degree else 0)).ravel()
    n = A.shape[0]
    dev = A.device
    if normed:
        isq = np.where(deg > 0, 1.0 / np.sqrt(np.where(deg > 0, deg, 1)), 0)
        Dhalf = diags([isq], [0], shape=(n, n), device=dev)
        L = (diags([np.where(deg > 0, 1.0, 0.0)], [0], shape=(n, n), device=dev)
             - (Dhalf @ A @ Dhalf).tocsr()).tocsr()
        d_out = np.sqrt(deg)
    else:
        L = (diags([deg], [0], shape=(n, n), device=dev) - A).tocsr()
        d_out = deg
    if dtype is not None:
        L = L.astype(dtype)
    if return_diag:
        return L, d_out.astype(dtype) if dtype is not None else d_out
    return L


def _relax_scatter_min(row, col, w, dist0, maxiter, with_pred=True):
    """Iterated (min, +) edge relaxation with predecessor tracking.

    A sweep: cand[v] = min over the edges (u, v) of dist[u] + w(u, v), for
    every source row of ``dist0`` [k, n] at once; a whole Bellman-Ford pass
    is one scatter-min. Runs at most ``maxiter`` sweeps on the device
    (``hostsync.device_while``). Returns (dist, pred, changed_last), pred
    None without ``with_pred`` (the distances do not depend on it)."""
    k = dist0.shape[0]
    colk = col.expand(k, -1)
    rowk = row.to(torch.int32).expand(k, -1)
    none = torch.tensor(_NO_PRED, dtype=torch.int32, device=dist0.device)

    def body(s):
        dist = s["dist"]
        cand = dist[:, row] + w
        best = torch.full_like(dist, np.inf).scatter_reduce(1, colk, cand, "amin")
        improved = best < dist
        new = {"dist": torch.where(improved, best, dist), "it": s["it"] + 1,
               "changed": improved.any()}
        if with_pred:
            # an edge wins if its cand equals the new distance at its head;
            # the scatter-max over the winners picks one (any optimal edge is a
            # valid predecessor); improved vertices' stale preds are reset first
            wins = cand <= new["dist"][:, col]
            base = torch.where(improved, none, s["pred"])
            scat = base.scatter_reduce(1, colk, torch.where(wins, rowk, none), "amax")
            new["pred"] = torch.where(improved, scat, s["pred"])
        return new

    state = {"dist": dist0, "it": torch.zeros((), dtype=torch.int32, device=dist0.device),
             "changed": torch.ones((), dtype=torch.bool, device=dist0.device)}
    if with_pred:
        state["pred"] = torch.full(dist0.shape, _NO_PRED, dtype=torch.int32, device=dist0.device)
    state, _, (changed,) = hostsync.device_while(
        lambda s: s["changed"] & (s["it"] < maxiter), body, state, maxiter, count="it",
        stats=lambda s: [s["changed"]])
    return state["dist"], state.get("pred"), bool(changed)


def _sources(indices, n, device):
    """(host int64 source list, [k, n] float64 distances: 0 at each source)."""
    idx = np.arange(n) if indices is None else np.atleast_1d(np.asarray(indices, dtype=np.int64))
    dist0 = torch.full((len(idx), n), np.inf, dtype=torch.float64, device=device)
    dist0[torch.arange(len(idx), device=device), as_tensor(idx, device)] = 0.0
    return idx, dist0


@track_provenance
def bellman_ford(csgraph, directed=True, indices=None, return_predecessors=False,
                 unweighted=False):
    """Bellman-Ford shortest paths (scipy semantics; raises
    NegativeCycleError on a reachable negative cycle): scatter-min
    relaxations on the device, at most n sweeps."""
    row, col, w, n = _graph_edges(csgraph, directed, unweighted)
    _, dist0 = _sources(indices, n, w.device)
    # n sweeps reach any shortest path; one more detects a negative cycle
    dist, pred, changed = _relax_scatter_min(row, col, w, dist0, maxiter=n)
    if changed:
        # the n-th sweep still improved: one more sweep confirms a negative cycle
        best = torch.full_like(dist, np.inf).scatter_reduce(
            1, col.expand(dist.shape[0], -1), dist[:, row] + w, "amin")
        if bool(hostsync.fetch((best < dist).any())):
            raise NegativeCycleError("negative cycle detected")
    dist_np, pred_np = hostsync.fetch(dist), hostsync.fetch(pred)
    if indices is not None and np.ndim(indices) == 0:
        dist_np, pred_np = dist_np[0], pred_np[0]
    if return_predecessors:
        return dist_np, pred_np
    return dist_np


def _host_dijkstra(row, col, w, n, sources):
    """Binary-heap Dijkstra on host arrays, the high-diameter fallback:
    O(E log n) a source instead of (hop diameter) full-edge sweeps; the
    same (dist, pred) contract as the device relaxation (ties may pick
    another, equally optimal predecessor)."""
    import heapq

    from ._direct import _coo_to_csr_host

    indptr, _, c, wv = _coo_to_csr_host(np.asarray(row, dtype=np.int64),
                                        np.asarray(col, dtype=np.int64), np.asarray(w), n)
    dist = np.full((len(sources), n), np.inf)
    pred = np.full((len(sources), n), _NO_PRED, dtype=np.int32)
    for si, s in enumerate(sources):
        d, p = dist[si], pred[si]
        d[s] = 0.0
        heap = [(0.0, int(s))]
        while heap:
            du, u = heapq.heappop(heap)
            if du > d[u]:
                continue
            for e in range(indptr[u], indptr[u + 1]):
                v = int(c[e])
                nd = du + wv[e]
                if nd < d[v]:
                    d[v] = nd
                    p[v] = u
                    heapq.heappush(heap, (nd, v))
    return dist, pred


@track_provenance
def dijkstra(csgraph, directed=True, indices=None, return_predecessors=False, unweighted=False,
             limit=np.inf, min_only=False):
    """Shortest paths for non-negative weights (scipy's surface). The
    distances come from the device relaxation, which converges in (the
    longest shortest path's hop count) sweeps, bounded at
    min(n, max(64, 2 sqrt(n) + 16)): mesh-like graphs have hop diameter
    O(sqrt(n)). A graph past the bound (a long path) falls back to the
    host binary heap, with a warning."""
    if not unweighted:
        data = getattr(csgraph, "data", None)
        if isinstance(data, torch.Tensor):
            neg = data.numel() and float(hostsync.fetch(data.min())) < 0
        else:
            wchk = np.asarray(data if data is not None else csgraph)
            neg = wchk.size and float(np.min(wchk)) < 0
        if neg:
            raise ValueError("dijkstra requires non-negative weights; use bellman_ford")
    row, col, w, n = _graph_edges(csgraph, directed, unweighted)
    # min_only needs the [k, n] form, never the squeezed one
    idx_arr, dist0 = _sources(indices, n, w.device)
    bound = int(min(n, max(64, 2 * int(np.sqrt(n)) + 16)))
    d_dev, p_dev, changed = _relax_scatter_min(row, col, w, dist0, maxiter=bound,
                                               with_pred=return_predecessors)
    if changed and bound < n:
        from .utils import user_warning

        user_warning(f"dijkstra: hop diameter exceeds the {bound}-sweep device bound; falling "
                     "back to the host binary-heap algorithm")
        dist, pred = _host_dijkstra(*(host_array(a) for a in (row, col, w)), n, idx_arr)
    else:
        dist = hostsync.fetch(d_dev)
        pred = hostsync.fetch(p_dev) if return_predecessors else None
    if np.isfinite(limit):
        pruned = dist > limit
        dist = np.where(pruned, np.inf, dist)
        if pred is not None:
            pred = np.where(pruned, np.int32(_NO_PRED), pred)  # no stale paths
    if min_only:
        win = np.argmin(dist, axis=0)
        verts = np.arange(n)
        dmin = dist[win, verts]
        if return_predecessors:
            # scipy's 3-tuple: (dist, predecessors, sources)
            sources = np.where(np.isfinite(dmin), idx_arr[win], _NO_PRED)
            return dmin, pred[win, verts], sources
        return dmin
    if indices is not None and np.ndim(indices) == 0:
        dist = dist[0]
        pred = None if pred is None else pred[0]
    if return_predecessors:
        return dist, pred
    return dist


@track_provenance
def floyd_warshall(csgraph, directed=True, return_predecessors=False, unweighted=False,
                   overwrite=False):
    """All-pairs shortest paths on the dense [n, n] distance matrix on the
    device: n pivot steps, each a vectorized min-plus rank-1 update."""
    row, col, w, n = _graph_coo(csgraph, directed, unweighted)
    D0 = np.full((n, n), np.inf)
    np.minimum.at(D0, (row, col), w)  # scipy keeps the minimum parallel edge
    np.fill_diagonal(D0, 0.0)
    P0 = np.full((n, n), _NO_PRED, dtype=np.int32)
    P0[row, col] = row
    dev = csgraph.device if isinstance(csgraph, SparseArray) else resolve_device()
    D, P = as_tensor(D0, dev), as_tensor(P0, dev)
    for k in range(n):
        through = D[:, k, None] + D[None, k, :]
        better = through < D
        P = torch.where(better, P[k, None, :], P)
        D = torch.where(better, through, D)
    if bool(hostsync.fetch((torch.diagonal(D) < 0).any())):
        raise NegativeCycleError("negative cycle detected")
    if return_predecessors:
        return hostsync.fetch(D), hostsync.fetch(P)
    return hostsync.fetch(D)


@track_provenance
def johnson(csgraph, directed=True, indices=None, return_predecessors=False, unweighted=False):
    """All-pairs shortest paths with negative edges (scipy's surface): the
    relaxation takes negative edges as they are, so this is
    :func:`bellman_ford` (no reweighting pass)."""
    return bellman_ford(csgraph, directed=directed, indices=indices,
                        return_predecessors=return_predecessors, unweighted=unweighted)


@track_provenance
def shortest_path(csgraph, method="auto", directed=True, return_predecessors=False,
                  unweighted=False, overwrite=False, indices=None):
    """scipy.sparse.csgraph.shortest_path's dispatcher."""
    if method == "auto":
        method = "FW" if indices is None and _nverts(csgraph) <= 1024 else "BF"
    if method == "FW":
        if indices is not None:
            D = floyd_warshall(csgraph, directed, return_predecessors, unweighted)
            idx = np.atleast_1d(indices)
            if return_predecessors:
                out = (D[0][idx], D[1][idx])
                if np.ndim(indices) == 0:
                    return out[0][0], out[1][0]
                return out
            return D[idx][0] if np.ndim(indices) == 0 else D[idx]
        return floyd_warshall(csgraph, directed, return_predecessors, unweighted)
    if method in ("D", "BF", "J"):
        fn = {"D": dijkstra, "BF": bellman_ford, "J": johnson}[method]
        return fn(csgraph, directed=directed, indices=indices,
                  return_predecessors=return_predecessors, unweighted=unweighted)
    raise ValueError(f"unrecognized method {method!r}")


@track_provenance
def connected_components(csgraph, directed=True, connection="weak", return_labels=True):
    """Connected components by min-label propagation: a sweep is one
    scatter-min over all edges, on the device until no label moves."""
    if directed and connection == "strong":
        raise NotImplementedError("connection='strong' is not implemented; the weak form and "
                                  "undirected graphs are supported")
    row, col, _, n = _graph_edges(csgraph, directed=False)  # weak: both directions

    def body(s):
        lab = s["lab"]
        new = lab.scatter_reduce(0, col, lab[row], "amin")
        return {"lab": new, "changed": (new < lab).any(), "it": s["it"] + 1}

    dev = row.device
    state = {"lab": torch.arange(n, dtype=torch.int32, device=dev),
             "changed": torch.ones((), dtype=torch.bool, device=dev),
             "it": torch.zeros((), dtype=torch.int64, device=dev)}
    state, _, _ = hostsync.device_while(lambda s: s["changed"], body, state, n + 1, count="it")
    roots, labels = np.unique(hostsync.fetch(state["lab"]), return_inverse=True)
    if return_labels:
        return len(roots), labels.astype(np.int32)
    return len(roots)


@track_provenance
def breadth_first_order(csgraph, i_start, directed=True,
                        return_predecessors=True):
    """BFS order via level-synchronous relaxation: hop distances come
    from the unweighted scatter-min; the order is (level, node) — a valid
    BFS ordering (scipy's intra-level order may differ)."""
    dist, pred = bellman_ford(csgraph, directed=directed, indices=i_start,
                              return_predecessors=True, unweighted=True)
    reach = np.isfinite(dist)
    nodes = np.nonzero(reach)[0]
    order = nodes[np.lexsort((nodes, dist[nodes]))]
    node_array = order.astype(np.int32)
    if return_predecessors:
        pred = pred.astype(np.int32)
        pred[~reach] = _NO_PRED
        pred[int(np.atleast_1d(i_start)[0])] = _NO_PRED
        return node_array, pred
    return node_array


def _tree_from_pred(pred, csgraph, n):
    """CSR tree of the predecessor array with original edge weights."""
    from .coo import coo_array

    row, col, w, _ = _graph_coo(csgraph, directed=True)
    wmap = {}
    for r, c, ww in zip(row, col, w):
        key = (int(r), int(c))
        if key not in wmap or ww < wmap[key]:
            wmap[key] = ww
    tr, tc, tw = [], [], []
    for v in range(n):
        p = int(pred[v])
        if p >= 0:
            tr.append(p)
            tc.append(v)
            tw.append(wmap.get((p, v), wmap.get((v, p), 1.0)))
    return coo_array(
        (np.asarray(tw), (np.asarray(tr, dtype=np.int64),
                          np.asarray(tc, dtype=np.int64))),
        shape=(n, n),
    ).tocsr()


@track_provenance
def breadth_first_tree(csgraph, i_start, directed=True):
    n = _nverts(csgraph)
    _, pred = breadth_first_order(csgraph, i_start, directed=directed,
                                  return_predecessors=True)
    return _tree_from_pred(pred, csgraph, n)


@track_provenance
def depth_first_order(csgraph, i_start, directed=True,
                      return_predecessors=True):
    """DFS is inherently sequential: a host numpy stack."""
    row, col, w, n = _graph_coo(csgraph, directed)
    order_csr = np.argsort(row, kind="stable")
    srow, scol = row[order_csr], col[order_csr]
    starts = np.searchsorted(srow, np.arange(n + 1))
    visited = np.zeros(n, dtype=bool)
    pred = np.full(n, _NO_PRED, dtype=np.int32)
    node_array = []
    stack = [int(i_start)]
    visited[int(i_start)] = True
    while stack:
        u = stack.pop()
        node_array.append(u)
        nbrs = scol[starts[u]:starts[u + 1]]
        # push in REVERSE index order so the smallest neighbor pops first
        for v in np.unique(nbrs)[::-1]:
            if not visited[v]:
                visited[v] = True
                pred[v] = u
                stack.append(int(v))
    node_array = np.asarray(node_array, dtype=np.int32)
    if return_predecessors:
        return node_array, pred
    return node_array


@track_provenance
def depth_first_tree(csgraph, i_start, directed=True):
    n = _nverts(csgraph)
    _, pred = depth_first_order(csgraph, i_start, directed=directed,
                                return_predecessors=True)
    return _tree_from_pred(pred, csgraph, n)


@track_provenance
def minimum_spanning_tree(csgraph, overwrite=False):
    """Kruskal on host (sort + union-find: O(E log E) control-plane
    work; the edge sort is the only heavy step and runs on numpy)."""
    from .coo import coo_array

    row, col, w, n = _graph_coo(csgraph, directed=True)
    # undirected: canonicalize and keep min parallel edge
    lo, hi = np.minimum(row, col), np.maximum(row, col)
    keep = lo != hi
    lo, hi, w = lo[keep], hi[keep], w[keep]
    order = np.lexsort((hi, lo))
    lo, hi, w = lo[order], hi[order], w[order]
    same = np.flatnonzero(
        (np.diff(lo) == 0) & (np.diff(hi) == 0)
    )
    # min weight among duplicates
    wmin = w.copy()
    for i in same[::-1]:
        wmin[i] = min(wmin[i], wmin[i + 1])
    first = np.ones(len(lo), dtype=bool)
    first[same + 1] = False
    lo, hi, w = lo[first], hi[first], wmin[first]
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    tr, tc, tw = [], [], []
    for e in np.argsort(w, kind="stable"):
        ra, rb = find(lo[e]), find(hi[e])
        if ra != rb:
            parent[ra] = rb
            tr.append(lo[e])
            tc.append(hi[e])
            tw.append(w[e])
    return coo_array(
        (np.asarray(tw), (np.asarray(tr, dtype=np.int64),
                          np.asarray(tc, dtype=np.int64))),
        shape=(n, n),
    ).tocsr()


@track_provenance
def reverse_cuthill_mckee(csgraph, symmetric_mode=False):
    """Bandwidth-reducing RCM ordering (host BFS; feeds this library's
    banded DIA fast path — reorder, then convert to DIA)."""
    row, col, w, n = _graph_coo(csgraph, directed=True)
    # the ordering always works on the symmetrized pattern
    row, col = np.concatenate([row, col]), np.concatenate([col, row])
    deg = np.bincount(row, minlength=n)
    order_csr = np.argsort(row, kind="stable")
    srow, scol = row[order_csr], col[order_csr]
    starts = np.searchsorted(srow, np.arange(n + 1))
    visited = np.zeros(n, dtype=bool)
    out = []
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        queue = [int(seed)]
        qi = 0
        while qi < len(queue):
            u = queue[qi]
            qi += 1
            out.append(u)
            nbrs = np.unique(scol[starts[u]:starts[u + 1]])
            nbrs = nbrs[~visited[nbrs]]
            visited[nbrs] = True
            queue.extend(nbrs[np.argsort(deg[nbrs], kind="stable")].tolist())
    return np.asarray(out[::-1], dtype=np.int32)


def _bipartite_matching(csgraph):
    """Augmenting-path maximum matching on the bipartite row/col graph
    (host control-plane). Returns (rank, match_col) with match_col[c] =
    matched row or -1."""
    row, col, w, n = _graph_coo(csgraph, directed=True)
    shp = (csgraph.shape if hasattr(csgraph, "shape")
           else np.asarray(csgraph).shape)
    m, ncols = int(shp[0]), int(shp[1])
    adj = [[] for _ in range(m)]
    for r, c in zip(row, col):
        adj[int(r)].append(int(c))
    match_col = np.full(ncols, -1, dtype=np.int64)

    def augment(u, seen):
        for v in adj[u]:
            if not seen[v]:
                seen[v] = True
                if match_col[v] < 0 or augment(int(match_col[v]), seen):
                    match_col[v] = u
                    return True
        return False

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, m * 2 + 100))
    try:
        rank = 0
        for u in range(m):
            if augment(u, np.zeros(ncols, dtype=bool)):
                rank += 1
    finally:
        sys.setrecursionlimit(old)
    return rank, match_col


@track_provenance
def structural_rank(csgraph):
    """Maximum-matching structural rank (host augmenting paths on the
    bipartite row/col graph)."""
    return _bipartite_matching(csgraph)[0]


@track_provenance
def maximum_bipartite_matching(graph, perm_type="row"):
    """scipy.sparse.csgraph.maximum_bipartite_matching: perm_type='row'
    returns, per column, the matched row (-1 if unmatched);
    'column' returns, per row, the matched column."""
    rank, match_col = _bipartite_matching(graph)
    if perm_type == "row":
        return match_col.astype(np.int32)
    if perm_type == "column":
        m = graph.shape[0]
        match_row = np.full(m, -1, dtype=np.int32)
        matched = match_col >= 0
        match_row[match_col[matched]] = np.nonzero(matched)[0]
        return match_row
    raise ValueError("perm_type must be 'row' or 'column'")


@track_provenance
def construct_dist_matrix(graph, predecessors, directed=True,
                          null_value=np.inf):
    """Rebuild the all-pairs distance matrix from an [n, n] predecessor
    matrix + edge weights (scipy.sparse.csgraph.construct_dist_matrix;
    row i's source is vertex i)."""
    row, col, w, n = _graph_coo(graph, directed)
    pred = host_array(predecessors)
    if pred.shape != (n, n):
        raise ValueError("predecessors must be [n, n] (all-pairs form)")
    W = np.full((n, n), np.inf)
    np.minimum.at(W, (row, col), w)
    out = np.full((n, n), float(null_value))
    for s in range(n):
        out[s, s] = 0.0
        for v in range(n):
            if v == s:
                continue
            total, cur, hops = 0.0, v, 0
            while pred[s, cur] >= 0 and hops <= n:
                p = int(pred[s, cur])
                total += W[p, cur]
                cur = p
                hops += 1
            if cur == s and hops <= n:
                out[s, v] = total
    return out


@track_provenance
def csgraph_masked_from_dense(graph, null_value=0, nan_null=True,
                              infinity_null=True):
    D = np.asarray(graph, dtype=np.float64)
    mask = np.zeros_like(D, dtype=bool)
    if null_value is not None:
        mask |= D == null_value
    if nan_null:
        mask |= np.isnan(D)
    if infinity_null:
        mask |= np.isinf(D)
    return np.ma.masked_array(np.where(mask, 0.0, D), mask)


@track_provenance
def csgraph_from_masked(graph):
    from .csr import csr_array

    D = np.ma.asarray(graph)
    filled = np.where(np.ma.getmaskarray(D), 0.0, np.ma.filled(D, 0.0))
    return csr_array(np.asarray(filled, dtype=np.float64))


@track_provenance
def csgraph_to_masked(csgraph):
    G = csgraph.tocoo()
    n, m = csgraph.shape
    data = np.zeros((n, m))
    mask = np.ones((n, m), dtype=bool)
    data[host_array(G.row), host_array(G.col)] = host_array(G.data)
    mask[host_array(G.row), host_array(G.col)] = False
    return np.ma.masked_array(data, mask)


@track_provenance
def csgraph_from_dense(graph, null_value=0, nan_null=True,
                       infinity_null=True):
    from .csr import csr_array

    D = np.array(graph, dtype=np.float64, copy=True)
    mask = np.ones_like(D, dtype=bool)
    if null_value is not None:
        mask &= D != null_value
    if nan_null:
        mask &= ~np.isnan(D)
    if infinity_null:
        mask &= ~np.isinf(D)
    D = np.where(mask, D, 0.0)
    out = csr_array(D)
    return out


@track_provenance
def csgraph_to_dense(csgraph, null_value=0):
    G = csgraph.tocoo()
    out = np.full(csgraph.shape, float(null_value))
    out[host_array(G.row), host_array(G.col)] = host_array(G.data)
    return out


@track_provenance
def reconstruct_path(csgraph, predecessors, directed=True):
    """Tree of the predecessor array (scipy surface)."""
    n = _nverts(csgraph)
    return _tree_from_pred(host_array(predecessors), csgraph, n)


def _masked_sssp(row, col, w, n, src, edge_ok, node_ok):
    """Single-source shortest path by vectorized (min,+) sweeps over a
    masked edge list (host numpy — yen's spur searches mutate the edge
    mask every call, so this stays on the control plane like the other
    inherently sequential orderings). Returns (dist, pred)."""
    dist = np.full(n, np.inf)
    pred = np.full(n, _NO_PRED, dtype=np.int64)
    if not node_ok[src]:
        return dist, pred
    dist[src] = 0.0
    ok = edge_ok & node_ok[row] & node_ok[col]
    r, c, ww = row[ok], col[ok], w[ok]
    for _ in range(n):
        cand = dist[r] + ww
        best = np.full(n, np.inf)
        np.minimum.at(best, c, cand)
        improved = best < dist
        if not improved.any():
            break
        dist = np.where(improved, best, dist)
        win = cand <= dist[c]
        p = np.full(n, _NO_PRED, dtype=np.int64)
        np.maximum.at(p, c[win], r[win])
        pred = np.where(improved, p, pred)
    return dist, pred


def _walk_pred(pred, src, dst):
    """Vertex list src..dst from a predecessor array (None if no path)."""
    path = [int(dst)]
    cur = int(dst)
    for _ in range(len(pred) + 1):
        if cur == src:
            return path[::-1]
        cur = int(pred[cur])
        if cur < 0:
            return None
        path.append(cur)
    return None


@track_provenance
def yen(csgraph, source, sink, K, *, directed=True,
        return_predecessors=False, unweighted=False):
    """K-shortest loopless paths (scipy.sparse.csgraph.yen).

    Yen's algorithm: the candidate spur searches run on a masked edge
    list via :func:`_masked_sssp` (each spur masks the root-path edges
    of previously accepted paths), so no graph copies are built per
    candidate."""
    row, col, w, n = _graph_coo(csgraph, directed, unweighted)
    source, sink = int(source), int(sink)
    if w.size and float(np.min(w)) < 0:
        raise ValueError("yen requires non-negative weights")
    edge_ok = np.ones(len(row), dtype=bool)
    node_ok = np.ones(n, dtype=bool)

    def mask_edge(u, v):
        sel = (row == u) & (col == v)
        if not directed:
            sel |= (row == v) & (col == u)
        edge_ok[sel] = False

    # weight lookup for root-path costs (min over parallel edges,
    # matching the relaxation's choice)
    def edge_w(u, v):
        sel = (row == u) & (col == v)
        return float(np.min(w[sel]))

    dist, pred = _masked_sssp(row, col, w, n, source, edge_ok, node_ok)
    first = _walk_pred(pred, source, sink)
    A, A_cost = [], []
    if first is not None and np.isfinite(dist[sink]):
        A.append(first)
        A_cost.append(float(dist[sink]))
    B = {}  # path tuple -> cost
    while first is not None and len(A) < int(K):
        prev = A[-1]
        for i in range(len(prev) - 1):
            spur = prev[i]
            root = prev[: i + 1]
            edge_ok[:] = True
            node_ok[:] = True
            for p in A:
                if len(p) > i + 1 and p[: i + 1] == root:
                    mask_edge(p[i], p[i + 1])
            node_ok[root[:-1]] = False
            sd, sp = _masked_sssp(row, col, w, n, spur, edge_ok, node_ok)
            tail = _walk_pred(sp, spur, sink)
            if tail is None or not np.isfinite(sd[sink]):
                continue
            cand = root[:-1] + tail
            key = tuple(cand)
            if key in B or cand in A:
                continue
            root_cost = sum(edge_w(root[j], root[j + 1])
                            for j in range(len(root) - 1))
            B[key] = root_cost + float(sd[sink])
        if not B:
            break
        key = min(B, key=lambda t: (B[t], t))
        A.append(list(key))
        A_cost.append(B.pop(key))
    costs = np.asarray(A_cost, dtype=np.float64)
    if not return_predecessors:
        return costs
    preds = np.full((len(A), n), _NO_PRED, dtype=np.int32)
    for k, p in enumerate(A):
        for j in range(len(p) - 1):
            preds[k, p[j + 1]] = p[j]
    return costs, preds


class MaximumFlowResult:
    """Result of :func:`maximum_flow` (scipy.sparse.csgraph surface):
    ``flow_value`` plus the per-edge net ``flow`` matrix."""

    def __init__(self, flow_value, flow):
        self.flow_value = flow_value
        self.flow = flow

    def __repr__(self):
        return f"MaximumFlowResult with value of {self.flow_value}"


@track_provenance
def maximum_flow(csgraph, source, sink, *, method="dinic"):
    """Maximum s-t flow (scipy.sparse.csgraph.maximum_flow semantics:
    integer capacities; returns net flows on the pattern of
    ``csgraph + csgraph.T``). Dinic's blocking-flow algorithm on the
    host control plane — level BFS and augmentation are inherently
    sequential; capacities stay in compact numpy edge arrays."""
    if method not in ("dinic", "edmonds_karp"):
        raise ValueError(f"method expected 'dinic' or 'edmonds_karp', got {method!r}")
    if hasattr(csgraph, "tocoo"):
        G = csgraph.tocoo()
        data = host_array(G.data)
        urow = host_array(G.row).astype(np.int64)
        ucol = host_array(G.col).astype(np.int64)
        n = int(G.shape[0])
        if G.shape[0] != G.shape[1]:
            raise ValueError("csgraph must be square")
    else:
        D = np.asarray(csgraph)
        if D.ndim != 2 or D.shape[0] != D.shape[1]:
            raise ValueError("csgraph must be square")
        n = D.shape[0]
        urow, ucol = np.nonzero(D)
        data = D[urow, ucol]
    if not np.issubdtype(data.dtype, np.integer):
        raise ValueError("csgraph must have an integer dtype")
    if data.size and int(data.min()) < 0:
        raise ValueError("capacities must be non-negative")
    source, sink = int(source), int(sink)
    if not (0 <= source < n and 0 <= sink < n):
        raise ValueError("source/sink out of range")
    if source == sink:
        raise ValueError("source and sink must differ")

    # residual edge arrays: stored edge 2e = forward(cap), 2e+1 = reverse(0)
    E = len(urow)
    head = np.empty(2 * E, dtype=np.int64)
    cap = np.zeros(2 * E, dtype=np.int64)
    head[0::2], head[1::2] = ucol, urow
    cap[0::2] = data.astype(np.int64)
    tail = np.empty(2 * E, dtype=np.int64)
    tail[0::2], tail[1::2] = urow, ucol
    order = np.argsort(tail, kind="stable")
    adj_start = np.searchsorted(tail[order], np.arange(n + 1))

    total = 0
    INF = np.iinfo(np.int64).max
    while True:
        # BFS level graph on residual capacities
        level = np.full(n, -1, dtype=np.int64)
        level[source] = 0
        frontier = [source]
        while frontier:
            nxt = []
            for u in frontier:
                for t in order[adj_start[u]:adj_start[u + 1]]:
                    v = head[t]
                    if cap[t] > 0 and level[v] < 0:
                        level[v] = level[u] + 1
                        nxt.append(int(v))
            frontier = nxt
        if level[sink] < 0:
            break
        # blocking flow: iterative DFS with per-vertex edge cursors
        it = adj_start[:-1].copy()
        while True:
            # find one augmenting path in the level graph
            path = []
            u = source
            while u != sink:
                advanced = False
                while it[u] < adj_start[u + 1]:
                    t = order[it[u]]
                    v = head[t]
                    if cap[t] > 0 and level[v] == level[u] + 1:
                        path.append(t)
                        u = int(v)
                        advanced = True
                        break
                    it[u] += 1
                if not advanced:
                    if not path:
                        u = None
                        break
                    # dead end: retreat, exhaust the edge that led here
                    dead = path.pop()
                    u = int(tail[dead])
                    it[u] += 1
            if u is None:
                break
            pushed = int(min(INF, min(cap[t] for t in path)))
            for t in path:
                cap[t] -= pushed
                cap[t ^ 1] += pushed
            total += pushed
    fwd_flow = data.astype(np.int64) - cap[0::2]  # flow on each stored edge

    # net flow matrix on pattern(csgraph) ∪ pattern(csgraph.T)
    from .coo import coo_array

    rows = np.concatenate([urow, ucol])
    cols = np.concatenate([ucol, urow])
    vals = np.concatenate([fwd_flow, -fwd_flow])
    flow = coo_array((vals, (rows, cols)), shape=(n, n))
    flow.sum_duplicates()
    return MaximumFlowResult(int(total), flow.tocsr())


@track_provenance
def min_weight_full_bipartite_matching(biadjacency, maximize=False):
    """Sparse assignment problem (scipy.sparse.csgraph
    .min_weight_full_bipartite_matching): full matching of the smaller
    side minimizing total weight; explicit zeros count as edges.
    Successive shortest augmenting paths with dual potentials (the
    LAPJVsp recurrence) on the host control plane."""
    import heapq

    if not hasattr(biadjacency, "tocsr"):
        raise TypeError("biadjacency must be a sparse array")
    B = biadjacency.tocsr()
    m, n = (int(s) for s in B.shape)
    transposed = m > n
    if transposed:
        B = B.T.tocsr()
        m, n = n, m
    indptr = host_array(B.indptr).astype(np.int64)
    indices = host_array(B.indices).astype(np.int64)
    data = host_array(B.data).astype(np.float64)
    if maximize:
        data = -data
    # a constant shift moves every full matching's cost equally: safe way
    # to make reduced-cost Dijkstra's nonnegativity invariant hold
    shift = float(np.min(data)) if data.size else 0.0
    if shift < 0:
        data = data - shift
    u = np.zeros(m)
    v = np.zeros(n)
    row4col = np.full(n, -1, dtype=np.int64)
    col4row = np.full(m, -1, dtype=np.int64)
    for cur in range(m):
        dist = np.full(n, np.inf)
        prev_row = np.full(n, -1, dtype=np.int64)
        seen = np.zeros(n, dtype=bool)
        heap = []

        def relax(i, d0):
            for t in range(indptr[i], indptr[i + 1]):
                j = int(indices[t])
                if seen[j]:
                    continue
                nd = d0 + data[t] - u[i] - v[j]
                if nd < dist[j]:
                    dist[j] = nd
                    prev_row[j] = i
                    heapq.heappush(heap, (nd, j))

        relax(cur, 0.0)
        sink = -1
        while heap:
            d, j = heapq.heappop(heap)
            if seen[j]:
                continue
            seen[j] = True
            if row4col[j] < 0:
                sink = j
                break
            relax(int(row4col[j]), d)
        if sink < 0:
            raise ValueError("no full matching exists")
        # dual update keeps all reduced costs nonnegative
        minv = dist[sink]
        u[cur] += minv
        scanned = np.nonzero(seen)[0]
        for j in scanned:
            if j == sink:
                continue
            v[j] += dist[j] - minv
            u[int(row4col[j])] += minv - dist[j]
        # augment along the alternating path
        j = sink
        while True:
            i = int(prev_row[j])
            row4col[j] = i
            col4row[i], j = j, col4row[i]
            if i == cur:
                break
    row_ind = np.arange(m, dtype=np.int64)
    col_ind = col4row
    if transposed:
        order = np.argsort(col_ind)
        row_ind, col_ind = col_ind[order], row_ind[order]
    return row_ind, col_ind
