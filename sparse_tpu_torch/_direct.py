"""Direct solvers and structure queries (``sparse_tpu/_direct.py``):
spsolve_triangular, splu, spilu, ilu0, ic0, factorized, inv, expm,
is_sptriangular, spbandwidth.

* ``spsolve_triangular`` and every factor's solve are the reference's
  blocked substitution (:class:`_PreparedTriangular`): K = ceil(n / nb)
  sequential steps, each a gather of the solved prefix through the block's
  off-diagonal entries, an in-order segment sum by row and a dense
  triangular solve of the [nb, nb] diagonal tile. On a CUDA tensor the
  K-step loop is captured as a CUDA graph on a plan's second apply of a
  right-hand-side width and replayed from then on: the analog of the
  reference's one jitted ``lax.scan``, the same kernels in the same order
  as the loop.
* The factorizations run on the host (``native``: ILU(0), IC(0), the
  Gilbert-Peierls LU and ILUT) from the matrix's entries, fetched once by
  :func:`_coo_host`; the solves run on the matrix's device.
* ``splu``/``inv``/``expm`` take dense ``torch.linalg`` paths up to
  ``DENSE_DIRECT_MAX_N``; above it a real ``splu`` takes the native
  sparse LU, and ``inv``/``expm`` raise.
"""

from __future__ import annotations

import numpy as np
import torch

from . import hostsync
from .ops.coords import segment_sum
from .utils import as_tensor, resolve_device

__all__ = [
    "spbandwidth",
    "is_sptriangular",
    "spsolve_triangular",
    "SuperLU",
    "SpILU",
    "splu",
    "spilu",
    "ilu0",
    "ic0",
    "factorized",
    "inv",
    "expm",
]

# dense factorization ceiling of splu / inv / expm (n * n f32 is 256 MiB at
# 8192): past it direct methods are the wrong tool
DENSE_DIRECT_MAX_N = 8192


def _float_dtype(dt: torch.dtype) -> torch.dtype:
    """result_type(dt, float32): the reference's working dtype."""
    return torch.promote_types(dt, torch.float32)


def _coo_host(A):
    """(row, col, data) of A as host numpy (int64, int64, A's dtype): the
    one explicit fetch through which a factorization sees the entries."""
    c = A.tocoo()
    return (hostsync.fetch(c.row).astype(np.int64), hostsync.fetch(c.col).astype(np.int64),
            hostsync.fetch(c.data))


def _coo_to_csr_host(row, col, data, n):
    """Canonical host CSR from COO triples: lexsort by (row, col), count,
    cumsum. Returns (indptr, sorted_row, sorted_col, sorted_data)."""
    order = np.lexsort((col, row))
    row, col, data = row[order], col[order], data[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    return np.cumsum(indptr), row, col, data


def _csr_from_host(indptr, col, val, shape, device, dtype=None):
    from .csr import csr_array

    return csr_array((np.asarray(val, dtype=dtype), np.asarray(col, dtype=np.int64),
                      np.asarray(indptr, dtype=np.int64)), shape=shape, device=device)


def spbandwidth(A):
    """(below, above) bandwidth of a sparse array (scipy.sparse.spbandwidth)."""
    row, col, data = _coo_host(A)
    keep = data != 0
    row, col = row[keep], col[keep]
    if row.size == 0:
        return (0, 0)
    d = col - row
    return (int(max(-d.min(), 0)), int(max(d.max(), 0)))


def is_sptriangular(A):
    """(lower, upper) structural triangularity (scipy.sparse.linalg)."""
    lo, hi = spbandwidth(A)
    return (hi == 0, lo == 0)


def _as_2d(b, device):
    b = as_tensor(b, device)
    if b.ndim == 1:
        return b[:, None], True
    if b.ndim == 2:
        return b, False
    raise ValueError("b must be 1-D or 2-D")


def spsolve_triangular(A, b, lower=True, overwrite_A=False, overwrite_b=False,
                       unit_diagonal=False, block=256):
    """Solve a (structurally) triangular system A x = b by blocked
    substitution (:class:`_PreparedTriangular`) on A's device. Raises
    ``ValueError`` for entries in the wrong triangle and ``LinAlgError``
    for a zero on the diagonal (scipy)."""
    A = A.tocsr()
    m, n = A.shape
    if m != n:
        raise ValueError("matrix must be square")
    bmat, squeeze = _as_2d(b, A.device)
    if bmat.shape[0] != n:
        raise ValueError("A and b dimension mismatch")
    row, col, data = _coo_host(A)
    bad = (col > row) if lower else (col < row)
    if np.any(data[bad] != 0):
        raise ValueError(f"A is not {'lower' if lower else 'upper'} triangular")
    if not unit_diagonal:
        diag = np.zeros(n, dtype=data.dtype)
        on_d = row == col
        diag[row[on_d]] = data[on_d]
        if np.any(diag == 0):
            raise np.linalg.LinAlgError("A is singular: zero entry on diagonal.")
    dt = _float_dtype(torch.promote_types(A.dtype, bmat.dtype))
    prep = _PreparedTriangular(n, row, col, data, lower=lower, unit_diagonal=unit_diagonal,
                               block=block, dtype=dt, device=A.device)
    x = prep.apply(bmat)
    return x[:, 0] if squeeze else x


class _PreparedTriangular:
    """Blocked triangular-solve plan: the host preprocessing runs once,
    each :meth:`apply` walks the K blocks (forward for lower, backward for
    upper).

    The diagonal tiles are dense ([K, nb, nb]); ``nb`` is capped at
    2^28 / (n * itemsize), so the tiles hold at most 256 MiB whatever n.
    The off-diagonal entries are sorted by row (block by block, stable),
    so step k's sum is ``segment_sum`` over the block's row offsets: one
    fixed order, the same on every apply. Memory is O(nnz + n * nb)."""

    def __init__(self, n, row, col, data, lower, unit_diagonal, block=256, dtype=None,
                 device=None):
        data = np.asarray(data)
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        dt = dtype if dtype is not None else _float_dtype(torch.from_numpy(data[:0]).dtype)
        itemsize = torch.empty((), dtype=dt).element_size()
        cap = max(32, (1 << 28) // (max(n, 1) * itemsize))
        nb = int(min(max(block, 8), max(n, 1), cap))
        K = (n + nb - 1) // nb
        n_pad = K * nb
        self.n, self.nb, self.K, self.n_pad = n, nb, K, n_pad
        self.lower, self.unit_diagonal, self.dt = lower, unit_diagonal, dt
        self.device = resolve_device(device)

        blk = row // nb
        in_diag = (col // nb) == blk
        Dh = np.zeros((K, nb, nb), dtype=data.dtype)
        dr, dc, dv = row[in_diag], col[in_diag], data[in_diag]
        Dh[dr // nb, dr % nb, dc - (dr // nb) * nb] = dv
        if unit_diagonal:
            Dh[:, np.arange(nb), np.arange(nb)] = 1.0
        # identity rows for the padding tail: a zero diagonal there would
        # poison the last tile's solve (and, backwards, every earlier one)
        pad_rows = np.arange(n, n_pad)
        Dh[pad_rows // nb, pad_rows % nb, pad_rows % nb] = 1.0
        orow, ocol, oval = row[~in_diag], col[~in_diag], data[~in_diag]
        order = np.argsort(orow, kind="stable")  # by block, then by row in it
        orow, ocol, oval = orow[order], ocol[order], oval[order]
        # per block: [start, end) in the sorted entries, and the row
        # offsets inside it, relative to its start
        self._pos = np.searchsorted(orow, np.arange(K + 1) * nb).tolist()
        seg = np.searchsorted(orow, np.arange(n_pad + 1)).reshape(-1)
        seg = [seg[k * nb:(k + 1) * nb + 1] - self._pos[k] for k in range(K)]
        dev = self.device
        self._D = torch.as_tensor(Dh, device=dev).to(dt)
        self._offc = torch.as_tensor(ocol, device=dev)
        self._offv = torch.as_tensor(oval, device=dev).to(dt)
        self._seg = torch.as_tensor(np.stack(seg) if K else np.zeros((0, nb + 1), np.int64),
                                    device=dev)
        # rhs columns -> False (applied once by the loop) or the captured
        # (graph, static b, static x)
        self._graphs = {}

    def _steps(self, b_pad, x):
        """The K sequential steps, from ``b_pad`` [n_pad, r] into ``x``."""
        nb = self.nb
        ks = range(self.K) if self.lower else range(self.K - 1, -1, -1)
        for k in ks:
            lo = k * nb
            y = b_pad[lo:lo + nb]
            s, e = self._pos[k], self._pos[k + 1]
            if e > s:
                gathered = self._offv[s:e, None] * x.index_select(0, self._offc[s:e])
                y = y - segment_sum(gathered, self._seg[k])
            x[lo:lo + nb] = torch.linalg.solve_triangular(
                self._D[k], y, upper=not self.lower, unitriangular=self.unit_diagonal)
        return x

    def _capture(self, r: int, warm: bool):
        """Capture the K steps for ``r`` right-hand-side columns as a CUDA
        graph; ``warm`` first runs them once on a side stream (the lazy
        library set-up a capture must not see), which an earlier loop
        apply has done already."""
        b_static = torch.zeros((self.n_pad, r), dtype=self.dt, device=self.device)
        x_static = torch.zeros_like(b_static)
        if warm:
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._steps(b_static, x_static)
            torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._steps(b_static, x_static)
        self._graphs[r] = (graph, b_static, x_static)
        return self._graphs[r]

    def apply(self, bmat, graph=None):
        """[n, r] -> [n, r] on the plan's device. On a CUDA device the first
        apply of r columns runs the loop and the second captures the steps
        as a graph, replayed from then on: a one-shot solve pays no
        capture, a preconditioner captures once. ``graph`` True or False
        forces the graph (captured now if need be) or the loop. The CPU
        always runs the loop."""
        bmat = as_tensor(bmat, self.device).to(self.dt)
        r = bmat.shape[1]
        if self.device.type == "cuda" and self.K:
            seen = self._graphs.get(r)
            if graph is None:
                graph = seen is not None
                if seen is None:
                    self._graphs[r] = False  # applied once: capture on the next
            if graph:
                g, b_static, x_static = seen if seen else self._capture(r, seen is None)
                b_static[: self.n].copy_(bmat)
                g.replay()
                return x_static[: self.n].clone()
        b_pad = torch.zeros((self.n_pad, r), dtype=self.dt, device=self.device)
        b_pad[: self.n] = bmat
        return self._steps(b_pad, torch.zeros_like(b_pad))[: self.n]


class SuperLU:
    """LU factorization with scipy's ``SuperLU`` surface (shape, nnz,
    perm_r, perm_c, L, U, solve), in two regimes:

    * n <= ``DENSE_DIRECT_MAX_N``: ``torch.linalg.lu_factor`` on A's device,
      solves by ``lu_solve``;
    * larger real matrices: the native Gilbert-Peierls LU with partial
      pivoting (natural column order), then two :class:`_PreparedTriangular`
      solves on A's device. Complex matrices past the ceiling raise."""

    def _setup_common(self, A):
        A = A.tocsr()
        m, n = A.shape
        if m != n:
            raise ValueError("matrix must be square")
        self.shape = (m, n)
        self.nnz = A.nnz
        self.device = A.device
        return A

    def __init__(self, A, permc_spec=None):
        A = self._setup_common(A)
        n = self.shape[0]
        is_complex = A.dtype.is_complex
        if n > DENSE_DIRECT_MAX_N:
            if not is_complex and self._init_sparse(A, permc_spec):
                return
            raise ValueError(
                f"splu: n={n} exceeds the dense-factorization ceiling ({DENSE_DIRECT_MAX_N}) "
                "and the native sparse-LU library is "
                + ("unavailable" if not is_complex else "real-only (complex input)")
                + "; use cg/gmres/bicgstab for large systems")
        self._mode = "dense"
        dense = A.toarray().to(_float_dtype(A.dtype))
        self._lu, self._piv = torch.linalg.lu_factor(dense)
        if bool(hostsync.fetch((torch.diagonal(self._lu) == 0).any())):
            raise RuntimeError("Factor is exactly singular")
        # LAPACK's swaps (1-based) -> the row permutation with A[perm] == L U;
        # scipy's perm_r is its inverse ((L U)[perm_r] == A)
        piv = hostsync.fetch(self._piv).astype(np.int64) - 1
        perm = np.arange(n)
        for i, p in enumerate(piv):
            perm[i], perm[p] = perm[p], perm[i]
        self.perm_r = np.argsort(perm)
        self.perm_c = np.arange(n)

    def _init_sparse(self, A, permc_spec=None, ilut=None):
        """Native factorization -> device triangular-solve plans; False
        without the native library. ``ilut=(droptol, lfil)`` runs the
        incomplete variant (spilu's fill_factor path)."""
        from . import native

        n = self.shape[0]
        q = None
        row, col, val = _coo_host(A)
        if isinstance(permc_spec, str) and permc_spec.upper() == "RCM":
            from .csgraph import reverse_cuthill_mckee

            # a symmetric pre-permutation: entry (r, c) of A lands at
            # (qinv[r], qinv[c]) of A[q][:, q]
            q = np.asarray(reverse_cuthill_mckee(A), dtype=np.int64)
            qinv = np.argsort(q)
            row, col = qinv[row], qinv[col]
        cp, _col_s, row_s, val_s = _coo_to_csr_host(col, row, val, n)  # CSC = CSR of A^T
        val_s = np.asarray(val_s, dtype=np.float64)
        if ilut is None:
            out = native.splu_host(cp, row_s, val_s, n)
        else:
            out = native.ilut_host(cp, row_s, val_s, n, droptol=ilut[0], lfil=ilut[1])
        if out is None:
            return False
        Lp, Li, Lx, Up, Ui, Ux, perm = out
        self._mode = "sparse"
        self._perm = torch.as_tensor(perm, device=self.device)
        self._pinv = torch.as_tensor(np.argsort(perm), device=self.device)
        self._q = self._qinv = None
        if q is None:
            self.perm_r = np.argsort(perm)
            self.perm_c = np.arange(n)
        else:
            # Pr A Pc = L U with Pc the RCM order: column j of A Pc is
            # A[:, q[j]], row k of the factored matrix A[q[perm[k]]]; scipy's
            # perm_r is the inverse
            self._q = torch.as_tensor(q, device=self.device)
            self._qinv = torch.as_tensor(qinv, device=self.device)
            self.perm_c = q
            self.perm_r = np.empty(n, dtype=np.int64)
            self.perm_r[q[perm]] = np.arange(n)
        self._Lcsc = (Lp, Li, Lx)
        self._Ucsc = (Up, Ui, Ux)
        self._dt = _float_dtype(A.dtype)
        Lcols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Lp))
        Ucols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Up))
        self._Lprep = _PreparedTriangular(n, Li, Lcols, Lx, lower=True, unit_diagonal=True,
                                          dtype=self._dt, device=self.device)
        self._Uprep = _PreparedTriangular(n, Ui, Ucols, Ux, lower=False, unit_diagonal=False,
                                          dtype=self._dt, device=self.device)
        self._LTprep = self._UTprep = None
        return True

    @classmethod
    def _ilut(cls, A, drop_tol, fill_factor):
        """ILUT(p, tau) with the SuperLU surface (scipy's
        ``spilu(drop_tol, fill_factor)``): per column at most
        ceil(fill_factor x mean column count / 2) kept in each factor
        half. None without the native library."""
        self = cls.__new__(cls)
        A = self._setup_common(A)
        n = self.shape[0]
        avg = max(A.nnz / max(n, 1), 1.0)
        lfil = max(1, int(np.ceil(float(fill_factor) * avg / 2.0)))
        droptol = 1e-4 if drop_tol is None else float(drop_tol)
        if not self._init_sparse(A, ilut=(droptol, lfil)):
            return None
        return self

    def _solve_sparse_real(self, bmat, trans):
        """P A = L U: N solves x = U \\ (L \\ (P b)); T/H (real factors)
        solve U^T, then L^T, and un-permute. Under an RCM order q the
        factored matrix is A[q][:, q], also the symmetric permutation of
        A^T: both directions permute the rhs in and the solution out."""
        n = self.shape[0]
        if self._q is not None:
            bmat = bmat[self._q]
        if trans == "N":
            x = self._Uprep.apply(self._Lprep.apply(bmat[self._perm]))
            return x if self._q is None else x[self._qinv]
        if self._UTprep is None:
            Lp, Li, Lx = self._Lcsc
            Up, Ui, Ux = self._Ucsc
            Lcols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Lp))
            Ucols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Up))
            # the transposes: U^T is lower non-unit, L^T upper unit
            self._UTprep = _PreparedTriangular(n, Ucols, Ui, Ux, lower=True,
                                               unit_diagonal=False, dtype=self._dt,
                                               device=self.device)
            self._LTprep = _PreparedTriangular(n, Lcols, Li, Lx, lower=False,
                                               unit_diagonal=True, dtype=self._dt,
                                               device=self.device)
        x = self._LTprep.apply(self._UTprep.apply(bmat))[self._pinv]
        return x if self._q is None else x[self._qinv]

    @property
    def L(self):
        n = self.shape[0]
        if getattr(self, "_mode", "dense") == "sparse":
            Lp, Li, Lx = self._Lcsc
            cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Lp))
            row = np.concatenate([Li, np.arange(n, dtype=np.int64)])
            col = np.concatenate([cols, np.arange(n, dtype=np.int64)])
            val = np.concatenate([Lx, np.ones(n)])  # the explicit unit diagonal
            indptr, _, col, val = _coo_to_csr_host(row, col, val, n)
            return _csr_from_host(indptr, col, val, (n, n), self.device)
        from .csr import csr_array

        Ld = torch.tril(self._lu, -1) + torch.eye(n, dtype=self._lu.dtype, device=self.device)
        return csr_array(Ld)

    @property
    def U(self):
        if getattr(self, "_mode", "dense") == "sparse":
            n = self.shape[0]
            Up, Ui, Ux = self._Ucsc
            cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Up))
            indptr, _, col, val = _coo_to_csr_host(Ui, cols, Ux, n)
            return _csr_from_host(indptr, col, val, (n, n), self.device)
        from .csr import csr_array

        return csr_array(torch.triu(self._lu))

    def _lu_solve(self, b, trans):
        """Dense solve of A x = b (N), A^T x = b (T) or A^H x = b (H)."""
        if trans == "N":
            return torch.linalg.lu_solve(self._lu, self._piv, b)
        if trans == "T" and self._lu.is_complex():
            # A^T x = b  <=>  A^H conj(x) = conj(b)
            return torch.conj_physical(torch.linalg.lu_solve(self._lu, self._piv,
                                                             torch.conj_physical(b), adjoint=True))
        return torch.linalg.lu_solve(self._lu, self._piv, b, adjoint=True)

    def solve(self, rhs, trans="N"):
        bmat, squeeze = _as_2d(rhs, self.device)
        if trans not in ("N", "T", "H"):
            raise ValueError("trans must be 'N', 'T' or 'H'")
        if getattr(self, "_mode", "dense") == "sparse":
            # real factors: A^H == A^T, so 'H' == 'T'; a complex rhs solves
            # its real and imaginary parts against the same factors
            if bmat.is_complex():
                x = torch.complex(self._solve_sparse_real(bmat.real.to(self._dt), trans),
                                  self._solve_sparse_real(bmat.imag.to(self._dt), trans))
            else:
                x = self._solve_sparse_real(bmat.to(self._dt), trans)
            return x[:, 0] if squeeze else x
        if bmat.is_complex() and not self._lu.is_complex():
            # a real factor and a complex rhs: real and imaginary parts apart
            # (a cast would drop the imaginary part)
            x = torch.complex(self._lu_solve(bmat.real.to(self._lu.dtype), trans),
                              self._lu_solve(bmat.imag.to(self._lu.dtype), trans))
        else:
            x = self._lu_solve(bmat.to(self._lu.dtype), trans)
        return x[:, 0] if squeeze else x


class SpILU:
    """Incomplete LU (ILU(0), optional threshold drop) with scipy's
    ``SuperLU`` surface (shape, nnz, perm_r, perm_c, L, U, solve).

    The factorization is the native row-sequential ILU(0) on the host; each
    solve is two :class:`_PreparedTriangular` applies on A's device, so the
    object preconditions cg/gmres without leaving the device. O(nnz)
    memory. ``drop_tol`` drops factor off-diagonals with
    |v| < drop_tol * ||A_row||_2 after the factorization: it thins the
    factors and never adds fill."""

    def __init__(self, A, drop_tol=None, block=256):
        A = A.tocsr()
        m, n = A.shape
        if m != n:
            raise ValueError("matrix must be square")
        self.shape = (m, n)
        self.device = A.device
        self.perm_r = np.arange(n)
        self.perm_c = np.arange(n)
        if A.dtype.is_complex:
            raise NotImplementedError("SpILU/ilu0 are real-valued; use splu for complex matrices")
        row, col, data = _coo_host(A)
        indptr, row, col, data = _coo_to_csr_host(row, col, data, n)
        data = data.astype(np.float64)

        from . import native

        fdata = native.ilu0_host(indptr, col, data, n)
        keep = np.ones(fdata.size, dtype=bool)
        if drop_tol is not None and drop_tol > 0:
            sq = np.zeros(n)
            np.add.at(sq, row, data * data)
            keep = (np.abs(fdata) >= drop_tol * np.sqrt(sq)[row]) | (row == col)
        lmask = (col < row) & keep
        umask = (col >= row) & keep
        # scipy's nnz counts the factors: L with its unit diagonal, and U
        self.nnz = int(lmask.sum()) + int(umask.sum()) + n
        self._dtype = _float_dtype(A.dtype)
        self._Lsolve = _PreparedTriangular(n, row[lmask], col[lmask], fdata[lmask], lower=True,
                                           unit_diagonal=True, block=block, dtype=self._dtype,
                                           device=self.device)
        self._Usolve = _PreparedTriangular(n, row[umask], col[umask], fdata[umask], lower=False,
                                           unit_diagonal=False, block=block, dtype=self._dtype,
                                           device=self.device)
        self._parts = (row, col, fdata, lmask, umask)
        self._L_cache = None
        self._U_cache = None

    def _factor_csr(self, mask, unit_diag):
        row, col, fdata, _, _ = self._parts
        n = self.shape[0]
        r, c, v = row[mask], col[mask], fdata[mask]
        if unit_diag:
            r = np.concatenate([r, np.arange(n)])
            c = np.concatenate([c, np.arange(n)])
            v = np.concatenate([v, np.ones(n)])
        indptr, _, c, v = _coo_to_csr_host(r, c, v, n)
        return _csr_from_host(indptr, c, v, self.shape, self.device)

    @property
    def L(self):
        if self._L_cache is None:
            self._L_cache = self._factor_csr(self._parts[3], unit_diag=True)
        return self._L_cache

    @property
    def U(self):
        if self._U_cache is None:
            self._U_cache = self._factor_csr(self._parts[4], unit_diag=False)
        return self._U_cache

    def solve(self, rhs, trans="N"):
        if trans != "N":
            raise NotImplementedError("SpILU.solve supports trans='N' only")
        bmat, squeeze = _as_2d(rhs, self.device)
        if bmat.is_complex():
            x = torch.complex(self._Usolve.apply(self._Lsolve.apply(bmat.real)),
                              self._Usolve.apply(self._Lsolve.apply(bmat.imag)))
        else:
            x = self._Usolve.apply(self._Lsolve.apply(bmat))
        return x[:, 0] if squeeze else x


def ilu0(A, block=256):
    """ILU(0) factorization: ``spilu(A)`` without dropping."""
    return SpILU(A, drop_tol=None, block=block)


class _IC0:
    """IC(0)'s factor L (``.L``) and ``.solve`` applying (L L^T)^-1 by two
    blocked triangular solves on the matrix's device."""

    def __init__(self, shape, row, col, fdata, dt, device):
        n = shape[0]
        self.shape = shape
        self.nnz = fdata.size
        self._Lsolve = _PreparedTriangular(n, row, col, fdata, lower=True, unit_diagonal=False,
                                           dtype=dt, device=device)
        # L^T: the same entries, coordinates swapped
        self._Ltsolve = _PreparedTriangular(n, col, row, fdata, lower=False,
                                            unit_diagonal=False, dtype=dt, device=device)
        ip = np.zeros(n + 1, dtype=np.int64)
        np.add.at(ip, row + 1, 1)
        self.device = device
        self.L = _csr_from_host(np.cumsum(ip), col, fdata, shape, device)

    def solve(self, rhs):
        bmat, squeeze = _as_2d(rhs, self.device)
        x = self._Ltsolve.apply(self._Lsolve.apply(bmat))
        return x[:, 0] if squeeze else x


def ic0(A, block=256):
    """Incomplete Cholesky IC(0) of an SPD matrix: A ~= L L^T on the
    lower-triangular pattern; the object's ``solve`` is the classic SPD
    preconditioner for :func:`cg`."""
    A = A.tocsr()
    m, n = A.shape
    if m != n:
        raise ValueError("matrix must be square")
    if A.dtype.is_complex:
        raise NotImplementedError("ic0 is real-valued (SPD matrices)")
    row, col, data = _coo_host(A)
    lm = col <= row
    indptr, row, col, data = _coo_to_csr_host(row[lm], col[lm], data[lm].astype(np.float64), n)

    from . import native

    fdata = native.ic0_host(indptr, col, data, n)
    return _IC0((m, n), row, col, fdata, _float_dtype(A.dtype), A.device)


def splu(A, permc_spec=None, diag_pivot_thresh=None, relax=None, panel_size=None,
         options=None):
    """LU factorization returning a :class:`SuperLU`
    (scipy.sparse.linalg.splu). ``permc_spec``: ``"NATURAL"`` (default;
    scipy's COLAMD/MMD names are taken as it); ``"RCM"`` pre-permutes the
    sparse factorization symmetrically by csgraph's reverse Cuthill-McKee
    order, which cuts the fill of a scattered banded pattern. The other
    SuperLU knobs are accepted and ignored."""
    return SuperLU(A, permc_spec=permc_spec)


def spilu(A, drop_tol=None, fill_factor=None, drop_rule=None, **kw):
    """Incomplete-LU preconditioner (scipy.sparse.linalg.spilu), O(nnz)
    memory with no size ceiling:

    * ``fill_factor`` given (scipy's ILUT): the native ILUT(p, tau) on the
      Gilbert-Peierls core, ``drop_tol`` default 1e-4 (scipy's), partial
      pivoting;
    * ``fill_factor`` omitted: ILU(0) on A's pattern (:class:`SpILU`),
      ``drop_tol`` a post-factorization thinning.

    ``drop_rule`` is ignored. Complex matrices take the exact dense
    factorization (the native kernels are real)."""
    if A.dtype.is_complex:
        return SuperLU(A)
    if fill_factor is not None:
        obj = SuperLU._ilut(A, drop_tol, fill_factor)
        if obj is not None:
            return obj
    return SpILU(A, drop_tol=drop_tol)


def factorized(A):
    """Pre-factorized solve closure (scipy.sparse.linalg.factorized)."""
    return splu(A).solve


def inv(A):
    """Sparse inverse by one factorization and n triangular solves
    (scipy.sparse.linalg.inv; A's format). The inverse of a sparse matrix is
    dense, so n past ``DENSE_DIRECT_MAX_N`` raises whatever splu could do."""
    n = A.shape[0]
    if n > DENSE_DIRECT_MAX_N:
        raise ValueError(
            f"inv: n={n} exceeds the dense ceiling ({DENSE_DIRECT_MAX_N}); the inverse of a "
            "sparse matrix is dense — use factorized(A) (or splu(A).solve) to apply A^-1 to "
            "vectors instead")
    lu = splu(A)
    dt = lu._lu.dtype if getattr(lu, "_mode", "dense") == "dense" else lu._dt
    X = lu.solve(torch.eye(n, dtype=dt, device=lu.device))
    from .csr import csr_array

    return csr_array(X).asformat(A.format)


def expm(A):
    """Sparse matrix exponential (scipy.sparse.linalg.expm): densify and
    take ``torch.linalg.matrix_exp`` (scaling and squaring) on A's device;
    A's format back."""
    from .csr import csr_array

    n = A.shape[0]
    if n > DENSE_DIRECT_MAX_N:
        raise ValueError(
            f"expm: n={n} exceeds the dense ceiling ({DENSE_DIRECT_MAX_N}); use expm_multiply to "
            "apply the exponential to vectors instead")
    E = torch.linalg.matrix_exp(A.toarray().to(_float_dtype(A.dtype)))
    out = csr_array(E)
    fmt = getattr(A, "format", "csr")
    return out.asformat(fmt) if fmt in ("csr", "csc", "coo", "dia") else out
