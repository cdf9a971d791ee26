"""LaplacianNd, the N-D grid Laplacian operator with closed-form eigenpairs
(``sparse_tpu/_laplacian.py``; scipy.sparse.linalg.LaplacianNd).

``matvec`` applies the stencil as shifted adds on the reshaped grid
(``torch.roll`` and edge masks, no sparse gather); ``tosparse`` assembles
the matrix by ``module.kronsum`` of 1-D stencils, whose products then take
the DIA kernel on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .linalg import LinearOperator
from .utils import as_tensor, resolve_device

__all__ = ["LaplacianNd"]

_BCS = ("dirichlet", "neumann", "periodic")


def _eigvals_1d(n: int, bc: str) -> np.ndarray:
    i = np.arange(n)
    if bc == "dirichlet":
        return -4.0 * np.sin(np.pi * (i + 1) / (2 * (n + 1))) ** 2
    if bc == "neumann":
        return -4.0 * np.sin(np.pi * i / (2 * n)) ** 2
    return -4.0 * np.sin(np.pi * i / n) ** 2  # periodic


def _eigvecs_1d(n: int, bc: str) -> np.ndarray:
    """[n, n] columns: the eigenvectors in _eigvals_1d's order."""
    j = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    if bc == "dirichlet":
        V = np.sin(np.pi * (j + 1) * (i + 1) / (n + 1))
    elif bc == "neumann":
        V = np.cos(np.pi * i * (j + 0.5) / n)
    else:  # periodic: real cos/sin pairs per frequency
        V = np.zeros((n, n))
        for k in range(n):
            if k == 0:
                V[:, k] = 1.0
            elif 2 * k == n:  # Nyquist
                V[:, k] = np.cos(np.pi * j[:, 0])
            elif k <= n // 2:
                V[:, k] = np.cos(2 * np.pi * k * j[:, 0] / n)
            else:  # the sin partner of frequency n - k (same eigenvalue)
                V[:, k] = np.sin(2 * np.pi * (n - k) * j[:, 0] / n)
    V /= np.linalg.norm(V, axis=0, keepdims=True)
    return V


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


class LaplacianNd(LinearOperator):
    """N-D grid Laplacian under ``dirichlet``/``neumann``/``periodic``
    boundary conditions (scipy's surface: ``toarray``, ``tosparse``,
    ``eigenvalues(m)``, ``eigenvectors(m)``), on ``device`` (default
    ``settings.device``).

    A size-1 axis under neumann/periodic contributes 0: a single cell has
    no neighbors. ``matvec``, ``tosparse`` and the eigenpairs all agree on
    it (scipy's ``toarray`` puts -1 on that diagonal while its eigenvalue
    formula says 0). ``tosparse`` carries the operator's dtype when it is a
    floating one, else float64; its values are the same."""

    def __init__(self, grid_shape, *, boundary_conditions="neumann", dtype=np.int8,
                 device=None):
        if boundary_conditions not in _BCS:
            raise ValueError(
                f"boundary_conditions must be one of {_BCS}, got {boundary_conditions!r}")
        self.grid_shape = tuple(int(g) for g in grid_shape)
        self.boundary_conditions = boundary_conditions
        n = int(np.prod(self.grid_shape))
        super().__init__((n, n), dtype=_torch_dtype(dtype))
        self.device = resolve_device(device)

    # -- the stencil as shifted adds ----------------------------------------
    def matvec(self, x):
        x = as_tensor(x, self.device)
        squeeze = x.ndim == 1
        cols = 1 if squeeze else x.shape[1]
        g = self.grid_shape
        bc = self.boundary_conditions
        v = x.reshape(g + (cols,))
        y = torch.zeros_like(v)
        for ax in range(len(g)):
            n = g[ax]
            up = torch.roll(v, -1, dims=ax)  # neighbor at i + 1
            dn = torch.roll(v, 1, dims=ax)  # neighbor at i - 1
            if bc != "periodic":  # no wrapped neighbor
                up.select(ax, n - 1).zero_()
                dn.select(ax, 0).zero_()
            diag = torch.full_like(v, -2.0)
            if bc == "neumann":  # a missing neighbor contributes its own cell
                diag.select(ax, n - 1).fill_(-1.0)
                diag.select(ax, 0).add_(1.0)
            y = y + up + dn + diag * v
        y = y.reshape((self.shape[0], cols))
        return y[:, 0] if squeeze else y

    rmatvec = matvec  # symmetric

    def matmat(self, X):
        return self.matvec(X)

    # -- assembly ---------------------------------------------------------
    def tosparse(self):
        from .module import diags, kronsum

        dt = self.dtype if self.dtype.is_floating_point else torch.float64
        parts = []
        for n in self.grid_shape:
            o = np.full(n - 1, 1.0) if n > 1 else np.zeros(0)
            d = np.full(n, -2.0)
            if self.boundary_conditions == "neumann":
                # += (not =): a size-1 axis has both faces on one cell,
                # whose diagonal cancels to 0 (as matvec)
                d[0] += 1.0
                d[-1] += 1.0
            bands, offs = [o, d, o], [-1, 0, 1]
            if self.boundary_conditions == "periodic" and n == 1:
                bands, offs = [np.zeros(1)], [0]  # its own both neighbors: 0
            elif self.boundary_conditions == "periodic" and n == 2:
                bands = [np.full(1, 2.0), d, np.full(1, 2.0)]  # wrap == direct neighbor
            elif self.boundary_conditions == "periodic" and n > 2:
                bands = [np.ones(1), o, d, o, np.ones(1)]
                offs = [-(n - 1), -1, 0, 1, n - 1]
            parts.append(diags(bands, offs, shape=(n, n), dtype=dt, device=self.device))
        L = parts[0]
        for p in parts[1:]:
            L = kronsum(p, L)  # kron(I, L) + kron(p, I): row-major order
        return L.tocsr()

    def toarray(self):
        return self.tosparse().toarray().to(self.dtype)

    # -- closed-form eigenpairs (host numpy, as scipy) ------------------------
    def _all_eigvals(self):
        total = np.zeros(self.grid_shape)
        for ax, n in enumerate(self.grid_shape):
            shape = [1] * len(self.grid_shape)
            shape[ax] = n
            total = total + _eigvals_1d(n, self.boundary_conditions).reshape(shape)
        return total

    def eigenvalues(self, m=None):
        """All (or the ``m`` largest) eigenvalues, ascending (scipy)."""
        w = np.sort(self._all_eigvals().ravel())
        if m is None:
            return w
        return w[len(w) - int(m):]  # not w[-m:]: m = 0 gives none

    def eigenvectors(self, m=None):
        """Eigenvectors in ``eigenvalues(m)``'s order, [N, m]."""
        order = np.argsort(self._all_eigvals().ravel())
        if m is not None:
            order = order[len(order) - int(m):]
        if len(order) == 0:
            return np.zeros((self.shape[0], 0))
        Vs = [_eigvecs_1d(n, self.boundary_conditions) for n in self.grid_shape]
        cols = []
        for flat in order:
            v = np.ones(1)
            for ax, i in enumerate(np.unravel_index(flat, self.grid_shape)):
                v = np.kron(v, Vs[ax][:, i])
            cols.append(v / np.linalg.norm(v))
        return np.stack(cols, axis=1)
