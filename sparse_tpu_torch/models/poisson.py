"""5-point Poisson/Laplacian workload: the PDE benchmark's compute core.

Port of ``sparse_tpu/models/poisson.py``. The operator is generated on the
device in its layout (ELL or scipy DIA planes) with plain torch ops, and
the CG loops are Python loops over device tensors with the scalars kept on
the device, so a fixed-iteration run makes no host sync (the counterpart
of the reference's compiled ``fori_loop``).

The flagship step, :func:`make_cg_step_dia`, sends its SpMV through
``kernels.dia_spmv.dia_spmv_direct``, the hand-written kernel on a CUDA
tensor. ``laplacian_2d_csr`` builds the operator as the reference does,
``kron(l1, I) + kron(I, l1)``, on the device.

Every function that makes data runs on ``settings.device`` unless given
``device=``. ``jax.random`` becomes a seeded ``torch.Generator``, which
gives other numbers than the reference from the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.dia_spmv import dia_spmv_direct
from ..ops.dia_spmv import dia_spmv_torch
from ..ops.spmv import csr_spmv_ell as _spmv_ell
from ..utils import resolve_device


def laplacian_2d_ell(n: int, dtype=torch.float32, device=None):
    """The n*n-point 2-D 5-point Laplacian as ELL planes ([N, 5] idx/val).

    Stencil per grid point (i, j): 4 on the diagonal, -1 to each in-grid
    neighbor. Out-of-grid slots point at column 0 with value 0.
    """
    dev = resolve_device(device)
    N = n * n
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    i, j = ids // n, ids % n
    # neighbor columns: W, S, center, N, E (sorted by column id)
    cols = torch.stack([ids - n, ids - 1, ids, ids + 1, ids + n], dim=1)
    valid = torch.stack([i > 0, j > 0, torch.ones_like(ids, dtype=torch.bool), j < n - 1,
                         i < n - 1], dim=1)
    stencil = torch.tensor([-1.0, -1.0, 4.0, -1.0, -1.0], dtype=dtype, device=dev)
    vals = torch.where(valid, stencil, torch.zeros((), dtype=dtype, device=dev))
    cols = torch.where(valid, cols, torch.zeros((), dtype=torch.int32, device=dev))
    return cols, vals


def laplacian_2d_csr(n: int, dtype=np.float64, device=None):
    """The n*n-point 2-D Laplacian through the library's own diags, kron
    and sparse addition: kron(l1, I) + kron(I, l1) as CSR, l1 the 1-D
    [-1, 2, -1] stencil."""
    from ..module import diags, identity, kron

    l1 = diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), dtype=dtype, device=device)
    eye = identity(n, dtype=dtype, device=device)
    return (kron(l1, eye) + kron(eye, l1)).tocsr()


def laplacian_2d_csr_host(n: int, dtype=np.float64, device=None):
    """Large-scale CSR construction on the host (numpy assembly of the
    stencil rows in CSR order, O(nnz)), then one copy to the device."""
    from ..csr import csr_array

    N = n * n
    ids = np.arange(N, dtype=np.int64)
    i, j = ids // n, ids % n
    # per-row neighbor columns in sorted order: W(-n), S(-1), C, N(+1), E(+n)
    cols = np.stack([ids - n, ids - 1, ids, ids + 1, ids + n], axis=1)
    valid = np.stack([i > 0, j > 0, np.ones(N, dtype=bool), j < n - 1, i < n - 1], axis=1)
    vals = np.broadcast_to(np.where(np.arange(5) == 2, 4.0, -1.0).astype(dtype), (N, 5))[valid]
    indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=indptr[1:])
    dev = resolve_device(device)
    return csr_array.from_parts(
        torch.from_numpy(np.ascontiguousarray(vals)).to(dev),
        torch.from_numpy(cols[valid]).to(dev), torch.from_numpy(indptr).to(dev), (N, N),
    )


def laplacian_2d_dia(n: int, dtype=torch.float32, device=None):
    """The n*n 2-D 5-point Laplacian as DIA planes ([5, N] data).

    scipy DIA convention: data[k, j] = A[j - o_k, j], so the mask for
    offset o is "row j - o is a grid neighbor of column j". Returns
    (planes, offsets) with offsets a tuple.
    """
    dev = resolve_device(device)
    N = n * n
    j = torch.arange(N, dtype=torch.int64, device=dev)
    col_in_row = j % n
    neg = torch.full((), -1.0, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    planes = torch.stack([
        torch.where(j + n < N, neg, zero),  # o=-n: vertical edge (j+n, j)
        torch.where(col_in_row < n - 1, neg, zero),  # o=-1: edge (j+1, j)
        torch.full((N,), 4.0, dtype=dtype, device=dev),  # o=0
        torch.where(col_in_row > 0, neg, zero),  # o=+1: edge (j-1, j)
        torch.where(j - n >= 0, neg, zero),  # o=+n: edge (j-n, j)
    ])
    return planes, (-n, -1, 0, 1, n)


def cg_step_ell(ell_idx, ell_val, x, r, p, rho):
    """One CG iteration on an ELL matrix."""
    rho_new = torch.dot(r, r)
    beta = rho_new / torch.where(rho == 0, torch.ones_like(rho), rho)
    p = torch.where(rho == 0, r, r + beta * p)
    q = _spmv_ell(ell_idx, ell_val, p)
    alpha = rho_new / torch.dot(p, q)
    return x + alpha * p, r - alpha * q, p, rho_new


def _normal(N: int, dtype, seed: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((N,), dtype=dtype, device=dev, generator=gen)


def poisson_cg_state(n: int, dtype=torch.float32, seed: int = 0, device=None):
    """Build (ell_idx, ell_val, x0, r0, p0, rho0) for an n*n Poisson solve."""
    dev = resolve_device(device)
    ell_idx, ell_val = laplacian_2d_ell(n, dtype=dtype, device=dev)
    N = n * n
    b = _spmv_ell(ell_idx, ell_val, _normal(N, dtype, seed, dev))
    zeros = torch.zeros((N,), dtype=dtype, device=dev)
    return ell_idx, ell_val, zeros, b, zeros.clone(), torch.zeros((), dtype=dtype, device=dev)


def cg_ell(ell_idx, ell_val, x, r, p, rho, iters: int = 300):
    """Fixed-iteration CG (throughput mode, like ``pde.py -throughput``)."""
    state = (x, r, p, rho)
    for _ in range(iters):
        state = cg_step_ell(ell_idx, ell_val, *state)
    return state


def make_cg_step_dia(offsets: tuple, n: int):
    """One CG iteration with the diagonal-layout SpMV; offsets are static
    structure, closed over, so the returned fn takes tensors alone.

    The SpMV is :func:`~sparse_tpu_torch.kernels.dia_spmv.dia_spmv_direct`,
    which launches the hand-written kernel on a CUDA tensor and runs its
    plain version on a CPU one. The scalars stay 0-d tensors: a step makes
    no host sync.
    """
    offsets = tuple(int(o) for o in offsets)
    N = n * n

    def cg_step_dia(planes, x, r, p, rho):
        rho_new = torch.dot(r, r)
        beta = rho_new / torch.where(rho == 0, torch.ones_like(rho), rho)
        p = torch.where(rho == 0, r, r + beta * p)
        q = dia_spmv_direct(planes, offsets, p, (N, N))
        alpha = rho_new / torch.dot(p, q)
        return x + alpha * p, r - alpha * q, p, rho_new

    return cg_step_dia


def poisson_cg_state_dia(n: int, dtype=torch.float32, seed: int = 0, device=None):
    """(planes, x0, r0, p0, rho0) and the step fn for an n*n Poisson solve,
    with b = A xtrue for a standard-normal xtrue from ``seed``."""
    dev = resolve_device(device)
    planes, offsets = laplacian_2d_dia(n, dtype=dtype, device=dev)
    N = n * n
    b = dia_spmv_torch(planes, offsets, _normal(N, dtype, seed, dev), (N, N))
    zeros = torch.zeros((N,), dtype=dtype, device=dev)
    state = (planes, zeros, b, zeros.clone(), torch.zeros((), dtype=dtype, device=dev))
    return state, make_cg_step_dia(offsets, n)


def cg_dia(step_fn, planes, x, r, p, rho, iters: int = 300):
    """Fixed-iteration DIA-CG: ``iters`` calls of ``step_fn``; returns
    (x, r, p, rho)."""
    state = (x, r, p, rho)
    for _ in range(iters):
        state = step_fn(planes, *state)
    return state
