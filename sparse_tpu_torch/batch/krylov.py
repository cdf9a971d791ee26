"""Masked batched Krylov solvers: CG, BiCGStab and GMRES over lane stacks.

Port of ``sparse_tpu/batch/krylov.py`` (``batched_ir`` waits for the
mixed-precision package). One loop drives B independent systems; each lane
carries its own convergence mask, iteration count and residual. Converged
lanes freeze: every carried tensor updates through ``torch.where(active,
new, old)``, so a finished lane's iterate stays bit-stable while the
others work. Convergence is tested at the points of the unbatched solvers
(every ``conv_test_iters`` steps and at ``maxiter - 1``, absolute
``||r|| < tol``), so a batch of one reproduces ``linalg.cg``. On a SELL
operator each lane's SpMV and dot products equal those of the lone solve
bit for bit (the chunk layout's work list depends on the pattern alone,
``kernels/sell_spmv.sell_chunk_pack``; ``linalg._vdot``), so a lane's
iterates and iteration count are the lone ``linalg.cg``'s.

Host syncs: the reference's ``while any(active)`` runs on the device. Here
the host reads the mask only at the test points: between them ``active``
cannot change, so the iterates and counts are the same as a check every
step. GMRES syncs once per restart cycle (and to end a cycle whose lanes
are all done).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# per-lane inner product (last axis, first argument conjugated): linalg's,
# so a lane's scalars equal those of its lone solve
from ..linalg import _vdot as _bdot
from ..utils import as_tensor, resolve_device
from .operator import BatchedOperator, as_batched_matvec


@dataclass
class BatchedSolveInfo:
    """Per-lane outcome of a batched solve: ``iters`` (the count at freeze,
    the unbatched solver's ``iters`` for that lane), ``resid2`` (final
    squared residual norm) and ``converged`` (met its tolerance, as opposed
    to hitting ``maxiter``), each ``(B,)``."""

    iters: torch.Tensor
    resid2: torch.Tensor
    converged: torch.Tensor

    @property
    def batch(self) -> int:
        return int(self.iters.shape[0])


def _nz(v):
    """``v`` with zeros replaced by one: the 0/0 guard of the recurrences."""
    return torch.where(v == 0, torch.ones_like(v), v)


def _device(A):
    dev = getattr(A, "device", None)
    return dev if isinstance(dev, torch.device) else resolve_device()


def _lanes(x, dev, dtype=None):
    x = as_tensor(x, dev, dtype)
    return x[None, :] if x.ndim == 1 else x


def _prep(A, b, x0, tol, maxiter):
    """Entry glue: the matvec, b promoted to the operator's dtype, X0, the
    per-lane tolerance. Returns (matvec, b, X0, tol(B,), maxiter)."""
    mv = as_batched_matvec(A)
    b = _lanes(b, _device(A))
    if b.ndim != 2:
        raise ValueError(f"rhs must be (B, n); got {tuple(b.shape)}")
    if isinstance(A, BatchedOperator):
        if A.batch != b.shape[0]:
            raise ValueError(f"operator batch {A.batch} != rhs batch {b.shape[0]}")
        b = b.to(torch.promote_types(b.dtype, A.dtype))
    B, n = b.shape
    if maxiter is None:
        maxiter = n * 10
    X0 = torch.zeros_like(b) if x0 is None else _lanes(x0, b.device, b.dtype)
    rdt = b.real.dtype
    tol = torch.broadcast_to(torch.as_tensor(tol, dtype=rdt, device=b.device), (B,))
    return mv, b, X0, tol, int(maxiter)


def _tested(k: int, cti: int, maxiter: int) -> bool:
    return k % cti == 0 or k == maxiter - 1


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------
def _cg_loop(matvec, b, X0, tol, maxiter, conv_test_iters, Mvec=None):
    """Masked batched CG core: the recurrences and test points of
    ``linalg._cg_device_loop`` with per-lane scalars. Returns
    ``(X, iters, resid2, converged)``."""
    tol2 = tol.to(b.real.dtype) ** 2
    B = b.shape[0]
    cti = max(int(conv_test_iters), 1)
    X = X0
    R = b - matvec(X)
    P = torch.zeros_like(b)
    rho = torch.zeros((B,), dtype=b.dtype, device=b.device)
    active = torch.ones((B,), dtype=torch.bool, device=b.device)
    iters = torch.zeros((B,), dtype=torch.int32, device=b.device)
    k = 0
    while k < maxiter:
        Z = R if Mvec is None else Mvec(R)
        rho_new = _bdot(R, Z)
        beta = rho_new / _nz(rho)
        Pn = Z if k == 0 else Z + beta[:, None] * P
        Q = matvec(Pn)
        pq = _bdot(Pn, Q)
        alpha = rho_new / _nz(pq)  # 0/0 guard: b = 0 or an exact x0
        am = active[:, None]
        X = torch.where(am, X + alpha[:, None] * Pn, X)
        R = torch.where(am, R - alpha[:, None] * Q, R)
        P = torch.where(am, Pn, P)
        rho = torch.where(active, rho_new, rho)
        iters += active.to(torch.int32)
        k += 1
        if _tested(k, cti, maxiter):
            active = active & ~(_bdot(R, R).real < tol2)
            if not bool(active.any()):
                break
    return X, iters, _bdot(R, R).real, ~active


def batched_cg(A, b, x0=None, tol=1e-08, maxiter=None, M=None, conv_test_iters=25):
    """Batched conjugate gradient over a lane stack.

    ``A`` is a :class:`~sparse_tpu_torch.batch.operator.BatchedOperator`, a
    ``(B, n) -> (B, n)`` callable, or anything ``make_batched_operator``
    takes; ``b`` is ``(B, n)``; ``tol`` broadcasts per lane. Returns
    ``(X, BatchedSolveInfo)``. A batch of one matches ``linalg.cg``.
    """
    mv, b, X0, tol, maxiter = _prep(A, b, x0, tol, maxiter)
    Mvec = None if M is None else as_batched_matvec(M)
    X, iters, resid2, conv = _cg_loop(mv, b, X0, tol, maxiter, conv_test_iters, Mvec)
    return X, BatchedSolveInfo(iters, resid2, conv)


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------
def _bicgstab_loop(matvec, b, X0, tol, maxiter, conv_test_iters, Mvec=None):
    """Masked batched BiCGStab core: the reference's recurrences with
    per-lane scalars and frozen converged lanes; ``Mvec`` right-
    preconditions the search directions."""
    tol2 = tol.to(b.real.dtype) ** 2
    B = b.shape[0]
    cti = max(int(conv_test_iters), 1)
    X = X0
    R = b - matvec(X)
    Rt = R
    P = torch.zeros_like(b)
    V = torch.zeros_like(b)
    rho = torch.zeros((B,), dtype=b.dtype, device=b.device)
    alpha = torch.ones((B,), dtype=b.dtype, device=b.device)
    omega = torch.ones((B,), dtype=b.dtype, device=b.device)
    active = torch.ones((B,), dtype=torch.bool, device=b.device)
    iters = torch.zeros((B,), dtype=torch.int32, device=b.device)
    k = 0
    while k < maxiter:
        rho_new = _bdot(Rt, R)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        Pn = R if k == 0 else R + beta[:, None] * (P - omega[:, None] * V)
        Ph = Pn if Mvec is None else Mvec(Pn)
        Vn = matvec(Ph)
        alpha_n = rho_new / _nz(_bdot(Rt, Vn))
        S = R - alpha_n[:, None] * Vn
        Sh = S if Mvec is None else Mvec(S)
        T = matvec(Sh)
        omega_n = _bdot(T, S) / _nz(_bdot(T, T))
        am = active[:, None]
        X = torch.where(am, X + alpha_n[:, None] * Ph + omega_n[:, None] * Sh, X)
        R = torch.where(am, S - omega_n[:, None] * T, R)
        P = torch.where(am, Pn, P)
        V = torch.where(am, Vn, V)
        rho = torch.where(active, rho_new, rho)
        alpha = torch.where(active, alpha_n, alpha)
        omega = torch.where(active, omega_n, omega)
        iters += active.to(torch.int32)
        k += 1
        if _tested(k, cti, maxiter):
            active = active & ~(_bdot(R, R).real < tol2)
            if not bool(active.any()):
                break
    return X, iters, _bdot(R, R).real, ~active


def batched_bicgstab(A, b, x0=None, tol=1e-08, maxiter=None, M=None, conv_test_iters=25):
    """Batched BiCGStab; see :func:`batched_cg` for the lane contract. ``M``
    right-preconditions, so the residual recurrence and the stopping rule
    stay those of the unpreconditioned solver."""
    mv, b, X0, tol, maxiter = _prep(A, b, x0, tol, maxiter)
    Mvec = None if M is None else as_batched_matvec(M)
    X, iters, resid2, conv = _bicgstab_loop(mv, b, X0, tol, maxiter, conv_test_iters, Mvec)
    return X, BatchedSolveInfo(iters, resid2, conv)


# ---------------------------------------------------------------------------
# GMRES: batched restart cycles, host-driven outer loop
# ---------------------------------------------------------------------------
def _make_batched_gmres_cycle(mv, Mv, restart: int, dt):
    """One restart cycle of the reference's batched GMRES: per-lane
    Hessenberg/Givens scalars as ``(B,)`` vectors, the Krylov basis
    ``(B, restart+1, n)``, and lanes that converge or break down mid-cycle
    frozen (their carries mask on ``~done``) while the others finish.
    Returns the per-lane ``(inner, entry residual, breakdown)`` triple."""
    rdt = torch.empty((), dtype=dt).real.dtype

    def cycle(X, b, target):
        B, n = b.shape
        dev = b.device
        R = Mv(b - mv(X))
        beta = torch.linalg.vector_norm(R, dim=-1)
        start_ok = beta > target
        beta_safe = torch.where(start_ok, beta, torch.ones_like(beta))
        V = torch.zeros((B, restart + 1, n), dtype=dt, device=dev)
        V[:, 0] = R / beta_safe[:, None].to(dt)
        H = torch.zeros((B, restart + 1, restart), dtype=dt, device=dev)
        cs = torch.zeros((B, restart), dtype=rdt, device=dev)
        sn = torch.zeros((B, restart), dtype=dt, device=dev)
        g = torch.zeros((B, restart + 1), dtype=dt, device=dev)
        g[:, 0] = beta.to(dt)
        kk = torch.zeros((B,), dtype=torch.int32, device=dev)
        bd = torch.zeros((B,), dtype=torch.bool, device=dev)
        done = ~start_ok
        one_r = torch.ones((), dtype=rdt, device=dev)
        for j in range(restart):
            if bool(done.all()):
                break
            w = Mv(mv(V[:, j]))
            # masked modified Gram-Schmidt + one reorthogonalization pass
            mask = (torch.arange(restart + 1, device=dev) <= j).to(rdt)
            hcol = torch.einsum("bin,bn->bi", V.conj(), w) * mask
            w = w - torch.einsum("bi,bin->bn", hcol, V)
            h2 = torch.einsum("bin,bn->bi", V.conj(), w) * mask
            w = w - torch.einsum("bi,bin->bn", h2, V)
            hcol = hcol + h2
            hkk = torch.linalg.vector_norm(w, dim=-1)
            grew = hkk > 1e-30
            upd = ~done
            vnew = torch.where(grew[:, None], w / torch.where(grew, hkk, one_r)[:, None].to(dt),
                               torch.zeros((), dtype=dt, device=dev))
            V[:, j + 1] = torch.where(upd[:, None], vnew, V[:, j + 1])
            col = hcol.clone()
            col[:, j + 1] = hkk.to(dt)
            for i in range(j):  # apply the earlier rotations
                t = cs[:, i] * col[:, i] + sn[:, i] * col[:, i + 1]
                bt = -torch.conj(sn[:, i]) * col[:, i] + cs[:, i] * col[:, i + 1]
                col[:, i] = t
                col[:, i + 1] = bt
            hk, hk1 = col[:, j].clone(), col[:, j + 1].clone()
            ahk, ahk1 = torch.abs(hk), torch.abs(hk1)
            denom = torch.sqrt(ahk * ahk + ahk1 * ahk1)
            breakdown = denom <= 0
            denom_s = torch.where(breakdown, one_r, denom)
            ck = torch.where(ahk == 0, torch.zeros_like(ahk), ahk / denom_s)
            hk_unit = torch.where(ahk == 0, torch.ones_like(hk),
                                  hk / torch.where(ahk == 0, one_r, ahk).to(dt))
            sk = torch.where(
                ahk == 0,
                torch.conj(hk1) / torch.where(ahk1 == 0, one_r, ahk1).to(dt),
                hk_unit * torch.conj(hk1) / denom_s.to(dt),
            )
            col[:, j] = ck.to(dt) * hk + sk * hk1
            col[:, j + 1] = 0
            H[:, :, j] = torch.where(upd[:, None], col, H[:, :, j])
            cs[:, j] = torch.where(upd, ck, cs[:, j])
            sn[:, j] = torch.where(upd, sk, sn[:, j])
            gk1 = -torch.conj(sk) * g[:, j]
            ok = upd & ~breakdown
            g[:, j + 1] = torch.where(ok, gk1, g[:, j + 1])
            g[:, j] = torch.where(ok, ck.to(dt) * g[:, j], g[:, j])
            conv = torch.abs(gk1) < target
            kk = kk + ok.to(torch.int32)
            bd = bd | (upd & breakdown)
            done = done | (upd & (breakdown | conv))
        # per-lane masked triangular solve: columns past each lane's kk get
        # a unit diagonal and a zero right-hand side
        idx = torch.arange(restart, device=dev)
        mk = (idx[None, :] < kk[:, None]).to(rdt)
        Hs = H[:, :restart, :restart] * (mk[:, :, None] * mk[:, None, :])
        Hs = Hs + torch.einsum("bi,ij->bij", 1.0 - mk,
                               torch.eye(restart, dtype=rdt, device=dev)).to(dt)
        gv = g[:, :restart] * mk
        y = torch.linalg.solve_triangular(Hs, gv[:, :, None], upper=True)[:, :, 0]
        X = X + torch.einsum("bi,bin->bn", y, V[:, :restart])
        info = torch.stack([kk.to(rdt), beta.to(rdt), bd.to(rdt)], dim=-1)
        return X, info

    return cycle


def batched_gmres(A, b, x0=None, tol=1e-08, restart=None, maxiter=None, M=None, atol=None):
    """Batched restarted GMRES: batched Arnoldi cycles, one host sync per
    restart, per-lane masks at both granularities (mid-cycle freezing,
    converged lanes skipped across restarts).

    The stopping rule of ``linalg.gmres``: relative ``tol * ||b||`` floored
    by ``atol``, per lane. Returns ``(X, BatchedSolveInfo)``; ``info.iters``
    counts inner iterations, breakdown stages included.
    """
    mv = as_batched_matvec(A)
    b = _lanes(b, _device(A))
    dt = b.dtype
    if isinstance(A, BatchedOperator):
        dt = torch.promote_types(dt, A.dtype)
    if x0 is not None:
        x0 = _lanes(x0, b.device)
        dt = torch.promote_types(dt, x0.dtype)
    b = b.to(dt)
    B, n = b.shape
    if restart is None:
        restart = min(20, n)
    restart = min(int(restart), n)
    if maxiter is None:
        maxiter = max(n // restart, 1) * 10
    X = torch.zeros_like(b) if x0 is None else x0.to(dt)
    rdt = b.real.dtype
    bnorm = torch.linalg.vector_norm(b, dim=-1)
    tol_l = torch.broadcast_to(torch.as_tensor(tol, dtype=rdt, device=b.device), (B,))
    target = torch.clamp(tol_l * bnorm, min=atol if atol is not None else 0.0)
    target = torch.clamp(target, min=1e-30)

    Mv = (lambda r: r) if M is None else as_batched_matvec(M)
    cycle = _make_batched_gmres_cycle(mv, Mv, restart, dt)
    iters = torch.zeros((B,), dtype=torch.int64)
    lane_done = torch.zeros((B,), dtype=torch.bool)
    beta_last = torch.zeros((B,), dtype=torch.float64)
    for _outer in range(int(maxiter)):
        X, info = cycle(X, b, target)
        info_h = info.double().cpu()  # the one host sync of the cycle
        inner = info_h[:, 0].to(torch.int64)
        beta_last = torch.where(lane_done, beta_last, info_h[:, 1])
        bdown = info_h[:, 2] > 0
        newly_done = (inner == 0) & ~bdown
        # breakdown stages did a matvec but add no column; count them like
        # the unbatched solver so iters reflects work
        iters += torch.where(lane_done, torch.zeros_like(inner), inner + bdown.to(torch.int64))
        lane_done |= newly_done
        if bool(lane_done.all()):
            break
    resid2 = (beta_last.to(rdt) ** 2).to(b.device)
    info = BatchedSolveInfo(iters.to(torch.int32).to(b.device), resid2, lane_done.to(b.device))
    return X, info
