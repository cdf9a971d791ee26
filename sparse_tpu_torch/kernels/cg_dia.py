"""Fused CG iteration on a DIA matrix: two hand-written kernels per iteration.

Port of ``sparse_tpu/kernels/cg_dia.py::cg_dia_fused`` around
``csrc/cg_dia.cu``, whose kernel A and kernel B replace the Pallas
``_kernel_a`` and ``_kernel_b``:

  * kernel A: beta from the device scalars, p_new = r + beta*p computed at
    every neighbour row it reads (recompute instead of a grid barrier),
    q = A p_new from the row-indexed planes, and <p_new, q>, from which
    its last block sets pq and alpha;
  * kernel B: x += alpha*p, r -= alpha*q, and <r, r>, from which its last
    block sets rho_prev and rho.

Vectors live padded at [m_pad + 2B] (the plan of ``kernels/dia_spmv.py``)
with zero halos. The scalars stay on the device in ``sc = [rho_prev, rho,
pq, alpha]``; a chunk of iterations makes no host sync. Unlike the JAX
function, this one updates the state it is given in place (x and r in
kernel B, p by ping-pong with a second buffer): the returned x and r are
views of the state's buffers.

Each wrapper runs its plain torch version for CPU tensors and launches
its CUDA kernel (or raises) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dia_spmv import DiaPlan, dia_pack, dia_pad_x, dia_plan, dia_spmv_packed

_THREADS = 256  # csrc/cg_dia.cu kThreads
_MAX_BLOCKS = 1024  # fixed grid cap: partial counts depend only on m_pad

_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIG_A = [_PTR] * 8 + [_I64, _I64, ctypes.POINTER(_I64), _I32, _I32, _PTR]
_SIG_B = [_PTR] * 7 + [_I64, _I64, _I32, _PTR]
_SIGNATURES = {"stk_cg_kernel_a_f32": _SIG_A, "stk_cg_kernel_b_f32": _SIG_B}
#: the fused CG's kernels are built for f32 only, the dtype of the
#: reference's fused-CG gate (linalg._try_fused_cg)
CG_KERNEL_DTYPES = (torch.float32,)

# scalar slots of sc
RHO_PREV, RHO, PQ, ALPHA = 0, 1, 2, 3


class CgWorkspace:
    """Per-block dot partials and the last-block ticket of both kernels
    (they run in order on one stream, so they share one set)."""

    __slots__ = ("nblocks", "partials", "ticket")

    def __init__(self, plan: DiaPlan, dtype, device):
        self.nblocks = max(min(-(-plan.m_pad // _THREADS), _MAX_BLOCKS), 1)
        self.partials = torch.empty((self.nblocks,), dtype=dtype, device=device)
        self.ticket = torch.zeros((1,), dtype=torch.int32, device=device)


def _scalar_guard_div(num, den):
    """num / den with 1 as the divisor where den == 0 (the reference's guard)."""
    return num / torch.where(den == 0, torch.ones_like(den), den)


def cg_kernel_a_plain(planes, r, p, pnew, q, sc, plan: DiaPlan):
    """Plain torch version of kernel A (same elementwise operations, in the
    same order; the dot is torch's)."""
    m_pad, B = plan.m_pad, plan.B
    rho_prev, rho = sc[RHO_PREV], sc[RHO]
    beta = torch.where(rho_prev == 0, torch.zeros_like(rho), _scalar_guard_div(rho, rho_prev))
    pw = r + beta * p
    acc = torch.zeros((m_pad,), dtype=r.dtype, device=r.device)
    for k, o in enumerate(plan.offsets):
        acc = acc + planes[k * m_pad : (k + 1) * m_pad] * pw[B + o : B + o + m_pad]
    mid = pw[B : B + m_pad]
    pnew[B : B + m_pad] = mid
    q[B : B + m_pad] = acc
    pq = torch.dot(mid, acc)
    sc[PQ] = pq
    sc[ALPHA] = _scalar_guard_div(rho, pq)


def cg_kernel_b_plain(x, r, p, q, sc, plan: DiaPlan):
    """Plain torch version of kernel B."""
    m_pad, B = plan.m_pad, plan.B
    alpha = sc[ALPHA]
    x[B : B + m_pad] = x[B : B + m_pad] + alpha * p[B : B + m_pad]
    rn = r[B : B + m_pad] - alpha * q[B : B + m_pad]
    r[B : B + m_pad] = rn
    rr = torch.dot(rn, rn)
    sc[RHO_PREV] = sc[RHO]
    sc[RHO] = rr


def _check(name, plan, planes, *vecs):
    _build.require_cuda(name, *([planes] if planes is not None else []), *vecs)
    dt = vecs[0].dtype
    if dt not in CG_KERNEL_DTYPES or any(v.dtype != dt for v in vecs) or (
        planes is not None and planes.dtype != dt
    ):
        raise ValueError(f"{name}: operands must share a dtype in {CG_KERNEL_DTYPES}")
    L = plan.m_pad + 2 * plan.B
    if any(v.shape != (L,) for v in vecs[:-1]) or vecs[-1].shape != (4,):
        raise ValueError(f"{name}: vectors must be [{L}] and sc must be [4]")
    if planes is not None and planes.shape != (plan.D * plan.m_pad,):
        raise ValueError(f"{name}: planes must be [{plan.D * plan.m_pad}]")
    if plan.m_pad == 0:
        raise ValueError(f"{name}: empty operator")


def cg_kernel_a(planes, r, p, pnew, q, sc, plan: DiaPlan, ws: CgWorkspace):
    """Kernel A: writes p_new and q (interior rows), sets sc[PQ], sc[ALPHA]."""
    if r.device.type == "cpu" and planes.device.type == "cpu":
        return cg_kernel_a_plain(planes, r, p, pnew, q, sc, plan)
    name = "cg_kernel_a"
    _check(name, plan, planes, r, p, pnew, q, sc)
    lib = _build.library("cg_dia", _SIGNATURES)
    code = lib.stk_cg_kernel_a_f32(
        planes.data_ptr(), r.data_ptr(), p.data_ptr(), pnew.data_ptr(), q.data_ptr(),
        ws.partials.data_ptr(), ws.ticket.data_ptr(), sc.data_ptr(),
        plan.m_pad, plan.B, _build.offsets_array(plan.offsets), plan.D, ws.nblocks,
        _build.stream_handle(r),
    )
    _build.check_launch(lib, code, name)
    cg_kernel_a.launches += 1


cg_kernel_a.launches = 0


def cg_kernel_b(x, r, p, q, sc, plan: DiaPlan, ws: CgWorkspace):
    """Kernel B: updates x and r in place (interior rows), sets sc[RHO_PREV], sc[RHO]."""
    if r.device.type == "cpu":
        return cg_kernel_b_plain(x, r, p, q, sc, plan)
    name = "cg_kernel_b"
    _check(name, plan, None, x, r, p, q, sc)
    lib = _build.library("cg_dia", _SIGNATURES)
    code = lib.stk_cg_kernel_b_f32(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
        ws.partials.data_ptr(), ws.ticket.data_ptr(), sc.data_ptr(),
        plan.m_pad, plan.B, ws.nblocks, _build.stream_handle(r),
    )
    _build.check_launch(lib, code, name)
    cg_kernel_b.launches += 1


cg_kernel_b.launches = 0


def _pad_vec(v: torch.Tensor, plan: DiaPlan) -> torch.Tensor:
    out = torch.zeros((plan.m_pad + 2 * plan.B,), dtype=v.dtype, device=v.device)
    out[plan.B : plan.B + v.shape[0]] = v
    return out


def cg_dia_fused(data, offsets: tuple, b, x0, m: int, iters: int = 300, state=None,
                 return_state: bool = False, planes=None):
    """``iters`` fixed CG iterations on the DIA matrix (throughput mode).

    Returns (x, r, rho) with rho = ||r||^2 (a 0-d tensor). The recurrence
    and its guards are the reference's (beta = 0 when rho_prev == 0; alpha
    divides by 1 when pq == 0). ``x0=None`` starts from zero (r0 = b).

    ``state``/``return_state`` thread the full CG state ``(xp, rp, pp,
    sc)``, with the scratch ``(pnew, q, ws)`` the iterations reuse, across
    calls, so ``linalg.cg`` runs conv-test-sized chunks with one host
    fetch of rho per chunk, the same iterates as one long run and no
    allocation after the first chunk. ``planes`` is the packed plane
    buffer of ``dia_pack`` when the caller holds one
    (``kernels.dia_spmv.prepared_dia``); otherwise it is packed here.
    """
    dt = torch.promote_types(data.dtype, b.dtype)
    plan = dia_plan(offsets, (m, data.shape[1]))
    if planes is None:
        planes = dia_pack(data.to(dt), plan)
    if state is None:
        if x0 is None:
            xp = torch.zeros((plan.m_pad + 2 * plan.B,), dtype=dt, device=b.device)
            rp = _pad_vec(b.to(dt), plan)
        else:
            x0 = x0.to(dt)
            ax0 = dia_spmv_packed(planes, dia_pad_x(x0, plan), plan)[:m]
            xp, rp = _pad_vec(x0, plan), _pad_vec(b.to(dt) - ax0, plan)
        sc = torch.zeros((4,), dtype=dt, device=b.device)
        sc[RHO] = torch.dot(rp, rp)
        # halos of pnew and q stay zero; kernel A fills their rows
        scratch = (torch.zeros_like(xp), torch.zeros_like(xp), CgWorkspace(plan, dt, b.device))
        state = (xp, rp, torch.zeros_like(xp), sc, scratch)
    xp, rp, pp, sc, (pnew, q, ws) = state
    for _ in range(iters):
        cg_kernel_a(planes, rp, pp, pnew, q, sc, plan, ws)
        cg_kernel_b(xp, rp, pnew, q, sc, plan, ws)
        pp, pnew = pnew, pp
    out_state = (xp, rp, pp, sc, (pnew, q, ws))
    B = plan.B
    x_out, r_out, rho = xp[B : B + m], rp[B : B + m], sc[RHO].clone()
    if return_state:
        return x_out, r_out, rho, out_state
    return x_out, r_out, rho
