"""Fused CG iterations on a DIA matrix: two-pass and one-pass, hand-written.

Port of ``sparse_tpu/kernels/cg_dia.py``'s ``cg_dia_fused`` and
``cg_dia_fused_onepass`` around ``csrc/cg_dia.cu``, whose kernels replace
the Pallas ``_kernel_a``, ``_kernel_b`` and ``_kernel_cgcg``:

  * kernel A: beta from the device scalars, p_new = r + beta*p computed at
    every neighbour row it reads (recompute instead of a grid barrier),
    q = A p_new from the row-indexed planes, and <p_new, q>, from which
    its last block sets pq and alpha;
  * kernel B: x += alpha*p, r -= alpha*q, and <r, r>, from which its last
    block sets rho_prev and rho;
  * the one-pass (Chronopoulos-Gear) kernel: alpha and beta from the
    device scalars, s = w + beta*s and r -= alpha*s at every row it reads,
    w = A r, p = r + beta*p, x += alpha*p, and both <r, r> and <w, r>, from
    which its last block sets the scalars of the next iteration.

Vectors live padded at [m_pad + 2B] (the plan of ``kernels/dia_spmv.py``)
with zero halos. The scalars stay on the device in ``sc``; a chunk of
iterations makes no host sync. Unlike the JAX functions, these update the
state they are given in place: x and r in kernel B, p by ping-pong with a
second buffer; in the one-pass kernel x and p in place (each row is read
and written by its own thread only) and r, w and s by ping-pong (other
blocks read their old values at halo rows during the launch). The returned
x and r are views of the state's buffers.

``plane_dtype=torch.bfloat16`` streams the planes in bf16 (widened to f32
at the load; the multiply and add stay in f32), for callers whose values
are exact in bf16. The TPU's 2048-row alignment rule for 2-byte planes
does not apply here.

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
_SIG_CGCG = [_PTR] * 12 + [_I64, _I64, ctypes.POINTER(_I64), _I32, _I32, _PTR]
_SIGNATURES = {
    "stk_cg_kernel_a_f32": _SIG_A, "stk_cg_kernel_a_f32_bf16": _SIG_A,
    "stk_cg_kernel_b_f32": _SIG_B,
    "stk_cgcg_f32": _SIG_CGCG, "stk_cgcg_f32_bf16": _SIG_CGCG, "stk_cgcg_f64": _SIG_CGCG,
}
#: the two-pass kernels are built for f32 vectors only, the dtype of the
#: reference's fused-CG gate (linalg._try_fused_cg)
CG_KERNEL_DTYPES = (torch.float32,)
#: the one-pass kernel is built for f32 and f64 vectors
CGCG_KERNEL_DTYPES = (torch.float32, torch.float64)
# entry points by (vector dtype, plane dtype)
_F32, _F64, _BF16 = torch.float32, torch.float64, torch.bfloat16
_ENTRIES_A = {(_F32, _F32): "stk_cg_kernel_a_f32", (_F32, _BF16): "stk_cg_kernel_a_f32_bf16"}
_ENTRIES_B = {(_F32, None): "stk_cg_kernel_b_f32"}
_ENTRIES_CGCG = {(_F32, _F32): "stk_cgcg_f32", (_F32, _BF16): "stk_cgcg_f32_bf16",
                 (_F64, _F64): "stk_cgcg_f64"}

# scalar slots of sc; two-pass: [rho_prev, rho, pq, alpha],
# one-pass: [rho_prev, rho, mu, alpha_prev]
RHO_PREV, RHO, PQ, ALPHA = 0, 1, 2, 3
MU, ALPHA_PREV = 2, 3


class CgWorkspace:
    """Per-block dot partials (two per block: the one-pass kernel reduces
    two dots) and the last-block ticket. The kernels of one solve run in
    order on one stream, so they share one set."""

    __slots__ = ("nblocks", "partials", "ticket")

    def __init__(self, plan: DiaPlan, dtype, device):
        self.nblocks = max(min(-(-plan.m_pad // _THREADS), _MAX_BLOCKS), 1)
        self.partials = torch.empty((2 * self.nblocks,), dtype=dtype, device=device)
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
        acc = acc + planes[k * m_pad : (k + 1) * m_pad].to(r.dtype) * pw[B + o : B + o + m_pad]
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


def cgcg_kernel_plain(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan: DiaPlan):
    """Plain torch version of the one-pass kernel (same elementwise
    operations, in the same order; the dots are torch's). beta and alpha
    carry the reference's zero guards (``cg_dia.py:435-441``): beta = 0
    where rho_prev = 0, beta / alpha_prev = 0 where alpha_prev = 0, alpha =
    0 where its denominator is 0."""
    m_pad, B = plan.m_pad, plan.B
    rho_prev, rho, mu, alpha_prev = sc[RHO_PREV], sc[RHO], sc[MU], sc[ALPHA_PREV]
    zero = torch.zeros_like(rho)
    beta = torch.where(rho_prev == 0, zero, _scalar_guard_div(rho, rho_prev))
    ratio = torch.where(alpha_prev == 0, zero, _scalar_guard_div(beta, alpha_prev))
    denom = mu - ratio * rho
    alpha = torch.where(denom == 0, zero, _scalar_guard_div(rho, denom))
    s_new = w + beta * s  # halos: 0 + beta * 0, as the kernel reads them
    r_new = r - alpha * s_new
    acc = torch.zeros((m_pad,), dtype=r.dtype, device=r.device)
    for k, o in enumerate(plan.offsets):
        acc = acc + planes[k * m_pad : (k + 1) * m_pad].to(r.dtype) * r_new[B + o : B + o + m_pad]
    mid = slice(B, B + m_pad)
    p_new = r[mid] + beta * p[mid]
    x[mid] = x[mid] + alpha * p_new
    p[mid] = p_new
    r_mid = r_new[mid]
    r_out[mid] = r_mid
    s_out[mid] = s_new[mid]
    w_out[mid] = acc
    rr, wr = torch.dot(r_mid, r_mid), torch.dot(acc, r_mid)
    sc[RHO_PREV] = sc[RHO]
    sc[RHO] = rr
    sc[MU] = wr
    sc[ALPHA_PREV] = torch.where(alpha == 0, torch.ones_like(alpha), alpha)


def _entry(name, entries, plan, planes, *vecs):
    """Check the operands of a launch; returns the C entry point's name."""
    _build.require_cuda(name, *([planes] if planes is not None else []), *vecs)
    dt = vecs[0].dtype
    key = (dt, None if planes is None else planes.dtype)
    if key not in entries or any(v.dtype != dt for v in vecs):
        built = ", ".join(f"{v} vectors" + (f" with {p} planes" if p else "") for v, p in entries)
        raise TypeError(f"{name}: these operand dtypes have no CUDA kernel (built for {built})")
    L = plan.m_pad + 2 * plan.B
    if any(v.shape != (L,) for v in vecs[:-1]) or vecs[-1].shape != (4,):
        raise ValueError(f"{name}: vectors must be [{L}] and sc must be [4]")
    if planes is not None and planes.shape != (plan.D * plan.m_pad,):
        raise ValueError(f"{name}: planes must be [{plan.D * plan.m_pad}]")
    if plan.m_pad == 0:
        raise ValueError(f"{name}: empty operator")
    return entries[key]


def cg_kernel_a(planes, r, p, pnew, q, sc, plan: DiaPlan, ws: CgWorkspace):
    """Kernel A: writes p_new and q (interior rows), sets sc[PQ], sc[ALPHA]."""
    if r.device.type == "cpu" and planes.device.type == "cpu":
        return cg_kernel_a_plain(planes, r, p, pnew, q, sc, plan)
    name = "cg_kernel_a"
    entry = _entry(name, _ENTRIES_A, plan, planes, r, p, pnew, q, sc)
    lib = _build.library("cg_dia", _SIGNATURES)
    code = getattr(lib, entry)(
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
    entry = _entry(name, _ENTRIES_B, plan, None, x, r, p, q, sc)
    lib = _build.library("cg_dia", _SIGNATURES)
    code = getattr(lib, entry)(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
        ws.partials.data_ptr(), ws.ticket.data_ptr(), sc.data_ptr(),
        plan.m_pad, plan.B, ws.nblocks, _build.stream_handle(r),
    )
    _build.check_launch(lib, code, name)
    cg_kernel_b.launches += 1


cg_kernel_b.launches = 0


def cgcg_kernel(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan: DiaPlan,
                ws: CgWorkspace):
    """One one-pass CG iteration: reads r, w, s; writes r_out, w_out, s_out
    (interior rows); updates p and x in place; sets all four slots of sc."""
    if r.device.type == "cpu" and planes.device.type == "cpu":
        return cgcg_kernel_plain(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan)
    name = "cgcg_kernel"
    entry = _entry(name, _ENTRIES_CGCG, plan, planes, r, w, s, p, x, r_out, w_out, s_out, sc)
    lib = _build.library("cg_dia", _SIGNATURES)
    code = getattr(lib, entry)(
        planes.data_ptr(), r.data_ptr(), w.data_ptr(), s.data_ptr(), p.data_ptr(),
        x.data_ptr(), r_out.data_ptr(), w_out.data_ptr(), s_out.data_ptr(),
        ws.partials.data_ptr(), ws.ticket.data_ptr(), sc.data_ptr(),
        plan.m_pad, plan.B, _build.offsets_array(plan.offsets), plan.D, ws.nblocks,
        _build.stream_handle(r),
    )
    _build.check_launch(lib, code, name)
    cgcg_kernel.launches += 1


cgcg_kernel.launches = 0


def _pad_vec(v: torch.Tensor, plan: DiaPlan) -> torch.Tensor:
    out = torch.zeros((plan.m_pad + 2 * plan.B,), dtype=v.dtype, device=v.device)
    out[plan.B : plan.B + v.shape[0]] = v
    return out


def _plane_stream(planes, plane_dtype):
    """The planes the iterations read: ``planes`` at ``plane_dtype``."""
    if plane_dtype is None or plane_dtype == planes.dtype:
        return planes
    return planes.to(plane_dtype)


def _start(data, offsets, b, x0, m, planes, kernel_dtypes, name):
    """Shared set-up: dtype, plan, the packed planes at the vector dtype,
    and the padded x and r0 = b - A x0 (the setup SpMV through
    ``dia_spmv_packed``, so the kernel on the card)."""
    dt = torch.promote_types(data.dtype, b.dtype)
    if b.device.type != "cpu" and dt not in kernel_dtypes:
        raise TypeError(
            f"{name} on {b.device}: dtype {dt} has no CUDA kernel "
            f"(built for {', '.join(map(str, kernel_dtypes))})"
        )
    plan = dia_plan(offsets, (m, data.shape[1]))
    if planes is None:
        planes = dia_pack(data.to(dt), plan)
    if x0 is None:
        xp = torch.zeros((plan.m_pad + 2 * plan.B,), dtype=dt, device=b.device)
        rp = _pad_vec(b.to(dt), plan)
    else:
        x0 = x0.to(dt)
        ax0 = dia_spmv_packed(planes, dia_pad_x(x0, plan), plan)[:m]
        xp, rp = _pad_vec(x0, plan), _pad_vec(b.to(dt) - ax0, plan)
    return dt, plan, planes, xp, rp


def cg_dia_fused(data, offsets: tuple, b, x0, m: int, iters: int = 300, state=None,
                 return_state: bool = False, planes=None, plane_dtype=None):
    """``iters`` fixed CG iterations on the DIA matrix (throughput mode).

    Returns (x, r, rho) with rho = ||r||^2 (a 0-d tensor). The recurrence
    and its guards are the reference's (beta = 0 when rho_prev == 0; alpha
    divides by 1 when pq == 0). ``x0=None`` starts from zero (r0 = b).

    ``state``/``return_state`` thread the full CG state ``(xp, rp, pp,
    sc)``, with the scratch ``(pnew, q, ws)`` the iterations reuse, across
    calls, so ``linalg.cg`` runs conv-test-sized chunks with one host
    fetch of rho per chunk, the same iterates as one long run and no
    allocation after the first chunk. ``planes`` is the packed plane
    buffer of ``dia_pack`` at the vector dtype when the caller holds one
    (``kernels.dia_spmv.prepared_dia``); otherwise it is packed here.
    ``plane_dtype`` (``None`` or ``torch.bfloat16``) is the dtype the
    iterations stream the planes at.
    """
    if state is None:
        dt, plan, planes, xp, rp = _start(data, offsets, b, x0, m, planes, CG_KERNEL_DTYPES,
                                          "cg_dia_fused")
        sc = torch.zeros((4,), dtype=dt, device=b.device)
        sc[RHO] = torch.dot(rp, rp)
        # halos of pnew and q stay zero; kernel A fills their rows
        scratch = (torch.zeros_like(xp), torch.zeros_like(xp), CgWorkspace(plan, dt, b.device))
        state = (xp, rp, torch.zeros_like(xp), sc, scratch)
    else:
        plan = dia_plan(offsets, (m, data.shape[1]))
        if planes is None:
            planes = dia_pack(data.to(state[0].dtype), plan)
    stream = _plane_stream(planes, plane_dtype)
    xp, rp, pp, sc, (pnew, q, ws) = state
    for _ in range(iters):
        cg_kernel_a(stream, rp, pp, pnew, q, sc, plan, ws)
        cg_kernel_b(xp, rp, pnew, q, sc, plan, ws)
        pp, pnew = pnew, pp
    out_state = (xp, rp, pp, sc, (pnew, q, ws))
    B = plan.B
    x_out, r_out, rho = xp[B : B + m], rp[B : B + m], sc[RHO].clone()
    if return_state:
        return x_out, r_out, rho, out_state
    return x_out, r_out, rho


def cg_dia_fused_onepass(data, offsets: tuple, b, x0, m: int, iters: int = 300,
                         plane_dtype=None):
    """``iters`` Chronopoulos-Gear CG iterations, one kernel launch each.

    The port of the reference's ``cg_dia_fused_onepass``: the dots <r, r>
    and <A r, r> of the next iteration come out of the same sweep that
    applies the current update, and alpha follows the CG-CG recurrence
    alpha_j = rho_j / (mu_j - (beta_j / alpha_{j-1}) rho_j), with the
    reference's zero guards. Initial state: r0 = b - A x0, w0 = A r0,
    rho0 = <r0, r0>, mu0 = <w0, r0>, rho_prev = 0, alpha_prev = 1, p = s =
    0; the setup SpMVs run through ``dia_spmv_packed`` (the kernel on the
    card). f32 or f64 vectors; ``plane_dtype`` (``None`` or
    ``torch.bfloat16``, f32 only) is the dtype the iterations stream the
    planes at.

    Returns (x, r, rho) with rho = ||r||^2 (a 0-d tensor).
    """
    dt, plan, planes, xp, r0 = _start(data, offsets, b, x0, m, None, CGCG_KERNEL_DTYPES,
                                      "cg_dia_fused_onepass")
    w0 = _pad_vec(dia_spmv_packed(planes, r0, plan), plan)
    sc = torch.zeros((4,), dtype=dt, device=b.device)
    sc[RHO] = torch.dot(r0, r0)
    sc[MU] = torch.dot(w0, r0)
    sc[ALPHA_PREV] = 1
    stream = _plane_stream(planes, plane_dtype)
    del planes  # a bf16 stream leaves the packed planes at dt unused
    # r, w, s ping-pong: [current, next]; the halos of every buffer stay zero
    r, w = [r0, torch.zeros_like(r0)], [w0, torch.zeros_like(r0)]
    s = [torch.zeros_like(r0), torch.zeros_like(r0)]
    p = torch.zeros_like(r0)
    ws = CgWorkspace(plan, dt, b.device)
    for _ in range(iters):
        cgcg_kernel(stream, r[0], w[0], s[0], p, xp, r[1], w[1], s[1], sc, plan, ws)
        r.reverse()
        w.reverse()
        s.reverse()
    B = plan.B
    return xp[B : B + m], r[0][B : B + m], sc[RHO].clone()
