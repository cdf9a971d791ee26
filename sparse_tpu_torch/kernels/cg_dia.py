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
  * the one-pass (Chronopoulos-Gear) iteration: alpha and beta from the
    device scalars, s = w + beta*s, r -= alpha*s, w = A r, p = r + beta*p,
    x += alpha*p, and both <r, r> and <w, r>, from which its last block
    sets the scalars of the next iteration. Two kernels compute it:
    ``cgcg_kernel``, the windowed one, where each block of a persistent
    grid walks its own contiguous range of rows and slides a ring of r
    values in shared memory over it, so r, w and s are loaded once a row
    (its geometry is :class:`CgcgWindow`, a plain function of the plan and
    the card's numbers); and ``cgcg_kernel_wide``, the grid-stride kernel
    that recomputes s and r at every row it reads, for bands whose window
    does not fit a block's shared memory or is long against the rows a
    block owns. :func:`cgcg_iteration` picks one from the plan.

Vectors live padded at [m_pad + 2B] (the plan of ``kernels/dia_spmv.py``;
B a multiple of 4) with zero halos. The scalars stay on the device in
``sc``; a chunk of iterations makes no host sync. Unlike the JAX
functions, these update the state they are given in place: x and r in
kernel B, p by ping-pong with a second buffer; in the one-pass kernels x
and p in place (each row is read and written by the one thread that owns
it) and r, w and s by ping-pong (other blocks read their old values at
halo rows during the launch). The returned x and r are views of the
state's buffers.

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
#: rows a thread of the windowed one-pass kernel takes at once (one 16-byte
#: group) and rows a tile step (csrc/cg_dia.cu kRows, kTile)
WINDOW_ROWS = 4
WINDOW_TILE = _THREADS * WINDOW_ROWS
#: the windowed kernel's tile-step schedule by vector itemsize (csrc/cg_dia.cu
#: kSchedule, the faster on an H100, PERF.md): "async" (f32) copies the
#: entering rows of the tile after next with cp.async into a staging area
#: of five tiles in shared memory; "ahead" (f64) loads the next tile's into
#: registers while the current tile computes
WINDOW_SCHEDULE = {4: "async", 8: "ahead"}
#: tiles of shared memory beside the span by itemsize: a ring of two, and
#: the "async" staging area
_WINDOW_TILES = {4: 2 + 5, 8: 2}
#: the least ratio of a block's rows to the window's span at which the
#: one-pass iteration takes the windowed kernel: below it each block's
#: prefill of a span of rows outweighs the loads it saves (chip_smoke.py
#: --window-sweep on an H100: at ratios of 1.54 and more the windowed
#: kernel took 0.69-0.86 of the wide kernel's time, at 1.02 and less
#: 0.97-1.53 of it, in f32 and f64 alike, bar one case; PERF.md)
WINDOW_MIN_RATIO = 1.5

_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIG_A = [_PTR] * 8 + [_I64, _I64, ctypes.POINTER(_I64), _I32, _I32, _PTR]
_SIG_B = [_PTR] * 7 + [_I64, _I64, _I32, _PTR]
_SIG_WIDE = [_PTR] * 12 + [_I64, _I64, ctypes.POINTER(_I64), _I32, _I32, _PTR]
_SIG_WINDOW = [_PTR] * 12 + [_I64, _I64, ctypes.POINTER(_I64), _I32, _I32, _I32, _I32, _PTR]
_SIG_LIMITS = [_I64, ctypes.POINTER(_I32)]
#: the two-pass kernels are built for f32 vectors only, the dtype of the
#: reference's fused-CG gate (linalg._try_fused_cg)
CG_KERNEL_DTYPES = (torch.float32,)
#: the one-pass kernels are built for f32 and f64 vectors
CGCG_KERNEL_DTYPES = (torch.float32, torch.float64)
# entry points by (vector dtype, plane dtype)
_F32, _F64, _BF16 = torch.float32, torch.float64, torch.bfloat16
_ENTRIES_A = {(_F32, _F32): "stk_cg_kernel_a_f32", (_F32, _BF16): "stk_cg_kernel_a_f32_bf16"}
_ENTRIES_B = {(_F32, None): "stk_cg_kernel_b_f32"}
_CGCG_SUFFIX = {(_F32, _F32): "f32", (_F32, _BF16): "f32_bf16", (_F64, _F64): "f64"}
_ENTRIES_WIDE = {k: f"stk_cgcg_wide_{v}" for k, v in _CGCG_SUFFIX.items()}
_ENTRIES_WINDOW = {k: f"stk_cgcg_window_{v}" for k, v in _CGCG_SUFFIX.items()}
_SIGNATURES = {
    "stk_cg_kernel_a_f32": _SIG_A, "stk_cg_kernel_a_f32_bf16": _SIG_A,
    "stk_cg_kernel_b_f32": _SIG_B,
    **{name: _SIG_WIDE for name in _ENTRIES_WIDE.values()},
    **{name: _SIG_WINDOW for name in _ENTRIES_WINDOW.values()},
    **{f"stk_cgcg_window_limits_{v}": _SIG_LIMITS for v in _CGCG_SUFFIX.values()},
}

# scalar slots of sc; two-pass: [rho_prev, rho, pq, alpha],
# one-pass: [rho_prev, rho, mu, alpha_prev]
RHO_PREV, RHO, PQ, ALPHA = 0, 1, 2, 3
MU, ALPHA_PREV = 2, 3


def window_extent(offsets) -> tuple[int, int]:
    """(lo, hi) of the windowed kernel: min(0, min o_k) and max(0, max o_k),
    rounded out to a multiple of ``WINDOW_ROWS``, so the window holds the
    row itself and every row it reads."""
    up = lambda v: -(-v // WINDOW_ROWS) * WINDOW_ROWS  # noqa: E731
    return -up(max(0, -min(offsets, default=0))), up(max(0, max(offsets, default=0)))


def window_shared_bytes(span: int, itemsize: int, tile: int = WINDOW_TILE) -> int:
    """Dynamic shared memory of the windowed kernel: a ring of ``span`` rows
    plus two tiles of r' values, and for "async" a staging area of five
    tiles beside it."""
    return (span + _WINDOW_TILES[itemsize] * tile) * itemsize


class CgcgWindow:
    """Launch geometry of the windowed one-pass kernel, from the plan, the
    vectors' itemsize and three numbers of the card.

    ``lo``/``hi``: :func:`window_extent`; ``span = hi - lo``; ``ring`` =
    span + 2 tiles; ``schedule``: ``WINDOW_SCHEDULE`` of the itemsize;
    ``shared_bytes``: :func:`window_shared_bytes`, and ``fits`` says whether
    it fits one block's (else only the wide kernel takes the band). Block b
    owns rows ``block_range(b)``: whole tiles, split as evenly as the tile
    count allows over ``nblocks`` = min(tiles, SMs x resident blocks an
    SM). ``windowed``: the one-pass iteration takes the windowed kernel,
    where it fits and a block owns at least ``WINDOW_MIN_RATIO`` spans of
    rows (``rows_per_block``). Nothing here depends on a timing, so a
    repeated solve on one card is bit-identical."""

    __slots__ = ("m_pad", "tile", "lo", "hi", "span", "ring", "schedule", "shared_bytes",
                 "smem_per_block", "fits", "ntiles", "nblocks")

    def __init__(self, plan: DiaPlan, itemsize: int, sm_count: int, blocks_per_sm: int,
                 smem_per_block: int, tile: int = WINDOW_TILE):
        self.m_pad, self.tile = plan.m_pad, tile
        self.lo, self.hi = window_extent(plan.offsets)
        self.span = self.hi - self.lo
        self.ring = self.span + 2 * tile
        self.schedule = WINDOW_SCHEDULE[itemsize]
        self.shared_bytes = window_shared_bytes(self.span, itemsize, tile)
        self.smem_per_block = smem_per_block
        self.fits = self.shared_bytes <= smem_per_block
        self.ntiles = -(-plan.m_pad // tile)
        self.nblocks = max(1, min(self.ntiles, sm_count * blocks_per_sm)) if self.fits else 0

    def block_range(self, b: int) -> tuple[int, int]:
        """Rows [R0, R1) of block b (csrc/cg_dia.cu, cgcg_window_kernel)."""
        t0, t1 = b * self.ntiles // self.nblocks, (b + 1) * self.ntiles // self.nblocks
        return t0 * self.tile, min(t1 * self.tile, self.m_pad)

    @property
    def rows_per_block(self) -> int:
        """Rows the longest range holds (0 where the window does not fit)."""
        return -(-self.ntiles // self.nblocks) * self.tile if self.fits else 0

    @property
    def windowed(self) -> bool:
        return self.fits and self.rows_per_block >= WINDOW_MIN_RATIO * self.span

    @property
    def terms_per_thread(self) -> int:
        """Terms a thread of the kernel sums in sequence into each dot."""
        return -(-self.ntiles // self.nblocks) * self.tile // _THREADS


class CgWorkspace:
    """Per-block dot partials (two per block: the one-pass kernels reduce
    two dots) and the last-block ticket. The kernels of one solve run in
    order on one stream, so they share the ticket. The two-pass kernels and
    the wide one-pass kernel take the fixed grid of ``nblocks``; the
    windowed kernel takes its own grid (:meth:`window`), with its own
    partials."""

    __slots__ = ("plan", "nblocks", "partials", "ticket", "_windows")

    def __init__(self, plan: DiaPlan, dtype, device):
        self.plan = plan
        self.nblocks = max(min(-(-plan.m_pad // _THREADS), _MAX_BLOCKS), 1)
        self.partials = torch.empty((2 * self.nblocks,), dtype=dtype, device=device)
        self.ticket = torch.zeros((1,), dtype=torch.int32, device=device)
        self._windows = {}

    def window(self, plane_dtype):
        """(:class:`CgcgWindow`, partials) of the windowed kernel on this
        workspace's card for ``plane_dtype`` planes, asked of the card once
        (which also lets the kernel take the window's shared memory). The
        geometry is the one of planes at the vectors' dtype for every plane
        dtype, so bf16 and f32 planes run one grid and sum the dots in one
        order."""
        if plane_dtype not in self._windows:
            dt, itemsize = self.partials.dtype, self.partials.element_size()
            lib = _build.library("cg_dia", _SIGNATURES)
            limits = getattr(lib, f"stk_cgcg_window_limits_{_CGCG_SUFFIX[(dt, plane_dtype)]}")
            lo, hi = window_extent(self.plan.offsets)
            out = (_I32 * 3)()
            code = limits(window_shared_bytes(hi - lo, itemsize), out)
            _build.check_launch(lib, code, "cgcg_kernel (limits)")
            if plane_dtype != dt:
                self._windows[plane_dtype] = self.window(dt)
            else:
                geo = CgcgWindow(self.plan, itemsize, sm_count=out[0], blocks_per_sm=out[2],
                                 smem_per_block=out[1])
                parts = torch.empty((2 * max(geo.nblocks, 1),), dtype=dt,
                                    device=self.partials.device)
                self._windows[plane_dtype] = (geo, parts)
        return self._windows[plane_dtype]


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


def cgcg_scalars(sc):
    """(alpha, beta) of a one-pass iteration from sc, with the reference's
    zero guards (``cg_dia.py:435-441``): beta = 0 where rho_prev = 0,
    beta / alpha_prev = 0 where alpha_prev = 0, alpha = 0 where its
    denominator is 0."""
    rho_prev, rho, mu, alpha_prev = sc[RHO_PREV], sc[RHO], sc[MU], sc[ALPHA_PREV]
    zero = torch.zeros_like(rho)
    beta = torch.where(rho_prev == 0, zero, _scalar_guard_div(rho, rho_prev))
    ratio = torch.where(alpha_prev == 0, zero, _scalar_guard_div(beta, alpha_prev))
    denom = mu - ratio * rho
    return torch.where(denom == 0, zero, _scalar_guard_div(rho, denom)), beta


def cgcg_kernel_plain(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan: DiaPlan):
    """Plain torch version of the one-pass kernels (same elementwise
    operations, in the same order; the dots are torch's)."""
    m_pad, B = plan.m_pad, plan.B
    alpha, beta = cgcg_scalars(sc)
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


def _cgcg_pointers(planes, r, w, s, p, x, r_out, w_out, s_out, partials, ws, sc):
    return (planes.data_ptr(), r.data_ptr(), w.data_ptr(), s.data_ptr(), p.data_ptr(),
            x.data_ptr(), r_out.data_ptr(), w_out.data_ptr(), s_out.data_ptr(),
            partials.data_ptr(), ws.ticket.data_ptr(), sc.data_ptr())


def cgcg_kernel(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan: DiaPlan,
                ws: CgWorkspace):
    """One one-pass CG iteration through the windowed kernel: reads r, w, s;
    writes r_out, w_out, s_out (interior rows); updates p and x in place;
    sets all four slots of sc. On the card the plan's window must fit a
    block's shared memory (``ws.window(planes.dtype)[0].fits``; else
    :func:`cgcg_kernel_wide` takes the band, and :func:`cgcg_iteration`
    chooses)."""
    if r.device.type == "cpu" and planes.device.type == "cpu":
        return cgcg_kernel_plain(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan)
    _window_or_wide(None, planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan, ws)


cgcg_kernel.launches = 0


def _window_or_wide(wide, planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan, ws):
    """The windowed launch on CUDA tensors. With ``wide`` None, wherever
    the plan's window fits a block's shared memory (else a ValueError);
    otherwise where the geometry chooses it (``CgcgWindow.windowed``), else
    ``wide(...)``."""
    name = "cgcg_kernel"
    entry = _entry(name, _ENTRIES_WINDOW, plan, planes, r, w, s, p, x, r_out, w_out, s_out, sc)
    geo, partials = ws.window(planes.dtype)
    if wide is not None and not geo.windowed:
        return wide(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan, ws)
    if not geo.fits:
        raise ValueError(
            f"{name}: the window's ring ({geo.shared_bytes} bytes) exceeds a block's shared memory "
            f"({geo.smem_per_block} bytes); cgcg_kernel_wide takes this band"
        )
    if any(t.data_ptr() % 16 for t in (planes, r, w, s, p, x, r_out, w_out, s_out)):
        raise ValueError(f"{name}: the 16-byte row groups need 16-byte aligned operands")
    lib = _build.library("cg_dia", _SIGNATURES)
    code = getattr(lib, entry)(
        *_cgcg_pointers(planes, r, w, s, p, x, r_out, w_out, s_out, partials, ws, sc),
        plan.m_pad, plan.B, _build.offsets_array(plan.offsets), plan.D, geo.lo, geo.span,
        geo.nblocks, _build.stream_handle(r),
    )
    _build.check_launch(lib, code, name)
    cgcg_kernel.launches += 1


def cgcg_kernel_wide(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan: DiaPlan,
                     ws: CgWorkspace):
    """The same iteration through the grid-stride kernel, which reads r, w
    and s at every row it needs through the cache and takes any band: the
    one-pass kernel for bands whose window does not fit."""
    if r.device.type == "cpu" and planes.device.type == "cpu":
        return cgcg_kernel_plain(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan)
    name = "cgcg_kernel_wide"
    entry = _entry(name, _ENTRIES_WIDE, plan, planes, r, w, s, p, x, r_out, w_out, s_out, sc)
    lib = _build.library("cg_dia", _SIGNATURES)
    code = getattr(lib, entry)(
        *_cgcg_pointers(planes, r, w, s, p, x, r_out, w_out, s_out, ws.partials, ws, sc),
        plan.m_pad, plan.B, _build.offsets_array(plan.offsets), plan.D, ws.nblocks,
        _build.stream_handle(r),
    )
    _build.check_launch(lib, code, name)
    cgcg_kernel_wide.launches += 1


cgcg_kernel_wide.launches = 0


def cgcg_iteration(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan: DiaPlan,
                   ws: CgWorkspace):
    """One one-pass iteration: the plain version on CPU tensors; on the card
    the windowed kernel where the plan's window fits a block's shared
    memory and a block owns at least ``WINDOW_MIN_RATIO`` spans of rows
    (``CgcgWindow.windowed``), else the wide kernel."""
    if r.device.type == "cpu" and planes.device.type == "cpu":
        return cgcg_kernel_plain(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan)
    _window_or_wide(cgcg_kernel_wide, planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan, ws)


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
    card), each iteration through :func:`cgcg_iteration`. f32 or f64 vectors; ``plane_dtype`` (``None`` or
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
        cgcg_iteration(stream, r[0], w[0], s[0], p, xp, r[1], w[1], s[1], sc, plan, ws)
        r.reverse()
        w.reverse()
        s.reverse()
    B = plan.B
    return xp[B : B + m], r[0][B : B + m], sc[RHO].clone()
