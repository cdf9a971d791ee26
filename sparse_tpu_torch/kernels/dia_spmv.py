"""DIA SpMV kernels: the prepared path and the direct one.

Port of ``sparse_tpu/kernels/dia_spmv.py``'s prepared path (``DiaPlan``,
``dia_plan``, ``dia_pack``, ``dia_pad_x``, ``PreparedDia``,
``cached_prepared_spmv``) around a hand-written CUDA kernel
(``csrc/dia_spmv.cu``) that replaces the Pallas ``dia_spmv_packed``, and
of ``dia_spmv_pallas`` as :func:`dia_spmv_direct`, whose kernel in the
same source replaces the Pallas ``_dia_spmv_pallas``: one product straight
from the scipy column-indexed planes, read in place (no pack, no pad).

Packing: plane k's coefficient for row i is ``planes[k * m_pad + i] =
data[k, i + o_k]`` (zero where the column or the row falls outside the
matrix), so the kernel streams exactly D planes with no halo; x is padded
with B zeros on each side so ``xpad[B + o_k + i]`` is always in bounds.
The TPU's tile and halo roundings (1024/512, VMEM rules) are not carried
over: rows pad only to the kernel's block of ``ROWS_PER_BLOCK`` and B is
the band rounded up to a multiple of ``HALO_ALIGN`` rows, so that every
interior row group of the windowed one-pass CG kernel (``csrc/cg_dia.cu``)
starts on a 16-byte boundary.
"""

from __future__ import annotations

import ctypes

import torch

from .. import plan_cache
from ..config import settings
from ..ops.dia_spmv import dia_spmv_torch
from . import _build

#: rows per CUDA block of the DIA kernel (csrc/dia_spmv.cu kThreads)
ROWS_PER_BLOCK = 256
#: dtypes the CUDA kernels are built for
KERNEL_DTYPES = (torch.float32, torch.float64)
#: B (the halo) is a multiple of this many rows: the 4-row groups of the
#: windowed one-pass CG kernel's 16-byte loads (csrc/cg_dia.cu kRows)
HALO_ALIGN = 4


class DiaPlan:
    """Static geometry of a prepared DIA operator."""

    __slots__ = ("offsets", "m", "n", "TM", "B", "G", "D")

    def __init__(self, offsets, m, n, TM, B, G):
        self.offsets = tuple(int(o) for o in offsets)
        self.m, self.n, self.TM, self.B, self.G = m, n, TM, B, G
        self.D = len(self.offsets)

    @property
    def m_pad(self) -> int:
        return self.G * self.TM


def dia_plan(offsets, shape) -> DiaPlan:
    m, n = int(shape[0]), int(shape[1])
    band = max((abs(int(o)) for o in offsets), default=0)
    B = -(-band // HALO_ALIGN) * HALO_ALIGN
    TM = ROWS_PER_BLOCK
    G = (m + TM - 1) // TM
    return DiaPlan(offsets, m, n, TM, B, G)


def dia_pack(data: torch.Tensor, plan: DiaPlan) -> torch.Tensor:
    """scipy-layout [D, n] planes -> flat row-indexed [D * m_pad] buffer.

    Columns past ``m_pad + B - 1`` can never be read (row i reads column
    i + o <= m_pad - 1 + B), so wide matrices are truncated there. Row
    mask: scipy ignores DIA slots whose row falls outside the matrix, but
    the arrays may hold junk there; those slots land in rows i >= m and
    are zeroed, which keeps padded rows exactly zero — vital for the fused
    CG, where a nonzero padded q would leak into r and rho.
    """
    m_pad, B = plan.m_pad, plan.B
    ncap = min(plan.n, data.shape[1], m_pad + B)
    buf = torch.zeros((plan.D, m_pad + 2 * B), dtype=data.dtype, device=data.device)
    buf[:, B : B + ncap] = data[:, :ncap]
    out = torch.empty((plan.D, m_pad), dtype=data.dtype, device=data.device)
    for k, o in enumerate(plan.offsets):
        out[k] = buf[k, B + o : B + o + m_pad]
    out[:, plan.m :] = 0
    return out.reshape(-1)


def dia_pad_x(x: torch.Tensor, plan: DiaPlan) -> torch.Tensor:
    """[n] -> [m_pad + 2B] with x at offset B, zeros elsewhere (entries past
    ``m_pad + B - 1`` are unreachable and dropped, as in dia_pack)."""
    m_pad, B = plan.m_pad, plan.B
    ncap = min(x.shape[0], m_pad + B)
    out = torch.zeros((m_pad + 2 * B,), dtype=x.dtype, device=x.device)
    out[B : B + ncap] = x[:ncap]
    return out


def dia_spmv_packed_plain(planes: torch.Tensor, x_padded: torch.Tensor, plan: DiaPlan):
    """Plain torch version of the kernel: the same sum, in the same order."""
    m_pad, B = plan.m_pad, plan.B
    acc = torch.zeros((m_pad,), dtype=planes.dtype, device=planes.device)
    for k, o in enumerate(plan.offsets):
        acc = acc + planes[k * m_pad : (k + 1) * m_pad] * x_padded[B + o : B + o + m_pad]
    return acc


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURE = [_PTR, _PTR, _PTR, _I64, _I64, ctypes.POINTER(_I64), _I32, _PTR]
_SIG_DIRECT = [_PTR, _PTR, _PTR, _I64, _I64, _I64, ctypes.POINTER(_I64), _I32, _PTR]
_SIGNATURES = {
    "stk_dia_spmv_f32": _SIGNATURE, "stk_dia_spmv_f64": _SIGNATURE,
    "stk_dia_spmv_direct_f32": _SIG_DIRECT, "stk_dia_spmv_direct_f64": _SIG_DIRECT,
}


def dia_spmv_packed(planes: torch.Tensor, x_padded: torch.Tensor, plan: DiaPlan):
    """y = A @ x from the prepared layout; returns the [m_pad] padded y.

    On a CPU tensor this runs :func:`dia_spmv_packed_plain`; on a CUDA
    tensor it launches ``csrc/dia_spmv.cu`` or raises.
    """
    if planes.device.type == "cpu" and x_padded.device.type == "cpu":
        return dia_spmv_packed_plain(planes, x_padded, plan)
    name = "dia_spmv_packed"
    _build.require_cuda(name, planes, x_padded)
    if planes.dtype != x_padded.dtype or planes.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: planes and x must share a dtype in {KERNEL_DTYPES}")
    m_pad = plan.m_pad
    if planes.shape != (plan.D * m_pad,) or x_padded.shape != (m_pad + 2 * plan.B,):
        raise ValueError(f"{name}: operand shapes do not match the plan")
    y = torch.empty((m_pad,), dtype=planes.dtype, device=planes.device)
    if m_pad == 0:
        return y
    lib = _build.library("dia_spmv", _SIGNATURES)
    fn = lib.stk_dia_spmv_f32 if planes.dtype == torch.float32 else lib.stk_dia_spmv_f64
    code = fn(
        planes.data_ptr(), x_padded.data_ptr(), y.data_ptr(), m_pad, plan.B,
        _build.offsets_array(plan.offsets), plan.D, _build.stream_handle(planes),
    )
    _build.check_launch(lib, code, name)
    dia_spmv_packed.launches += 1
    return y


dia_spmv_packed.launches = 0


def dia_spmv_direct_plain(data: torch.Tensor, offsets, x: torch.Tensor, shape):
    """Plain torch version of the direct kernel: ``ops.dia_spmv.dia_spmv_torch``
    on the planes cut or zero-padded to width n. It sums the kernel's terms
    data[k, j] * x[j] in the kernel's order, ((0 + t_0) + t_1) + ..., with
    0 for a term outside the matrix."""
    n = int(shape[1])
    if data.shape[1] != n:
        data = torch.nn.functional.pad(data[:, :n], (0, max(n - data.shape[1], 0)))
    return dia_spmv_torch(data, tuple(int(o) for o in offsets), x, shape)


def dia_spmv_direct(data: torch.Tensor, offsets, x: torch.Tensor, shape):
    """y = A @ x for A in scipy DIA layout (``data[k, j]`` holds ``A[j - o_k,
    j]``), ``data`` [D, n'] and x [n], any m and n; returns [m].

    The port of ``dia_spmv_pallas``: the planes are read in place, with no
    per-call pad and no tile. On a CPU tensor this runs
    :func:`dia_spmv_direct_plain`; on a CUDA tensor it launches
    ``csrc/dia_spmv.cu``'s direct kernel (f32 or f64, data and x sharing
    the dtype) or raises.
    """
    m, n = int(shape[0]), int(shape[1])
    if data.ndim != 2 or data.shape[0] != len(offsets) or x.shape != (n,):
        raise ValueError(
            f"dia_spmv_direct: data must be [{len(offsets)}, *] and x [{n}] "
            f"(got {tuple(data.shape)} and {tuple(x.shape)})"
        )
    if data.device.type == "cpu" and x.device.type == "cpu":
        return dia_spmv_direct_plain(data, offsets, x, (m, n))
    name = "dia_spmv_direct"
    _build.require_cuda(name, data, x)
    if data.dtype != x.dtype or data.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"{name} on {x.device}: dtypes {data.dtype}, {x.dtype} have no CUDA kernel "
            f"(built for data and x sharing one of {', '.join(map(str, KERNEL_DTYPES))})"
        )
    y = torch.empty((m,), dtype=data.dtype, device=data.device)
    if m == 0:
        return y
    lib = _build.library("dia_spmv", _SIGNATURES)
    fn = lib.stk_dia_spmv_direct_f32 if data.dtype == torch.float32 else lib.stk_dia_spmv_direct_f64
    code = fn(
        data.data_ptr(), x.data_ptr(), y.data_ptr(), m, min(n, data.shape[1]), data.shape[1],
        _build.offsets_array(offsets), len(offsets), _build.stream_handle(data),
    )
    _build.check_launch(lib, code, name)
    dia_spmv_direct.launches += 1
    return y


dia_spmv_direct.launches = 0


class PreparedDia:
    """A DIA operator packed once into the kernel's layout; each call pads
    x, runs :func:`dia_spmv_packed` and trims the result."""

    __slots__ = ("plan", "planes")

    def __init__(self, data: torch.Tensor, offsets, shape):
        self.plan = dia_plan(offsets, shape)
        self.planes = dia_pack(data, self.plan)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = dia_spmv_packed(self.planes, dia_pad_x(x, self.plan), self.plan)
        return y[: self.plan.m]


def prepared_dia(obj, data, offsets, shape, dtype) -> PreparedDia:
    """The plan-cached :class:`PreparedDia` of ``obj`` at ``dtype`` — shared
    by the banded SpMV and the fused CG, so a solve after ``A @ x`` never
    repacks."""
    shape = (int(shape[0]), int(shape[1]))
    return plan_cache.get(
        obj, f"dia_prepared:{dtype}:{shape}",
        lambda: PreparedDia(data.to(dtype), offsets, shape),
    )


def cached_prepared_spmv(obj, data, offsets, shape, x):
    """Prepared-DIA SpMV for the format classes: applies the plan-cached
    :class:`PreparedDia` of ``obj``.

    On the CPU it keeps the reference's gates and returns ``None`` (the
    caller then runs the plain ``ops.dia_spmv.dia_spmv_torch``) when the
    band exceeds ``settings.pallas_max_band`` or the dtype is not one the
    kernel is built for. On the card there is no gate: the kernel has no
    VMEM window, so it takes any band, and a dtype it is not built for
    raises rather than run the plain version there.
    """
    dt = torch.promote_types(data.dtype, x.dtype)
    if x.device.type == "cpu":
        band = max((abs(int(o)) for o in offsets), default=0)
        if band > settings.pallas_max_band or dt not in KERNEL_DTYPES:
            return None
    elif dt not in KERNEL_DTYPES:
        raise TypeError(
            f"banded SpMV on {x.device}: dtype {dt} has no CUDA kernel "
            f"(built for {', '.join(map(str, KERNEL_DTYPES))})"
        )
    return prepared_dia(obj, data, offsets, shape, dt)(x.to(dt))
