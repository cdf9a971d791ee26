"""SELL-C-sigma packing and the prepared general (non-banded) SpMV.

Port of ``sparse_tpu/kernels/sell_spmv.py``: ``SellPlan`` and ``sell_pack``
(numpy, the same output as the reference for the same input), the per-slab
kernels ``sell_spmv_slab`` / ``sell_spmv_slab_batched`` (``csrc/sell_spmv.cu``,
replacing the Pallas ``_sell_slab_pallas`` and ``_sell_slab_pallas_batched``)
launched slab by slab from ``sell_spmv`` / ``sell_spmv_batched``, and
``PreparedCSR``, the packed operator ``csr_array`` caches in ``plan_cache``.

Layout: rows are sorted by degree within sigma-row windows, cut into chunks
of C rows, each chunk padded to its own max degree; chunks of one padded
width K form a slab, stored as plane-major ``[K, R]`` index and value
planes. ``pos`` maps each original row to its place in the concatenated
packed output (slabs in order, then the all-empty rows).

Each kernel wrapper runs its plain version (``ops/spmv.py``) for CPU
tensors only; on a CUDA tensor it launches the kernel or raises. The TPU's
VMEM gates (``PALLAS_MAX_X``, ``PALLAS_MAX_K``) remain the path choice on
the CPU, as in the reference; the CUDA kernel reads x through L2 and takes
any width.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import settings
from ..ops.spmv import (
    _sell_slab_spmv,
    _sell_slab_spmv_batched,
    csr_spmm_sell,
    csr_spmv_sell,
    csr_spmv_sell_batched,
)
from ..utils import as_tensor, host_array, resolve_device
from . import _build

# Slab rows pad to a multiple of ROW_ALIGN (the reference's sublane rule,
# kept so packs stay identical); pad rows hold index 0 and value 0 and the
# pos gather never reads them.
ROW_ALIGN = 8
# The reference's Pallas gates (x resident in VMEM, planes unrolled); the
# path choice for CPU tensors only.
PALLAS_MAX_X = 1 << 20
PALLAS_MAX_K = 128
#: dtypes the CUDA kernels are built for
KERNEL_DTYPES = (torch.float32, torch.float64)
_INDEX_DTYPES = (torch.int32, torch.int64)

# split-K rule (sell_split): enough warps to keep the card's 132 SMs busy,
# at least SPLIT_MIN_PLANES planes per warp, at most SPLIT_MAX_WARPS warps a block
SPLIT_TARGET_WARPS = 8192
SPLIT_MIN_PLANES = 32
SPLIT_MAX_WARPS = 8
_TILE_ROWS = 32


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


class SellPlan:
    """Static geometry of a packed SELL operator.

    ``slab_meta`` is a tuple of ``(K, rows, pad_rows)`` per slab; ``rows``
    includes the alignment padding, ``pad_rows`` counts it.
    """

    __slots__ = ("m", "n", "C", "sigma", "slab_meta", "zero_rows", "nnz")

    def __init__(self, m, n, C, sigma, slab_meta, zero_rows, nnz):
        self.m, self.n, self.C, self.sigma = int(m), int(n), int(C), int(sigma)
        self.slab_meta = tuple((int(k), int(r), int(p)) for k, r, p in slab_meta)
        self.zero_rows = int(zero_rows)
        self.nnz = int(nnz)

    @property
    def stored_slots(self) -> int:
        return sum(k * r for k, r, _ in self.slab_meta)

    @property
    def pad_ratio(self) -> float:
        """Stored slots per nonzero (1.0 = no padding)."""
        return self.stored_slots / max(self.nnz, 1)

    def _key(self):
        return (self.m, self.n, self.C, self.sigma, self.slab_meta, self.zero_rows)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, SellPlan) and self._key() == other._key()

    def __repr__(self):
        return (
            f"SellPlan(m={self.m}, n={self.n}, C={self.C}, sigma={self.sigma}, "
            f"slabs={len(self.slab_meta)}, pad_ratio={self.pad_ratio:.3f})"
        )


def sell_pack(indptr, indices, data, shape, C=None, sigma=None, max_slabs=None,
              with_srcs=False, device=None):
    """Pack CSR buffers into the SELL-C-sigma slab layout.

    The pack runs in numpy on the host and gives the reference's output
    exactly (plan, planes, ``pos``, ``srcs``); only its outputs become
    tensors, on ``device`` (default ``settings.device``). Returns
    ``(plan, slabs, pos)`` with ``slabs`` a tuple of ``(idx_t, val_t)``
    ``[K, R]`` pairs, plus ``srcs`` (per-slab packed slot -> nnz position,
    -1 for pad slots) with ``with_srcs=True``. Chunk widths group exactly;
    past ``max_slabs`` distinct widths they round up to powers of two.
    """
    C = int(C or settings.sell_chunk)
    sigma = int(sigma if sigma is not None else settings.sell_sigma)
    max_slabs = int(max_slabs or settings.sell_max_slabs)
    dev = resolve_device(device)
    indptr, indices, data = host_array(indptr), host_array(indices), host_array(data)
    m, n = int(shape[0]), int(shape[1])
    nnz = int(data.shape[0])
    counts = (indptr[1:] - indptr[:-1]).astype(np.int64)

    # sigma-window degree sort: descending, ties in row order
    sigma_eff = max(min(sigma if sigma > 0 else m, m), 1) if m else 1
    perm = np.lexsort((-counts, np.arange(m, dtype=np.int64) // sigma_eff)).astype(np.int64)

    # C-row chunks, each padded to its own max degree
    nchunks = (m + C - 1) // C
    chunk_w = (
        np.maximum.reduceat(counts[perm], np.arange(0, m, C)) if m
        else np.zeros(0, dtype=np.int64)
    )
    widths = np.unique(chunk_w[chunk_w > 0])
    if len(widths) > max_slabs:
        chunk_w = np.where(
            chunk_w > 0, 2 ** np.ceil(np.log2(chunk_w.clip(1))).astype(np.int64), 0
        )
        widths = np.unique(chunk_w[chunk_w > 0])
    # padded width of the chunk holding each packed position
    pos_w = chunk_w[np.arange(m, dtype=np.int64) // C] if nchunks else chunk_w

    idt = indices.dtype if indices.dtype in (np.int32, np.int64) else np.int32
    src_dt = np.int32 if nnz < 2**31 else np.int64
    slabs, srcs, slab_meta = [], [], []
    packed_rows = []  # original row ids, slab-major packed order (-1: pad row)
    for K in widths.tolist():
        rws = perm[pos_w == K]
        R = _round_up(len(rws), ROW_ALIGN)
        idx_t = np.zeros((K, R), dtype=idt)
        val_t = np.zeros((K, R), dtype=data.dtype)
        L = counts[rws]
        rr = np.repeat(np.arange(len(rws), dtype=np.int64), L)
        slot = np.arange(int(L.sum()), dtype=np.int64) - np.repeat(np.cumsum(L) - L, L)
        src = np.repeat(indptr[rws].astype(np.int64), L) + slot
        idx_t[slot, rr] = indices[src]
        val_t[slot, rr] = data[src]
        slabs.append((as_tensor(idx_t, dev), as_tensor(val_t, dev)))
        if with_srcs:
            src_t = np.full((K, R), -1, dtype=src_dt)
            src_t[slot, rr] = src.astype(src_dt)
            srcs.append(as_tensor(src_t, dev))
        slab_meta.append((K, R, R - len(rws)))
        packed_rows.append(rws)
        packed_rows.append(np.full(R - len(rws), -1, dtype=np.int64))

    # trailing block of all-empty rows (chunk width 0)
    zero_rws = perm[pos_w == 0]
    packed_rows.append(zero_rws)
    flat = np.concatenate(packed_rows)
    pos = np.zeros(m, dtype=np.int64)
    real = flat >= 0
    pos[flat[real]] = np.nonzero(real)[0]
    pos_dt = np.int32 if len(flat) < 2**31 else np.int64

    plan = SellPlan(m, n, C, sigma_eff, slab_meta, len(zero_rws), nnz)
    pos_t = as_tensor(pos.astype(pos_dt), dev)
    if with_srcs:
        return plan, tuple(slabs), pos_t, tuple(srcs)
    return plan, tuple(slabs), pos_t


# ---------------------------------------------------------------------------
# the kernels: csrc/sell_spmv.cu
# ---------------------------------------------------------------------------
def sell_split(K: int, R: int):
    """The kernel's shape for one ``[K, R]`` slab: ``(KS, W, nblk)`` =
    planes per warp segment, warps per block, blocks per 32-row tile.
    ``(K, 1, 1)`` is the narrow shape (one thread per row, all K planes,
    bit-identical to the plain version); anything else splits K when the
    slab's rows alone give fewer than ``SPLIT_TARGET_WARPS`` warps.

    The shape depends on the slab only, not on the lane count, so each lane
    of the batched kernel sums in the order of the single-matrix kernel: a
    lane of a batched solve equals the lone solve bit for bit."""
    row_warps = -(-R // _TILE_ROWS)
    nseg = min(-(-SPLIT_TARGET_WARPS // max(row_warps, 1)), -(-K // SPLIT_MIN_PLANES))
    if nseg <= 1:
        return K, 1, 1
    KS = -(-K // nseg)
    nseg = -(-K // KS)
    W = min(SPLIT_MAX_WARPS, nseg)
    return KS, W, -(-nseg // W)


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURE = [_PTR] * 6 + [_I64] * 5 + [_I32] * 3 + [_PTR]
_DT = {torch.float32: "f32", torch.float64: "f64"}
_IT = {torch.int32: "i32", torch.int64: "i64"}
_SIGNATURES = {
    f"stk_sell_spmv_slab{b}_{d}_{i}": _SIGNATURE
    for b in ("", "_batched") for d in _DT.values() for i in _IT.values()
}


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _launch(name: str, idx_t, val, x, y, lanes: int, ldy: int) -> None:
    """Check the operands and launch ``csrc/sell_spmv.cu`` over ``lanes``
    lanes: ``val`` is ``[lanes, K, R]`` (or ``[K, R]``), ``x`` ``[lanes, n]``
    (or ``[n]``), lane b of y starts at ``b * ldy``."""
    if val.dtype != x.dtype or val.dtype != y.dtype or val.dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"{name}: values, x and y must share a dtype in {KERNEL_DTYPES} "
            f"(got {val.dtype}, {x.dtype}, {y.dtype})"
        )
    if idx_t.dtype not in _INDEX_DTYPES:
        raise ValueError(f"{name}: index planes must be int32 or int64 (got {idx_t.dtype})")
    K, R = idx_t.shape
    sp = torch.cuda.current_stream(x.device)
    KS, W, nblk = sell_split(K, R)
    partials = tickets = None  # only a K range split across blocks needs them
    if nblk > 1:
        partials = torch.empty((lanes * nblk * R,), dtype=val.dtype, device=x.device)
        tiles = -(-R // _TILE_ROWS)
        tickets = torch.zeros((lanes * tiles,), dtype=torch.int32, device=x.device)
    lib = _build.library("sell_spmv", _SIGNATURES)
    kind = "_batched" if name.endswith("_batched") else ""
    fn = getattr(lib, f"stk_sell_spmv_slab{kind}_{_DT[val.dtype]}_{_IT[idx_t.dtype]}")
    code = fn(
        idx_t.data_ptr(), val.data_ptr(), x.data_ptr(), y.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        K, R, x.shape[-1], ldy, KS, W, nblk, lanes, ctypes.c_void_p(sp.cuda_stream),
    )
    _build.check_launch(lib, code, name)


#: the kernels' plain versions (ops/spmv.py): the same sums in plane order
sell_spmv_slab_plain = _sell_slab_spmv
sell_spmv_slab_batched_plain = _sell_slab_spmv_batched


def sell_spmv_slab(idx_t, val_t, x, out=None):
    """y_slab = A_slab @ x on one ``[K, R]`` slab; writes into ``out`` (a
    contiguous ``[R]`` view) when given.

    On CPU tensors this runs the plain ``ops.spmv._sell_slab_spmv``; on
    CUDA tensors it launches ``csrc/sell_spmv.cu`` or raises.
    """
    if _on_cpu(idx_t, val_t, x):
        y = _sell_slab_spmv(idx_t, val_t, x)
        return y if out is None else out.copy_(y)
    name = "sell_spmv_slab"
    K, R = idx_t.shape
    y = torch.empty((R,), dtype=val_t.dtype, device=x.device) if out is None else out
    _build.require_cuda(name, idx_t, val_t, x, y)
    if tuple(val_t.shape) != (K, R) or x.ndim != 1 or tuple(y.shape) != (R,):
        raise ValueError(f"{name}: shapes idx {tuple(idx_t.shape)}, val {tuple(val_t.shape)}, "
                         f"x {tuple(x.shape)}, y {tuple(y.shape)} do not fit")
    if K == 0:
        return y.zero_()
    _launch(name, idx_t, val_t, x, y, 1, R)
    sell_spmv_slab.launches += 1
    return y


sell_spmv_slab.launches = 0


def sell_spmv_slab_batched(idx_t, val_bt, X, out=None):
    """Y_slab[b] = A_b,slab @ X[b]: shared ``[K, R]`` index planes, value
    planes ``[B, K, R]``, X ``[B, n]``; writes into ``out`` (``[B, R]``,
    rows contiguous, any row stride) when given.

    On CPU tensors this runs the plain
    ``ops.spmv._sell_slab_spmv_batched``; on CUDA tensors it launches
    ``csrc/sell_spmv.cu`` over a lane grid dimension or raises.
    """
    if _on_cpu(idx_t, val_bt, X):
        Y = _sell_slab_spmv_batched(idx_t, val_bt, X)
        return Y if out is None else out.copy_(Y)
    name = "sell_spmv_slab_batched"
    K, R = idx_t.shape
    B = X.shape[0]
    Y = torch.empty((B, R), dtype=val_bt.dtype, device=X.device) if out is None else out
    _build.require_cuda(name, idx_t, val_bt, X)
    if Y.device != X.device or Y.stride(-1) != 1 or tuple(Y.shape) != (B, R):
        raise ValueError(f"{name}: out must be a [{B}, {R}] view with contiguous rows on {X.device}")
    if tuple(val_bt.shape) != (B, K, R) or X.ndim != 2:
        raise ValueError(f"{name}: shapes idx {tuple(idx_t.shape)}, val {tuple(val_bt.shape)}, "
                         f"X {tuple(X.shape)} do not fit")
    if K == 0 or B == 0:
        return Y.zero_()
    _launch(name, idx_t, val_bt, X, Y, B, Y.stride(0))
    sell_spmv_slab_batched.launches += 1
    return Y


sell_spmv_slab_batched.launches = 0


def _out_dtype(val_dtype, x):
    return torch.promote_types(val_dtype, x.dtype)


def sell_spmv(plan: SellPlan, slabs, pos, x):
    """y = A @ x: :func:`sell_spmv_slab` per slab into one packed buffer,
    the all-empty rows zeroed, then the ``pos`` gather back to row order
    (the reference's XLA glue, plain torch here)."""
    out_dt = _out_dtype(slabs[0][1].dtype if slabs else x.dtype, x)
    if not slabs:
        return torch.zeros((plan.m,), dtype=out_dt, device=x.device)
    total = sum(R for _, R, _ in plan.slab_meta) + plan.zero_rows
    packed = torch.empty((total,), dtype=out_dt, device=x.device)
    off = 0
    for (idx_t, val_t), (_K, R, _) in zip(slabs, plan.slab_meta):
        sell_spmv_slab(idx_t, val_t, x, out=packed[off : off + R])
        off += R
    packed[off:].zero_()
    return packed[pos]


def sell_spmv_plain(plan: SellPlan, slabs, pos, x):
    """Plain torch twin of :func:`sell_spmv` (``ops.spmv.csr_spmv_sell``)."""
    return csr_spmv_sell(slabs, pos, x, plan.zero_rows)


def sell_spmv_batched(plan: SellPlan, idx_slabs, val_slabs, pos, X):
    """Y[b] = A_b @ X[b] over one shared pattern: :func:`sell_spmv_slab_batched`
    per slab into one packed ``[B, rows]`` buffer, then the ``pos`` gather."""
    out_dt = _out_dtype(val_slabs[0].dtype if val_slabs else X.dtype, X)
    B = X.shape[0]
    if not idx_slabs:
        return torch.zeros((B, plan.m), dtype=out_dt, device=X.device)
    total = sum(R for _, R, _ in plan.slab_meta) + plan.zero_rows
    packed = torch.empty((B, total), dtype=out_dt, device=X.device)
    off = 0
    for idx_t, val_bt, (_K, R, _) in zip(idx_slabs, val_slabs, plan.slab_meta):
        sell_spmv_slab_batched(idx_t, val_bt, X, out=packed[:, off : off + R])
        off += R
    packed[:, off:].zero_()
    return packed[:, pos]


def sell_spmv_batched_plain(plan: SellPlan, idx_slabs, val_slabs, pos, X):
    """Plain torch twin of :func:`sell_spmv_batched`."""
    return csr_spmv_sell_batched(idx_slabs, val_slabs, pos, X, plan.zero_rows)


def kernel_dtype(val_dtype, x_dtype, what: str) -> torch.dtype:
    """The promoted dtype a SELL kernel runs at on the card; raises for a
    dtype with no kernel (complex, f16) instead of running plain torch."""
    dt = torch.promote_types(val_dtype, x_dtype)
    if dt not in KERNEL_DTYPES:
        raise TypeError(
            f"{what} on the card: dtype {dt} has no CUDA kernel "
            f"(built for {', '.join(map(str, KERNEL_DTYPES))})"
        )
    return dt


class PreparedCSR:
    """A general CSR operator packed once into the SELL slab layout.

    ``csr_array`` obtains one through ``plan_cache`` so repeated ``A @ x``
    and solver loops never repack. ``__call__`` launches the SELL kernel on
    a CUDA operand (mixed operand dtypes promote; a dtype with no kernel
    raises); on the CPU it keeps the reference's choice: the kernel path
    (its plain version here) under ``spmv_mode='pallas'`` within the VMEM
    gates at f32, the plain slab formulation otherwise.
    """

    __slots__ = ("plan", "slabs", "pos", "_cast", "__weakref__")

    def __init__(self, indptr, indices, data, shape, C=None, sigma=None,
                 max_slabs=None, device=None):
        self.plan, self.slabs, self.pos = sell_pack(
            indptr, indices, data, shape, C=C, sigma=sigma, max_slabs=max_slabs,
            device=device,
        )
        self._cast = {}

    @classmethod
    def from_parts(cls, plan: SellPlan, slabs, pos) -> "PreparedCSR":
        """Reassemble a prepared operator from already-packed parts."""
        prep = object.__new__(cls)
        prep.plan = plan
        prep.slabs = tuple((it, vt) for it, vt in slabs)
        prep.pos = pos
        prep._cast = {}
        return prep

    @property
    def shape(self):
        return (self.plan.m, self.plan.n)

    def _val_dtype(self, x):
        return self.slabs[0][1].dtype if self.slabs else x.dtype

    def _slabs_at(self, dt):
        """The slabs with values at ``dt`` (converted once and kept)."""
        if not self.slabs or self.slabs[0][1].dtype == dt:
            return self.slabs
        if dt not in self._cast:
            self._cast[dt] = tuple((it, vt.to(dt)) for it, vt in self.slabs)
        return self._cast[dt]

    def _pallas_viable(self, x) -> bool:
        if not self.slabs or x.shape[0] > PALLAS_MAX_X:
            return False
        if any(K > PALLAS_MAX_K for K, _, _ in self.plan.slab_meta):
            return False
        return _out_dtype(self._val_dtype(x), x) == torch.float32

    def matvec_plain(self, x):
        return sell_spmv_plain(self.plan, self.slabs, self.pos, x)

    def matvec_kernel(self, x):
        dt = _out_dtype(self._val_dtype(x), x)
        if x.device.type != "cpu":
            kernel_dtype(self._val_dtype(x), x.dtype, "SELL SpMV")
        return sell_spmv(self.plan, self._slabs_at(dt), self.pos, x.to(dt))

    def matmat(self, B):
        return csr_spmm_sell(self.slabs, self.pos, B, self.plan.zero_rows)

    def __call__(self, x):
        if x.device.type != "cpu":
            return self.matvec_kernel(x)
        if settings.spmv_mode == "pallas" and self._pallas_viable(x):
            return self.matvec_kernel(x)
        return self.matvec_plain(x)

