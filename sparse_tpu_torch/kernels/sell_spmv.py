"""SELL packing and the prepared general (non-banded) SpMV.

Port of ``sparse_tpu/kernels/sell_spmv.py``, with two layouts:

* ``SellPlan`` and ``sell_pack``: the reference's SELL-C-sigma slab pack
  (numpy, the same output as the reference for the same input). It serves
  the CPU path, the parity tests and ``interop``; ``sell_chunk``,
  ``sell_sigma`` and ``sell_max_slabs`` govern it. ``sell_spmv`` /
  ``sell_spmv_batched`` run it on CPU tensors (the slab kernels' plain
  versions, ``ops/spmv.py``), where ``spmv_mode='pallas'`` keeps the
  reference's path choice; a CUDA tensor raises.
* ``SellChunks`` and ``sell_chunk_pack``: the card's layout, built on the
  device in torch ops. One stable sort of the rows by descending degree,
  chunks of 32 rows (one warp), each at its own width with no cap,
  slot-major index and value slots, and a work list of segments of at most
  ``seg`` slots a row. The kernels ``sell_chunk_spmv`` and
  ``sell_chunk_spmv_batched`` (``csrc/sell_spmv.cu``, replacing the Pallas
  ``_sell_slab_pallas`` and ``_sell_slab_pallas_batched``) run one product
  in one launch over it.

``PreparedCSR``, the operator ``csr_array`` caches in ``plan_cache``, packs
the slab layout on the CPU and the chunk layout on a CUDA device. Each
kernel wrapper runs its plain version for CPU tensors only; on a CUDA
tensor it launches the kernel or raises. The TPU's VMEM gates
(``PALLAS_MAX_X``, ``PALLAS_MAX_K``) remain the path choice on the CPU, as
in the reference; the CUDA kernels read x through L2 and take any width.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import settings
from ..ops.coords import expand_rows
from ..ops.spmv import (
    csr_spmm_chunks,
    csr_spmm_sell,
    csr_spmv_chunks,
    csr_spmv_chunks_batched,
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

#: rows a chunk of the card's layout: one warp, one lane a row
CHUNK_ROWS = 32
#: slots a row in one work item (segment) of the chunk layout; it fixes the
#: summation order, which both kernels and their plain versions share.
#: Chosen on the H100 (``python3 chip_smoke.py --segment-sweep``): shorter
#: segments split the widest chunks of a power-law matrix over more warps
SELL_SEGMENT = 128
# lanes a block of the batched kernel takes (csrc/sell_spmv.cu kLaneGroup)
_LANE_GROUP = 64
_INT32_MAX = 2**31 - 1


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
# the card's layout: chunks of 32 rows over one global degree sort
# ---------------------------------------------------------------------------
class SellChunks:
    """The chunked SELL layout of one matrix or pattern, on its device.

    ``perm[p]`` is the row at packed position p (descending degree, ties in
    row order); chunk c holds positions ``32c .. 32c + 31`` and its slots
    ``cptr[c] .. cptr[c + 1]``, slot k of its lane r at ``cptr[c] + 32k +
    r``. ``idx``/``val`` are the index and value slots (``val`` None for a
    pattern), ``src`` (with ``with_src``) the nonzero each slot holds (-1
    for a pad slot). ``work`` is int32 ``[nwork, 4]``: chunk, segment,
    segments of the chunk and the chunk's first partial row (-1 when it has
    one segment); segment s covers slots ``[s * seg, min((s + 1) * seg,
    w_c))``. ``npart`` partial rows serve the split chunks.
    """

    __slots__ = ("m", "n", "nnz", "seg", "slots", "perm", "cptr", "idx", "val", "src",
                 "work", "nwork", "npart")
    #: rows a chunk (one warp)
    rows = CHUNK_ROWS

    def __init__(self, m, n, nnz, seg, slots, perm, cptr, idx, val, src, work, npart):
        self.m, self.n, self.nnz, self.seg, self.slots = int(m), int(n), int(nnz), int(seg), int(slots)
        self.perm, self.cptr, self.idx, self.val, self.src = perm, cptr, idx, val, src
        self.work, self.nwork, self.npart = work, int(work.shape[0]), int(npart)

    @property
    def nchunks(self) -> int:
        return int(self.cptr.shape[0]) - 1

    @property
    def pad_ratio(self) -> float:
        """Stored slots per nonzero (1.0 = no padding)."""
        return self.slots / max(self.nnz, 1)

    def pack_values(self, values):
        """A ``(B, nnz)`` value stack as ``[slots, B]`` (pad slots zero):
        one gather through ``src``."""
        g = values[:, self.src.clamp(min=0)]
        return torch.where(self.src >= 0, g, torch.zeros((), dtype=g.dtype, device=g.device)).t().contiguous()

    def __repr__(self):
        return (f"SellChunks(m={self.m}, n={self.n}, chunks={self.nchunks}, slots={self.slots}, "
                f"pad_ratio={self.pad_ratio:.3f}, seg={self.seg}, work={self.nwork}, "
                f"partial_rows={self.npart})")


def _work_list(width, seg: int):
    """(work ``[nwork, 4]`` int32, npart) for chunk widths ``width``: every
    chunk cut into ``max(1, ceil(w_c / seg))`` segments, chunk-major."""
    dev = width.device
    nseg = ((width + seg - 1) // seg).clamp(min=1)
    nwork = int(nseg.sum())
    chunk = torch.repeat_interleave(torch.arange(width.shape[0], device=dev), nseg,
                                    output_size=nwork)
    first = torch.cumsum(nseg, 0) - nseg
    segment = torch.arange(nwork, device=dev) - first[chunk]
    psz = torch.where(nseg > 1, nseg, 0)
    pbase = torch.where(nseg > 1, torch.cumsum(psz, 0) - psz, -1)
    work = torch.stack([chunk, segment, nseg[chunk], pbase[chunk]], dim=1)
    return work.to(torch.int32).contiguous(), int(psz.sum())


def sell_chunk_pack(indptr, indices, data, shape, seg=None, with_src=False) -> SellChunks:
    """Pack CSR buffers (tensors on one device) into the chunk layout, on
    that device: a stable sort of the rows by descending degree, a
    per-chunk max, a cumsum and one scatter of the nonzeros. ``data`` None
    packs the pattern alone; ``with_src`` keeps each slot's nonzero for
    :meth:`SellChunks.pack_values`. The work list depends on the chunk
    widths (so on the pattern) and ``seg`` (default ``SELL_SEGMENT``)
    only."""
    seg = int(seg or SELL_SEGMENT)
    dev = indices.device
    m, n = int(shape[0]), int(shape[1])
    nnz = int(indices.shape[0])
    i64 = dict(dtype=torch.int64, device=dev)
    ip = indptr.to(**i64)
    counts = ip[1:] - ip[:-1]
    perm = torch.sort(-counts, stable=True).indices
    nch = -(-m // CHUNK_ROWS)
    if nch > _INT32_MAX:
        raise ValueError(f"sell_chunk_pack: {nch} chunks do not fit the int32 work list")
    deg = torch.zeros((nch * CHUNK_ROWS,), **i64)
    deg[:m] = counts[perm]
    width = deg.view(nch, CHUNK_ROWS).amax(dim=1) if nch else deg
    cptr = torch.zeros((nch + 1,), **i64)
    torch.cumsum(width * CHUNK_ROWS, 0, out=cptr[1:])
    slots = int(cptr[-1])

    # each nonzero's slot: chunk base + (slot within its row) * 32 + lane
    rows = expand_rows(ip, nnz)
    packed = torch.empty((m,), **i64)
    packed[perm] = torch.arange(m, **i64)
    p = packed[rows]
    slot = cptr[p // CHUNK_ROWS] + (torch.arange(nnz, **i64) - ip[rows]) * CHUNK_ROWS + p % CHUNK_ROWS
    del rows, packed, p
    wide = indices.dtype == torch.int64 or max(m, n) > _INT32_MAX
    idt = torch.int64 if wide else torch.int32
    idx = torch.zeros((slots,), dtype=idt, device=dev)
    idx[slot] = indices.to(idt)
    val = None
    if data is not None:
        val = torch.zeros((slots,), dtype=data.dtype, device=dev)
        val[slot] = data
    src = None
    if with_src:
        src = torch.full((slots,), -1, dtype=torch.int32 if nnz < 2**31 else torch.int64, device=dev)
        src[slot] = torch.arange(nnz, dtype=src.dtype, device=dev)
    work, npart = _work_list(width, seg)
    return SellChunks(m, n, nnz, seg, slots, perm.to(idt), cptr, idx, val, src, work, npart)


def chunks_from_slabs(plan: SellPlan, slabs, pos) -> SellChunks:
    """The chunk layout of a matrix given as the reference's slab pack, on
    the slabs' device: each packed row's slots up to its last one that is
    not a pad slot (index 0 and value 0) become the row's nonzeros, in slot
    order. A row's trailing explicit zeros at column 0 are dropped with the
    pads; they add nothing to y. The work list takes ``SELL_SEGMENT``, so
    the products equal those of the layout packed from CSR bit for bit."""
    dev = pos.device
    i64 = dict(dtype=torch.int64, device=dev)
    owners, ents_i, ents_v = [], [], []
    off = 0
    for (it, vt), (K, R, _pad) in zip(slabs, plan.slab_meta):
        real = (it != 0) | (vt != 0)
        length = (real * torch.arange(1, K + 1, **i64)[:, None]).amax(dim=0)
        r, k = (torch.arange(K, **i64)[None, :] < length[:, None]).nonzero(as_tuple=True)
        owners.append(off + r)
        ents_i.append(it[k, r])
        ents_v.append(vt[k, r])
        off += R
    m = plan.m
    row_of = torch.full((off + plan.zero_rows,), -1, **i64)
    row_of[pos.to(torch.int64)] = torch.arange(m, **i64)
    if owners:
        rows = row_of[torch.cat(owners)]
        order = torch.sort(rows, stable=True).indices
        indices, data = torch.cat(ents_i)[order], torch.cat(ents_v)[order]
        counts = torch.bincount(rows, minlength=m)
    else:
        indices = torch.zeros((0,), dtype=torch.int32, device=dev)
        data = torch.zeros((0,), dtype=torch.float32, device=dev)
        counts = torch.zeros((m,), **i64)
    indptr = torch.zeros((m + 1,), **i64)
    torch.cumsum(counts, 0, out=indptr[1:])
    return sell_chunk_pack(indptr, indices, data, (plan.m, plan.n))


class SellWorkspace:
    """The chunk kernels' scratch for one layout, value dtype and lane
    count, allocated once: the split chunks' partials and their integer
    tickets, zeroed here once; each launch rearms the tickets it takes, so
    a product needs no fill. One product at a time (one stream) per
    workspace."""

    __slots__ = ("partials", "tickets", "lanes")

    def __init__(self, ch: SellChunks, dtype, lanes: int = 1):
        dev = ch.idx.device
        rows = max(ch.npart, 1)
        self.lanes = int(lanes)
        self.partials = torch.empty((rows * CHUNK_ROWS * self.lanes,), dtype=dtype, device=dev)
        groups = -(-self.lanes // _LANE_GROUP)
        self.tickets = torch.zeros((rows * groups,), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# the kernels: csrc/sell_spmv.cu
# ---------------------------------------------------------------------------
_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURE = [_PTR] * 9 + [_I64, _I64, _I32, _I32, _PTR]
_DT = {torch.float32: "f32", torch.float64: "f64"}
_IT = {torch.int32: "i32", torch.int64: "i64"}
_SIGNATURES = {
    f"stk_sell_chunk_spmv{b}_{d}_{i}": _SIGNATURE
    for b in ("", "_batched") for d in _DT.values() for i in _IT.values()
}


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _launch(ch: SellChunks, val, x, y, ws, lanes: int, batched: bool) -> None:
    """Check the operands and launch ``csrc/sell_spmv.cu``: the
    single-matrix kernel with ``val`` ``[slots]``, x ``[n]`` and y ``[m]``,
    or the batched one with ``val`` ``[slots, lanes]``, x ``[n, lanes]``
    and y ``[lanes, m]``."""
    kind = "_batched" if batched else ""
    name = f"sell_chunk_spmv{kind}"
    _build.require_cuda(name, ch.idx, ch.perm, ch.cptr, ch.work, val, x, y)
    if val.dtype != x.dtype or val.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: values and x must share a dtype in {KERNEL_DTYPES} "
                         f"(got {val.dtype}, {x.dtype})")
    if ch.idx.dtype not in _INDEX_DTYPES or ch.perm.dtype != ch.idx.dtype:
        raise ValueError(f"{name}: index slots and perm must be int32 or int64 alike "
                         f"(got {ch.idx.dtype}, {ch.perm.dtype})")
    want = ((ch.slots, lanes), (ch.n, lanes)) if batched else ((ch.slots,), (ch.n,))
    if (tuple(val.shape), tuple(x.shape)) != want:
        raise ValueError(f"{name}: values {tuple(val.shape)} and x {tuple(x.shape)} do not fit "
                         f"{ch} (want {want[0]} and {want[1]})")
    if ws is None or ws.partials.dtype != val.dtype or ws.lanes != lanes:
        raise ValueError(f"{name}: needs the operator's SellWorkspace for {val.dtype} and "
                         f"{lanes} lane(s)")
    lib = _build.library("sell_spmv", _SIGNATURES)
    fn = getattr(lib, f"stk_sell_chunk_spmv{kind}_{_DT[val.dtype]}_{_IT[ch.idx.dtype]}")
    code = fn(
        ch.idx.data_ptr(), val.data_ptr(), x.data_ptr(), y.data_ptr(), ch.perm.data_ptr(),
        ch.cptr.data_ptr(), ch.work.data_ptr(), ws.partials.data_ptr(), ws.tickets.data_ptr(),
        ch.m, ch.nwork, ch.seg, lanes, _build.stream_handle(x),
    )
    _build.check_launch(lib, code, name)


#: the kernels' plain versions (ops/spmv.py): the same sums in the same order
sell_chunk_spmv_plain = csr_spmv_chunks
sell_chunk_spmv_batched_plain = csr_spmv_chunks_batched


def sell_chunk_spmv(ch: SellChunks, val, x, ws: SellWorkspace | None = None):
    """y = A @ x over the chunk layout ``ch`` with value slots ``val``: one
    launch of ``csrc/sell_spmv.cu``'s single-matrix kernel, y in row order.

    On CPU tensors this runs the plain ``ops.spmv.csr_spmv_chunks``; on
    CUDA tensors it launches the kernel, with the workspace ``ws``
    (:class:`SellWorkspace` at ``val``'s dtype, one lane), or raises.
    """
    if _on_cpu(val, x):
        return csr_spmv_chunks(ch, val, x)
    y = torch.empty((ch.m,), dtype=val.dtype, device=x.device)
    if ch.m:
        _launch(ch, val, x, y, ws, 1, batched=False)
        sell_chunk_spmv.launches += 1
    return y


sell_chunk_spmv.launches = 0


def sell_chunk_spmv_batched(ch: SellChunks, vals, X, ws: SellWorkspace | None = None):
    """Y[b] = A_b @ X[b] over one shared chunk layout: value slots
    ``[slots, B]`` (:meth:`SellChunks.pack_values`), X ``[B, n]``, Y
    ``[B, m]`` in row order. Each lane sums in :func:`sell_chunk_spmv`'s
    order, so it equals the lone product bit for bit.

    On CPU tensors this runs the plain ``ops.spmv.csr_spmv_chunks_batched``;
    on CUDA tensors it takes X as ``[n, B]`` (one transpose) and launches
    the batched kernel once, with the workspace ``ws`` (B lanes), or
    raises.
    """
    if _on_cpu(vals, X):
        return csr_spmv_chunks_batched(ch, vals, X)
    B = X.shape[0]
    Y = torch.empty((B, ch.m), dtype=vals.dtype, device=X.device)
    if ch.m and B:
        _launch(ch, vals, X.t().contiguous(), Y, ws, B, batched=True)
        sell_chunk_spmv_batched.launches += 1
    return Y


sell_chunk_spmv_batched.launches = 0


# ---------------------------------------------------------------------------
# the reference's slab pack on CPU tensors
# ---------------------------------------------------------------------------
def _slabs_on_cpu(what: str, *tensors) -> None:
    if not _on_cpu(*tensors):
        raise ValueError(f"{what}: the slab layout runs on CPU tensors only; on a CUDA device "
                         f"the chunk layout runs (sell_chunk_pack, sell_chunk_spmv)")


def _out_dtype(val_dtype, x):
    return torch.promote_types(val_dtype, x.dtype)


def sell_spmv(plan: SellPlan, slabs, pos, x):
    """y = A @ x over the slab pack on CPU tensors: the slab kernels' plain
    versions slab by slab, the all-empty rows zeroed, then the ``pos``
    gather (``ops.spmv.csr_spmv_sell``)."""
    _slabs_on_cpu("sell_spmv", x, pos, *(t for s in slabs for t in s))
    return csr_spmv_sell(slabs, pos, x, plan.zero_rows)


def sell_spmv_batched(plan: SellPlan, idx_slabs, val_slabs, pos, X):
    """Y[b] = A_b @ X[b] over one shared slab pack on CPU tensors
    (``ops.spmv.csr_spmv_sell_batched``)."""
    _slabs_on_cpu("sell_spmv_batched", X, pos, *idx_slabs, *val_slabs)
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
    """A general CSR operator packed once: the slab pack on the CPU, the
    chunk layout (:func:`sell_chunk_pack`) on a CUDA device.

    ``csr_array`` obtains one through ``plan_cache`` so repeated ``A @ x``
    and solver loops never repack. On the card ``__call__`` launches the
    chunk kernel once a product (mixed operand dtypes promote; a dtype with
    no kernel raises), with value slots and workspace kept per dtype. On
    the CPU it keeps the reference's choice: the kernel path (its plain
    version here) under ``spmv_mode='pallas'`` within the VMEM gates at
    f32, the plain slab formulation otherwise; both give the same sums.
    """

    __slots__ = ("shape", "plan", "slabs", "pos", "chunks", "_cast", "_ws", "__weakref__")

    def __init__(self, indptr, indices, data, shape, C=None, sigma=None,
                 max_slabs=None, device=None):
        dev = resolve_device(device)
        self.shape = (int(shape[0]), int(shape[1]))
        self._cast, self._ws = {}, {}
        self.plan = self.slabs = self.pos = self.chunks = None
        if dev.type == "cpu":
            self.plan, self.slabs, self.pos = sell_pack(
                indptr, indices, data, shape, C=C, sigma=sigma, max_slabs=max_slabs,
                device=dev,
            )
        else:
            self.chunks = sell_chunk_pack(*(as_tensor(a, dev) for a in (indptr, indices, data)),
                                          shape)

    @classmethod
    def from_parts(cls, plan: SellPlan, slabs, pos) -> "PreparedCSR":
        """Reassemble a prepared operator from the parts of a slab pack; on
        a CUDA device (``pos``'s) the chunk layout is built from them."""
        prep = object.__new__(cls)
        prep.shape = (plan.m, plan.n)
        prep._cast, prep._ws = {}, {}
        prep.plan = prep.slabs = prep.pos = prep.chunks = None
        if pos.device.type == "cpu":
            prep.plan, prep.slabs, prep.pos = plan, tuple((it, vt) for it, vt in slabs), pos
        else:
            prep.chunks = chunks_from_slabs(plan, slabs, pos)
        return prep

    def _val_dtype(self, x):
        if self.chunks is not None:
            return self.chunks.val.dtype
        return self.slabs[0][1].dtype if self.slabs else x.dtype

    def _slabs_at(self, dt):
        """The slabs with values at ``dt`` (converted once and kept)."""
        if not self.slabs or self.slabs[0][1].dtype == dt:
            return self.slabs
        if dt not in self._cast:
            self._cast[dt] = tuple((it, vt.to(dt)) for it, vt in self.slabs)
        return self._cast[dt]

    def _chunk_vals(self, dt):
        """The chunk layout's value slots at ``dt`` (converted once)."""
        if self.chunks.val.dtype == dt:
            return self.chunks.val
        if dt not in self._cast:
            self._cast[dt] = self.chunks.val.to(dt)
        return self._cast[dt]

    def _pallas_viable(self, x) -> bool:
        if not self.slabs or x.shape[0] > PALLAS_MAX_X:
            return False
        if any(K > PALLAS_MAX_K for K, _, _ in self.plan.slab_meta):
            return False
        return _out_dtype(self._val_dtype(x), x) == torch.float32

    def matvec_plain(self, x):
        if self.chunks is not None:
            return csr_spmv_chunks(self.chunks, self.chunks.val, x)
        return csr_spmv_sell(self.slabs, self.pos, x, self.plan.zero_rows)

    def matvec_kernel(self, x):
        if x.device.type == "cpu":
            dt = _out_dtype(self._val_dtype(x), x)
        else:
            dt = kernel_dtype(self._val_dtype(x), x.dtype, "SELL SpMV")
        if self.chunks is None:  # the slab pack: CPU tensors only
            return sell_spmv(self.plan, self._slabs_at(dt), self.pos, x.to(dt))
        if dt not in self._ws:
            self._ws[dt] = SellWorkspace(self.chunks, dt)
        return sell_chunk_spmv(self.chunks, self._chunk_vals(dt), x.to(dt), self._ws[dt])

    def matmat(self, B):
        if self.chunks is not None:
            return csr_spmm_chunks(self.chunks, self.chunks.val, B)
        return csr_spmm_sell(self.slabs, self.pos, B, self.plan.zero_rows)

    def __call__(self, x):
        if x.device.type != "cpu" or self.chunks is not None:
            return self.matvec_kernel(x)
        if settings.spmv_mode == "pallas" and self._pallas_viable(x):
            return self.matvec_kernel(x)
        return self.matvec_plain(x)
