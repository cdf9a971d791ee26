"""SpGEMM: sparse @ sparse -> sparse (``sparse_tpu/ops/spgemm.py``).

ESC (expand, sort, compress), the reference's device formulation, in
plain torch:

  1. expand: each A nonzero (i, k, a) pairs with every nonzero of B's row
     k into a triple (i, j, a * b); the slot's source entries come from one
     ``repeat_interleave`` over B's row lengths gathered at A's columns;
  2. sort: one stable sort of the fused (row, col) key
     (``coords.fused_keys``, the key of ``lexsort_rc``);
  3. compress: duplicate pairs collapse into in-order segment sums
     (``coords.segment_sum``).

A product makes two counted host fetches (``hostsync``), as the reference
does: the expansion total and the unique count. Sizes are exact: the
reference's power-of-two buckets only let XLA reuse a compiled program,
and torch compiles nothing. On the card the stable sort and the segment
sums fix the summation order, so a repeated product gives the same bits.

Products of f32/f64 CPU tensors take the native Gustavson
(``native.spgemm_host``) where its library builds, as the reference's
host-resident products do; it adds in f64 and rounds once.
"""

from __future__ import annotations

import torch

from .. import hostsync, native
from ..types import index_dtype_for
from .coords import (
    counts_to_indptr,
    expand_rows,
    first_of_runs,
    fused_keys,
    nonzero_count,
    rows_to_indptr,
    segment_sum,
)

_INT32_MAX = 2**31 - 1


def _native_spgemm(indptr_a, indices_a, data_a, indptr_b, indices_b, data_b, m, n, dt):
    """The native Gustavson on CPU tensors of f32/f64, or None where it
    does not apply (a CUDA tensor, another dtype, or no native library)."""
    parts = (indptr_a, indices_a, data_a, indptr_b, indices_b, data_b)
    if dt not in (torch.float32, torch.float64):
        return None
    if any(t.device.type != "cpu" for t in parts):
        return None
    got = native.spgemm_host(*(t.numpy() for t in parts), m, n)
    if got is None:
        return None
    Cp, Cj, Cx = (torch.from_numpy(a) for a in got)
    idt = index_dtype_for((m, n), int(Cx.shape[0]))
    return Cp.to(idt), Cj.to(idt), Cx.to(dt)


def esc_expand_sort_compress(indptr_a, indices_a, data_a, indptr_b, indices_b, data_b,
                             m: int, n: int, total: int, dt):
    """The ESC body shared by the single-device product and, later, the
    distributed tile product: ``total`` (the expansion size, known on the
    host) triples expanded, sorted by (row, col) and compressed. Returns
    (rows, cols, vals) of the unique pairs in row-major order, int64
    coordinates; one counted host fetch (the unique count). Expansion
    indices are int32 unless the total or nnz(B) needs int64; each
    intermediate is freed once used."""
    if max(m, n) > _INT32_MAX:
        raise ValueError(f"esc_expand_sort_compress: dimension max({m}, {n}) exceeds int32 range")
    dev = data_a.device
    edt = torch.int64 if max(total, data_b.shape[0]) > _INT32_MAX else torch.int32
    starts = indptr_b[indices_a]
    counts = (indptr_b[indices_a + 1] - starts).to(edt)
    src = torch.repeat_interleave(counts, output_size=total)  # the A entry of each slot
    # slot t of A entry e reads B entry starts[e] + (t - offsets[e])
    shift = starts.to(edt) - counts_to_indptr(counts, dtype=edt)[:-1]
    del starts, counts
    p = torch.arange(total, dtype=edt, device=dev)
    p += shift[src]
    del shift
    vals = data_a[src].to(dt)
    vals *= data_b[p].to(dt)
    keys = fused_keys(expand_rows(indptr_a, data_a.shape[0])[src], indices_b[p], (m, n))
    del src, p
    skeys, order = torch.sort(keys, stable=True)
    del keys
    svals = vals[order]
    del vals, order
    is_new = first_of_runs(skeys)
    nunique = hostsync.fetch_int(is_new.sum())
    first = nonzero_count(is_new, nunique)
    del is_new
    ends = torch.full((1,), total, dtype=first.dtype, device=dev)
    uvals = segment_sum(svals, torch.cat([first, ends]))
    del svals
    ukeys = skeys[first].to(torch.int64)
    return ukeys // n, ukeys % n, uvals


def spgemm_csr_csr(indptr_a, indices_a, data_a, indptr_b, indices_b, data_b, shape_a, shape_b):
    """C = A @ B, both CSR. Returns (indptr, indices, data) of C."""
    m, n = int(shape_a[0]), int(shape_b[1])
    dt = torch.promote_types(data_a.dtype, data_b.dtype)
    out = _native_spgemm(indptr_a, indices_a, data_a, indptr_b, indices_b, data_b, m, n, dt)
    if out is not None:
        return out
    dev = data_a.device
    total = 0
    if data_a.shape[0] and data_b.shape[0]:
        counts = indptr_b[indices_a + 1] - indptr_b[indices_a]
        total = hostsync.fetch_int(counts.sum(dtype=torch.int64))
    if total == 0:
        idt = index_dtype_for((m, n), 0)
        return (torch.zeros((m + 1,), dtype=idt, device=dev),
                torch.zeros((0,), dtype=idt, device=dev), torch.zeros((0,), dtype=dt, device=dev))
    urows, ucols, uvals = esc_expand_sort_compress(
        indptr_a, indices_a, data_a, indptr_b, indices_b, data_b, m, n, total, dt)
    idt = index_dtype_for((m, n), uvals.shape[0])
    return rows_to_indptr(urows, m, dtype=idt), ucols.to(idt), uvals
