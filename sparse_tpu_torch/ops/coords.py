"""Coordinate plumbing: indptr <-> row ids, (row, col) sorting and dedup.

Port of ``sparse_tpu/ops/coords.py``: the same vectorized formulations
(batched binary search for row expansion, one stable key sort, a
boundary-mask dedup) on torch tensors, so they run on the device the
tensors live on. Sorted segments are summed by :func:`segment_sum` in one
fixed order (the reference's ``jax.ops.segment_sum``), never by scatter
atomics, so a repeated call gives the same bits on the card.
"""

from __future__ import annotations

import torch

from .. import hostsync

_INT32_MAX = 2**31 - 1


def expand_rows(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Per-nnz row ids from a CSR indptr (CSR -> COO row coordinates)."""
    if nnz == 0:
        return torch.zeros((0,), dtype=indptr.dtype, device=indptr.device)
    pts = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    rows = torch.searchsorted(
        indptr, pts, right=True, out_int32=indptr.dtype == torch.int32
    )
    return (rows - 1).to(indptr.dtype)


def segment_sum(values: torch.Tensor, offsets: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sums of the contiguous segments ``offsets[i]:offsets[i + 1]`` of
    ``values`` along ``axis`` (0 or, for ``[B, nnz]`` values, 1), 0 for an
    empty segment. Floating values go through ``torch.segment_reduce``,
    which sums each segment in one order on every call; complex values sum
    their real and imaginary parts apart. Integer sums are exact in any
    order and take ``index_add_``."""
    if values.is_complex():
        return torch.view_as_complex(segment_sum(torch.view_as_real(values), offsets, axis))
    if not values.is_floating_point():
        seg = expand_rows(offsets, values.shape[axis])
        shape = list(values.shape)
        shape[axis] = offsets.shape[0] - 1
        return torch.zeros(shape, dtype=values.dtype, device=values.device).index_add_(
            axis, seg, values)
    if axis:
        offsets = offsets.expand(*values.shape[:axis], offsets.shape[0])
    return torch.segment_reduce(values, "sum", offsets=offsets, axis=axis)


def counts_to_indptr(counts: torch.Tensor, dtype=None) -> torch.Tensor:
    """Row counts -> indptr by an exclusive scan (``counts`` of length m
    gives m + 1 offsets, starting at 0)."""
    dtype = dtype or counts.dtype
    out = torch.zeros((counts.shape[0] + 1,), dtype=dtype, device=counts.device)
    torch.cumsum(counts, 0, dtype=dtype, out=out[1:])
    return out


def rows_to_indptr(sorted_rows: torch.Tensor, m: int, dtype=None) -> torch.Tensor:
    """Sorted row ids -> indptr (one searchsorted over the sorted coords)."""
    dtype = dtype or (sorted_rows.dtype if sorted_rows.numel() else torch.int32)
    if not sorted_rows.numel():
        return torch.zeros((m + 1,), dtype=dtype, device=sorted_rows.device)
    targets = torch.arange(m + 1, dtype=sorted_rows.dtype, device=sorted_rows.device)
    return torch.searchsorted(sorted_rows.contiguous(), targets).to(dtype)


def fused_keys(primary, secondary, shape) -> torch.Tensor:
    """``primary * extent(secondary) + secondary``: int32 when the key
    space ``shape[0] * shape[1]`` fits int32, int64 otherwise."""
    p, s = int(shape[0]), int(shape[1])
    kdt = torch.int32 if p * s <= _INT32_MAX else torch.int64
    keys = primary.to(kdt, copy=True)
    keys *= s
    keys += secondary
    return keys


def lexsort_rc(primary, secondary, shape) -> torch.Tensor:
    """Stable order making (primary, secondary) lexicographically sorted.

    ``shape`` = (extent of primary, extent of secondary). One stable sort
    of the fused key (:func:`fused_keys`).
    """
    return torch.argsort(fused_keys(primary, secondary, shape), stable=True)


def sort_coo(rows, cols, vals, shape, by="row"):
    """Lexicographic sort of COO triples by (row, col) or (col, row)."""
    if by == "row":
        order = lexsort_rc(rows, cols, shape)
    else:
        order = lexsort_rc(cols, rows, (shape[1], shape[0]))
    return rows[order], cols[order], vals[order]


def nonzero_count(mask: torch.Tensor, count: int) -> torch.Tensor:
    """Positions of the ``count`` true entries of a 1-D mask, ascending;
    ``count`` is known on the host, so no sync for the output size."""
    return torch.nonzero_static(mask, size=count).squeeze(1)


def first_of_runs(keys: torch.Tensor) -> torch.Tensor:
    """Mask of the first entry of each run of equal sorted keys."""
    is_new = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    torch.ne(keys[1:], keys[:-1], out=is_new[1:])
    return is_new


def run_starts(rows, cols):
    """(positions of the first entry of each run of equal (row, col) pairs
    in lex-sorted coordinates, the run count); one counted host fetch."""
    is_new = torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    is_new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    nruns = hostsync.fetch_int(is_new.sum())
    return nonzero_count(is_new, nruns), nruns


def dedup_sorted(rows, cols, vals, sum_duplicates=True):
    """Collapse duplicate (already lex-sorted) (row, col) pairs, summing
    their values in order (``sum_duplicates=False`` keeps the last value
    of each run, scipy's ``setdiag`` rule). Returns (unique_rows,
    unique_cols, unique_vals, nunique); one counted host fetch for the
    unique count.
    """
    nnz = rows.shape[0]
    if nnz == 0:
        return rows, cols, vals, 0
    first, nunique = run_starts(rows, cols)
    if nunique == nnz:
        return rows, cols, vals, nnz
    ends = torch.full((1,), nnz, dtype=first.dtype, device=first.device)
    if sum_duplicates:
        uvals = segment_sum(vals, torch.cat([first, ends]))
    else:
        uvals = vals[torch.cat([first[1:], ends]) - 1]
    return rows[first], cols[first], uvals, nunique


def segment_searchsorted(sorted_vals, starts, ends, queries):
    """Per-query lower bound of ``queries[i]`` in
    ``sorted_vals[starts[i]:ends[i]]``: the absolute insertion index
    (``ends[i]`` when every entry of the segment is smaller). A
    vectorized binary search with a fixed trip count, the bit length of
    the longest possible segment (``len(sorted_vals)``)."""
    nb = int(sorted_vals.shape[0])
    if nb == 0:
        return starts.clone()
    lo, hi = starts.clone(), ends.clone()
    for _ in range(nb.bit_length()):
        mid = lo + (hi - lo) // 2
        mv = sorted_vals[mid.clamp(0, nb - 1)]
        go_right = (mv < queries) & (mid < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | (mid >= hi), hi, mid)
    return lo
