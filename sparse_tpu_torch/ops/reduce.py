"""Whole-array and axis reductions with scipy.sparse semantics
(``sparse_tpu/ops/reduce.py``).

Implicit zeros participate: ``A.max()`` of a matrix whose stored values
are all negative is 0 whenever a position is unstored, and ``argmax``
follows scipy's two-step rule (the stored extreme, NaN winning, then the
first zero position when implicit zeros exist and the extreme is not
strictly positive, or negative for ``argmin``). The reference runs them
as host numpy passes; here they are torch ops on the array's device:
per-line extremes by ``scatter_reduce`` (``amax``/``amin``, whose result
does not depend on the order), counts by integer ``index_add_``. A
whole-array ``argmax``/``argmin`` fetches its one integer answer.
"""

from __future__ import annotations

import torch

from .. import hostsync
from .coords import lexsort_rc

_BIG = torch.iinfo(torch.int64).max


def _parts(A):
    # duplicates must sum first (scipy canonicalizes before a reduction)
    coo = A._canonical_coo()
    return coo.row.to(torch.int64), coo.col.to(torch.int64), coo.data


def _isnan(vals):
    if vals.is_floating_point():
        return torch.isnan(vals)
    return torch.zeros(vals.shape, dtype=torch.bool, device=vals.device)


def _fill(dt, is_max):
    """The identity of max (the lowest value) or of min (the highest)."""
    if dt.is_floating_point:
        return -float("inf") if is_max else float("inf")
    info = torch.iinfo(dt)
    return info.min if is_max else info.max


def _count(ids, length, where=None):
    """Per-line counts of ``ids`` (only where ``where``), integer adds."""
    ones = torch.ones(ids.shape, dtype=torch.int64, device=ids.device)
    if where is not None:
        ones = where.to(torch.int64)
    return torch.zeros((length,), dtype=torch.int64, device=ids.device).index_add_(0, ids, ones)


def _line_reduce(ids, vals, length, fill, reduce):
    out = torch.full((length,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, ids, vals, reduce, include_self=True)


def min_or_max(A, is_max: bool, axis=None, nan: bool = False):
    """The max (``is_max``) or min over all entries (a 0-d tensor) or per
    line (axis 0: per column, 1: per row; a dense 1-D tensor, where scipy
    gives a sparse 1-row matrix). ``nan=True`` ignores stored NaNs in the
    reduction, but they still count as stored positions."""
    m, n = A.shape
    if m * n == 0:
        raise ValueError("zero-size array to reduction operation")
    rows, cols, vals = _parts(A)
    dt, dev = vals.dtype, vals.device
    isnan = _isnan(vals)
    op = torch.maximum if is_max else torch.minimum
    zero = torch.zeros((), dtype=dt, device=dev)
    if axis is None:
        has_implicit = vals.shape[0] < m * n
        if vals.shape[0] == 0:
            return zero
        red = torch.where(isnan, _fill(dt, is_max), vals) if nan else vals
        stored = red.amax() if is_max else red.amin()
        if nan and vals.is_floating_point():
            empty = torch.full((), 0.0 if has_implicit else float("nan"), dtype=dt, device=dev)
            stored = torch.where(isnan.all(), empty, stored)
        return op(stored, zero) if has_implicit else stored
    if axis not in (0, 1):
        raise ValueError(f"invalid axis {axis}")
    ids = rows if axis == 1 else cols
    length, other = (m, n) if axis == 1 else (n, m)
    # the reference reduces in f64 and casts back: exact for floats, and
    # for integers up to 2**53
    wdt = dt if dt.is_floating_point else torch.float64
    fill = _fill(wdt, is_max)
    counts = _count(ids, length)
    nans = _count(ids, length, isnan)
    seg = _line_reduce(ids, torch.where(isnan, fill, vals.to(wdt)), length, fill,
                       "amax" if is_max else "amin")
    nanv = torch.full((), float("nan"), dtype=wdt, device=dev)
    zw = torch.zeros((), dtype=wdt, device=dev)
    if not nan:
        seg = torch.where(nans > 0, nanv, seg)
    reduced = counts - nans if nan else counts
    has_implicit = counts < other
    out = torch.where(reduced > 0, seg, torch.where(has_implicit, zw, nanv))
    out = torch.where(has_implicit, op(out, zw), out)
    return out.to(dt)


def arg_min_or_max(A, is_max: bool, axis=None):
    """np.argmax/np.argmin analog, scipy's two-step rule per line:

    1. the extreme over STORED values (NaN wins both; the first of ties in
       row-major order);
    2. when the line has implicit zeros and that extreme is not strictly
       positive (argmax) or negative (argmin), NaN counting as "not", the
       answer is the first zero position: the earlier of the first stored
       zero (not for a NaN extreme) and the first unstored slot.

    Lines with no stored entries resolve to 0. Whole-array: a Python int;
    per line: an int64 tensor on the array's device."""
    m, n = A.shape
    if m * n == 0:
        raise ValueError("cannot compute argmax/argmin of an empty matrix")
    rows, cols, vals = _parts(A)
    isnan = _isnan(vals)
    dt, dev = vals.dtype, vals.device
    fill = _fill(dt, is_max)
    reduce = "amax" if is_max else "amin"
    if axis is None:
        if vals.shape[0] == 0:
            return 0
        flats = rows * n + cols
        big = torch.full((), _BIG, dtype=torch.int64, device=dev)
        red = torch.where(isnan, fill, vals)
        ext = red.amax() if is_max else red.amin()
        any_nan = isnan.any()
        pos = torch.where(any_nan, torch.where(isnan, flats, big).min(),
                          torch.where((vals == ext) & ~isnan, flats, big).min())
        if vals.shape[0] < m * n:
            positive = (ext > 0 if is_max else ext < 0) & ~any_nan
            gap = _first_missing_flat(flats)
            stored_zero = torch.where(vals == 0, flats, big).min()
            cand = torch.where(any_nan, gap, torch.minimum(gap, stored_zero))
            pos = torch.where(positive, pos, cand)
        return hostsync.fetch_int(pos)
    if axis not in (0, 1):
        raise ValueError(f"invalid axis {axis}")
    if axis == 0:  # reduce over rows: the columns are the lines
        rows, cols = cols, rows
        length, other = n, m
    else:
        length, other = m, n
    counts = _count(rows, length)
    nan_col = _line_reduce(rows, torch.where(isnan, cols, _BIG), length, _BIG, "amin")
    has_nan = nan_col < _BIG
    ext = _line_reduce(rows, torch.where(isnan, fill, vals), length, fill, reduce)
    at_ext = (vals == ext[rows]) & ~isnan
    ext_col = _line_reduce(rows, torch.where(at_ext, cols, _BIG), length, _BIG, "amin")
    stored = counts > 0
    out = torch.where(stored, torch.where(has_nan, nan_col, ext_col), 0)
    positive = (ext > 0 if is_max else ext < 0) & ~has_nan & stored
    need_zero = (counts < other) & ~positive
    gap = _first_missing_per_line(rows, cols, length, other)
    zero_col = _line_reduce(rows, torch.where(vals == 0, cols, _BIG), length, _BIG, "amin")
    cand = torch.where(has_nan & stored, gap, torch.minimum(gap, zero_col))
    return torch.where(need_zero, cand, out)


def _first_missing_flat(flats):
    """Smallest flat index absent from the duplicate-free ``flats`` (the
    caller knows one exists)."""
    s = torch.sort(flats).values
    k = torch.arange(s.shape[0], dtype=torch.int64, device=s.device)
    return torch.where(s != k, k, s.shape[0]).min()


def _first_missing_per_line(lines, others, length: int, other: int):
    """For each line in [0, length): the smallest column not stored there
    (a line storing the full prefix 0..k-1 gets k, ``other`` when full)."""
    dev = lines.device
    if lines.shape[0] == 0:
        return torch.zeros((length,), dtype=torch.int64, device=dev)
    order = lexsort_rc(lines, others, (length, other))
    r_s, c_s = lines[order], others[order]
    starts = torch.searchsorted(r_s, torch.arange(length, dtype=torch.int64, device=dev))
    pos = torch.arange(r_s.shape[0], dtype=torch.int64, device=dev) - starts[r_s]
    first_bad = _line_reduce(r_s, torch.where(c_s != pos, pos, _BIG), length, _BIG, "amin")
    return torch.minimum(torch.minimum(first_bad, _count(r_s, length)),
                         torch.tensor(other, device=dev))
