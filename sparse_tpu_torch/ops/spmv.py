"""CSR SpMV and SpMM in plain torch (``sparse_tpu/ops/spmv.py``; CSC
products run on a CSR form, ``csc.py``).

Segment path: per-nnz products summed row by row in a fixed order
(``coords.segment_sum``); ELL path: one gather per padded-row plane plus
adds. Neither is a TPU kernel in the reference (both are XLA gathers
there), so both stay plain torch.

SELL slab path (``csr_spmv_sell`` and its batched and SpMM forms): one
gather per plane of each plane-major ``[K, R]`` slab of the reference's
pack, summed over k in plane order: the path CPU tensors take.

SELL chunk path (``csr_spmv_chunks`` and its batched and SpMM forms): the
plain versions of the chunk kernels (``kernels/sell_spmv.py``,
``csrc/sell_spmv.cu``) over the card's chunk layout. They loop over at
most ``seg`` slot steps, vectorised over every work item, then fold each
split chunk's segment partials in segment order: the kernels' sums in the
kernels' order, so equal to them bit for bit.
"""

from __future__ import annotations

import torch

from .coords import segment_sum


def _result_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return torch.promote_types(a.dtype, b.dtype)


def csr_spmv_segment(indptr, indices, data, x, m: int):
    """y = A @ x via gather + segment sum. General path, any row profile."""
    nnz = data.shape[0]
    out_dt = _result_dtype(data, x)
    if nnz == 0:
        return torch.zeros((m,), dtype=out_dt, device=x.device)
    return segment_sum(data.to(out_dt) * x[indices].to(out_dt), indptr)


def csr_spmv_ell(ell_indices, ell_data, x):
    """y = A @ x on the padded-row (ELL) layout: k 1-D gathers + adds."""
    k = ell_data.shape[1]
    acc = ell_data[:, 0] * x[ell_indices[:, 0]]
    for kk in range(1, k):
        acc = acc + ell_data[:, kk] * x[ell_indices[:, kk]]
    return acc


def _sell_slab_spmv(idx_t, val_t, x):
    """y_slab = A_slab @ x on one SELL slab of plane-major ``[K, R]``
    index/value planes: ``acc = 0; acc += val[k] * x[idx[k]]`` for k in
    plane order."""
    out_dt = _result_dtype(val_t, x)
    acc = torch.zeros((idx_t.shape[1],), dtype=out_dt, device=x.device)
    for kk in range(idx_t.shape[0]):
        acc = acc + val_t[kk].to(out_dt) * x[idx_t[kk]].to(out_dt)
    return acc


def _sell_out_dtype(slabs, x):
    return torch.promote_types(slabs[0][1].dtype if slabs else x.dtype, x.dtype)


def csr_spmv_sell(slabs, pos, x, zero_rows: int):
    """y = A @ x on the SELL-C-sigma layout: per-slab plane gathers, the
    slabs and the ``zero_rows`` all-empty rows concatenated in packed
    order, then gathered back to row order by ``pos``."""
    out_dt = _sell_out_dtype(slabs, x)
    parts = [_sell_slab_spmv(it, vt, x) for it, vt in slabs]
    if zero_rows:
        parts.append(torch.zeros((zero_rows,), dtype=out_dt, device=x.device))
    if not parts:  # empty matrix: pos is empty too
        return torch.zeros(pos.shape, dtype=out_dt, device=x.device)
    return torch.cat(parts)[pos]


def csr_spmm_sell(slabs, pos, B, zero_rows: int):
    """C = A @ B (dense ``[n, nB]``) on the SELL layout: per-slab row
    gathers of B accumulated in plane order, then the ``pos`` gather."""
    out_dt = _sell_out_dtype(slabs, B)
    nB = B.shape[1]
    parts = []
    for it, vt in slabs:
        acc = torch.zeros((it.shape[1], nB), dtype=out_dt, device=B.device)
        for kk in range(it.shape[0]):
            acc = acc + vt[kk].to(out_dt)[:, None] * B[it[kk]].to(out_dt)
        parts.append(acc)
    if zero_rows:
        parts.append(torch.zeros((zero_rows, nB), dtype=out_dt, device=B.device))
    if not parts:
        return torch.zeros((pos.shape[0], nB), dtype=out_dt, device=B.device)
    return torch.cat(parts)[pos]


def _sell_slab_spmv_batched(idx_t, val_bt, X):
    """Y_slab[b] = A_b,slab @ X[b]: shared ``[K, R]`` index planes, value
    planes ``[B, K, R]``, X ``[B, n]``; summed over k in plane order."""
    out_dt = _result_dtype(val_bt, X)
    acc = torch.zeros((X.shape[0], idx_t.shape[1]), dtype=out_dt, device=X.device)
    for kk in range(idx_t.shape[0]):
        acc = acc + val_bt[:, kk].to(out_dt) * X[:, idx_t[kk]].to(out_dt)
    return acc


def csr_spmv_sell_batched(idx_slabs, val_slabs, pos, X, zero_rows: int):
    """Y[b] = A_b @ X[b] on the SELL layout with one shared pattern:
    ``idx_slabs``/``pos``/``zero_rows`` are pattern state, ``val_slabs``
    the stacked ``[B, K, R]`` value planes, X ``[B, n]``."""
    out_dt = torch.promote_types(val_slabs[0].dtype if val_slabs else X.dtype, X.dtype)
    Bn = X.shape[0]
    parts = [_sell_slab_spmv_batched(it, vt, X) for it, vt in zip(idx_slabs, val_slabs)]
    if zero_rows:
        parts.append(torch.zeros((Bn, zero_rows), dtype=out_dt, device=X.device))
    if not parts:
        return torch.zeros((Bn, pos.shape[0]), dtype=out_dt, device=X.device)
    return torch.cat(parts, dim=1)[:, pos]


def csr_spmm_sell_batched(idx_slabs, val_slabs, pos, X, zero_rows: int):
    """C[b] = A_b @ X[b] (dense ``[B, n, k]``) on the shared-pattern SELL
    layout, lane by lane."""
    return torch.stack([
        csr_spmm_sell(tuple((it, vt[b]) for it, vt in zip(idx_slabs, val_slabs)),
                      pos, X[b], zero_rows)
        for b in range(X.shape[0])
    ])


def _chunk_products(ch, vals, Xt):
    """``Y[row, b] = sum_k vals[slot, b] * Xt[idx[slot], b]`` over the chunk
    layout ``ch`` (``kernels.sell_spmv.SellChunks``), in row order: value
    slots ``[slots, B]`` (or ``[slots, 1]``, broadcast), ``Xt`` ``[n, B]``,
    Y ``[m, B]``. Each work item sums its segment's slots from 0 in slot
    order; a split chunk's partials are then summed in segment order."""
    R = ch.rows
    out_dt = torch.promote_types(vals.dtype, Xt.dtype)
    dev = Xt.device
    nb = Xt.shape[1]
    wk = ch.work.to(torch.int64)
    chunk, segment, nseg = wk[:, 0], wk[:, 1], wk[:, 2]
    base = ch.cptr[chunk]
    k0 = segment * ch.seg
    steps = ((ch.cptr[chunk + 1] - base) // R - k0).clamp(min=0, max=ch.seg)
    lane = torch.arange(R, device=dev)
    acc = torch.zeros((wk.shape[0], R, nb), dtype=out_dt, device=dev)
    for t in range(int(steps.max()) if wk.shape[0] else 0):
        act = (t < steps)[:, None]
        p = torch.where(act, (base + (k0 + t) * R)[:, None] + lane, 0)
        term = vals[p].to(out_dt) * Xt[ch.idx[p]].to(out_dt)
        acc = torch.where(act[..., None], acc + term, acc)
    first = (segment == 0).nonzero()[:, 0]  # one work item a chunk, chunk order
    ych = acc[first]
    split = (nseg[first] > 1).nonzero()[:, 0]
    if split.numel():
        fs, ns, ys = first[split], nseg[first[split]], ych[split]
        for j in range(1, int(ns.max())):
            more = (j < ns)[:, None, None]
            ys = torch.where(more, ys + acc[(fs + j).clamp(max=wk.shape[0] - 1)], ys)
        ych[split] = ys
    Y = torch.empty((ch.m, nb), dtype=out_dt, device=dev)
    Y[ch.perm.to(torch.int64)] = ych.reshape(-1, nb)[: ch.m]
    return Y


def csr_spmv_chunks(ch, val, x):
    """y = A @ x over the chunk layout, value slots ``val`` ``[slots]``:
    the single-matrix chunk kernel's plain version."""
    return _chunk_products(ch, val[:, None], x[:, None])[:, 0]


def csr_spmv_chunks_batched(ch, vals, X):
    """Y[b] = A_b @ X[b] over one chunk layout, value slots ``[slots, B]``,
    X ``[B, n]``, Y ``[B, m]``: the batched chunk kernel's plain version.
    Lane b equals ``csr_spmv_chunks(ch, vals[:, b], X[b])`` bit for bit."""
    return _chunk_products(ch, vals, X.t()).t().contiguous()


def csr_spmm_chunks(ch, val, B):
    """C = A @ B (dense ``[n, k]``) over the chunk layout: the same sums
    for every column of B."""
    return _chunk_products(ch, val[:, None], B)


def csr_spmv_segment_batched(indptr, indices, values, X, m: int):
    """Y[b] = A_b @ X[b] via the segment path, values ``[B, nnz]`` over one
    shared pattern: the batched path that needs no pack."""
    nnz = values.shape[1]
    out_dt = _result_dtype(values, X)
    if nnz == 0:
        return torch.zeros((X.shape[0], m), dtype=out_dt, device=X.device)
    return segment_sum(values.to(out_dt) * X[:, indices].to(out_dt), indptr, axis=1)


def csr_spmm_segment(indptr, indices, data, B, m: int):
    """C = A @ B with B dense [k, n]."""
    nnz = data.shape[0]
    out_dt = _result_dtype(data, B)
    if nnz == 0:
        return torch.zeros((m, B.shape[1]), dtype=out_dt, device=B.device)
    return segment_sum(data.to(out_dt)[:, None] * B[indices].to(out_dt), indptr)


def csr_spmm_ell(ell_indices, ell_data, B):
    """C = A @ B on the ELL layout: k row-gathers of B + accumulate."""
    k = ell_data.shape[1]
    acc = ell_data[:, 0, None] * B[ell_indices[:, 0]]
    for kk in range(1, k):
        acc = acc + ell_data[:, kk, None] * B[ell_indices[:, kk]]
    return acc

