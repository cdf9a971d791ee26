"""Carry matrices across from the JAX package (or scipy) as buffers.

``from_numpy_parts`` rebuilds a port array from the numpy buffers of
another implementation's matrix, unchanged: the index and value dtypes
stay as given, so two packages fed the same buffers compute on the same
data. ``prepared_csr_from_numpy`` does the same for a SELL pack and
``batched_csr_from_numpy`` for a pattern-shared value stack.
"""

from __future__ import annotations

from .bsr import bsr_array
from .coo import coo_array
from .csc import csc_array
from .csr import csr_array
from .dia import dia_array
from .utils import as_tensor, resolve_device


def from_numpy_parts(fmt: str, parts: dict, shape, device=None):
    """Port array of format ``fmt`` from numpy buffers.

    ``parts`` holds ``indptr``/``indices``/``data`` for 'csr' and 'csc',
    ``row``/``col``/``data`` for 'coo', ``data``/``offsets`` for 'dia'
    (scipy layout), and ``data`` [nnzb, R, C]/``indices``/``indptr`` for
    'bsr' (``blocksize`` optional, checked against the blocks).
    """
    shape = (int(shape[0]), int(shape[1]))
    t = {k: as_tensor(v, device) for k, v in parts.items() if k not in ("offsets", "blocksize")}
    if fmt == "csr":
        return csr_array.from_parts(t["data"], t["indices"], t["indptr"], shape)
    if fmt == "csc":
        return csc_array.from_parts(t["data"], t["indices"], t["indptr"], shape)
    if fmt == "coo":
        return coo_array((t["data"], (t["row"], t["col"])), shape=shape)
    if fmt == "dia":
        return dia_array((t["data"], parts["offsets"]), shape=shape)
    if fmt == "bsr":
        return bsr_array((t["data"], t["indices"], t["indptr"]), shape=shape,
                         blocksize=parts.get("blocksize"))
    raise ValueError(f"unknown format {fmt!r}")


def prepared_csr_from_numpy(slab_meta, geometry, slabs, pos, device=None):
    """A :class:`~sparse_tpu_torch.kernels.sell_spmv.PreparedCSR` from an
    existing SELL pack: ``slab_meta`` as in ``SellPlan``, ``geometry`` =
    ``(m, n, C, sigma, zero_rows, nnz)``, ``slabs`` a sequence of
    ``(idx_t, val_t)`` numpy pairs and ``pos`` the row map, all unchanged.
    On a CUDA device the operator builds the card's chunk layout from them
    (``PreparedCSR.from_parts``); the product is the same."""
    from .kernels.sell_spmv import PreparedCSR, SellPlan

    dev = resolve_device(device)
    m, n, C, sigma, zero_rows, nnz = geometry
    plan = SellPlan(m, n, C, sigma, slab_meta, zero_rows, nnz)
    return PreparedCSR.from_parts(
        plan, tuple((as_tensor(it, dev), as_tensor(vt, dev)) for it, vt in slabs),
        as_tensor(pos, dev),
    )


def batched_csr_from_numpy(indptr, indices, shape, values, device=None):
    """A :class:`~sparse_tpu_torch.batch.BatchedCSR` over the host pattern
    ``(indptr, indices, shape)`` with the ``[B, nnz]`` value stack unchanged."""
    from .batch.operator import BatchedCSR, SparsityPattern

    return BatchedCSR(SparsityPattern(indptr, indices, shape),
                      as_tensor(values, resolve_device(device)))
