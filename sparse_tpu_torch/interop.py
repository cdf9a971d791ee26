"""Carry matrices across from the JAX package (or scipy) as buffers.

``from_numpy_parts`` rebuilds a port array from the numpy buffers of
another implementation's matrix, unchanged: the index and value dtypes
stay as given, so two packages fed the same buffers compute on the same
data.
"""

from __future__ import annotations

from .coo import coo_array
from .csc import csc_array
from .csr import csr_array
from .dia import dia_array
from .utils import as_tensor


def from_numpy_parts(fmt: str, parts: dict, shape, device=None):
    """Port array of format ``fmt`` from numpy buffers.

    ``parts`` holds ``indptr``/``indices``/``data`` for 'csr' and 'csc',
    ``row``/``col``/``data`` for 'coo', and ``data``/``offsets`` for 'dia'
    (scipy layout).
    """
    shape = (int(shape[0]), int(shape[1]))
    t = {k: as_tensor(v, device) for k, v in parts.items() if k != "offsets"}
    if fmt == "csr":
        return csr_array.from_parts(t["data"], t["indices"], t["indptr"], shape)
    if fmt == "csc":
        return csc_array.from_parts(t["data"], t["indices"], t["indptr"], shape)
    if fmt == "coo":
        return coo_array((t["data"], (t["row"], t["col"])), shape=shape)
    if fmt == "dia":
        return dia_array((t["data"], parts["offsets"]), shape=shape)
    raise ValueError(f"unknown format {fmt!r}")
