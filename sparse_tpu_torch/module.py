"""Top-level constructors: diags / spdiags / eye / identity
(``sparse_tpu/module.py:25-93``)."""

from __future__ import annotations

import numpy as np
import torch

from .csr import csr_array
from .dia import dia_array
from .utils import as_tensor


def _np_dtype(dtype):
    """numpy dtype for a numpy or torch dtype (None stays None)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((0,), dtype=dtype).numpy().dtype
    return None if dtype is None else np.dtype(dtype)


def _as_format(A, format):
    return A if format is None else A.asformat(format)


def diags(diagonals, offsets=0, shape=None, format=None, dtype=None, device=None):
    """scipy.sparse.diags-compatible constructor."""
    if np.isscalar(offsets):
        offsets = [offsets]
        if np.isscalar(diagonals) or (
            hasattr(diagonals, "ndim") and getattr(diagonals, "ndim", 1) == 1
        ) or (
            isinstance(diagonals, (list, tuple)) and diagonals and np.isscalar(diagonals[0])
        ):
            diagonals = [np.asarray(diagonals)]
    diagonals = [np.atleast_1d(np.asarray(d)) for d in diagonals]
    offsets = np.atleast_1d(np.asarray(offsets, dtype=np.int64))
    if len(diagonals) != len(offsets):
        raise ValueError("number of diagonals does not match number of offsets")
    if shape is None:
        m = max(len(d) + abs(int(o)) for d, o in zip(diagonals, offsets))
        shape = (m, m)
    m, n = int(shape[0]), int(shape[1])
    dtype = _np_dtype(dtype)
    if dtype is None:
        dtype = np.result_type(*[d.dtype for d in diagonals])
    data = np.zeros((len(offsets), n), dtype=dtype)
    for k, (d, off) in enumerate(zip(diagonals, offsets)):
        off = int(off)
        length = min(m + min(off, 0), n - max(off, 0))
        if length < 0:
            raise ValueError(f"offset {off} out of bounds for shape {shape}")
        lo = max(off, 0)
        if d.size == 1 and length > 1:
            d = np.full((length,), d[0])
        if d.size < length:
            raise ValueError(f"diagonal {k} has wrong length {d.size}, needs {length}")
        data[k, lo : lo + length] = d[:length]
    A = dia_array((as_tensor(data, device), offsets), shape=(m, n))
    return _as_format(A, format)


def spdiags(data, diags_offsets, m=None, n=None, format=None, device=None):
    """scipy.sparse.spdiags-compatible constructor."""
    if m is None and n is None:
        raise ValueError("spdiags requires m, n")
    if n is None:
        m, n = m
    A = dia_array(
        (as_tensor(np.atleast_2d(np.asarray(data)), device),
         np.atleast_1d(np.asarray(diags_offsets, dtype=np.int64))),
        shape=(int(m), int(n)),
    )
    return _as_format(A, format)


def eye(m, n=None, k=0, dtype=np.float64, format="csr", device=None):
    """Identity-like matrix with ones on diagonal ``k``."""
    n = m if n is None else n
    m, n = int(m), int(n)
    length = min(m + min(k, 0), n - max(k, 0))
    if length <= 0:
        tdt = torch.from_numpy(np.zeros(0, dtype=_np_dtype(dtype))).dtype
        return _as_format(csr_array((m, n), dtype=tdt, device=device), format)
    d = np.ones((length,), dtype=_np_dtype(dtype))
    return diags([d], [k], shape=(m, n), format=format, dtype=dtype, device=device)


def identity(n, dtype=np.float64, format=None, device=None):
    return eye(n, dtype=dtype, format=format or "csr", device=device)
