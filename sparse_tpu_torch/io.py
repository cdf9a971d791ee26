"""MatrixMarket IO (``sparse_tpu/io.py``).

``mmread`` parses on the host, with the native tokenizer
(``native.parse_mtx_body`` / ``parse_mtx_dense``) where it builds and
numpy's ``loadtxt`` where it does not, and returns a ``coo_array`` on the
requested device. Symmetric, skew-symmetric and hermitian files expand
their mirrored entries; pattern files read as ones. ``mmwrite`` writes a
general coordinate file that both packages (and scipy) read."""

from __future__ import annotations

import numpy as np

from . import native
from .coo import coo_array
from .utils import host_array


def _parse_header(line: str):
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket" or parts[1] != "matrix":
        raise ValueError(f"invalid MatrixMarket header: {line!r}")
    fmt, field, symmetry = parts[2], parts[3], parts[4]
    if fmt not in ("coordinate", "array"):
        raise ValueError(f"unsupported MatrixMarket format {fmt}")
    if field not in ("real", "double", "integer", "complex", "pattern"):
        raise ValueError(f"unsupported MatrixMarket field {field}")
    if symmetry not in ("general", "symmetric", "skew-symmetric", "hermitian"):
        raise ValueError(f"unsupported MatrixMarket symmetry {symmetry}")
    return fmt, field, symmetry


def _parse_coordinate_body(f, nnz: int, field: str):
    if nnz and native.lib() is not None:
        parsed = native.parse_mtx_body(f.read().encode(), nnz,
                                       {"pattern": 0, "complex": 2}.get(field, 1))
        if parsed is None:
            raise ValueError(f"MatrixMarket body does not contain exactly {nnz} entries")
        rows, cols, re, im = parsed
        return rows, cols, re + 1j * im if field == "complex" else re
    body = np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))
    if body.shape[0] != nnz:
        raise ValueError(f"expected {nnz} entries, found {body.shape[0]}")
    rows = body[:, 0].astype(np.int64) - 1
    cols = body[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.ones((nnz,), dtype=np.float64)
    elif field == "complex":
        vals = body[:, 2] + 1j * body[:, 3]
    else:
        vals = body[:, 2]
    return rows, cols, vals


def _parse_array_body(f, m: int, n: int, field: str, symmetry: str):
    """Dense column-major ``array`` body -> (rows, cols, vals) of its nonzeros."""
    if symmetry == "general":
        count = m * n
    else:  # the lower triangle; strict for skew-symmetric files
        count = n * (n - 1) // 2 if symmetry == "skew-symmetric" else n * (n + 1) // 2
    if field != "complex" and count and native.lib() is not None:
        flat = native.parse_mtx_dense(f.read().encode(), count)
        if flat is None:
            raise ValueError(f"MatrixMarket array body does not contain exactly {count} entries")
    else:
        body = np.loadtxt(f, ndmin=2)
        flat = body[:, 0] + 1j * body[:, 1] if field == "complex" else body[:, 0]
    if symmetry == "general":
        dense = flat.reshape((n, m)).T
    else:
        # lower triangle, column-major (column j: rows j..m-1); the strict
        # lower triangle for skew-symmetric files
        lo = 1 if symmetry == "skew-symmetric" else 0
        dense = np.zeros((m, n), dtype=flat.dtype)
        c = np.repeat(np.arange(n), np.maximum(m - np.arange(n) - lo, 0))
        r = np.concatenate([np.arange(j + lo, m) for j in range(n)])
        dense[r, c] = flat
    rows, cols = np.nonzero(dense != 0)
    return rows, cols, dense[rows, cols]


def mmread(path, device=None) -> coo_array:
    """Read a MatrixMarket file into a COO array."""
    with open(path, "r") as f:
        fmt, field, symmetry = _parse_header(f.readline())
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        dims = line.split()
        m, n = int(dims[0]), int(dims[1])
        if fmt == "coordinate":
            rows, cols, vals = _parse_coordinate_body(f, int(dims[2]), field)
        else:
            rows, cols, vals = _parse_array_body(f, m, n, field, symmetry)
    if symmetry != "general":
        off = rows != cols
        r2, c2 = cols[off], rows[off]
        if symmetry == "skew-symmetric":
            v2 = -vals[off]
        elif symmetry == "hermitian":
            v2 = np.conjugate(vals[off])
        else:
            v2 = vals[off]
        rows = np.concatenate([rows, r2])
        cols = np.concatenate([cols, c2])
        vals = np.concatenate([vals, v2])
    return coo_array((vals, (rows, cols)), shape=(m, n), device=device)


def mmwrite(path, A, comment: str = "", precision: int = 16) -> None:
    """Write a sparse array (or a dense 2-D operand) as a general
    MatrixMarket coordinate file, real or complex, values at
    ``precision`` significant digits."""
    c = A.tocoo() if hasattr(A, "tocoo") else coo_array(A, device="cpu")
    rows, cols, vals = host_array(c.row) + 1, host_array(c.col) + 1, host_array(c.data)
    cplx = np.iscomplexobj(vals)
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {'complex' if cplx else 'real'} general\n")
        for ln in comment.splitlines():
            f.write(f"%{ln}\n")
        f.write(f"{c.shape[0]} {c.shape[1]} {c.nnz}\n")
        if cplx:
            for r, cc, v in zip(rows, cols, vals):
                f.write(f"{r} {cc} {v.real:.{precision}g} {v.imag:.{precision}g}\n")
        else:
            for r, cc, v in zip(rows, cols, vals):
                f.write(f"{r} {cc} {v:.{precision}g}\n")
