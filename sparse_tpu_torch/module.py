"""Top-level constructors and helpers (``sparse_tpu/module.py``):
diags / spdiags / eye / identity, kron / kronsum, random, block assembly
(bmat and the stacks), tril / triu / find, the .npz format shared with
the reference and scipy, and the predicates.

Assembly runs on the device of the operands (``settings.device`` for
host ones): COO coordinates are built with torch ops and converted by
the device sort. ``random`` draws with numpy's ``default_rng`` as the
reference does, so one seed gives both packages the same matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from . import hostsync
from .base import SparseArray
from .coo import coo_array
from .csc import csc_array
from .csr import csr_array
from .dia import dia_array
from .utils import as_tensor, host_array

_INT32_MAX = 2**31 - 1


def _torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


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
        return _as_format(csr_array((m, n), dtype=_torch_dtype(dtype), device=device), format)
    d = np.ones((length,), dtype=_np_dtype(dtype))
    return diags([d], [k], shape=(m, n), format=format, dtype=dtype, device=device)


def identity(n, dtype=np.float64, format=None, device=None):
    return eye(n, dtype=dtype, format=format or "csr", device=device)


def _coo(A, device=None):
    """A COO view of a sparse array, or a COO of a dense / scipy operand."""
    return A.tocoo() if isinstance(A, SparseArray) else coo_array(A, device=device)


def kron(A, B, format=None):
    """Kronecker product: the nnz(A) x nnz(B) triples of the outer product
    in one broadcast; a COO unless ``format`` asks otherwise."""
    A = _coo(A)
    B = _coo(B, device=A.device)
    ma, na = A.shape
    mb, nb = B.shape
    out_shape = (ma * mb, na * nb)
    if A.nnz == 0 or B.nnz == 0:
        dt = torch.promote_types(A.dtype, B.dtype)
        return _as_format(csr_array(out_shape, dtype=dt, device=A.device), format)
    # int64 only where an output dimension itself needs it: the sorts work
    # on (row, col) pairs, whatever m * n is
    rdt = torch.int64 if ma * mb > _INT32_MAX else torch.int32
    cdt = torch.int64 if na * nb > _INT32_MAX else torch.int32
    rows = (A.row.to(rdt)[:, None] * mb + B.row.to(rdt)[None, :]).reshape(-1)
    cols = (A.col.to(cdt)[:, None] * nb + B.col.to(cdt)[None, :]).reshape(-1)
    vals = (A.data[:, None] * B.data[None, :]).reshape(-1)
    out = coo_array((vals, (rows, cols)), shape=out_shape)
    return out if format in (None, "coo") else out.asformat(format)


def kronsum(A, B, format=None):
    """kron(I_n, A) + kron(B, I_m) for square A [m, m] and B [n, n]."""
    m, m2 = A.shape
    n, n2 = B.shape
    if m != m2 or n != n2:
        raise ValueError("kronsum needs square operands")
    out = (kron(identity(n, dtype=A.dtype, device=A.device), A)
           + kron(B, identity(m, dtype=B.dtype, device=B.device)))
    return _as_format(out.tocoo(), format) if format else out


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` for a 1-D integer array, by one sort and a run
    mask. numpy 2.3's ``np.unique`` first collects the distinct values in
    a hash table: for the 2·10^7 positions of ``random(2**20, 2**20,
    16 / 2**20)`` that took 31-41 s on the host of an H100 machine, where
    this sort and mask took 0.4 s."""
    a = np.sort(a)
    keep = np.empty(a.shape, dtype=bool)
    keep[:1] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


def random(m, n, density=0.01, format="coo", dtype=None, random_state=None, data_rvs=None,
           device=None):
    """Sparse random matrix: positions and values from numpy's generator,
    drawn exactly as the reference draws them."""
    m, n = int(m), int(n)
    if density < 0 or density > 1:
        raise ValueError("density expected in [0, 1]")
    mn = m * n
    k = int(round(density * mn))
    if random_state is None:
        rng = np.random.default_rng()
    elif isinstance(random_state, (int, np.integer)):
        rng = np.random.default_rng(int(random_state))
    else:
        rng = random_state
    if mn > 0 and k > 0:
        if mn < (1 << 26):
            flat = rng.choice(mn, size=k, replace=False)
        else:  # sample and deduplicate in a huge index space
            uniq = _sorted_unique(rng.integers(0, mn, size=int(k * 1.2) + 16))
            while uniq.shape[0] < k:  # top up until k distinct positions
                more = rng.integers(0, mn, size=int(k * 0.4) + 16)
                uniq = _sorted_unique(np.concatenate([uniq, more]))
            # a uniform subsample: truncating the sorted positions would
            # favour low rows
            flat = rng.choice(uniq, size=k, replace=False)
    else:
        flat = np.zeros((0,), dtype=np.int64)
        k = 0
    rows = (flat // n).astype(np.int64)
    cols = (flat % n).astype(np.int64)
    vals = np.asarray(data_rvs(k)) if data_rvs is not None else rng.random(k)
    if dtype is not None:
        vals = vals.astype(_np_dtype(dtype))
    return _as_format(coo_array((vals, (rows, cols)), shape=(m, n), device=device), format)


def rand(m, n, density=0.01, format="coo", dtype=None, random_state=None, device=None):
    return random(m, n, density, format, dtype, random_state, device=device)


def random_array(shape, *, density=0.01, format="coo", dtype=None, random_state=None, rng=None,
                 data_sampler=None, device=None):
    """scipy's ``random_array`` surface (shape tuple, keyword-only)."""
    m, n = shape
    state = rng if rng is not None else random_state
    # scipy calls data_sampler with the size keyword; random() passes a count
    rvs = None if data_sampler is None else (lambda k: data_sampler(size=k))
    return random(m, n, density, format, dtype, state, data_rvs=rvs, device=device)


def issparse(o) -> bool:
    return isinstance(o, SparseArray)


is_sparse_matrix = isspmatrix = issparse


def isspmatrix_csr(o) -> bool:
    return isinstance(o, csr_array)


def isspmatrix_csc(o) -> bool:
    return isinstance(o, csc_array)


def isspmatrix_coo(o) -> bool:
    return isinstance(o, coo_array)


def isspmatrix_dia(o) -> bool:
    return isinstance(o, dia_array)


def isspmatrix_bsr(o) -> bool:
    from .bsr import bsr_array

    return isinstance(o, bsr_array)


def isspmatrix_dok(o) -> bool:
    from .dok import dok_array

    return isinstance(o, dok_array)


def isspmatrix_lil(o) -> bool:
    from .lil import lil_array

    return isinstance(o, lil_array)


class SparseWarning(Warning):
    pass


class SparseEfficiencyWarning(SparseWarning):
    pass


def find(A):
    """(rows, cols, values) of the nonzero entries, row-major (duplicates
    summed first, so cancelling ones do not appear)."""
    c = _coo(A).tocsr().tocoo()
    keep = c.data != 0
    return c.row[keep], c.col[keep], c.data[keep]


def _triangle(A, k, format, lower):
    c = _coo(A)
    d = c.col.to(torch.int64) - c.row.to(torch.int64)
    keep = d <= k if lower else d >= k
    out = coo_array((c.data[keep], (c.row[keep], c.col[keep])), shape=c.shape)
    return _as_format(out, format)


def tril(A, k=0, format=None):
    """Lower triangle (entries with col - row <= k)."""
    return _triangle(A, k, format, lower=True)


def triu(A, k=0, format=None):
    """Upper triangle (entries with col - row >= k)."""
    return _triangle(A, k, format, lower=False)


def bmat(blocks, format=None, dtype=None):
    """Assemble a sparse matrix from a 2-D grid of blocks (None = zero)."""
    blocks = [list(row) for row in blocks]
    R = len(blocks)
    C = len(blocks[0]) if R else 0
    row_h, col_w = [None] * R, [None] * C
    for i in range(R):
        if len(blocks[i]) != C:
            raise ValueError("blocks must be a rectangular 2-D grid")
        for j in range(C):
            b = blocks[i][j]
            if b is None:
                continue
            m, n = b.shape
            if row_h[i] is None:
                row_h[i] = m
            elif row_h[i] != m:
                raise ValueError(f"block row {i} has incompatible heights")
            if col_w[j] is None:
                col_w[j] = n
            elif col_w[j] != n:
                raise ValueError(f"block column {j} has incompatible widths")
    if any(h is None for h in row_h) or any(w is None for w in col_w):
        raise ValueError("every block row/column needs at least one block")
    r_off = np.concatenate([[0], np.cumsum(row_h)])
    c_off = np.concatenate([[0], np.cumsum(col_w)])
    dev = next((b.device for row in blocks for b in row if isinstance(b, SparseArray)), None)
    rows, cols, vals = [], [], []
    for i in range(R):
        for j in range(C):
            if blocks[i][j] is None:
                continue
            c = _coo(blocks[i][j], device=dev)
            dev = c.device
            rows.append(c.row.to(torch.int64) + int(r_off[i]))
            cols.append(c.col.to(torch.int64) + int(c_off[j]))
            vals.append(c.data)
    out = coo_array((torch.cat(vals), (torch.cat(rows), torch.cat(cols))),
                    shape=(int(r_off[-1]), int(c_off[-1])),
                    dtype=None if dtype is None else _torch_dtype(dtype))
    return _as_format(out, format)


block_array = bmat


def vstack(blocks, format=None, dtype=None):
    return bmat([[b] for b in blocks], format=format, dtype=dtype)


def hstack(blocks, format=None, dtype=None):
    return bmat([list(blocks)], format=format, dtype=dtype)


def block_diag(mats, format=None, dtype=None):
    return bmat([[m if i == j else None for j in range(len(mats))] for i, m in enumerate(mats)],
                format=format, dtype=dtype)


def save_npz(file, matrix, compressed=True):
    """scipy's .npz layout (csr, csc, coo; other formats as coo), so a file
    written here loads in scipy and in the reference, and theirs here."""
    fmt = matrix.format
    if fmt not in ("csr", "csc", "coo"):
        return save_npz(file, matrix.tocoo(), compressed)
    fields = {"shape": np.asarray(matrix.shape), "format": fmt.encode("ascii"),
              "data": host_array(matrix.data)}
    if fmt == "coo":
        fields.update(row=host_array(matrix.row), col=host_array(matrix.col))
    else:
        fields.update(indices=host_array(matrix.indices), indptr=host_array(matrix.indptr))
    (np.savez_compressed if compressed else np.savez)(file, **fields)


def load_npz(file, device=None):
    """Read scipy's .npz layout onto ``device``."""
    with np.load(file) as f:
        fmt = f["format"].item()
        if isinstance(fmt, bytes):
            fmt = fmt.decode("ascii")
        shape = tuple(int(v) for v in f["shape"])
        parts = {k: as_tensor(f[k], device) for k in f.files if k not in ("format", "shape")}
    if fmt in ("csr", "csc"):
        cls = csr_array if fmt == "csr" else csc_array
        return cls.from_parts(parts["data"], parts["indices"], parts["indptr"], shape)
    if fmt == "coo":
        return coo_array((parts["data"], (parts["row"], parts["col"])), shape=shape)
    raise ValueError(f"unsupported sparse npz format {fmt!r}")


def get_index_dtype(arrays=(), maxval=None, check_contents=False):
    """scipy's rule: int32 only when safe. An array whose dtype cannot cast
    to int32 forces int64 unless ``check_contents`` finds its values fit."""
    i32 = np.iinfo(np.int32)
    if maxval is not None and maxval > i32.max:
        return np.int64
    for a in arrays:
        a = host_array(a)
        if np.can_cast(a.dtype, np.int32):
            continue
        if check_contents and np.issubdtype(a.dtype, np.integer):
            if a.size == 0 or (int(a.min()) >= i32.min and int(a.max()) <= i32.max):
                continue
        return np.int64
    return np.int32


# array-API-era aliases
eye_array = eye
diags_array = diags


def _check_axis(a) -> int:
    if a not in (-2, -1, 0, 1):
        raise ValueError(f"axis {a} out of bounds for a 2-D sparse array")
    return a % 2


def swapaxes(A, axis1, axis2):
    """2-D swapaxes: a copy for (0, 0) / (1, 1), the transpose for (0, 1)."""
    if len({_check_axis(axis1), _check_axis(axis2)}) == 1:
        return A.copy()
    return A.T


def permute_dims(A, axes=None):
    """2-D permute_dims: (0, 1) a copy, (1, 0) the transpose."""
    axes = (1, 0) if axes is None else tuple(_check_axis(a) for a in axes)
    if axes == (0, 1):
        return A.copy()
    if axes == (1, 0):
        return A.T
    raise ValueError(f"invalid axes permutation {axes}")


def expand_dims(A, axis):
    """Sparse arrays here are 2-D only, as in the reference: raises."""
    raise NotImplementedError(
        "expand_dims needs n-D sparse arrays; sparse_tpu_torch (like the reference) is 2-D only")


def safely_cast_index_arrays(A, idx_dtype=np.int32, msg=""):
    """A's index arrays cast to ``idx_dtype`` (numpy or torch), raising
    when a value does not fit: (indices, indptr) for CSR/CSC, the offsets
    for DIA (a numpy array), (row, col) for COO."""
    if hasattr(A, "offsets"):  # DIA keeps its offsets on the host
        info = np.iinfo(idx_dtype)
        if A.offsets.size and (A.offsets.max() > info.max or A.offsets.min() < info.min):
            raise ValueError(f"index values too large for {idx_dtype} {msg}")
        return A.offsets.astype(idx_dtype)
    tdt = _torch_dtype(idx_dtype)
    info = torch.iinfo(tdt)
    arrs = (A.indices, A.indptr) if hasattr(A, "indptr") else (A.row, A.col)
    for a in arrs:
        if a.numel() and hostsync.fetch_int((a.max() > info.max) | (a.min() < info.min)):
            raise ValueError(f"index values too large for {idx_dtype} {msg}")
    return tuple(a.to(tdt) for a in arrs)
