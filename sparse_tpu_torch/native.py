"""Loader of the port's host-side native library (``csrc/host_native.cc``).

It serves what runs on the host only: the Gustavson SpGEMM of CPU-tensor
f32/f64 products (``ops.spgemm``), the MatrixMarket tokenizers of
``io.mmread``, the independent-set expansion of ``quantum``'s build, and
the factorizations of ``_direct`` (ILU(0), IC(0), the Gilbert-Peierls
sparse LU and ILUT), which take numpy arrays that the
caller fetched on purpose (``_direct._coo_host``). The source compiles with
``g++ -O3 -march=native -shared -fPIC`` on first use into ``build/sparse_tpu_torch/``
at the repository root (beside the CUDA builds of ``kernels/_build.py``),
under a name that carries a digest of the source and flags, and is bound
with ``ctypes``. Without ``g++`` (or with a failed build) :func:`lib`
returns None and every caller takes its plain path, ESC or numpy. No CUDA
tensor ever reaches this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "host_native.cc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "sparse_tpu_torch"
# the reference library's flags: -march=native lets g++ contract a * b + c
# into one fused multiply-add, so the factorizations round as its do
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path | None:
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    out = _BUILD_DIR / f"host_native-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([gxx, *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: concurrent processes each write their own tmp
    return out


def lib():
    """The loaded library, or None when it cannot be built here."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            path = _build()
            if path is not None:
                _lib = _declare(ctypes.CDLL(str(path)))
            _tried = True
    return _lib


def _declare(cdll):
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    cdll.mtx_parse_body.restype = i64
    cdll.mtx_parse_body.argtypes = [ctypes.c_char_p, i64, i64, ctypes.c_int32, i64p, i64p,
                                    f64p, f64p]
    cdll.mtx_parse_dense.restype = i64
    cdll.mtx_parse_dense.argtypes = [ctypes.c_char_p, i64, i64, f64p]
    cdll.spgemm_count.restype = i64
    cdll.spgemm_count.argtypes = [i64, i64, i64p, i64p, i64p, i64p, i64p]
    cdll.spgemm_fill.restype = None
    cdll.spgemm_fill.argtypes = [i64, i64, i64p, i64p, f64p, i64p, i64p, f64p, i64p, i64p, f64p]
    for name in ("ilu0_csr", "ic0_csr"):
        getattr(cdll, name).restype = i64
        getattr(cdll, name).argtypes = [i64, i64p, i64p, f64p]
    cdll.splu_factor.restype = ctypes.c_void_p
    cdll.splu_factor.argtypes = [i64, i64p, i64p, f64p, i64p]
    cdll.ilut_factor.restype = ctypes.c_void_p
    cdll.ilut_factor.argtypes = [i64, i64p, i64p, f64p, ctypes.c_double, i64, i64p]
    for name in ("splu_lnnz", "splu_unnz"):
        getattr(cdll, name).restype = i64
        getattr(cdll, name).argtypes = [ctypes.c_void_p]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    cdll.ind_sets_count.restype = i64
    cdll.ind_sets_count.argtypes = [u64p, i64, i64]
    cdll.ind_sets_expand.restype = None
    cdll.ind_sets_expand.argtypes = [u64p, u64p, u64p, i64, i64, i64, u64p, u64p]
    cdll.splu_get.restype = None
    cdll.splu_get.argtypes = [ctypes.c_void_p, i64p, i64p, f64p, i64p, i64p, f64p, i64p]
    cdll.splu_free.restype = None
    cdll.splu_free.argtypes = [ctypes.c_void_p]
    return cdll


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def expand_level(sets, queues, comp_gt, n: int):
    """One level of quantum.py's independent-set BFS on [S, W] uint64
    bitsets -> (new_sets, new_queues); None without the library."""
    L = lib()
    if L is None:
        return None
    S, W = queues.shape
    sets, queues, comp_gt = (np.ascontiguousarray(a, dtype=np.uint64)
                             for a in (sets, queues, comp_gt))
    count = L.ind_sets_count(_u64p(queues), S, W)
    new_sets = np.empty((count, W), dtype=np.uint64)
    new_queues = np.empty((count, W), dtype=np.uint64)
    L.ind_sets_expand(_u64p(sets), _u64p(queues), _u64p(comp_gt), S, W, n, _u64p(new_sets),
                      _u64p(new_queues))
    return new_sets, new_queues


def parse_mtx_body(body: bytes, nnz: int, kind: int):
    """Coordinate-body parse (``kind`` 0 pattern, 1 real/integer, 2
    complex) -> (rows, cols, re, im) as numpy, 0-based; None when the
    library is unavailable or the body does not hold exactly ``nnz``
    entries (it parses with room for one more to tell)."""
    L = lib()
    if L is None:
        return None
    cap = nnz + 1
    rows = np.empty(cap, dtype=np.int64)
    cols = np.empty(cap, dtype=np.int64)
    re = np.empty(cap, dtype=np.float64)
    im = np.zeros(cap, dtype=np.float64)
    got = L.mtx_parse_body(body, len(body), cap, kind, _i64p(rows), _i64p(cols), _f64p(re),
                           _f64p(im))
    if got != nnz:
        return None
    return rows[:nnz], cols[:nnz], re[:nnz], im[:nnz]


def parse_mtx_dense(body: bytes, count: int):
    """The first ``count`` whitespace-separated doubles of an ``array``
    body -> numpy, or None (no library, or fewer values)."""
    L = lib()
    if L is None:
        return None
    out = np.empty(count, dtype=np.float64)
    got = L.mtx_parse_dense(body, len(body), count, _f64p(out))
    return out if got == count else None


def spgemm_host(Ap, Aj, Ax, Bp, Bj, Bx, m: int, n: int):
    """C = A @ B by the two-pass Gustavson on host CSR parts (numpy),
    values in f64. Returns canonical (indptr, indices, data) as int64,
    int64, float64 numpy arrays, or None without the library."""
    L = lib()
    if L is None:
        return None
    Ap, Aj, Bp, Bj = (np.ascontiguousarray(a, dtype=np.int64) for a in (Ap, Aj, Bp, Bj))
    Ax, Bx = (np.ascontiguousarray(a, dtype=np.float64) for a in (Ax, Bx))
    Cp = np.empty(m + 1, dtype=np.int64)
    nnz = L.spgemm_count(m, n, _i64p(Ap), _i64p(Aj), _i64p(Bp), _i64p(Bj), _i64p(Cp))
    Cj = np.empty(nnz, dtype=np.int64)
    Cx = np.empty(nnz, dtype=np.float64)
    L.spgemm_fill(m, n, _i64p(Ap), _i64p(Aj), _f64p(Ax), _i64p(Bp), _i64p(Bj), _f64p(Bx),
                  _i64p(Cp), _i64p(Cj), _f64p(Cx))
    return Cp, Cj, Cx


def ilu0_host(indptr, indices, data, n: int):
    """ILU(0) on canonical CSR host arrays, values in f64: returns the
    factored data (L strictly lower with an implicit unit diagonal, and U,
    on A's pattern). Without the library a numpy row loop runs the same
    IKJ recurrence. Raises ``RuntimeError`` on a missing structural
    diagonal or a zero pivot."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.array(data, dtype=np.float64, copy=True)
    L = lib()
    if L is not None:
        rc = L.ilu0_csr(n, _i64p(indptr), _i64p(indices), _f64p(out))
        if rc != 0:
            raise RuntimeError(f"ILU(0): zero/missing pivot at row {-rc - 1}")
        return out
    diag = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        d = np.nonzero(indices[indptr[i]:indptr[i + 1]] == i)[0]
        if d.size == 0:
            raise RuntimeError(f"ILU(0): zero/missing pivot at row {i}")
        diag[i] = indptr[i] + d[0]
    pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        p0, p1 = indptr[i], indptr[i + 1]
        pos[indices[p0:p1]] = np.arange(p0, p1)
        for p in range(p0, p1):
            k = indices[p]
            if k >= i:
                break
            ukk = out[diag[k]]
            if ukk == 0.0:
                raise RuntimeError(f"ILU(0): zero/missing pivot at row {k}")
            lik = out[p] / ukk
            out[p] = lik
            q0, q1 = diag[k] + 1, indptr[k + 1]
            pj = pos[indices[q0:q1]]
            ok = pj >= 0
            out[pj[ok]] -= lik * out[q0:q1][ok]
        pos[indices[p0:p1]] = -1
        if out[diag[i]] == 0.0:
            raise RuntimeError(f"ILU(0): zero/missing pivot at row {i}")
    return out


def ic0_host(indptr, indices, data, n: int):
    """IC(0) on the lower-triangular canonical CSR of an SPD matrix (each
    row's diagonal last), values in f64: returns L's data, A ~= L L^T on
    the lower pattern. A numpy loop without the library. Raises
    ``RuntimeError`` on a missing or non-positive pivot."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.array(data, dtype=np.float64, copy=True)
    L = lib()
    if L is not None:
        rc = L.ic0_csr(n, _i64p(indptr), _i64p(indices), _f64p(out))
        if rc != 0:
            raise RuntimeError(f"IC(0): non-positive/missing pivot at row {-rc - 1}")
        return out
    for i in range(n):
        p0, p1 = indptr[i], indptr[i + 1]
        if p1 <= p0 or indices[p1 - 1] != i:
            raise RuntimeError(f"IC(0): non-positive/missing pivot at row {i}")
        for p in range(p0, p1):
            j = indices[p]
            a, b, b1 = p0, indptr[j], indptr[j + 1] - 1
            s = 0.0
            while a < p and b < b1:  # L rows i and j over the columns < j
                ca, cb = indices[a], indices[b]
                if ca == cb:
                    s += out[a] * out[b]
                    a += 1
                    b += 1
                elif ca < cb:
                    a += 1
                else:
                    b += 1
            if j < i:
                ljj = out[indptr[j + 1] - 1]
                if ljj == 0.0:
                    raise RuntimeError(f"IC(0): non-positive/missing pivot at row {j}")
                out[p] = (out[p] - s) / ljj
            else:
                v = out[p] - s
                if v <= 0.0:
                    raise RuntimeError(f"IC(0): non-positive/missing pivot at row {i}")
                out[p] = v ** 0.5
    return out


def _lu_extract(L, h, n: int):
    """Copy a factor handle's CSC parts out, then free it:
    ``(Lp, Li, Lx, Up, Ui, Ux, perm)``."""
    try:
        lnnz, unnz = L.splu_lnnz(h), L.splu_unnz(h)
        Lp = np.empty(n + 1, dtype=np.int64)
        Li = np.empty(max(lnnz, 1), dtype=np.int64)
        Lx = np.empty(max(lnnz, 1), dtype=np.float64)
        Up = np.empty(n + 1, dtype=np.int64)
        Ui = np.empty(max(unnz, 1), dtype=np.int64)
        Ux = np.empty(max(unnz, 1), dtype=np.float64)
        perm = np.empty(n, dtype=np.int64)
        L.splu_get(h, _i64p(Lp), _i64p(Li), _f64p(Lx), _i64p(Up), _i64p(Ui), _f64p(Ux),
                   _i64p(perm))
    finally:
        L.splu_free(h)
    return Lp, Li[:lnnz], Lx[:lnnz], Up, Ui[:unnz], Ux[:unnz], perm


def _factor(kind: str, indptr, indices, data, n: int, *extra):
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    info = np.zeros(1, dtype=np.int64)
    h = getattr(L, f"{kind}_factor")(n, _i64p(indptr), _i64p(indices), _f64p(data), *extra,
                                     _i64p(info))
    if not h:
        raise RuntimeError(f"{kind}: matrix is singular (column {-int(info[0]) - 1})")
    return _lu_extract(L, h, n)


def ilut_host(indptr, indices, data, n: int, droptol: float, lfil: int):
    """ILUT(p, tau) of the CSC arrays of a square A through the
    Gilbert-Peierls core: U entries below droptol * ||A(:, j)||_2 and L
    multipliers below droptol drop (the pivot stays), and each of L and
    U's off-diagonal keeps its ``lfil`` largest a column (0: no cap).
    :func:`splu_host`'s return contract; None without the library."""
    return _factor("ilut", indptr, indices, data, n, float(droptol), int(lfil))


def splu_host(indptr, indices, data, n: int):
    """P A = L U with partial pivoting, on the CSC arrays of a square A,
    values in f64 (Gilbert-Peierls, natural column order). Returns
    ``(Lp, Li, Lx, Up, Ui, Ux, perm)``: L unit lower (diagonal implicit)
    and U upper, both CSC over pivot row ids, ``perm[k]`` the original row
    chosen as pivot k; None without the library. Raises ``RuntimeError``
    on a singular column."""
    return _factor("splu", indptr, indices, data, n)
