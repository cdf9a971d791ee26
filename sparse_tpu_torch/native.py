"""Loader of the port's host-side native library (``csrc/host_native.cc``).

It serves what runs on the host only: the Gustavson SpGEMM of CPU-tensor
f32/f64 products (``ops.spgemm``) and the MatrixMarket tokenizers of
``io.mmread``. The source compiles with
``g++ -O3 -shared -fPIC`` on first use into ``build/sparse_tpu_torch/``
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
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

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
    return cdll


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


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
