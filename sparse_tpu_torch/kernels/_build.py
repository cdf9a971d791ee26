"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, bound with ``ctypes``. All sources build in parallel
(one ``nvcc`` process each, started together) on first use, into
``build/sparse_tpu_torch/`` at the repository root, under a name that
carries a digest of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused. Only sources in the checkout are built.
A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sparse_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels of sparse_tpu_torch cannot be built"
    )


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source not built yet; returns {stem: library path}.
    The compiler's output (with ``-Xptxas=-v`` register and spill counts)
    is kept beside each library as ``<name>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    targets = {src.stem: _target(src) for src in sources}
    jobs = []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    for src in sources:
        out = targets[src.stem]
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed to build:\n" + "\n".join(failed))
    return targets


def library(stem: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building on first
    use), with ``signatures`` ({function: argtypes}, each returning the
    launch's ``cudaGetLastError()`` code as an int) declared."""
    with _LOCK:
        if stem not in _LIBS:
            lib = ctypes.CDLL(str(build_all()[stem]))
            lib.stk_error_string.argtypes = [ctypes.c_int]
            lib.stk_error_string.restype = ctypes.c_char_p
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[stem] = lib
        return _LIBS[stem]


def check_launch(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` code returned by a launch."""
    if code != 0:
        msg = lib.stk_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {code} ({msg})")


def offsets_array(offsets) -> ctypes.Array:
    return (ctypes.c_longlong * len(offsets))(*[int(o) for o in offsets])


def stream_handle(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(kernel: str, *tensors) -> None:
    """Check that every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: every operand must be a contiguous tensor on one "
                f"CUDA device (got {t.device}, contiguous={t.is_contiguous()})"
            )
