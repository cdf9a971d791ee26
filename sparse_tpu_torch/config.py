"""Package settings for the PyTorch port (``sparse_tpu/config.py``'s subset).

Only the settings the ported paths read are carried over; each is
overridable from the environment under a ``SPARSE_TPU_TORCH_*`` name.

``device`` is the default device of every entry point that creates data
(constructors, ``io.mmread``, ``interop.from_numpy_parts``). It is
``"cuda"``: asking for CUDA on a machine without it raises
(:func:`sparse_tpu_torch.utils.resolve_device`), it never falls back to
the CPU. Tests set it to ``"cpu"``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() not in ("0", "false", "no", "off", "")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclass
class Settings:
    # CSR SpMV dispatch: 'auto' and 'pallas' run banded matrices through
    # the prepared DIA kernel (kernels/dia_spmv.py); 'sell' forces the
    # prepared SELL-C-sigma kernel (kernels/sell_spmv.py), which 'pallas'
    # takes for every other matrix and 'auto' for skewed row profiles;
    # 'ell' / 'segment' force those plain paths
    spmv_mode: str = field(
        default_factory=lambda: os.environ.get("SPARSE_TPU_TORCH_SPMV_MODE", "auto")
    )
    # max row length (relative to the mean) at which 'auto' takes ELL
    ell_max_ratio: float = 4.0
    # SELL-C-sigma packing geometry of the reference-equal slab pack
    # (kernels/sell_spmv.py::sell_pack): chunk height C, degree-sorting
    # window sigma (0 = one global window) and the number of distinct chunk
    # widths beyond which widths round up to powers of two. They govern the
    # CPU path, the parity tests and interop; on the card they are TPU
    # tiling knobs, like PALLAS_MAX_X: the card's chunk layout
    # (sell_chunk_pack) has its own fixed geometry (32-row chunks, one
    # global degree sort, per-chunk widths with no cap)
    sell_chunk: int = field(
        default_factory=lambda: max(_env_int("SPARSE_TPU_TORCH_SELL_C", 8), 1)
    )
    sell_sigma: int = field(
        default_factory=lambda: _env_int("SPARSE_TPU_TORCH_SELL_SIGMA", 4096)
    )
    sell_max_slabs: int = 16
    # weak-ref keyed LRU of prepared operators (plan_cache.py)
    plan_cache: bool = field(
        default_factory=lambda: _env_bool("SPARSE_TPU_TORCH_PLAN_CACHE", True)
    )
    plan_cache_capacity: int = field(
        default_factory=lambda: max(_env_int("SPARSE_TPU_TORCH_PLAN_CACHE_CAP", 128), 1)
    )
    # banded detection: at most this many distinct diagonals, and at most
    # this fill blowup (D * n <= dia_max_fill * nnz)
    dia_max_diags: int = 32
    dia_max_fill: float = 4.0
    # max |col - row| band for the prepared DIA SpMV and the fused CG on
    # CPU tensors, the reference's gate (a TPU VMEM limit), so the same
    # inputs take the same path there; the CUDA kernels take any band
    pallas_max_band: int = 8192
    # linalg.cg fused fast path: True / False / "force" ("force" also runs
    # it on the CPU through the kernels' plain versions — the test hook)
    fused_cg: bool | str = field(
        default_factory=lambda: (
            "force"
            if os.environ.get("SPARSE_TPU_TORCH_FUSED_CG", "").lower() == "force"
            else _env_bool("SPARSE_TPU_TORCH_FUSED_CG", True)
        )
    )
    # default device of every entry point that creates data
    device: str = field(
        default_factory=lambda: os.environ.get("SPARSE_TPU_TORCH_DEVICE", "cuda")
    )


settings = Settings()
