"""sparse_tpu_torch — the PyTorch / CUDA port of ``sparse_tpu``.

scipy.sparse-compatible arrays on torch tensors, with the TPU package's
Pallas kernels rewritten by hand for NVIDIA Hopper (``csrc/``). Imports
neither jax nor ``sparse_tpu``. Every entry point that creates data runs on
``config.settings.device`` (``"cuda"``) unless given ``device=``; asking
for CUDA where there is none raises.

    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import linalg
    A = sparse.diags([...], [...], dtype=np.float32).tocsc().T.tocsr()
    y = A @ x
    x, iters = linalg.cg(A, b)
"""

from __future__ import annotations

from . import csgraph, integrate, io, linalg, plan_cache, quantum, spatial
from .base import SparseArray
from .bsr import bsr_array
from .config import settings
from .coo import coo_array
from .coverage import coverage_report, track_provenance
from .csc import csc_array
from .csr import csr_array
from .dia import dia_array
from .dok import dok_array
from .lil import lil_array
from .interop import from_numpy_parts
from .module import (
    SparseEfficiencyWarning,
    SparseWarning,
    block_array,
    block_diag,
    bmat,
    diags,
    diags_array,
    expand_dims,
    eye,
    eye_array,
    find,
    get_index_dtype,
    hstack,
    identity,
    is_sparse_matrix,
    issparse,
    isspmatrix,
    isspmatrix_bsr,
    isspmatrix_coo,
    isspmatrix_csc,
    isspmatrix_csr,
    isspmatrix_dia,
    isspmatrix_dok,
    isspmatrix_lil,
    kron,
    kronsum,
    load_npz,
    permute_dims,
    rand,
    random,
    random_array,
    safely_cast_index_arrays,
    save_npz,
    spdiags,
    swapaxes,
    tril,
    triu,
    vstack,
)

__version__ = "0.1.0"

sparray = SparseArray  # scipy's abstract base alias

# scipy.sparse's *_matrix aliases
csr_matrix = csr_array
csc_matrix = csc_array
coo_matrix = coo_array
dia_matrix = dia_array
dok_matrix = dok_array
bsr_matrix = bsr_array
lil_matrix = lil_array

__all__ = [
    "SparseEfficiencyWarning", "SparseWarning", "block_array", "block_diag", "bmat",
    "bsr_array", "bsr_matrix", "coo_array", "coo_matrix", "coverage_report", "csc_array",
    "csc_matrix", "csgraph", "csr_array", "csr_matrix", "dia_array", "dia_matrix", "diags",
    "diags_array", "dok_array", "dok_matrix", "expand_dims", "eye", "eye_array", "find",
    "from_numpy_parts", "get_index_dtype", "hstack", "identity", "integrate", "io",
    "is_sparse_matrix", "issparse", "isspmatrix", "isspmatrix_bsr", "isspmatrix_coo",
    "isspmatrix_csc", "isspmatrix_csr", "isspmatrix_dia", "isspmatrix_dok", "isspmatrix_lil",
    "kron", "kronsum", "lil_array", "lil_matrix", "linalg", "load_npz", "permute_dims",
    "plan_cache", "quantum", "rand", "random", "random_array", "safely_cast_index_arrays",
    "save_npz", "settings", "spatial", "sparray", "spdiags", "swapaxes", "track_provenance",
    "tril", "triu", "vstack",
]
