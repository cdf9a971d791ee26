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

from . import io, linalg
from .config import settings
from .coo import coo_array
from .csc import csc_array
from .csr import csr_array
from .dia import dia_array
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

__all__ = [
    "SparseEfficiencyWarning", "SparseWarning", "block_array", "block_diag", "bmat",
    "coo_array", "csc_array", "csr_array", "dia_array", "diags", "diags_array", "expand_dims",
    "eye", "eye_array", "find", "from_numpy_parts", "get_index_dtype", "hstack", "identity",
    "io", "is_sparse_matrix", "issparse", "isspmatrix", "isspmatrix_bsr", "isspmatrix_coo",
    "isspmatrix_csc", "isspmatrix_csr", "isspmatrix_dia", "isspmatrix_dok", "isspmatrix_lil",
    "kron", "kronsum", "linalg", "load_npz", "permute_dims", "rand", "random", "random_array",
    "safely_cast_index_arrays", "save_npz", "settings", "spdiags", "swapaxes", "tril", "triu",
    "vstack",
]
