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
from .module import diags, eye, identity, spdiags

__all__ = [
    "coo_array", "csc_array", "csr_array", "dia_array", "diags", "eye",
    "from_numpy_parts", "identity", "io", "linalg", "settings", "spdiags",
]
