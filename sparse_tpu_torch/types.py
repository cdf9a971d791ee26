"""Canonical dtypes for sparse index data (``sparse_tpu/types.py``).

int32 coordinates by default; int64 only when a dimension or the nnz count
exceeds int32 range (docs/DESIGN.md §7).
"""

from __future__ import annotations

import torch

coord_ty = torch.int32
coord_ty_wide = torch.int64

_INT32_MAX = 2**31 - 1


def index_dtype_for(shape, nnz: int) -> torch.dtype:
    """Pick an index dtype large enough for ``shape`` and ``nnz``."""
    m = max([int(nnz), *[int(s) for s in shape]] or [0])
    return coord_ty_wide if m > _INT32_MAX else coord_ty
