"""DIA SpMV in plain torch: the counterpart of ``sparse_tpu``'s
``ops/dia_spmv.dia_spmv_xla``.

For A in scipy DIA layout (``data[k, j]`` holds ``A[j - o_k, j]``):

    y[i] = sum_k data[k, i + o_k] * x[i + o_k]

one [D, n] elementwise product and D shifted adds, no index loads. On the
card the banded paths run the hand-written kernels instead
(``kernels/dia_spmv.py``), which take any band and raise on a dtype they
are not built for; this version serves CPU tensors past the reference's
gates and ``dia_array`` products under ``spmv_mode`` ``'ell'``/``'segment'``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dia_spmv_torch(data: torch.Tensor, offsets: tuple, x: torch.Tensor, shape: tuple):
    """y = A @ x; ``data`` is [D, n] (scipy width), ``x`` is [n]."""
    m, n = shape
    out_dt = torch.promote_types(data.dtype, x.dtype)
    prod = data.to(out_dt) * x[None, :n].to(out_dt)  # [D, n]
    B = max(max((abs(int(o)) for o in offsets), default=0), max(m - n, 0))
    padded = F.pad(prod, (B, B + max(m - n, 0)))
    y = torch.zeros((m,), dtype=out_dt, device=x.device)
    for k, o in enumerate(offsets):
        y = y + padded[k, B + int(o) : B + int(o) + m]
    return y
