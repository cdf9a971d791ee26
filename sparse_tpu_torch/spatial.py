"""Spatial distances (``sparse_tpu/spatial.py``).

``cdist`` in euclidean and sqeuclidean form is one [m, k] x [k, n] matmul
plus the row and column norms, ||a - b||^2 = ||a||^2 + ||b||^2 - 2 a.b,
as the reference computes it (plain XLA there, ``torch.matmul`` here);
cityblock accumulates one [m, n] plane a feature, so the peak stays
O(m n) rather than the [m, n, k] broadcast.
"""

from __future__ import annotations

import torch

from .utils import as_tensor


def _sq_norms(XA, XB):
    return (XA * XA).sum(1)[:, None], (XB * XB).sum(1)[None, :]


def cdist(XA, XB, metric: str = "euclidean", mesh=None, device=None):
    """Pairwise distances between the rows of XA [m, k] and XB [n, k], on
    XA's device (numpy inputs go to ``device`` or ``settings.device``).
    ``mesh`` (the 2-D tiled form over a device mesh) raises: it comes with
    the distributed package (ROADMAP queue 1 item 8)."""
    if mesh is not None:
        raise NotImplementedError(
            "cdist(mesh=...) needs the distributed package, which is not ported to "
            "sparse_tpu_torch yet (ROADMAP queue 1 item 8)")
    XA = as_tensor(XA, device)
    XB = as_tensor(XB, XA.device)
    if XA.ndim != 2 or XB.ndim != 2:
        raise ValueError("XA and XB must be 2-dimensional")
    if XA.shape[1] != XB.shape[1]:
        raise ValueError(f"XA and XB must have the same number of columns "
                         f"({XA.shape[1]} != {XB.shape[1]})")
    if metric in ("euclidean", "sqeuclidean"):
        sqa, sqb = _sq_norms(XA, XB)
        d2 = torch.clamp(sqa + sqb - 2.0 * (XA @ XB.T), min=0.0)
        return torch.sqrt(d2) if metric == "euclidean" else d2
    if metric == "cityblock":
        acc = torch.zeros((XA.shape[0], XB.shape[0]), dtype=XA.dtype, device=XA.device)
        for i in range(XA.shape[1]):
            acc += torch.abs(XA[:, i, None] - XB[None, :, i])
        return acc
    raise ValueError(f"unsupported metric {metric!r}")
