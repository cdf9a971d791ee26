"""Shared helpers: device resolution, tensor conversion, warnings."""

from __future__ import annotations

import inspect
import warnings

import numpy as np
import torch

from .config import settings


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``settings.device``. Raises when CUDA is asked for and absent — the
    port never carries on on the CPU in its place."""
    dev = torch.device(settings.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' or set sparse_tpu_torch.config.settings.device"
        )
    return dev


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """Any array-like -> tensor with ``dtype`` (default: keep the input's)
    on ``device``. With ``device=None`` a tensor stays where it is and
    anything else goes to ``settings.device``. The counterpart of
    ``sparse_tpu.utils.asjnp``."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.to(dtype=dtype) if dtype is not None else x
    dev = resolve_device(device)
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if not a.flags.writeable:
            a = a.copy()
        x = torch.from_numpy(np.ascontiguousarray(a))
    return x.to(device=dev, dtype=dtype)


def host_array(a) -> np.ndarray:
    """A tensor's values (fetched to the host) or any array-like as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def host_int(x) -> int:
    """One device -> host fetch of an integer scalar."""
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def user_warning(msg: str) -> None:
    """warnings.warn at the first stack frame outside this package."""
    level = 1
    for frame, _ in zip(inspect.stack(), range(64)):
        if "sparse_tpu_torch" not in frame.filename:
            break
        level += 1
    warnings.warn(msg, stacklevel=level)
