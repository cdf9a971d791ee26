"""Counted device -> host fetches, host -> device uploads that do not
sync, and the device-side while loop.

Every fetch a solver or an op makes on purpose goes through :func:`fetch` (or
:func:`fetch_int`), which counts it in ``HOST_SYNCS``: reset the counter,
run a solve or a product, read it. The solvers of ``linalg``, the SpGEMM
and the union merges of ``ops`` and the tropical MIS share it. A host
array a loop sends to the card between two fetches goes through
:func:`upload`, which queues the copy and does not wait for the card.

:func:`device_while` is the reference's ``lax.while_loop`` on torch
(``linalg`` and ``ops.tropical`` run it).
"""

from __future__ import annotations

import numpy as np
import torch

#: device -> host fetches made through :func:`fetch` since the last reset
HOST_SYNCS = 0

#: iterations a device loop (:func:`device_while`) runs between two host
#: reads of its stop flag
CHECK_EVERY = 32


def fetch(x):
    """Fetch a device value to the host as numpy, counting the round trip."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fetch_int(x) -> int:
    """One counted fetch of an integer scalar."""
    return int(fetch(x))


def upload(x, device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To a CUDA device the copy
    goes through pinned memory, queued on the current stream: a pageable
    copy would wait for the card to drain."""
    t = torch.as_tensor(np.ascontiguousarray(x))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_while(cond, body, state, limit: int, count: str = "itn", stats=None, callback=None):
    """The reference's ``lax.while_loop`` on torch: ``state`` a dict of
    tensors, ``cond(state)`` a device bool, ``body(state)`` the next state,
    ``state[count]`` an iteration counter that ``cond`` stops at ``limit``.

    Runs chunks of at most ``CHECK_EVERY`` iterations with no host read,
    each iteration past the stop condition frozen: every tensor of the
    state (the counter included) keeps its value under ``torch.where``.
    The iterates and the count are then the reference's, and a NaN from a
    guarded division after convergence never leaks in. Before each chunk
    the host fetches the stop flag and the counter, packed with
    ``stats(state)`` (0-d tensors), in one counted fetch, and cuts the chunk
    at ``limit``: a loop of ``itn`` iterations makes at most
    ceil(itn / CHECK_EVERY) + 1 fetches. With a ``callback`` the loop runs
    eagerly, fetching before and calling ``callback(state["x"])`` after
    every iteration. Returns the final state, its count and the host
    values of ``stats`` on it."""

    while True:
        vals = [cond(state), state[count]] + (list(stats(state)) if stats is not None else [])
        host = fetch(torch.stack([v.to(torch.float64) for v in vals]))
        if not host[0]:
            return state, int(host[1]), host[2:]
        if callback is not None:
            state = body(state)
            callback(state["x"])
            continue
        for _ in range(min(CHECK_EVERY, limit - int(host[1]))):
            active = cond(state)
            new = body(state)
            state = {key: torch.where(active, new[key], v) for key, v in state.items()}
