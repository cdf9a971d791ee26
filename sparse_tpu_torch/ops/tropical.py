"""Tropical-semiring SpMV and the MIS built on it (``sparse_tpu/ops/tropical.py``).

``tropical_spmv``: y[i] is the lexicographically largest x[j] over the
columns j of row i (x an [n, f] integer tuple array; an empty row gives
the 0-tuple), A's values unused. It powers the AMG MIS aggregation
(``examples/amg.py:199-283``): ``mis_flags`` runs the reference's
``lax.while_loop`` tournament as ``hostsync.device_while`` (chunks of
rounds, one counted fetch a chunk), with the reference's numpy random
priorities, so the selected set is the reference's.

Each hop gathers the padded-row (ELL) candidates into ``[m, k, f]`` and
reduces them by a log-depth lexicographic tournament, in plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import hostsync
from .conv import csr_to_ell


def _lex_ge(a, b):
    """Lexicographic a >= b over the last axis."""
    diff = a - b
    neq = diff != 0
    first = torch.argmax(neq.to(torch.int8), dim=-1, keepdim=True)
    d = torch.take_along_dim(diff, first, dim=-1)[..., 0]
    return torch.where(neq.any(dim=-1), d > 0, True)


def _tournament(ell_idx, lens, x):
    """Gather and log-depth lexicographic tournament over the k axis."""
    m, k = ell_idx.shape
    f = x.shape[1]
    valid = torch.arange(k, dtype=lens.dtype, device=lens.device)[None, :] < lens[:, None]
    cand = torch.where(valid[:, :, None], x[ell_idx], torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))
    while cand.shape[1] > 1:
        if cand.shape[1] % 2:
            cand = torch.cat([cand, torch.zeros((m, 1, f), dtype=cand.dtype, device=cand.device)],
                             dim=1)
        a, b = cand[:, 0::2], cand[:, 1::2]
        cand = torch.where(_lex_ge(a, b)[..., None], a, b)
    return cand[:, 0, :]


def _ell_plane(indptr, indices, data, m, ell_idx):
    """(ell_idx, lens): the given padded-row index plane or a new one."""
    lens = indptr[1:] - indptr[:-1]
    if ell_idx is None:
        k = hostsync.fetch_int(lens.max()) if m else 0
        ell_idx, _ = csr_to_ell(indptr, indices, data, m, max(k, 1))
    return ell_idx, lens


def tropical_spmv(indptr, indices, data, x, m: int, ell_idx=None):
    """``ell_idx``: an optional prebuilt [m, k] padded-row index plane (the
    array's cached ELL layout), which saves the row-length fetch."""
    if x.ndim != 2:
        raise ValueError("tropical_spmv expects a 2-D tuple array")
    if indices.shape[0] == 0 or m == 0:
        return torch.zeros((m, x.shape[1]), dtype=x.dtype, device=x.device)
    return _tournament(*_ell_plane(indptr, indices, data, m, ell_idx), x)


def mis_flags(indptr, indices, data, m: int, k=1, invalid=None, seed=0, ell_idx=None):
    """MIS(k) by tropical tournament on the device. Returns the [m] int32
    flags: 2 = MIS member, 0 = dominated, -1 = invalid. A round that
    changes no flag ends the loop; a node still undecided then means a
    stalled tournament and raises."""
    ell_idx, lens = _ell_plane(indptr, indices, data, m, ell_idx)
    dev = indptr.device
    rng = np.random.default_rng(seed)
    rv = rng.integers(0, np.iinfo(np.int32).max, size=m, dtype=np.int32)
    flag0 = np.ones(m, np.int32)
    if invalid is not None:
        flag0[np.asarray(invalid)] = -1
    x0 = torch.from_numpy(np.stack([flag0, rv, np.arange(m, dtype=np.int32)], axis=1)).to(dev)
    idx = torch.arange(m, dtype=torch.int32, device=dev)

    def cond(s):
        return (s["x"][:, 0] == 1).any() & s["changed"] & (s["itn"] < m + 1)

    def body(s):
        x = s["x"]
        z = _tournament(ell_idx, lens, x)
        for _ in range(1, k):
            z = _tournament(ell_idx, lens, z)
        flag = x[:, 0]
        mis = (flag == 1) & (z[:, 2] == idx)
        non = (flag == 1) & (z[:, 0] == 2)
        new_flag = torch.where(mis, 2, torch.where(non, 0, flag)).to(torch.int32)
        return {"x": torch.cat([new_flag[:, None], x[:, 1:]], dim=1),
                "changed": (new_flag != flag).any(), "itn": s["itn"] + 1}

    state = {"x": x0, "changed": torch.ones((), dtype=torch.bool, device=dev),
             "itn": torch.zeros((), dtype=torch.int64, device=dev)}
    # every round that goes on changes a flag, so m + 1 rounds bound the loop
    state, _, _ = hostsync.device_while(cond, body, state, m + 1)
    flags = state["x"][:, 0]
    if hostsync.fetch_int((flags == 1).any()):
        # a no-progress round with nodes still undecided: a stalled
        # tournament (e.g. a strength graph without its diagonal, where
        # z[:, 2] == i never fires), not a partial MIS
        raise RuntimeError(
            "tropical MIS tournament made no progress within the round "
            "bound; does the strength graph include self-loops?"
        )
    return flags


def mis_aggregate_cols(indptr, indices, data, m: int, flags, ell_idx=None):
    """(aggregate column per fine node [m], n_coarse) from MIS flags: the
    coarse nodes are numbered in node order, then two tropical hops route
    every fine node to its nearest root (``examples/amg.py:225-243``)."""
    ell_idx, lens = _ell_plane(indptr, indices, data, m, ell_idx)
    mask = flags == 2
    coarse_idx = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    zero = torch.zeros((), dtype=torch.int32, device=flags.device)
    x = torch.stack([torch.where(mask, 2, zero).to(torch.int32),
                     torch.where(mask, coarse_idx, zero)], dim=1)
    y = _tournament(ell_idx, lens, x)
    y = torch.cat([(y[:, 0] + x[:, 0])[:, None], y[:, 1:]], dim=1)
    z = _tournament(ell_idx, lens, y)
    return z[:, 1], mask.to(torch.int32).sum()
