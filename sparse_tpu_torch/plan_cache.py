"""Operator plan cache: prepare once, execute everywhere.

Port of ``sparse_tpu/plan_cache.py``'s in-process tier (no disk tier).
Entries are keyed by the operator *object* and die with it: a
``weakref.finalize`` evicts an object's plans when it is collected, so
fresh objects (``_with_data``, new constructions) are new keys and a stale
layout is never served. LRU-bounded by ``settings.plan_cache_capacity``;
``settings.plan_cache = False`` makes every lookup build.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict

from .config import settings

_LOCK = threading.RLock()
_ENTRIES: OrderedDict = OrderedDict()  # (id(obj), kind) -> plan
_FINALIZERS: dict = {}  # id(obj) -> weakref.finalize
_COUNTS = {"hits": 0, "misses": 0, "evictions": 0}


def _evict_object(oid: int) -> None:
    with _LOCK:
        for k in [k for k in _ENTRIES if k[0] == oid]:
            del _ENTRIES[k]
            _COUNTS["evictions"] += 1
        _FINALIZERS.pop(oid, None)


def get(obj, kind: str, build):
    """The cached plan for ``(obj, kind)``, built by ``build()`` on a miss."""
    if not settings.plan_cache:
        with _LOCK:
            _COUNTS["misses"] += 1
        return build()
    key = (id(obj), kind)
    with _LOCK:
        if key in _ENTRIES:
            _ENTRIES.move_to_end(key)
            _COUNTS["hits"] += 1
            return _ENTRIES[key]
        _COUNTS["misses"] += 1
    plan = build()
    try:
        fin = weakref.finalize(obj, _evict_object, id(obj))
    except TypeError:  # not weak-referenceable: never cached
        return plan
    fin.atexit = False
    with _LOCK:
        old = _FINALIZERS.pop(id(obj), None)
        if old is not None:
            old.detach()
        _FINALIZERS[id(obj)] = fin
        _ENTRIES[key] = plan
        while len(_ENTRIES) > settings.plan_cache_capacity:
            _ENTRIES.popitem(last=False)
            _COUNTS["evictions"] += 1
    return plan


def lookup(obj, kind: str):
    """The cached plan for ``(obj, kind)``, or None; never builds. Counts a
    hit or a miss like :func:`get`."""
    with _LOCK:
        if settings.plan_cache and (id(obj), kind) in _ENTRIES:
            _ENTRIES.move_to_end((id(obj), kind))
            _COUNTS["hits"] += 1
            return _ENTRIES[(id(obj), kind)]
        _COUNTS["misses"] += 1
    return None


def forget(obj) -> None:
    """Drop every plan of ``obj``: its data changed in place."""
    with _LOCK:
        fin = _FINALIZERS.get(id(obj))
        if fin is not None:
            fin.detach()
        _evict_object(id(obj))


def stats() -> dict:
    with _LOCK:
        return {**_COUNTS, "size": len(_ENTRIES)}

