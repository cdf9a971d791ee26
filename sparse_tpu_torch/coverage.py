"""API coverage and provenance (``sparse_tpu/coverage.py``).

``track_provenance`` wraps a public entry point in a
``torch.profiler.record_function`` range named ``sparse_tpu.<qualname>``,
so a profile of the card attributes its kernels to the library call that
launched them (the reference opens a ``jax.named_scope``). Counting each
call in the telemetry log comes with the telemetry package.
``coverage_report`` walks ``scipy.sparse``'s public surface and reports what
``sparse_tpu_torch`` implements and what it lacks.
"""

from __future__ import annotations

import functools
import inspect

import torch


def track_provenance(fn):
    """Wrap a public op so its profile carries a ``sparse_tpu.<name>`` range."""
    scope = f"sparse_tpu.{fn.__qualname__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(scope):
            return fn(*args, **kwargs)

    return wrapper


# scipy.sparse names that are deliberately out of scope (deprecated in scipy,
# or matrix-creation aliases scipy itself discourages)
_EXCLUDED = {"matrix_power", "spmatrix", "sparsetools", "test"}


def _scipy_surface():
    """Public callables and classes of scipy.sparse (module level)."""
    import scipy.sparse as sp

    out = {}
    for name in dir(sp):
        if name.startswith("_") or name in _EXCLUDED:
            continue
        obj = getattr(sp, name)
        if inspect.ismodule(obj):
            continue
        if callable(obj) or inspect.isclass(obj):
            out[name] = obj
    return out


def _class_surface(cls):
    return {n for n in dir(cls) if not n.startswith("_") and callable(getattr(cls, n, None))}


def coverage_report(verbose: bool = False):
    """Compare this package's surface against scipy.sparse.

    Returns ``{"implemented": [...], "missing": [...], "classes": {...}}``;
    with ``verbose`` prints a table."""
    import scipy.sparse as sp

    import sparse_tpu_torch

    implemented, missing = [], []
    for name in sorted(_scipy_surface()):
        (implemented if hasattr(sparse_tpu_torch, name) else missing).append(name)
    classes = {}
    for name in ("csr_array", "csc_array", "coo_array", "dia_array"):
        sc_methods = _class_surface(getattr(sp, name))
        our_methods = _class_surface(getattr(sparse_tpu_torch, name))
        classes[name] = {"implemented": sorted(sc_methods & our_methods),
                         "missing": sorted(sc_methods - our_methods)}
    report = {"implemented": implemented, "missing": missing, "classes": classes}
    if verbose:
        print(f"scipy.sparse module surface: {len(implemented)}/"
              f"{len(implemented) + len(missing)} implemented")
        print("missing:", ", ".join(missing) or "(none)")
        for cname, c in classes.items():
            print(f"{cname}: {len(c['implemented'])}/"
                  f"{len(c['implemented']) + len(c['missing'])} methods")
            if c["missing"]:
                print("  missing:", ", ".join(c["missing"]))
    return report
