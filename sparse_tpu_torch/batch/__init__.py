"""sparse_tpu_torch.batch: the batched solve subsystem.

Port of ``sparse_tpu/batch`` for systems that share a sparsity pattern:

* :mod:`~sparse_tpu_torch.batch.operator`: pattern-shared batched
  operators (``BatchedCSR``, ``BatchedDIA``); one plan-cached SELL pack per
  pattern drives every lane, through the batched SELL kernel on the card;
* :mod:`~sparse_tpu_torch.batch.krylov`: masked batched CG, BiCGStab and
  GMRES with per-lane convergence; a batch of one matches the unbatched
  solver.

The microbatching ``SolveSession`` and its bucketing are not ported yet.
"""

from .krylov import (  # noqa: F401
    BatchedSolveInfo,
    batched_bicgstab,
    batched_cg,
    batched_gmres,
)
from .operator import (  # noqa: F401
    BatchedCSR,
    BatchedDIA,
    BatchedOperator,
    SparsityPattern,
    as_batched_matvec,
    make_batched_operator,
)

__all__ = [
    "BatchedCSR",
    "BatchedDIA",
    "BatchedOperator",
    "BatchedSolveInfo",
    "SparsityPattern",
    "as_batched_matvec",
    "batched_bicgstab",
    "batched_cg",
    "batched_gmres",
    "make_batched_operator",
]
