"""Model workloads (``sparse_tpu/models``): the 5-point Poisson problem."""

from .poisson import (
    cg_dia,
    cg_ell,
    cg_step_ell,
    laplacian_2d_csr,
    laplacian_2d_csr_host,
    laplacian_2d_dia,
    laplacian_2d_ell,
    make_cg_step_dia,
    poisson_cg_state,
    poisson_cg_state_dia,
)

__all__ = [
    "cg_dia", "cg_ell", "cg_step_ell", "laplacian_2d_csr", "laplacian_2d_csr_host",
    "laplacian_2d_dia", "laplacian_2d_ell", "make_cg_step_dia", "poisson_cg_state", "poisson_cg_state_dia",
]
