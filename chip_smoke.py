#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (``sparse_tpu_torch``).

    python3 chip_smoke.py [--segment-sweep] [--window-sweep]

Needs one CUDA card, ``nvcc`` and the repository checkout beside this file;
exits non-zero without them, and on any failed check. Phases, in the order
they run (1, 2a-2e, 3, 5, 6, 7, 8, 9, 10, 4, 11, 12, 13):

1. card name and power limit; build the CUDA kernels (csrc/*.cu) and time it;
2. each kernel against its plain torch version on the card: (a, b) the DIA
   SpMV and fused-CG kernels at the main path's shapes (the 6000^2
   Laplacian) and on the edge cases of tests/test_dia_spmv.py, one fused
   solve run twice bit-identical; (c) both chunked SELL kernels bit for bit
   in f32 and f64 values with int32 and int64 indices, on
   tests/test_torch_sell.py's edge cases (the layout packed from CSR and
   from the reference's slab packs) and on the full-size packs of phases 5
   and 6, each batched lane against the single-matrix kernel, and a complex
   operand must raise; (d) the
   column-indexed DIA SpMV, bit for bit in f32 and f64, on the edge cases,
   a wide matrix and the 6000^2 planes; (e) the one-pass CG kernels: the
   windowed kernel at 6000^2 with f32, bf16 and f64 planes, the wide
   kernel on the 3-D Laplacian at 200^3, whose band the window cannot
   hold: one iteration (vectors bit for
   bit, dots within their summation bound), 20 iterations against the
   plain loop and twice bit-identical, bf16 planes equal to f32 planes; a
   dtype with no kernel must raise;
3. the main path, as examples/pde.py drives it, at the reference's per-GPU
   size (6000^2 = 36e6 unknowns, float32): diags -> tocsc -> .T -> tocsr,
   y = A @ ones against a host f64 reference on sampled rows, a 300-iteration
   throughput CG, and a tolerance-driven CG at 1000^2 whose true residual is
   computed in f64 on the host;
5. the general (non-banded) path at bench.py's skewed_degree_csr(2**21),
   float32, spmv_mode 'auto': A @ x against scipy in f64 on sampled rows, a
   100-iteration throughput CG and a tolerance CG (1e-6 ||b||) whose true
   residual is held in f64 on the host;
6. batched_cg over 64 lanes A + d_b I sharing skewed_degree_csr(2**16)'s
   pattern: every lane converges with its true residual held in f64 and
   the iteration count of linalg.cg on that lane alone; solves/s against
   the lanes solved one after another;
7. the flagship Poisson step (``models.poisson``: ``poisson_cg_state_dia``,
   ``make_cg_step_dia``, ``cg_dia``) at 6000^2 f32 for 300 iterations with
   no host sync inside the loop (``torch.cuda.set_sync_debug_mode("error")``),
   and at the reference entry point's size 64 against the CPU; iters/s and
   the true residual in f64;
8. bench.py::run_fused's sweep at 6000^2, 300 iterations: two-pass and
   one-pass, f32 and bf16 planes, each gated on its final rho (finite, at
   most 10x the two-pass rho) and timed best of 3; the one-pass variants
   run the windowed kernel only, 300 launches a solve;
9. one-pass CG on the 7-point 3-D Laplacian at 200^3 (offsets +-40000,
   f32), 100 iterations through the wide kernel only, its true residual
   within 10x of the two-pass fused CG's;
10. the Krylov solvers of linalg: (a) on the 5-point upwind
   convection-diffusion operator at 6000^2 (f32, nonsymmetric), A @ x and
   A.T @ x against a host f64 reference and twice bit for bit, then 100
   iterations each of cgs, bicg, bicgstab, tfqmr, qmr, gmres (5 cycles of
   20), lsqr and lsmr, with every host sync outside the counted fetches an
   error; bicg and lsqr repeat bit for bit, bicg's DIA launches count its
   A and A^T products; (b) on phase 3's Laplacian, 100 minres iterations,
   spsolve (the fused CG kernels) and minres to tol at 1000^2, lgmres and
   gcrotmk in f64 at 6000^2, 3 outer cycles each; (c) on the nonsymmetric
   skewed_nonsym_csr(2**21) under spmv_mode 'sell', A.T @ x against scipy
   and twice bit for bit (and on skewed_degree_csr(2**16)), bicg, qmr,
   gmres and bicgstab to 1e-6 ||b|| in f32 (measured) and f64 (held),
   lsqr and lsmr for 300 iterations (their estimates held to the true
   residual) and to tol in f64 at 2**13;
4. times from CUDA events: each kernel, its plain version, its bound, and
   where one exists the PyTorch library call computing the same function;
   for the SELL kernels also the x gather's sectors, the layout's bytes
   beyond the function's, the single kernel on lane-contiguous columns and
   torch.profiler's list of the kernels one product launches; with
   ``--segment-sweep`` both SELL kernels at six segment lengths (the
   experiment that chose ``SELL_SEGMENT``); with ``--window-sweep`` the
   windowed and the wide one-pass kernel on 2-D and 3-D Laplacians of
   several sizes (the experiment behind ``cgcg_iteration``'s choice);
11. the core sparse ops at full width, last, with every earlier phase's
   operators freed: (a) examples/spgemm_microbenchmark.py's A @ B at
   n = 2^22 in f64 (11 diagonals of ones): iterations/s over 10 products,
   the peak of allocated memory, 2 host fetches a product and no other
   sync, two products bit for bit, C exactly the closed form on sampled
   rows, one product profiled, the library's CSR @ CSR on the same A and
   B, and C @ x (the DIA kernel) against A @ (A @ x); (b) A @ A of
   module.random(2^20, 2^20, 16 / 2^20, seed 7) in f32, bit for bit on a
   repeat, (A @ A) @ x through the SELL kernel against A @ (A @ x); (c)
   models.laplacian_2d_csr(6000) through kron and the union add, its
   A @ x bit for bit the pde.py-built operator's, 100 iterations of
   linalg.cg (the fused kernels); (d) on it A + A.T, A - A.T, A.multiply(A),
   column sums, row maxima, the diagonal, sddmm (k = 8) and x @ A, timed
   and checked, and the tropical MIS at 1000^2, held on the host as a
   maximal independent set and equal on a repeat;
12. the rest of linalg, after phase 11 with its operators freed: (a)
   eigsh(k=6, 'LM') on phase 3's 6000^2 Laplacian for 3 thick-restart
   cycles (dia_spmv_packed), twice bit for bit, one host fetch a cycle
   (the first run adds the DIA layout's build; the second runs under
   ``fetches_only`` from its start), its Ritz values inside LaplacianNd's closed-form spectrum, each
   residual estimate against the true residual, and eigsh at 100^2 in f64
   against the closed form; (b) expm_multiply at t = dx^2 on the (3000,
   3000) sine mode and its time grid against e^(t lambda) u0, the
   products made against the two-term test's count, norm and onenormest
   against the closed forms, matrix_power(A, 3) at 2000^2 against three
   products; (c) LaplacianNd((6000, 6000)): matvec equal to tosparse() @ x;
   (d) svds(k=6) on skewed_nonsym_csr(2**21) under spmv_mode 'sell'
   (sell_chunk_spmv on A and A^T) for 3 cycles with true residuals, each
   ||A^T u - s v|| / s within 1e-4, and at 2**13 in f64 against scipy;
   lobpcg on the 1000^2 Laplacian against the same call on CPU tensors,
   and eigs on the 1000^2 convection-diffusion operator, with true
   residuals; (e) splu
   at 256^2 in f64 (the native factor, triangular solves on the card),
   spilu (ILU(0)) at 1000^2 as a loop and as a CUDA graph (bit for bit)
   and as gmres's M (its device events an apply: 2 K times the events of
   a step of splu's solve, by torch.profiler), a 10^6-row tridiagonal ILU,
   dense splu/inv/expm at 2048 against scipy;
13. the remaining formats and application modules, after phase 12 with its
   operators freed: (a) examples/quantum_evolution.py's f32 stacked-real
   form on the 30-atom ring (1,860,498 states): the Hamiltonian build,
   DOP853 from 0 to 1 at rtol 1e-5 (dia_spmv_packed on the diagonal cost,
   ELL on H_driver), one counted fetch a step attempt past the setup's
   three and no other sync, twice bit for bit, steps/s, norm drift, MIS
   overlap and cost; the same under spmv_mode 'sell' (sell_chunk_spmv)
   within a stated bound of the ELL run; the 16-atom ring in f64 against
   scipy's DOP853 in complex128; (b) examples/heat_implicit.py's BDF at
   64^2 and Radau at 32^2 (dense LU on the card), the mode-1 decay within
   1e-4; (c) csgraph on the 2000^2 grid graph: connected_components,
   breadth_first_order and dijkstra from the corners against the closed
   form |di| + |dj|, twice bit for bit with their fetches; RCM of a
   permuted 256^2 Laplacian and splu(permc_spec='RCM') of it; (d) cdist
   at 16384^2 (k = 64, f32) against host f64 on sampled rows, the 6000^2
   operator's tobsr((2, 2)) against its CSR product, dok/lil round trips
   of 10^5 entries.

Each of the six paths (3, 5, 6, 7, 8, 9), each of phase 10's three
operators, phase 11 and each part of phases 12 and 13 runs with every
kernel's launch counter set to 0
just before it and read just after; each kernel of the path must have
launched. The
kernels line reports each kernel's launches summed over the paths that
run it.

The last lines are one JSON object listing the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Published peaks of the card this script has been run on (NVIDIA's data
# sheet, H100 SXM, dense, at the full 700 W power limit): bytes/s of HBM3 and
# float32 FLOP/s outside the tensor cores.
_PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def peaks(name: str):
    if name not in _PEAKS:
        raise RuntimeError(f"no published peak rates for {name!r}: add them to _PEAKS")
    return _PEAKS[name]


def laplacian_diagonals(nx: int, ny: int, dtype=np.float32):
    """examples/pde.py:40-56's diagonals of the 2-D Dirichlet Laplacian."""
    dx = 1.0 / (nx - 1)
    dy = 1.0 / (ny - 1)
    a, g = 1.0 / dx**2, 1.0 / dy**2
    c = -2.0 * a - 2.0 * g
    nxs, nys = nx - 2, ny - 2
    n = nxs * nys
    diag_a = np.full(n - 1, a, dtype=dtype)
    diag_a[nxs - 1 :: nxs] = 0.0
    diag_g = np.full(n - nxs, g, dtype=dtype)
    diag_c = np.full(n, c, dtype=dtype)
    return [diag_g, diag_a, diag_c, diag_a, diag_g], [-nxs, -1, 0, 1, nxs], n


def skewed_degree_csr(m: int, seed: int = 7):
    """bench.py's power-law-degree SPD matrix (scipy CSR, f32): pareto row
    degrees capped at m/20, symmetrized, diagonally dominant."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(1.2, m) * 4 + 1).astype(int), max(m // 20, 8))
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, m, rows.shape[0])
    vals = rng.random(rows.shape[0])
    G = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    A = (G + G.T) * 0.5
    A = A + sp.diags(np.asarray(np.abs(A).sum(axis=1)).ravel() + 1.0)
    return A.tocsr().astype(np.float32)


def powerlaw_csr(m: int, seed: int):
    """tests/test_sell_spmv.py's power-law profile with one near-dense row
    (scipy CSR, f64)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(1.0, m) * 3 + 1).astype(int), m - 1)
    deg[0] = m - 1
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, m, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0])
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()


def sell_edge_cases():
    """tests/test_torch_sell.py's awkward shapes (scipy CSR, f64)."""
    import scipy.sparse as sp

    return {
        "powerlaw": powerlaw_csr(300, 5),
        "empty_rows": sp.csr_matrix(
            (np.array([1.0, 2.0]), np.array([1, 3]), np.array([0, 0, 2, 2, 2, 2])), shape=(5, 4)
        ),
        "dup_cols": sp.csr_matrix(
            (np.array([1.0, 2.0, 4.0]), np.array([1, 1, 0]), np.array([0, 2, 3, 3])), shape=(3, 3)
        ),
        "random": sp.random(37, 29, density=0.25, random_state=np.random.default_rng(1),
                            format="csr"),
        "zero_nnz": sp.csr_matrix((7, 5)),
    }


def lane_values(A_s, lanes: int, seed: int):
    """The batched phase's value stack: lane b is A + d_b I, d_b in [0, 1)
    from the seed (the same pattern, still SPD), f32 ``[lanes, nnz]``."""
    m = A_s.shape[0]
    on_diag = A_s.indices == np.repeat(np.arange(m), np.diff(A_s.indptr))
    d = np.random.default_rng(seed).random(lanes).astype(np.float32)
    return A_s.data[None, :] + d[:, None] * on_diag[None, :].astype(np.float32)


def f64_residual(A64, x, b):
    """(||b - A x|| / ||b||, eps_f32 * || |A| |x| || / ||b||) in f64 on the
    host: the true relative residual and the f32 rounding floor under it.

    An f32 CG stops on its recursive residual; the true one drifts from it
    by rounding in every update of x and r, a random walk of about one
    floor per iteration. The general and batched phases hold a solve of k
    iterations to tol + sqrt(k) floors."""
    x = np.asarray(x, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    bn = float(np.linalg.norm(b))
    rel = float(np.linalg.norm(b - A64 @ x)) / bn
    floor = float(np.finfo(np.float32).eps) * float(np.linalg.norm(abs(A64) @ np.abs(x))) / bn
    return rel, floor


def cuda_ms(fn, reps: int, sync) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back runs, by CUDA events."""
    import torch

    fn()  # warm
    sync()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    sync()
    return start.elapsed_time(stop) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def spmv_cases():
    """tests/test_dia_spmv.py's shapes: square, wide, tall, single diagonal,
    multi-block with a ragged tail, a wide matrix past m_pad + B, and a band
    past the reference's pallas_max_band (8192), which the port's kernel
    takes like any other."""
    return [
        (50, 50, [-5, -1, 0, 1, 5]), (40, 60, [-3, 0, 2, 10]), (60, 40, [-7, 0, 1]),
        (7, 7, [0]), (300, 300, [-17, -1, 0, 1, 17]), (2500, 2500, [-70, -1, 0, 1, 70]),
        (100, 2000, [0, 5]), (20000, 20000, [-9000, -1, 0, 1, 9000]),
    ]


def spmv_err_bound(planes, xpad, plan):
    """Allowed |kernel - plain|: 4 * eps * sum_k |plane * x| per row (the two
    sum the same terms in the same order, so the expected error is 0; the
    bound admits one reordering)."""
    import torch

    mag = torch.zeros((plan.m_pad,), dtype=planes.dtype, device=planes.device)
    for k, o in enumerate(plan.offsets):
        sl = planes[k * plan.m_pad : (k + 1) * plan.m_pad]
        mag += (sl * xpad[plan.B + o : plan.B + o + plan.m_pad]).abs()
    return 4 * torch.finfo(planes.dtype).eps * mag


def check_dia_spmv(dev, lap):
    import torch
    from sparse_tpu_torch.kernels import dia_spmv as K

    print("phase 2a: DIA SpMV kernel vs plain", flush=True)
    rng = np.random.default_rng(0)
    cases = []
    for m, n, offs in spmv_cases():
        data = torch.tensor(rng.standard_normal((len(offs), n)).astype(np.float32), device=dev)
        cases.append((f"{m}x{n} offsets {offs}", data, offs, (m, n)))
    cases.append((f"{lap[2][0]}-row Laplacian", lap[0], lap[1], lap[2]))
    worst = 0.0
    for label, data, offs, shape in cases:
        plan = K.dia_plan(offs, shape)
        planes = K.dia_pack(data, plan)
        x = torch.tensor(rng.standard_normal(shape[1]).astype(np.float32), device=dev)
        xpad = K.dia_pad_x(x, plan)
        y = K.dia_spmv_packed(planes, xpad, plan)
        yp = K.dia_spmv_packed_plain(planes, xpad, plan)
        err = (y - yp).abs()
        check(bool(torch.all(err <= spmv_err_bound(planes, xpad, plan))),
              f"dia_spmv {label}: max |kernel - plain| = {float(err.max()):.3g}")
        if shape == lap[2]:
            worst = float(err.max())
    return worst


def _cg_start(K, data, offs, shape, dev, seed):
    """A CG state at the main path's shapes with nonzero p and rho_prev, so
    both kernels do their full arithmetic."""
    import torch
    from sparse_tpu_torch.kernels import dia_spmv as D

    m = shape[0]
    plan = D.dia_plan(offs, (m, data.shape[1]))
    planes = D.dia_pack(data, plan)
    rng = np.random.default_rng(seed)
    vec = lambda: K._pad_vec(torch.tensor(rng.standard_normal(m).astype(np.float32), device=dev), plan)
    x, r, p = vec(), vec(), vec()
    sc = torch.tensor([2.0, 1.5, 0.0, 0.0], dtype=torch.float32, device=dev)
    return plan, planes, x, r, p, sc


def check_cg_kernels(dev, lap):
    """Kernels A and B at the main path's shapes: one launch each from the
    same inputs (p_new, q, x, r equal bit for bit; the dots pq and <r, r>
    are sums in another order, held at 1e-5 relative to sum |terms|), then
    5 iterations from one start (the scalars' rounding differences
    propagate: held at 1e-4 of max |x|)."""
    import torch
    from sparse_tpu_torch.kernels import cg_dia as K

    print("phase 2b: fused CG kernels A and B vs plain", flush=True)
    data, offs, shape = lap
    plan, planes, x, r, p, sc = _cg_start(K, data, offs, shape, dev, seed=1)
    ws = K.CgWorkspace(plan, torch.float32, dev)
    B, mp = plan.B, plan.m_pad
    outs = {}
    for kind in ("kernel", "plain"):
        xs, rs, sck = x.clone(), r.clone(), sc.clone()
        pn, q = torch.zeros_like(p), torch.zeros_like(p)
        if kind == "kernel":
            K.cg_kernel_a(planes, rs, p, pn, q, sck, plan, ws)
            pq_after_a = sck[K.PQ].clone()
            K.cg_kernel_b(xs, rs, pn, q, sck, plan, ws)
        else:
            K.cg_kernel_a_plain(planes, rs, p, pn, q, sck, plan)
            pq_after_a = sck[K.PQ].clone()
            K.cg_kernel_b_plain(xs, rs, pn, q, sck, plan)
        outs[kind] = (pn, q, pq_after_a, xs, rs, sck)
    (pn, q, pq, xs, rs, sck), (pn0, q0, pq0, xs0, rs0, sck0) = outs["kernel"], outs["plain"]
    err_a = max(float((pn - pn0).abs().max()), float((q - q0).abs().max()))
    check(err_a == 0.0, f"kernel A p_new, q equal the plain version (max err {err_a})")
    mid = pn0[B : B + mp].double() * q0[B : B + mp].double()
    check(abs(float(pq) - float(pq0)) <= 1e-5 * float(mid.abs().sum()),
          f"kernel A <p_new, q> {float(pq):.9g} vs plain {float(pq0):.9g}")
    # kernel B from the same inputs and alpha: x, r exact
    xs1, rs1, sc1 = x.clone(), r.clone(), sck0.clone()
    xs2, rs2, sc2 = x.clone(), r.clone(), sck0.clone()
    K.cg_kernel_b(xs1, rs1, pn0, q0, sc1, plan, ws)
    K.cg_kernel_b_plain(xs2, rs2, pn0, q0, sc2, plan)
    err_b = max(float((xs1 - xs2).abs().max()), float((rs1 - rs2).abs().max()))
    check(err_b == 0.0, f"kernel B x, r equal the plain version (max err {err_b})")
    rr_mag = float((rs2[B : B + mp].double() ** 2).sum())
    check(abs(float(sc1[K.RHO]) - float(sc2[K.RHO])) <= 1e-5 * rr_mag,
          f"kernel B <r, r> {float(sc1[K.RHO]):.9g} vs plain {float(sc2[K.RHO]):.9g}")
    # five iterations of the fused solve from b = r
    m = shape[0]
    b = r[B : B + m].clone()
    xk = K.cg_dia_fused(data, offs, b, None, m, iters=5)[0].clone()
    xp_ = torch.zeros_like(x)
    rp_ = K._pad_vec(b, plan)
    scp = torch.zeros((4,), dtype=torch.float32, device=dev)
    scp[K.RHO] = torch.dot(rp_, rp_)
    pp_, pn_, q_ = torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(x)
    for _ in range(5):
        K.cg_kernel_a_plain(planes, rp_, pp_, pn_, q_, scp, plan)
        K.cg_kernel_b_plain(xp_, rp_, pn_, q_, scp, plan)
        pp_, pn_ = pn_, pp_
    xpl = xp_[B : B + m]
    err5 = float((xk - xpl).abs().max())
    check(err5 <= 1e-4 * float(xpl.abs().max()),
          f"5 fused iterations: max |kernel - plain| = {err5:.3g} (max |x| {float(xpl.abs().max()):.3g})")
    # repeatability: no float atomics, fixed reduction order
    x1 = K.cg_dia_fused(data, offs, b, None, m, iters=50)[0].clone()
    x2 = K.cg_dia_fused(data, offs, b, None, m, iters=50)[0].clone()
    check(bool(torch.equal(x1, x2)), "two 50-iteration fused solves give bit-identical x")
    return err_a, err_b, (plan, planes, x, r, p, sc, ws)


def hold_sell_chunks(label, ch, val, x, ws, lanes=None):
    """One product of a chunked SELL kernel against its plain version on the
    same inputs: equal bit for bit (the same products summed in the same
    order, fixed by the layout). ``lanes`` selects the batched kernel
    (``val`` [slots, B], x [B, n]); each of its lanes is then also held
    against the single-matrix kernel on that lane's values. Returns max
    |kernel - plain|."""
    import torch
    from sparse_tpu_torch.kernels import sell_spmv as S

    if lanes is None:
        got, want = S.sell_chunk_spmv(ch, val, x, ws), S.sell_chunk_spmv_plain(ch, val, x)
    else:
        got, want = (S.sell_chunk_spmv_batched(ch, val, x, ws),
                     S.sell_chunk_spmv_batched_plain(ch, val, x))
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: kernel differs from its plain version (max err {err:.3g})")
    if lanes is not None:
        ws1 = S.SellWorkspace(ch, val.dtype)
        for b in range(lanes):
            if not torch.equal(got[b], S.sell_chunk_spmv(ch, val[:, b].contiguous(), x[b], ws1)):
                raise AssertionError(f"{label}: batched lane {b} differs from the single-matrix kernel")
    return err


def chunk_pack_of(s, dev, dtype, itype, seg=None, with_src=False):
    """``sell_chunk_pack`` of scipy CSR ``s`` on ``dev`` with values at
    ``dtype`` and indices at ``itype``."""
    import torch
    from sparse_tpu_torch.kernels import sell_spmv as S

    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), device=dev).to(dt)  # noqa: E731
    return S.sell_chunk_pack(t(s.indptr), t(s.indices, itype),
                             None if dtype is None else t(s.data, dtype), s.shape, seg=seg,
                             with_src=with_src)


def check_sell_kernels(dev, A_s, lanes_s, lanes: int):
    """Phase 2c: both chunked SELL kernels against their plain versions, bit
    for bit, f32 and f64 values with int32 and int64 indices, on
    tests/test_torch_sell.py's edge cases (at the default segment and at 3
    slots, so that chunks split) with 3 batched lanes, and on the full-size
    packs of phases 5 and 6; the layout built from the reference's slab
    packs (``PreparedCSR.from_parts``, two geometries, one quantized to
    powers of two) gives the product of the layout built from CSR bit for
    bit; a dtype with no kernel must raise. Returns the max |kernel -
    plain| of each kernel on its full-size pack in f32."""
    import torch
    from sparse_tpu_torch.batch import BatchedCSR
    from sparse_tpu_torch.kernels import sell_spmv as S

    print("phase 2c: chunked SELL kernels vs plain", flush=True)
    rng = np.random.default_rng(2)
    combos = [(dt, it) for dt in (torch.float32, torch.float64) for it in (torch.int32, torch.int64)]
    for label, s in sell_edge_cases().items():
        held = 0
        for dt, it in combos:
            for seg in (3, None):
                ch = chunk_pack_of(s, dev, dt, it, seg=seg, with_src=True)
                x = torch.tensor(rng.standard_normal(s.shape[1]), dtype=dt, device=dev)
                tag = f"{label} {dt} {it} seg={ch.seg}"
                y = S.sell_chunk_spmv(ch, ch.val, x, S.SellWorkspace(ch, dt))
                hold_sell_chunks(tag, ch, ch.val, x, S.SellWorkspace(ch, dt))
                vals = ch.pack_values(torch.tensor(np.stack([s.data, 2 * s.data, -s.data]), dtype=dt,
                                                   device=dev))
                X = torch.tensor(rng.standard_normal((3, s.shape[1])), dtype=dt, device=dev)
                hold_sell_chunks(tag + " batched", ch, vals, X, S.SellWorkspace(ch, dt, 3), lanes=3)
                held += 2
                ref = s.astype(np.float64) @ x.double().cpu().numpy()
                tol = 1e-4 if dt == torch.float32 else 1e-12
                if not np.allclose(y.double().cpu().numpy(), ref, rtol=tol, atol=tol):
                    raise AssertionError(f"{tag}: sell_chunk_spmv differs from scipy")
        for C, sigma, max_slabs in ((8, 4096, 16), (4, 16, 3)):
            plan, slabs, pos = S.sell_pack(s.indptr, s.indices, s.data, s.shape, C=C, sigma=sigma,
                                           max_slabs=max_slabs, device=dev)
            prep = S.PreparedCSR.from_parts(plan, slabs, pos)
            direct = S.PreparedCSR(s.indptr, s.indices, s.data, s.shape, device=dev)
            x = torch.tensor(rng.standard_normal(s.shape[1]), device=dev)
            if (dev != "cpu" and prep.chunks is None) or not torch.equal(prep(x), direct(x)):
                raise AssertionError(f"{label}: from_parts (C={C}, sigma={sigma}) differs from the "
                                     f"layout packed from CSR")
        check(True, f"{label}: f32/f64 x int32/int64 x 2 segment lengths, {held} products (single and "
                    f"3 lanes) equal their plain versions bit for bit, batched lanes equal the single "
                    f"kernel; sell_chunk_spmv equals scipy; from_parts of 2 slab geometries equals "
                    f"the CSR-packed operator bit for bit")

    errs = {}
    print(f"  full-size pack of phase 5 (m = {A_s.shape[0]}, nnz = {A_s.nnz})", flush=True)
    for dt, it in combos:
        ch = chunk_pack_of(A_s, dev, dt, it)
        # signed x: the sums random-walk as a solver's do
        x = torch.randn((A_s.shape[1],), dtype=dt, device=dev)
        err = hold_sell_chunks(f"sell_chunk_spmv full size {dt} {it}", ch, ch.val, x,
                               S.SellWorkspace(ch, dt))
        check(True, f"sell_chunk_spmv full size {dt} {it}: {ch} equals its plain version bit for "
                    f"bit")
        if dt == torch.float32 and it == torch.int32:
            errs["sell_chunk_spmv"] = err
        del ch, x

    print(f"  full-size batched pack of phase 6 ({lanes} lanes, m = {lanes_s.shape[0]})", flush=True)
    values = torch.tensor(lane_values(lanes_s, lanes, seed=5), device=dev)
    for dt, it in combos:
        ch = chunk_pack_of(lanes_s, dev, None, it, with_src=True)
        vals = ch.pack_values(values.to(dt))
        X = torch.randn((lanes, lanes_s.shape[1]), dtype=dt, device=dev)
        tag = f"sell_chunk_spmv_batched full size {dt} {it}"
        err = hold_sell_chunks(tag, ch, vals, X, S.SellWorkspace(ch, dt, lanes), lanes=lanes)
        check(True, f"{tag}: {ch} equals its plain version bit for bit, each of {lanes} lanes the "
                    f"single-matrix kernel")
        if dt == torch.float32 and it == torch.int32:
            errs["sell_chunk_spmv_batched"] = err
        del ch, vals, X

    s = powerlaw_csr(60, 2).astype(np.complex64)
    prep = S.PreparedCSR(s.indptr, s.indices, s.data, s.shape, device=dev)
    bcx = BatchedCSR(s, torch.tensor(np.stack([s.data, s.data]), device=dev))
    for what, call in (("PreparedCSR", lambda: prep(torch.ones(60, dtype=torch.complex64, device=dev))),
                       ("BatchedCSR", lambda: bcx.matvec(torch.ones((2, 60), dtype=torch.complex64,
                                                                    device=dev)))):
        raised = raises_no_kernel(call)
        check("no CUDA kernel" in raised, f"a complex64 operand raises in {what}: {raised!r}")
    return errs


def raises_no_kernel(call) -> str:
    """The message of the TypeError ``call()`` raises ('' if it raises none)."""
    try:
        call()
    except TypeError as e:
        return str(e)
    return ""


def check_dia_direct(dev, grid: int):
    """Phase 2d: the column-indexed DIA SpMV against its plain version, bit
    for bit in f32 and f64, on tests/test_dia_spmv.py's cases, a wide
    matrix (100 x 2000) and the grid^2 Laplacian planes of phase 7; a
    dtype with no kernel must raise. Returns max |kernel - plain| at
    grid^2 in f32."""
    import torch
    from sparse_tpu_torch.kernels import cg_dia as C
    from sparse_tpu_torch.kernels import dia_spmv as D
    from sparse_tpu_torch.models import laplacian_2d_dia

    print("phase 2d: column-indexed DIA SpMV kernel vs plain", flush=True)
    rng = np.random.default_rng(4)
    cases = spmv_cases()[:5] + [(100, 2000, [0, 5])]
    worst = 0.0
    for dt in (torch.float32, torch.float64):
        for m, n, offs in cases:
            data = torch.tensor(rng.standard_normal((len(offs), n)), dtype=dt, device=dev)
            x = torch.tensor(rng.standard_normal(n), dtype=dt, device=dev)
            y, yp = D.dia_spmv_direct(data, offs, x, (m, n)), D.dia_spmv_direct_plain(data, offs, x, (m, n))
            if not torch.equal(y, yp):
                raise AssertionError(f"dia_spmv_direct {m}x{n} {offs} {dt}: max |kernel - plain| "
                                     f"{float((y - yp).abs().max()):.3g}")
        planes, offs = laplacian_2d_dia(grid, dtype=dt, device=dev)
        N = grid * grid
        x = torch.randn((N,), dtype=dt, device=dev)
        y, yp = D.dia_spmv_direct(planes, offs, x, (N, N)), D.dia_spmv_direct_plain(planes, offs, x, (N, N))
        err = float((y - yp).abs().max())
        check(bool(torch.equal(y, yp)),
              f"dia_spmv_direct {dt}: {len(cases)} edge cases and the {grid}^2 planes equal the plain "
              f"version bit for bit (max err {err})")
        if dt == torch.float32:
            worst = err
        del planes, x, y, yp
    for dt in (torch.complex64, torch.float16):
        data = torch.ones((3, 64), dtype=dt, device=dev)
        x = torch.ones(64, dtype=dt, device=dev)
        for what, call in (("dia_spmv_direct", lambda: D.dia_spmv_direct(data, (-1, 0, 1), x, (64, 64))),
                           ("cg_dia_fused_onepass",
                            lambda: C.cg_dia_fused_onepass(data, (-1, 0, 1), x, None, 64, iters=2))):
            msg = raises_no_kernel(call)
            check("no CUDA kernel" in msg, f"a {dt} operand raises in {what}: {msg!r}")
    return worst


def onepass_stepper(kernel, stream, packed, b, plan, ws=None):
    """One-pass CG from x0 = 0 on the packed planes, as
    ``cg_dia_fused_onepass`` sets it up (r0 = b, w0 = A r0 by the plain
    SpMV, rho_prev = 0, alpha_prev = 1, p = s = 0): each call of the
    returned function runs one iteration of ``kernel`` (``cgcg_kernel``
    with ``ws``, or ``cgcg_kernel_plain``) on the ``stream`` planes and
    swaps the r, w, s buffers, so repeated calls run the recurrence. x is
    the function's ``x`` attribute."""
    import torch
    from sparse_tpu_torch.kernels import cg_dia as C
    from sparse_tpu_torch.kernels import dia_spmv as D

    r0 = C._pad_vec(b, plan)
    w0 = C._pad_vec(D.dia_spmv_packed_plain(packed, r0, plan), plan)
    sc = torch.zeros((4,), dtype=b.dtype, device=b.device)
    sc[C.RHO], sc[C.MU], sc[C.ALPHA_PREV] = torch.dot(r0, r0), torch.dot(w0, r0), 1
    r, w = [r0, torch.zeros_like(r0)], [w0, torch.zeros_like(r0)]
    s = [torch.zeros_like(r0), torch.zeros_like(r0)]
    p, x = torch.zeros_like(r0), torch.zeros_like(r0)
    extra = () if ws is None else (ws,)

    def step():
        kernel(stream, r[0], w[0], s[0], p, x, r[1], w[1], s[1], sc, plan, *extra)
        r.reverse(), w.reverse(), s.reverse()

    step.x = x
    return step


def laplacian_3d_dia(n: int, dev, dtype=None):
    """The 7-point Dirichlet Laplacian on an n^3 grid (diagonal 6, -1 to
    each neighbour) as scipy-layout DIA planes [7, n^3] (``data[k, j] =
    A[j - o_k, j]``) and offsets (-n^2, -n, -1, 0, 1, n, n^2), built on
    the device."""
    import torch

    dtype = dtype or torch.float32
    N = n**3
    c = torch.arange(N, device=dev)
    i, j, k = c % n, (c // n) % n, c // (n * n)
    offsets = (-n * n, -n, -1, 0, 1, n, n * n)
    # column c of plane o couples row c - o: a neighbour inside the grid
    valid = {-n * n: k < n - 1, -n: j < n - 1, -1: i < n - 1, 1: i > 0, n: j > 0, n * n: k > 0}
    data = torch.stack([torch.full((N,), 6.0, dtype=dtype, device=dev) if o == 0 else
                        torch.where(valid[o], -1.0, 0.0).to(dtype) for o in offsets])
    return data, offsets


def hold_cgcg_launch(label, kernel, stream, plan, ws, kt, dev, seed=5, **kw):
    """One launch of ``kernel(..., plan, ws, **kw)`` (a one-pass wrapper)
    from a random state against ``cgcg_kernel_plain``: p, x, r', w' and s'
    bit for bit (the same elementwise operations, the scalars formed the
    same way), one launch counted, rho_prev and alpha_prev equal, and
    the dots <r', r'> and <w', r'>, which sum in other orders, within (kt +
    20) u S of the sum in f64 (u = eps / 2, S = sum |terms|): kt terms a
    thread in sequence, a 256-lane tree, the last block's 256 threads over
    at most 5 block partials each and a 256-lane tree. Returns (max
    |kernel - plain| over the vectors, r's interior rows)."""
    import torch
    from sparse_tpu_torch.kernels import cg_dia as C

    dt = ws.partials.dtype
    N, B, mp = plan.m, plan.B, plan.m_pad
    gen = torch.Generator(device=dev).manual_seed(seed)
    vec = lambda: C._pad_vec(torch.randn((N,), dtype=dt, device=dev, generator=gen), plan)  # noqa: E731
    r, w, s, p, x = vec(), vec(), vec(), vec(), vec()
    sc = torch.tensor([2.0, 1.5, 0.7, 0.9], dtype=dt, device=dev)
    outs = []
    for fn in (kernel, C.cgcg_kernel_plain):
        pk, xk, sck = p.clone(), x.clone(), sc.clone()
        ro, wo, so = torch.zeros_like(r), torch.zeros_like(r), torch.zeros_like(r)
        if fn is kernel:
            before = kernel.launches
            fn(stream, r, w, s, pk, xk, ro, wo, so, sck, plan, ws, **kw)
            if dev == "cuda" and kernel.launches != before + 1:
                raise AssertionError(f"{label}: {kernel.__name__} did not count one launch")
        else:
            fn(stream, r, w, s, pk, xk, ro, wo, so, sck, plan)
        outs.append((pk, xk, ro, wo, so, sck))
    err = max(float((a - b).abs().max()) for a, b in zip(outs[0][:5], outs[1][:5]))
    check(all(torch.equal(a, b) for a, b in zip(outs[0][:5], outs[1][:5])),
          f"{label}: p, x, r', w', s' equal the plain version bit for bit")
    (_, _, ro, wo, _, scp), sck = outs[1], outs[0][5]
    rm, wm = ro[B : B + mp].double(), wo[B : B + mp].double()
    u = torch.finfo(dt).eps / 2
    for slot, name, terms in ((C.RHO, "<r', r'>", rm * rm), (C.MU, "<w', r'>", wm * rm)):
        exact, S = float(terms.sum()), float(terms.abs().sum())
        dk, dp = abs(float(sck[slot]) - exact), abs(float(scp[slot]) - exact)
        check(dk <= (kt + 20) * u * S,
              f"{label} {name}: |kernel - f64| = {dk / (u * S):.3g} u S <= (kt + 20) u S, kt = {kt} "
              f"(plain: {dp / (u * S):.3g} u S; |kernel - plain| "
              f"{abs(float(sck[slot]) - float(scp[slot])):.3g})")
        del terms
    check(bool(torch.equal(sck[[C.RHO_PREV, C.ALPHA_PREV]], scp[[C.RHO_PREV, C.ALPHA_PREV]])),
          f"{label}: rho_prev and alpha_prev equal the plain version")
    return err, r[B : B + N].clone()


def window_kt(ws, stream, dev):
    """kt of the windowed kernel's dots (its geometry on the card; the plain
    version sums with torch's dot on the CPU)."""
    if dev != "cuda":
        return 1
    return ws.window(stream.dtype)[0].terms_per_thread


def show_window(geo, tag):
    print(f"  window ({tag}): schedule {geo.schedule!r}, lo {geo.lo}, hi {geo.hi}, "
          f"{geo.shared_bytes} B of shared memory of {geo.smem_per_block}, {geo.nblocks} blocks "
          f"over {geo.ntiles} tiles ({geo.rows_per_block} rows a block), "
          f"{geo.terms_per_thread} dot terms a thread", flush=True)


def check_cgcg_kernel(dev, grid: int, wide_n: int):
    """Phase 2e: the one-pass CG kernels. The windowed kernel at the grid^2
    Laplacian of phase 8, one launch from the same random state for f32,
    bf16 and f64 planes (the f32 vectors' schedule with its cp.async
    staging area, the f64 one without), held by :func:`hold_cgcg_launch`
    with kt its geometry's terms a thread. The wide kernel the same way on
    the 3-D Laplacian at wide_n^3, whose window exceeds a block's shared
    memory (there the windowed wrapper must refuse and ``cgcg_iteration``
    choose the wide kernel).
    Then 20 iterations of ``cg_dia_fused_onepass`` against the plain loop
    (x within 1e-4 of max |x|: the dots' last-bit differences move alpha
    and beta), two such solves equal bit for bit, f32 and bf16 planes giving
    the same x bit for bit (the Laplacian's values are exact in bf16), for
    the two-pass iteration too. Returns (max vector |kernel - plain| in f32
    for the windowed and the wide kernel, the timing states)."""
    import torch
    from sparse_tpu_torch.kernels import cg_dia as C
    from sparse_tpu_torch.kernels import dia_spmv as D
    from sparse_tpu_torch.models import laplacian_2d_dia

    print("phase 2e: one-pass CG kernels vs plain", flush=True)
    N = grid * grid
    worst, keep = 0.0, None
    for dt, pdt in ((torch.float32, None), (torch.float32, torch.bfloat16), (torch.float64, None)):
        planes, offs = laplacian_2d_dia(grid, dtype=dt, device=dev)
        plan = D.dia_plan(offs, (N, N))
        packed = D.dia_pack(planes, plan)
        del planes
        stream = packed if pdt is None else packed.to(pdt)
        ws = C.CgWorkspace(plan, dt, dev)
        tag = f"{dt} vectors, {pdt or dt} planes"
        if dev == "cuda":
            geo = ws.window(stream.dtype)[0]
            show_window(geo, tag)
            check(geo.windowed, f"the {grid}^2 window fits a block's shared memory and a block "
                                f"owns {C.WINDOW_MIN_RATIO} spans of rows or more ({tag})")
        err, b = hold_cgcg_launch(f"cgcg_kernel ({tag})", C.cgcg_kernel, stream, plan, ws,
                                  window_kt(ws, stream, dev), dev)
        if dt == torch.float32 and pdt is None:
            worst, keep = err, (plan, packed, b, ws)
        del packed, stream
    # the wide kernel, on a band past the window's capacity
    planes3, offs3 = laplacian_3d_dia(wide_n, dev)
    N3 = wide_n**3
    plan3 = D.dia_plan(offs3, (N3, N3))
    packed3 = D.dia_pack(planes3, plan3)
    ws3 = C.CgWorkspace(plan3, torch.float32, dev)
    if dev == "cuda":
        geo3 = ws3.window(packed3.dtype)[0]
        check(not geo3.fits, f"the {wide_n}^3 Laplacian's window ({geo3.shared_bytes} B) exceeds a "
                             f"block's shared memory ({geo3.smem_per_block} B)")
        z = torch.zeros(plan3.m_pad + 2 * plan3.B, device=dev)
        try:
            C.cgcg_kernel(packed3, z, z, z, z, z, z, z, z, torch.zeros(4, device=dev), plan3, ws3)
            refused = ""
        except ValueError as e:
            refused = str(e)
        check("cgcg_kernel_wide takes this band" in refused,
              f"the windowed wrapper refuses that band: {refused!r}")
        del z
    kt3 = -(-plan3.m_pad // (ws3.nblocks * 256))  # the grid-stride loop's rows a thread
    worst_wide, b3 = hold_cgcg_launch(f"cgcg_kernel_wide (float32, {wide_n}^3)", C.cgcg_kernel_wide,
                                      packed3, plan3, ws3, kt3, dev)
    keep_wide = (plan3, packed3, b3, ws3)
    del planes3
    # 20 iterations, kernel against the plain loop, from b = r's rows
    plan, packed, b = keep[0], keep[1], keep[2]
    B, mp = plan.B, plan.m_pad
    planes, offs = laplacian_2d_dia(grid, dtype=torch.float32, device=dev)
    xk = C.cg_dia_fused_onepass(planes, offs, b, None, N, iters=20)[0].clone()
    xk2 = C.cg_dia_fused_onepass(planes, offs, b, None, N, iters=20)[0]
    check(bool(torch.equal(xk, xk2)), "two 20-iteration one-pass solves give x bit for bit")
    step = onepass_stepper(C.cgcg_kernel_plain, packed, packed, b, plan)
    for _ in range(20):
        step()
    xpl = step.x[B : B + N]
    err20 = float((xk - xpl).abs().max())
    check(err20 <= 1e-4 * float(xpl.abs().max()),
          f"20 one-pass iterations: max |kernel - plain| = {err20:.3g} (max |x| "
          f"{float(xpl.abs().max()):.3g}; bound 1e-4 of it)")
    del step, xk2
    for fn, label in ((C.cg_dia_fused_onepass, "one-pass"), (C.cg_dia_fused, "two-pass")):
        x32 = fn(planes, offs, b, None, N, iters=20)[0].clone()
        xbf = fn(planes, offs, b, None, N, iters=20, plane_dtype=torch.bfloat16)[0]
        check(bool(torch.equal(x32, xbf)), f"{label}: 20 iterations with bf16 planes give x equal "
                                           f"to f32 planes bit for bit")
    del planes, x32, xbf
    return worst, worst_wide, keep, keep_wide


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def main_path(dev, grid: int, small_grid: int):
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import linalg
    from sparse_tpu_torch.ops.dia_spmv import dia_spmv_torch

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    out = {}
    print(f"phase 3: main path at {grid}^2 (float32)", flush=True)
    diagonals, offsets, n = laplacian_diagonals(grid + 2, grid + 2)
    t0 = time.perf_counter()
    A = sparse.diags(diagonals, offsets, shape=(n, n), dtype=np.float32, device=dev).tocsc().T
    A = A.tocsr()
    sync()
    out["build_s"] = time.perf_counter() - t0
    print(f"  matrix construction: {out['build_s']:.3f} s, {A}", flush=True)
    check(A.nnz == sum(int((d != 0).sum()) for d in diagonals), "nnz matches the diagonals")

    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    y = A @ ones
    sync()
    out["first_spmv_s"] = time.perf_counter() - t0
    check(tuple(y.shape) == (n,) and bool(torch.isfinite(y).all()), "A @ ones: finite, shape (n,)")
    rows = np.unique(np.concatenate([
        np.random.default_rng(7).choice(n, min(4096, n), replace=False), [0, 1, n - 2, n - 1]
    ]))
    y_rows = y[torch.as_tensor(rows, device=dev)].double().cpu().numpy()
    ref, mag = banded_rows(diagonals, offsets, rows, np.ones(n), transpose=False)
    err = np.abs(y_rows - ref)
    check(bool(np.all(err <= 8 * np.finfo(np.float32).eps * mag)),
          f"A @ ones vs host f64 reference on {len(rows)} sampled rows "
          f"(max err {err.max():.3g}, bound 8 eps sum|a_ij|)")

    b = torch.ones((n,), dtype=torch.float32, device=dev)
    xs = []
    for rep in range(2):
        sync()
        t0 = time.perf_counter()
        x, iters = linalg.cg(A, b, maxiter=300, conv_test_iters=10**9)
        sync()
        dt = time.perf_counter() - t0
        xs.append(x.clone())
        print(f"  throughput cg run {rep}: {iters} iterations in {dt:.4f} s", flush=True)
    out["cg_iters"] = iters
    out["cg_s"] = dt
    check(iters == 300 and tuple(x.shape) == (n,) and bool(torch.isfinite(x).all()),
          "cg(maxiter=300): 300 iterations, finite x of shape (n,)")
    check(bool(torch.equal(xs[0], xs[1])), "two throughput solves give bit-identical x")
    # reference: the plain-torch CG loop (fused path off) for 20 iterations
    x20 = linalg.cg(A, b, maxiter=20, conv_test_iters=10**9)[0].clone()
    fused, sparse.settings.fused_cg = sparse.settings.fused_cg, False
    try:
        x20_plain = linalg.cg(A, b, maxiter=20, conv_test_iters=10**9)[0]
    finally:
        sparse.settings.fused_cg = fused
    err20 = float((x20 - x20_plain).abs().max())
    check(err20 <= 1e-3 * float(x20_plain.abs().max()),
          f"20 fused iterations vs the plain torch CG loop: max |diff| {err20:.3g} "
          f"(max |x| {float(x20_plain.abs().max()):.3g}; bound 1e-3 of it, f32 dots in another order)")
    # pde.py's operator is negative definite: CG on it minimizes
    # phi(x) = b.x - x.Ax / 2 (that of -A x = -b), which starts at 0 and
    # must fall monotonically; the residual norm need not
    planes, offs = A._maybe_dia()
    data64 = planes.double()

    def phi(v):
        v = v.double()
        return float(b.double() @ v - 0.5 * (v @ dia_spmv_torch(data64, offs, v, (n, n))))

    phi20, phi300 = phi(x20), phi(x)
    check(phi300 < phi20 < 0.0, f"CG energy falls: phi(x_20) = {phi20:.6g}, phi(x_300) = {phi300:.6g}")
    res = b.double() - dia_spmv_torch(data64, offs, x.double(), (n, n))
    out["cg_rel_residual"] = float(torch.linalg.vector_norm(res) / torch.linalg.vector_norm(b.double()))
    print(f"  ||b - A x_300|| / ||b|| = {out['cg_rel_residual']:.4g}", flush=True)
    del data64, res

    print(f"  tolerance-driven cg at {small_grid}^2", flush=True)
    diag_s, offs_s, ns = laplacian_diagonals(small_grid + 2, small_grid + 2)
    As = sparse.diags(diag_s, offs_s, shape=(ns, ns), dtype=np.float32, device=dev).tocsc().T.tocsr()
    gx = np.linspace(0.0, 1.0, small_grid + 2)
    gy = np.linspace(-0.5, 0.5, small_grid + 2)
    X, Y = np.meshgrid(gx, gy, indexing="ij")
    rhs = np.sin(np.pi * X) * np.cos(np.pi * Y) + np.sin(5 * np.pi * X) * np.cos(5 * np.pi * Y)
    bs_np = rhs[1:-1, 1:-1].flatten("F")
    bs = torch.tensor(bs_np.astype(np.float32), device=dev)
    tol = 1e-4 * float(np.linalg.norm(bs_np))
    sync()
    t0 = time.perf_counter()
    xs_, it_s = linalg.cg(As, bs, tol=tol, maxiter=20000, conv_test_iters=25)
    sync()
    out["small_cg_s"] = time.perf_counter() - t0
    out["small_cg_iters"] = it_s
    # true residual in f64 on the host. pde.py's operator has entries
    # ~1/h^2 = 1e6, so in f32 the residual cannot fall below the rounding
    # floor eps * || |A| |x| || (~3e-2 of ||b|| here): held at the
    # tolerance plus 2x that floor
    data_s = As._maybe_dia()[0].double().cpu()
    offs_s = As._maybe_dia()[1]
    x64 = xs_.double().cpu()
    b64 = torch.tensor(bs_np)
    res_s = b64 - dia_spmv_torch(data_s, offs_s, x64, (ns, ns))
    floor = float(np.finfo(np.float32).eps) * float(
        torch.linalg.vector_norm(dia_spmv_torch(data_s.abs(), offs_s, x64.abs(), (ns, ns)))
    ) / float(np.linalg.norm(bs_np))
    rel_s = float(torch.linalg.vector_norm(res_s)) / float(np.linalg.norm(bs_np))
    out["small_rel_residual"] = rel_s
    out["small_f32_floor"] = floor
    print(f"  {it_s} iterations in {out['small_cg_s']:.4f} s", flush=True)
    check(it_s < 20000, f"cg at {small_grid}^2 stops on tol = 1e-4 ||b|| after {it_s} iterations")
    check(rel_s <= 1e-4 + 2 * floor,
          f"true residual ||b - Ax|| / ||b|| = {rel_s:.3g} (f64, host) <= 1e-4 + 2 x the f32 "
          f"rounding floor {floor:.3g}")
    # the right-hand side is two eigenvectors of the discrete Laplacian, so
    # the exact solution is known in closed form: hold x against it in f64
    h = 1.0 / (small_grid + 1)
    lam = lambda k: 2 * (2 * np.cos(k * np.pi * h) - 2) / h**2
    X1, Y1 = X[1:-1, 1:-1], Y[1:-1, 1:-1]
    x_ref = (np.sin(np.pi * X1) * np.cos(np.pi * Y1) / lam(1)
             + np.sin(5 * np.pi * X1) * np.cos(5 * np.pi * Y1) / lam(5)).flatten("F")
    fwd = float(np.linalg.norm(x64.numpy() - x_ref) / np.linalg.norm(x_ref))
    out["small_rel_error"] = fwd
    check(fwd < 1e-3, f"x vs the closed-form f64 solution: relative error {fwd:.3g} (bound 1e-3)")
    return A, out


# ---------------------------------------------------------------------------
# phase 5: the general (non-banded) path
# ---------------------------------------------------------------------------
def general_path(dev, A_s):
    """bench.py::run_skewed_cg's shape under the default spmv_mode 'auto':
    the skewed matrix skips the DIA branch and the ELL gate and takes the
    prepared SELL operator. A @ x against scipy in f64 on sampled rows, a
    100-iteration throughput CG, a tolerance CG (1e-6 ||b||) whose true
    residual is held in f64 on the host."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import linalg, plan_cache

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    m = A_s.shape[0]
    deg = np.diff(A_s.indptr)
    out = {"m": m, "nnz": int(A_s.nnz), "max_deg": int(deg.max())}
    print(f"phase 5: general path at skewed_degree_csr({m}) (float32, nnz {A_s.nnz}, max degree "
          f"{out['max_deg']}, spmv_mode {sparse.settings.spmv_mode!r})", flush=True)
    t0 = time.perf_counter()
    A = sparse.csr_array(A_s, device=dev)
    sync()
    out["build_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    x_np = rng.standard_normal(m).astype(np.float32)
    x = torch.tensor(x_np, device=dev)
    t0 = time.perf_counter()
    y = A @ x
    sync()
    out["first_spmv_s"] = time.perf_counter() - t0
    print(f"  to the card {out['build_s']:.3f} s; first A @ x (banded test, ELL gate, chunk "
          f"pack on the card, launch) {out['first_spmv_s']:.3f} s", flush=True)
    prep = plan_cache.lookup(A, "sell")
    check(prep is not None and A._maybe_dia() is None and (dev == "cpu" or prep.chunks is not None),
          "'auto' routed the skewed matrix past DIA to the prepared SELL operator")
    ch = prep.chunks
    if ch is not None:
        out.update(chunks=ch.nchunks, stored_slots=ch.slots, pad_ratio=ch.pad_ratio,
                   work_items=ch.nwork, partial_rows=ch.npart, segment=ch.seg)
        print(f"  {ch}; widest chunk {int((ch.cptr[1] - ch.cptr[0]) // 32)} slots a row",
              flush=True)
        from sparse_tpu_torch.kernels import sell_spmv as S

        before = S.sell_chunk_spmv.launches
        y2 = A @ x
        check(S.sell_chunk_spmv.launches == before + 1 and bool(torch.equal(y2, y)),
              "a second A @ x is one launch and gives y bit for bit")
        del y2
    check(tuple(y.shape) == (m,) and bool(torch.isfinite(y).all()), "A @ x: finite, shape (m,)")
    rows = np.unique(np.concatenate([rng.choice(m, min(4096, m), replace=False),
                                     [0, m - 1, int(deg.argmax())]]))
    sub = A_s[rows].astype(np.float64)
    want = sub @ x_np.astype(np.float64)
    mag = abs(sub) @ np.abs(x_np).astype(np.float64)
    err = np.abs(y[torch.as_tensor(rows, device=dev)].double().cpu().numpy() - want)
    check(bool(np.all(err <= (deg[rows] + 2) * np.finfo(np.float32).eps * mag)),
          f"A @ x vs scipy in f64 on {len(rows)} sampled rows, the widest included "
          f"(max err {err.max():.3g}, bound (row length + 2) eps sum |a_ij x_j|)")

    b_np = np.random.default_rng(3).standard_normal(m).astype(np.float32)
    b = torch.tensor(b_np, device=dev)
    for rep in range(2):  # run 0 warms
        sync()
        t0 = time.perf_counter()
        xt, it = linalg.cg(A, b, maxiter=100, tol=1e-30, conv_test_iters=200)
        sync()
        dt = time.perf_counter() - t0
        print(f"  throughput cg run {rep}: {it} iterations in {dt:.4f} s", flush=True)
    out["cg_iters_per_s"] = it / dt
    check(it == 100 and bool(torch.isfinite(xt).all()),
          "cg(maxiter=100, tol=1e-30): 100 iterations, finite x")

    A64 = A_s.astype(np.float64)
    tol = 1e-6 * float(np.linalg.norm(b_np.astype(np.float64)))
    sync()
    t0 = time.perf_counter()
    xs, its = linalg.cg(A, b, tol=tol, maxiter=5000)
    sync()
    out["tol_cg_s"], out["tol_cg_iters"] = time.perf_counter() - t0, its
    rel, floor = f64_residual(A64, xs.cpu().numpy(), b_np)
    out["tol_cg_rel_residual"], out["tol_cg_f32_floor"] = rel, floor
    print(f"  tolerance cg: {its} iterations in {out['tol_cg_s']:.4f} s", flush=True)
    check(its < 5000, f"cg stops on tol = 1e-6 ||b|| after {its} iterations")
    check(rel <= 1e-6 + np.sqrt(its) * floor,
          f"true residual ||b - Ax|| / ||b|| = {rel:.3g} (f64, host) <= 1e-6 + sqrt({its}) x the "
          f"f32 rounding floor {floor:.3g}")
    return A, prep, out


# ---------------------------------------------------------------------------
# phase 6: batched Krylov over one pattern
# ---------------------------------------------------------------------------
def batched_path(dev, A_s, lanes: int):
    """``lanes`` SPD systems A + d_b I over skewed_degree_csr's pattern
    through batched_cg (the batched SELL kernel) with per-lane tolerances
    between 1e-4 and 1e-6 of ||b_b||, f32: every lane converges, its true
    residual holds in f64, and its iteration count and x equal those of
    ``linalg.cg`` on the lane alone; a batch of one equals ``linalg.cg``.
    Solves/s against the lanes solved one after another."""
    import scipy.sparse as sp
    import torch
    from sparse_tpu_torch import linalg
    from sparse_tpu_torch.batch import BatchedCSR, SparsityPattern, batched_cg

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    m = A_s.shape[0]
    print(f"phase 6: batched_cg, {lanes} lanes over skewed_degree_csr({m}) (float32, nnz "
          f"{A_s.nnz} per lane)", flush=True)
    pattern = SparsityPattern.from_csr(A_s)
    vals = lane_values(A_s, lanes, seed=5)
    bc = BatchedCSR(pattern, torch.tensor(vals, device=dev))
    rng = np.random.default_rng(6)
    b_np = rng.standard_normal((lanes, m)).astype(np.float32)
    rel_tol = 10.0 ** (-4 - 2 * rng.random(lanes))
    tol_np = (rel_tol * np.linalg.norm(b_np.astype(np.float64), axis=1)).astype(np.float32)
    b = torch.tensor(b_np, device=dev)
    maxiter = 2000
    out = {"lanes": lanes, "m": m, "nnz": int(A_s.nnz)}
    t = []
    for rep in range(2):  # run 0 packs the pattern and the values
        sync()
        t0 = time.perf_counter()
        X, info = batched_cg(bc, b, tol=tol_np, maxiter=maxiter)
        sync()
        t.append(time.perf_counter() - t0)
    out["first_batched_s"], out["batched_s"] = t
    iters = info.iters.cpu().numpy()
    print(f"  batched_cg: {t[1]:.4f} s ({t[0]:.4f} s with the packs); lane iterations "
          f"{iters.min()}..{iters.max()}", flush=True)
    check(bool(info.converged.all()), f"all {lanes} lanes converged")
    Xh = X.cpu().numpy()
    worst = 0.0
    for i in range(lanes):
        Ai = sp.csr_matrix((vals[i].astype(np.float64), A_s.indices, A_s.indptr), shape=A_s.shape)
        rel, floor = f64_residual(Ai, Xh[i], b_np[i])
        bound = rel_tol[i] + np.sqrt(iters[i]) * floor
        if rel > bound:
            raise AssertionError(f"lane {i}: true residual {rel:.3g} > tol {rel_tol[i]:.3g} + "
                                 f"sqrt({iters[i]}) x floor {floor:.3g}")
        worst = max(worst, rel / bound)
    check(True, f"every lane's true residual (f64, host) <= its tol + sqrt(iterations) x the f32 "
                f"floor (worst lane at {worst:.3f} of its bound)")

    # the lanes one after another; each lane's SELL pack is set-up, not timed
    seq_s, mism, differ = 0.0, [], []
    for i in range(lanes):
        Ai = bc.lane(i)
        Ai @ b[i]
        sync()
        t0 = time.perf_counter()
        xu, iu = linalg.cg(Ai, b[i], tol=float(tol_np[i]), maxiter=maxiter)
        sync()
        seq_s += time.perf_counter() - t0
        if iu != int(iters[i]):
            mism.append((i, int(iters[i]), iu))
        if not torch.equal(X[i], xu):
            differ.append(i)
        if i == 0:
            x0u, i0u = xu, iu
        del Ai
    out["sequential_s"] = seq_s
    # each lane's SpMV sums and dot products equal the lone solve's bit for
    # bit; CG on this matrix amplifies any last-bit difference after its
    # first ~75 iterations, so anything less would move iteration counts
    check(not mism and not differ,
          f"every lane takes linalg.cg's iteration count on that lane and its x bit for bit "
          f"(count mismatches (lane, batched, alone): {mism}; x differs on lanes {differ})")
    X1, info1 = batched_cg(BatchedCSR(pattern, bc.values[:1]), b[:1], tol=tol_np[:1],
                           maxiter=maxiter)
    check(int(info1.iters[0]) == i0u and bool(torch.equal(X1[0], x0u)),
          f"B = 1: batched_cg equals linalg.cg bit for bit ({i0u} iterations)")
    if dev != "cpu":
        from sparse_tpu_torch.kernels import sell_spmv as S

        before = S.sell_chunk_spmv_batched.launches
        bc.matvec(b)
        check(S.sell_chunk_spmv_batched.launches == before + 1,
              f"one batched product over {lanes} lanes is one launch")
    out["batched_solves_per_s"] = lanes / t[1]
    out["sequential_solves_per_s"] = lanes / seq_s
    print(f"  {out['batched_solves_per_s']:.2f} solves/s batched vs "
          f"{out['sequential_solves_per_s']:.2f} solves/s one lane after another", flush=True)
    return bc, X, out


# ---------------------------------------------------------------------------
# phases 7 and 8: the flagship Poisson step and run_fused's sweep
# ---------------------------------------------------------------------------
def dia_residual(planes, offsets, x, b) -> float:
    """||b - A x|| / ||b|| in f64 (A from its DIA planes), on the card."""
    import torch
    from sparse_tpu_torch.ops.dia_spmv import dia_spmv_torch

    N = b.shape[0]
    b64 = b.double()
    res = b64 - dia_spmv_torch(planes.double(), offsets, x.double(), (N, N))
    return float(torch.linalg.vector_norm(res) / torch.linalg.vector_norm(b64))


def flagship_path(dev, grid: int, small: int, iters: int):
    """``__graft_entry__.entry()``'s flagship step, the port of
    models/poisson.py: ``poisson_cg_state_dia(n)`` and ``iters`` steps of
    ``cg_dia``, whose SpMV is the column-indexed DIA kernel, with every
    implicit host sync an error. At ``small`` (the entry point's size) the
    first 20 iterations are held against the same step on the CPU (1e-4 of
    max |x|: dots in another order) and the true residual after ``iters``
    must fall below 1e-3; at ``grid`` rho and the true residual (f64) must
    be finite and the residual below 1e-4 (``run`` then holds it within
    10x of phase 8's two-pass residual on the same b). Returns the
    measurements."""
    import torch
    from sparse_tpu_torch.models import cg_dia, poisson_cg_state_dia

    sync = torch.cuda.synchronize
    out = {}
    print(f"phase 7: flagship Poisson step (models.poisson.cg_dia) at {small}^2 and {grid}^2, "
          f"{iters} iterations, float32", flush=True)
    for n in (small, grid):
        t0 = time.perf_counter()
        (planes, x0, b, p0, rho0), step = poisson_cg_state_dia(n, device=dev)
        sync()
        build_s = time.perf_counter() - t0
        offsets = (-n, -1, 0, 1, n)
        cg_dia(step, planes, x0, b, p0, rho0, iters=2)  # first launches
        sync()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            x, r, p, rho = cg_dia(step, planes, x0, b, p0, rho0, iters=iters)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sync()
        secs = time.perf_counter() - t0
        rho_f = float(rho)
        rel = dia_residual(planes, offsets, x, b)
        tag = f"{n}^2"
        out[tag] = dict(build_s=build_s, iters=iters, s=secs, iters_per_s=iters / secs, rho=rho_f,
                        rel_residual=rel)
        print(f"  {tag}: state built in {build_s:.3f} s; {iters} iterations in {secs:.4f} s "
              f"({iters / secs:.2f} iters/s, {secs / iters * 1e3:.4f} ms an iteration); rho "
              f"{rho_f:.6g}; true ||b - A x|| / ||b|| = {rel:.4g} (f64)", flush=True)
        check(np.isfinite(rho_f) and np.isfinite(rel) and tuple(x.shape) == (n * n,),
              f"{tag}: {iters} steps with no host sync inside the loop; finite rho and x of shape "
              f"({n * n},)")
        if n == small:
            xc = cg_dia(step, planes.cpu(), x0.cpu(), b.cpu(), p0.cpu(), rho0.cpu(), iters=20)[0]
            xg = cg_dia(step, planes, x0, b, p0, rho0, iters=20)[0].cpu()
            err = float((xg - xc).abs().max())
            check(err <= 1e-4 * float(xc.abs().max()),
                  f"{tag}: 20 steps on the card vs on the CPU: max |diff| {err:.3g} (max |x| "
                  f"{float(xc.abs().max()):.3g}; bound 1e-4 of it)")
            check(rel < 1e-3, f"{tag}: the true residual after {iters} steps, {rel:.3g}, is below 1e-3")
        else:
            check(rel < 1e-4, f"{tag}: the true residual after {iters} steps, {rel:.4g}, is below "
                              f"1e-4")
        del planes, x0, b, p0, x, r, p
    return out


def fused_sweep(dev, grid: int, iters: int):
    """bench.py::run_fused at grid^2: the variants two-pass and one-pass,
    f32 and bf16 planes (tried only when the planes are exact in bf16),
    each run once as a warm-up whose final rho must be finite and at most
    10x the two-pass rho, then timed best of 3 (one call each: pack, setup
    and ``iters`` iterations, ended by reading rho). The true residual of
    each variant's x in f64 is reported."""
    import torch
    from sparse_tpu_torch.kernels import cg_dia as C
    from sparse_tpu_torch.models import poisson_cg_state_dia

    print(f"phase 8: run_fused's sweep at {grid}^2, {iters} iterations", flush=True)
    (planes, _x0, b, _p0, _rho0), _step = poisson_cg_state_dia(grid, device=dev)
    del _x0, _p0
    N = grid * grid
    offsets = (-grid, -1, 0, 1, grid)
    exact_bf16 = bool(torch.equal(planes, planes.to(torch.bfloat16).to(planes.dtype)))
    variants = [(C.cg_dia_fused, "twopass", None), (C.cg_dia_fused_onepass, "onepass", None)]
    if exact_bf16:
        variants += [(C.cg_dia_fused_onepass, "onepass_bf16", torch.bfloat16),
                     (C.cg_dia_fused, "twopass_bf16", torch.bfloat16)]
    check(len(variants) == 4, "the Laplacian's planes are exact in bf16: four variants")
    out, rho_ref = {}, None
    for fn, name, pdt in variants:
        x, _r, rho = fn(planes, offsets, b, None, N, iters=iters, plane_dtype=pdt)
        rho_f = float(rho)
        if rho_ref is None and name == "twopass" and np.isfinite(rho_f):
            rho_ref = rho_f
        check(rho_ref is not None and np.isfinite(rho_f) and rho_f <= 10 * max(rho_ref, 1e-30),
              f"{name}: rho {rho_f:.6g} passes run_fused's gate (finite, <= 10 x two-pass {rho_ref})")
        rel = dia_residual(planes, offsets, x, b)
        del x, _r
        best = 0.0
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(planes, offsets, b, None, N, iters=iters, plane_dtype=pdt)
            float(res[2])
            best = max(best, iters / (time.perf_counter() - t0))
            del res
        out[name] = dict(rho=rho_f, rel_residual=rel, iters_per_s=best)
        print(f"  {name}: {best:.2f} iters/s (best of 3), rho {rho_f:.6g}, true ||b - A x|| / ||b|| "
              f"= {rel:.4g} (f64)", flush=True)
    return out


def wide_band_path(dev, n: int, iters: int):
    """Phase 9: ``cg_dia_fused_onepass`` (run_fused's one-pass entry) on the
    7-point 3-D Laplacian at n^3, f32, whose +-n^2 diagonals put its window
    past a block's shared memory, so its iterations run the wide kernel.
    rho must fall and stay finite, and the true residual (f64) must lie
    within 10x of the two-pass fused CG's (``cg_dia_fused``) on the same b
    after the same iterations. Returns the measurements."""
    import torch
    from sparse_tpu_torch.kernels import cg_dia as C

    print(f"phase 9: one-pass CG on the 3-D Laplacian at {n}^3 (a band past the window), {iters} "
          f"iterations, float32", flush=True)
    planes, offs = laplacian_3d_dia(n, dev)
    N = n**3
    gen = torch.Generator(device=dev).manual_seed(11)
    b = torch.randn((N,), device=dev, generator=gen)
    rho0 = float(torch.dot(b, b))
    C.cg_dia_fused_onepass(planes, offs, b, None, N, iters=2)  # first launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, _r, rho = C.cg_dia_fused_onepass(planes, offs, b, None, N, iters=iters)
    rho_f = float(rho)
    secs = time.perf_counter() - t0
    rel = dia_residual(planes, offs, x, b)
    x2 = C.cg_dia_fused(planes, offs, b, None, N, iters=iters)[0]
    rel2 = dia_residual(planes, offs, x2, b)
    print(f"  {iters} iterations in {secs:.4f} s ({iters / secs:.2f} iters/s); rho {rho_f:.6g} "
          f"(from {rho0:.6g}); true ||b - A x|| / ||b|| = {rel:.4g} (two-pass {rel2:.4g}, f64)",
          flush=True)
    check(np.isfinite(rho_f) and rho_f < rho0 and np.isfinite(rel) and tuple(x.shape) == (N,),
          f"{n}^3: finite rho below rho0 and x of shape ({N},)")
    check(rel <= 10 * max(rel2, float(np.finfo(np.float32).eps)),
          f"{n}^3: the one-pass true residual {rel:.4g} within 10x of the two-pass {rel2:.4g}")
    del planes, b, x, x2, _r
    return dict(n=n, iters=iters, s=secs, iters_per_s=iters / secs, rho=rho_f, rel_residual=rel,
                twopass_rel_residual=rel2)


# ---------------------------------------------------------------------------
# phase 10: the Krylov solvers of linalg
# ---------------------------------------------------------------------------
#: operator products an iteration of each solver makes (tfqmr: a half-step)
KRYLOV_MATVECS = {"cgs": 2, "bicg": 2, "bicgstab": 2, "tfqmr": 1, "qmr": 2, "gmres": 1,
                  "lsqr": 2, "lsmr": 2, "minres": 1}


def convection_diffusion_diagonals(nx: int, ny: int, gamma: float = 0.5, dtype=np.float32):
    """The 5-point upwind convection-diffusion operator -Laplace(u) + beta . grad(u)
    on the unit square with Dirichlet boundaries, scaled by h^2 (Saad,
    Iterative Methods for Sparse Linear Systems, 2nd ed.): centre 4 + 2
    gamma, west and south -1 - gamma, east and north -1, cell Peclet number
    gamma = beta h. Returns the diagonals of its transpose, offsets and n:
    ``diags(diagonals, offsets).tocsc().T.tocsr()`` (pde.py's build) is
    the operator itself."""
    n = nx * ny
    up1 = np.full(n - 1, -1.0 - gamma, dtype=dtype)  # the transpose's (i, i+1): west of i+1
    lo1 = np.full(n - 1, -1.0, dtype=dtype)  # the transpose's (i+1, i): east of i
    up1[nx - 1 :: nx] = 0.0
    lo1[nx - 1 :: nx] = 0.0
    return ([np.full(n - nx, -1.0, dtype=dtype), lo1, np.full(n, 4.0 + 2 * gamma, dtype=dtype),
             up1, np.full(n - nx, -1.0 - gamma, dtype=dtype)], [-nx, -1, 0, 1, nx], n)


def banded_rows(diagonals, offsets, rows, x, transpose: bool):
    """Rows ``rows`` of B x (or B^T x) in f64 for B = diags(diagonals,
    offsets), and of |B| |x|: B holds d_o[min(i, i + o)] at (i, i + o), so
    B^T holds d_o[min(i, i - o)] at (i, i - o)."""
    n = x.shape[0]
    ref = np.zeros(len(rows))
    mag = np.zeros(len(rows))
    for d, o in zip(diagonals, offsets):
        o = -o if transpose else o
        j = rows + o
        ok = (j >= 0) & (j < n)
        k = np.clip(np.minimum(rows, j), 0, len(d) - 1)
        v = np.where(ok, d[k].astype(np.float64) * x[np.clip(j, 0, n - 1)].astype(np.float64), 0.0)
        ref += v
        mag += np.abs(v)
    return ref, mag


def skewed_nonsym_csr(m: int, seed: int = 7):
    """skewed_degree_csr's power-law rows without the symmetrizing step:
    G + diag(|G| row sums + 1), nonsymmetric and diagonally dominant
    (scipy CSR, f32)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(1.2, m) * 4 + 1).astype(int), max(m // 20, 8))
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, m, rows.shape[0])
    vals = rng.random(rows.shape[0])
    G = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    A = G + sp.diags(np.asarray(abs(G).sum(axis=1)).ravel() + 1.0)
    return A.tocsr().astype(np.float32)


class fetches_only:
    """Every host sync an error, except inside the counted fetches
    (``hostsync.fetch``): the error mode is armed as each fetch returns,
    so it covers every iteration and restart cycle a loop runs after its
    first fetch; with ``from_start`` it is armed on entry as well. A no-op
    off the card."""

    def __init__(self, dev, from_start: bool = False):
        self.dev, self.from_start = dev, from_start

    def __enter__(self):
        import torch
        from sparse_tpu_torch import hostsync

        self.hostsync, self.real = hostsync, hostsync.fetch
        if self.dev == "cpu":
            return self
        real = self.real

        def fetch(x):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return real(x)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        hostsync.fetch = fetch
        if self.from_start:
            torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        import torch

        if self.dev != "cpu":
            torch.cuda.set_sync_debug_mode("default")
        self.hostsync.fetch = self.real
        return False


def timed_solve(dev, fn, counter):
    """``fn()`` once to warm (layouts, the transposed CSR), then once timed,
    with the syncs held to the counted fetches (``fetches_only``). Returns
    (warm output, timed output, seconds, HOST_SYNCS, launches of
    ``counter`` in the timed run)."""
    import torch
    from sparse_tpu_torch import hostsync

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    warm = fn()
    sync()
    before = counter.launches
    hostsync.HOST_SYNCS = 0
    with fetches_only(dev):
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t0
    return warm, out, secs, hostsync.HOST_SYNCS, counter.launches - before


def solver_line(name, its, secs, syncs, launches, rel, extra=""):
    print(f"  {name}: {its} iterations in {secs:.4f} s = {its / secs:.2f} iters/s "
          f"({secs / max(its, 1) * 1e3:.4f} ms an iteration, {KRYLOV_MATVECS[name]} products an "
          f"iteration); HOST_SYNCS {syncs}; launches {launches}; true ||b - A x|| / ||b|| = "
          f"{rel:.6g} (f64, host){extra}", flush=True)
    return dict(iters=its, s=secs, iters_per_s=its / secs, ms_per_iter=secs / max(its, 1) * 1e3,
                matvecs=KRYLOV_MATVECS[name], host_syncs=syncs, launches=launches,
                rel_residual=rel)


def krylov_banded(dev, grid: int, iters: int = 100, restart: int = 20):
    """Phase 10a: the nonsymmetric banded operator at grid^2, f32. A @ x and
    A.T @ x against a host f64 reference on sampled rows, each twice bit
    for bit and one dia_spmv_packed launch; then ``iters`` iterations of
    cgs, bicg, bicgstab, tfqmr, qmr, gmres (restart cycles of ``restart``),
    lsqr and lsmr, each warmed once and timed once with its syncs held to
    the counted fetches. bicg and lsqr give x bit for bit on both runs;
    bicg's count of dia_spmv_packed launches must be 1 + 2 iters (A and A^T
    products alike); lsqr's r1norm and lsmr's normr must agree with the
    true residual (f64, host) to 1%."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import linalg
    from sparse_tpu_torch.kernels import dia_spmv as D
    from sparse_tpu_torch.ops.dia_spmv import dia_spmv_torch

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    print(f"phase 10a: Krylov solvers on the {grid}^2 upwind convection-diffusion operator "
          f"(float32, nonsymmetric, gamma 0.5), {iters} iterations each", flush=True)
    diagonals, offsets, n = convection_diffusion_diagonals(grid, grid)
    t0 = time.perf_counter()
    A = sparse.diags(diagonals, offsets, shape=(n, n), dtype=np.float32, device=dev).tocsc().T
    A = A.tocsr()
    sync()
    out = {"n": n, "build_s": time.perf_counter() - t0}
    check(A._maybe_dia() is not None and A.nnz == sum(int((d != 0).sum()) for d in diagonals),
          f"the operator ({A}) is detected banded")
    rng = np.random.default_rng(12)
    x_np = rng.standard_normal(n).astype(np.float32)
    x = torch.tensor(x_np, device=dev)
    rows = np.unique(np.concatenate([rng.choice(n, min(4096, n), replace=False),
                                     [0, 1, grid, n - grid - 1, n - 2, n - 1]]))
    ridx = torch.as_tensor(rows, device=dev)
    for label, prod, transpose in (("A @ x", lambda: A @ x, True), ("A.T @ x", lambda: A.T @ x, False)):
        t0 = time.perf_counter()
        y1 = prod()  # A.T @ x: the first builds the transpose's CSR and its DIA planes
        sync()
        first = time.perf_counter() - t0
        before = D.dia_spmv_packed.launches
        y2 = prod()
        launched = D.dia_spmv_packed.launches - before
        ref, mag = banded_rows(diagonals, offsets, rows, x_np, transpose)
        err = np.abs(y1[ridx].double().cpu().numpy() - ref)
        check(bool(np.all(err <= 8 * np.finfo(np.float32).eps * mag)),
              f"{label} vs host f64 on {len(rows)} sampled rows (max err {err.max():.3g}, bound "
              f"8 eps sum |a x|; first call {first:.3f} s)")
        check(bool(torch.equal(y1, y2)) and (dev == "cpu" or launched == 1),
              f"{label} twice: bit for bit, one dia_spmv_packed launch ({launched})")
    check(not bool(torch.equal(A @ x, A.T @ x)), "A.T @ x differs from A @ x (A is nonsymmetric)")
    del y1, y2

    b_np = rng.standard_normal(n).astype(np.float32)
    b = torch.tensor(b_np, device=dev)
    planes, offs = A._maybe_dia()
    P64 = planes.double().cpu()
    b64 = torch.tensor(b_np, dtype=torch.float64)

    def true_res(xs):
        r = b64 - dia_spmv_torch(P64, offs, xs.double().cpu(), (n, n))
        return float(torch.linalg.vector_norm(r))

    big = 10**9
    runs = {
        "cgs": lambda: linalg.cgs(A, b, tol=0.0, maxiter=iters, conv_test_iters=big),
        "bicg": lambda: linalg.bicg(A, b, tol=0.0, maxiter=iters, conv_test_iters=big),
        "bicgstab": lambda: linalg.bicgstab(A, b, tol=0.0, maxiter=iters, conv_test_iters=big),
        "tfqmr": lambda: linalg.tfqmr(A, b, tol=0.0, maxiter=iters),
        "qmr": lambda: linalg.qmr(A, b, tol=0.0, maxiter=iters, conv_test_iters=big),
        "gmres": lambda: linalg.gmres(A, b, tol=0.0, restart=restart, maxiter=iters // restart),
        "lsqr": lambda: linalg.lsqr(A, b, atol=0.0, btol=0.0, conlim=0.0, iter_lim=iters),
        "lsmr": lambda: linalg.lsmr(A, b, atol=0.0, btol=0.0, conlim=0.0, maxiter=iters),
    }
    bnorm = float(np.linalg.norm(b_np.astype(np.float64)))
    solvers = {}
    for name, fn in runs.items():
        warm, res, secs, syncs, launches = timed_solve(dev, fn, D.dia_spmv_packed)
        xs, its = res[0], res[1] if name not in ("lsqr", "lsmr") else res[2]
        rabs = true_res(xs)
        extra = ""
        if name in ("lsqr", "lsmr"):
            est = res[3]
            extra = f"; the solver's estimate {est / bnorm:.6g} (istop {res[1]})"
        solvers[name] = solver_line(name, its, secs, syncs, launches, rabs / bnorm, extra)
        # gmres, lsqr and lsmr minimize a residual norm that starts at ||b||
        monotone = name in ("gmres", "lsqr", "lsmr")
        check(its == iters and bool(torch.isfinite(xs).all()) and (rabs < bnorm or not monotone),
              f"{name}: {iters} iterations, finite x" + (", true residual below ||b||"
                                                        if monotone else ""))
        if name in ("lsqr", "lsmr"):
            solvers[name]["estimate"] = est / bnorm
            check(abs(rabs - est) <= 0.01 * rabs,
                  f"{name}: its residual estimate {est:.6g} within 1% of the true {rabs:.6g}")
        if name in ("bicg", "lsqr"):
            check(bool(torch.equal(warm[0], xs)), f"{name} run twice: x bit for bit")
        if name == "bicg" and dev != "cpu":
            check(launches == 1 + 2 * iters,
                  f"bicg: {launches} dia_spmv_packed launches = 1 + 2 x {iters} (A and A^T products)")
        del warm, res, xs
    out["solvers"] = solvers
    del A, P64, planes
    return out


def krylov_symmetric(dev, A, grid: int, small_grid: int, iters: int = 100, lg_grid=None):
    """Phase 10b: the symmetric (negative definite) Laplacian of phase 3.
    minres for ``iters`` iterations at grid^2 f32; spsolve (the fused CG
    kernels) with a tolerance (1e-4 ||b||, b seeded random) at
    small_grid^2, whose true residual (f64, host) must lie within tol +
    sqrt(k) f32 floors; minres to the same tolerance in f32 (measured: its
    f32 residual estimate parts from the true residual here) and in f64,
    held to tol + sqrt(k) f64 floors; lgmres (inner_m 30, outer_k 3) and gcrotmk (m 20),
    3 outer cycles each in f64 at lg_grid^2 (default grid), seconds a
    cycle and the peak of allocated memory."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import linalg
    from sparse_tpu_torch.kernels import cg_dia as C
    from sparse_tpu_torch.kernels import dia_spmv as D
    from sparse_tpu_torch.ops.dia_spmv import dia_spmv_torch

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    lg_grid = grid if lg_grid is None else lg_grid
    print(f"phase 10b: minres on phase 3's {grid}^2 Laplacian ({iters} iterations), spsolve and "
          f"minres with a tolerance at {small_grid}^2, lgmres and gcrotmk in f64 at {lg_grid}^2",
          flush=True)
    n = A.shape[0]
    b_np = np.random.default_rng(13).standard_normal(n).astype(np.float32)
    b = torch.tensor(b_np, device=dev)
    bnorm = float(np.linalg.norm(b_np.astype(np.float64)))
    planes, offs = A._maybe_dia()
    P64 = planes.double().cpu()
    out = {}
    _w, res, secs, syncs, launches = timed_solve(
        dev, lambda: linalg.minres(A, b, tol=0.0, maxiter=iters), D.dia_spmv_packed)
    r = torch.tensor(b_np, dtype=torch.float64) - dia_spmv_torch(P64, offs, res[0].double().cpu(),
                                                                 (n, n))
    rel = float(torch.linalg.vector_norm(r)) / bnorm
    out["minres"] = solver_line("minres", res[1], secs, syncs, launches, rel)
    check(res[1] == iters and rel < 1.0, f"minres: {iters} iterations, true residual below ||b||")
    del _w, res, r, P64

    # tolerance solves at small_grid^2 on a seeded random right-hand side
    # (phase 3's, two eigenvectors, is solved in two Krylov steps)
    diag_s, offs_s, ns = laplacian_diagonals(small_grid + 2, small_grid + 2)
    As = sparse.diags(diag_s, offs_s, shape=(ns, ns), dtype=np.float32, device=dev).tocsc().T.tocsr()
    bs_np = np.random.default_rng(16).standard_normal(ns).astype(np.float32).astype(np.float64)
    bs = torch.tensor(bs_np.astype(np.float32), device=dev)
    bsn = float(np.linalg.norm(bs_np))
    data_s, offs_ss = As._maybe_dia()
    data64 = data_s.double().cpu()
    b64 = torch.tensor(bs_np)

    def rel_floor(xs):
        x64 = xs.double().cpu()
        r = b64 - dia_spmv_torch(data64, offs_ss, x64, (ns, ns))
        mag = dia_spmv_torch(data64.abs(), offs_ss, x64.abs(), (ns, ns))
        return (float(torch.linalg.vector_norm(r)) / bsn,
                float(np.finfo(np.float32).eps) * float(torch.linalg.vector_norm(mag)) / bsn)

    before = (C.cg_kernel_a.launches, C.cg_kernel_b.launches)
    sync()
    t0 = time.perf_counter()
    xs = linalg.spsolve(As, bs, tol=1e-4 * bsn, maxiter=20000)
    sync()
    secs = time.perf_counter() - t0
    k = C.cg_kernel_a.launches - before[0]
    rel, floor = rel_floor(xs)
    out["spsolve"] = dict(n=ns, iters=k, s=secs, rel_residual=rel, f32_floor=floor)
    print(f"  spsolve at {small_grid}^2: {k} fused CG iterations in {secs:.4f} s; true residual "
          f"{rel:.4g} (floor {floor:.3g})", flush=True)
    check(dev == "cpu" or (k > 0 and C.cg_kernel_b.launches - before[1] == k),
          f"spsolve ran the fused CG: cg_kernel_a and cg_kernel_b launched {k} times each")
    check(rel <= 1e-4 + np.sqrt(max(k, 1)) * floor,
          f"spsolve: true residual {rel:.4g} <= 1e-4 + sqrt({k}) x the f32 floor {floor:.3g}")
    # minres to tol: in f32 its recurrence estimate of ||r|| parts from the
    # true residual on this operator (sparse_tpu's f32 minres as well), so
    # the f32 solve is measured and the tolerance is held in f64
    As64 = sparse.diags(diag_s, offs_s, shape=(ns, ns), dtype=np.float64,
                        device=dev).tocsc().T.tocsr()
    for prec, Am, bm in (("f32", As, bs), ("f64", As64, bs.double())):
        sync()
        t0 = time.perf_counter()
        xm, km = linalg.minres(Am, bm, tol=1e-4, maxiter=20000)
        sync()
        secs = time.perf_counter() - t0
        rel, floor = rel_floor(xm)
        if prec == "f64":
            floor *= float(np.finfo(np.float64).eps / np.finfo(np.float32).eps)
        out["minres_tol_" + prec] = dict(n=ns, iters=km, s=secs, rel_residual=rel, floor=floor)
        print(f"  minres at {small_grid}^2 ({prec}): {km} iterations in {secs:.4f} s; true residual "
              f"{rel:.4g} ({prec} floor {floor:.3g})", flush=True)
        check(km < 20000 and bool(torch.isfinite(xm).all()),
              f"minres ({prec}) stops on tol 1e-4 ||b|| after {km} iterations, finite x")
        if prec == "f64":
            check(rel <= 1e-4 + np.sqrt(km) * floor,
                  f"minres (f64): true residual {rel:.4g} <= 1e-4 + sqrt({km}) x the f64 floor "
                  f"{floor:.3g}")
    del As64
    del As, xs, xm, data64

    # lgmres and gcrotmk in f64: the largest grid (down from lg_grid) whose
    # augmented blocks fit the card
    for g in (lg_grid, lg_grid * 3 // 4, lg_grid // 2):
        try:
            out["augmented"] = augmented_f64(dev, g)
            break
        except torch.cuda.OutOfMemoryError:
            print(f"  lgmres/gcrotmk in f64 at {g}^2 do not fit: cut to a smaller grid", flush=True)
            torch.cuda.empty_cache()
    else:
        raise AssertionError("lgmres/gcrotmk in f64 fit at no grid tried")
    return out


def augmented_f64(dev, grid: int):
    """lgmres (inner_m 30, outer_k 3) and gcrotmk (m 20), 3 outer cycles
    each on the f64 Laplacian at grid^2: seconds a cycle, the peak of
    allocated memory, and the true residual, which must fall."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import hostsync, linalg

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    diagonals, offsets, n = laplacian_diagonals(grid + 2, grid + 2, dtype=np.float64)
    A = sparse.diags(diagonals, offsets, shape=(n, n), dtype=np.float64, device=dev).tocsc().T
    A = A.tocsr()
    b = torch.tensor(np.random.default_rng(14).standard_normal(n), device=dev)
    bnorm = float(torch.linalg.vector_norm(b))
    out = {"grid": grid}
    for name, fn in (("lgmres", lambda: linalg.lgmres(A, b, maxiter=3, inner_m=30, outer_k=3)),
                     ("gcrotmk", lambda: linalg.gcrotmk(A, b, maxiter=3, m=20))):
        A @ b  # layouts
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        hostsync.HOST_SYNCS = 0
        sync()
        t0 = time.perf_counter()
        x, info = fn()
        sync()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
        rel = float(torch.linalg.vector_norm(b - A @ x)) / bnorm
        out[name] = dict(cycles=3, s=secs, s_per_cycle=secs / 3, peak_bytes=peak, info=info,
                         rel_residual=rel, host_syncs=hostsync.HOST_SYNCS)
        print(f"  {name} f64 at {grid}^2: 3 outer cycles in {secs:.4f} s ({secs / 3:.4f} s a cycle), "
              f"peak allocated {peak / 2**30:.2f} GiB, HOST_SYNCS {hostsync.HOST_SYNCS}, info {info}, "
              f"||b - A x|| / ||b|| = {rel:.6g}", flush=True)
        check(np.isfinite(rel) and rel < 1.0, f"{name}: 3 cycles lower the residual ({rel:.4g})")
        del x
    del A, b
    return out


def scatter_repeats(A, x) -> dict:
    """How many entries differ between two runs of the column
    ``index_add_`` of A.T @ x that the port no longer sums with (the
    column-split product CSC arrays and adjoint products used before; a
    record, not a check), and between two runs of ``coo_to_dense`` on a
    COO with every entry repeated 100 times, which now sums the sorted
    duplicates in order (it used ``index_put_(accumulate=True)``)."""
    import torch
    from sparse_tpu_torch.ops.conv import coo_to_dense
    from sparse_tpu_torch.ops.coords import expand_rows

    rows = expand_rows(A.indptr, A.nnz)
    prod = A.data * x[rows]

    def col_sum():
        return torch.zeros_like(x).index_add_(0, A.indices.long(), prod)

    n = 4096
    g = torch.Generator(device=x.device).manual_seed(3)
    r = torch.randint(0, 64, (100 * n,), device=x.device, generator=g)
    c = torch.randint(0, 64, (100 * n,), device=x.device, generator=g)
    v = torch.randn((100 * n,), device=x.device, generator=g)
    out = {}
    for name, fn in (("index_add_ (A.T @ x by columns)", col_sum),
                     ("coo_to_dense (sorted duplicate sums, 100 duplicates an entry)",
                      lambda: coo_to_dense(r, c, v, (64, 64)))):
        y1, y2 = fn(), fn()
        out[name] = int((y1 != y2).sum())
        print(f"  two runs of {name}: {out[name]} of {y1.numel()} entries differ", flush=True)
    return out


def krylov_general(dev, m: int, small_m: int, ls_iters: int = 300, ls_m: int = 2**13):
    """Phase 10c: the nonsymmetric skewed_nonsym_csr(m), f32, under
    spmv_mode 'sell' (under 'auto' the transpose's tight row profile would
    take the ELL gathers): A @ x and A.T @ x against scipy in f64 on
    sampled rows, twice bit for bit, one sell_chunk_spmv launch each;
    A.T @ x twice bit for bit on skewed_degree_csr(small_m). Then bicg,
    qmr, gmres and bicgstab to 1e-6 ||b||: in f32 (at most 2000
    iterations) measured, and in f64, where each must stop on tol with its
    true residual (f64, host) within tol + sqrt(k) f64 floors; 1e-6 lies at
    this operator's f32 accuracy, where QMR without look-ahead stalls
    (sparse_tpu's as well). lsqr and lsmr iterate on the normal equations,
    whose condition is this operator's squared, so at m they run
    ``ls_iters`` iterations in f32, their residual estimates held to the
    true residual within 1%; their tolerance solves run in f64 on
    skewed_nonsym_csr(ls_m), where they must stop on tol (istop 1) within
    1% of it."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import hostsync, linalg
    from sparse_tpu_torch.kernels import sell_spmv as S

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    A_s = skewed_nonsym_csr(m)
    At_s = A_s.T.tocsr()
    host_s = time.perf_counter() - t0
    print(f"phase 10c: Krylov solvers on skewed_nonsym_csr({m}) (float32, nnz {A_s.nnz}, built on "
          f"the host with its transpose in {host_s:.2f} s), spmv_mode 'sell'", flush=True)
    prev = sparse.settings.spmv_mode
    sparse.settings.spmv_mode = "sell"
    out = {"m": m, "nnz": int(A_s.nnz), "host_build_s": host_s}
    try:
        A = sparse.csr_array(A_s, device=dev)
        rng = np.random.default_rng(15)
        x_np = rng.standard_normal(m).astype(np.float32)
        x = torch.tensor(x_np, device=dev)
        rows = np.unique(np.concatenate([rng.choice(m, min(4096, m), replace=False), [0, m - 1]]))
        for label, prod, M_s in (("A @ x", lambda: A @ x, A_s), ("A.T @ x", lambda: A.T @ x, At_s)):
            y1 = prod()
            before = S.sell_chunk_spmv.launches
            y2 = prod()
            launched = S.sell_chunk_spmv.launches - before
            sub = M_s[rows].astype(np.float64)
            want = sub @ x_np.astype(np.float64)
            mag = abs(sub) @ np.abs(x_np).astype(np.float64)
            err = np.abs(y1[torch.as_tensor(rows, device=dev)].double().cpu().numpy() - want)
            rl = np.diff(M_s.indptr)[rows]
            check(bool(np.all(err <= (rl + 2) * np.finfo(np.float32).eps * mag)),
                  f"{label} vs scipy in f64 on {len(rows)} sampled rows (max err {err.max():.3g}, "
                  f"bound (row length + 2) eps sum |a x|)")
            check(bool(torch.equal(y1, y2)) and (dev == "cpu" or launched == 1),
                  f"{label} twice: bit for bit, one sell_chunk_spmv launch ({launched})")
        del y1, y2
        Sm = sparse.csr_array(skewed_degree_csr(small_m), device=dev)
        xm = torch.tensor(rng.standard_normal(small_m).astype(np.float32), device=dev)
        check(bool(torch.equal(Sm.T @ xm, Sm.T @ xm)),
              f"A.T @ x twice bit for bit on skewed_degree_csr({small_m})")
        out["scatter_repeats"] = scatter_repeats(Sm, xm)
        del Sm, xm

        A64 = A_s.astype(np.float64)
        b_np = rng.standard_normal(m).astype(np.float32)
        b = torch.tensor(b_np, device=dev)
        bn = float(np.linalg.norm(b_np.astype(np.float64)))
        tol = 1e-6

        def runs(Ad, bd, cap):
            """The tolerance solves (and lsqr, lsmr for ls_iters) on Ad, bd."""
            return {
                "bicg": lambda: linalg.bicg(Ad, bd, tol=tol * bn, maxiter=cap),
                "qmr": lambda: linalg.qmr(Ad, bd, tol=tol, maxiter=cap),
                "gmres": lambda: linalg.gmres(Ad, bd, tol=tol, restart=20, maxiter=cap // 20),
                "bicgstab": lambda: linalg.bicgstab(Ad, bd, tol=tol * bn, maxiter=cap),
                "lsqr": lambda: linalg.lsqr(Ad, bd, atol=0.0, btol=0.0, conlim=0.0,
                                            iter_lim=ls_iters),
                "lsmr": lambda: linalg.lsmr(Ad, bd, atol=0.0, btol=0.0, conlim=0.0,
                                            maxiter=ls_iters),
            }

        solvers = {}
        A_d = sparse.csr_array(A64, device=dev)
        for prec, Ad, bd, cap in (("f32", A, b, 2000), ("f64", A_d, b.double(), 20000)):
            for name, fn in runs(Ad, bd, cap).items():
                if prec == "f64" and name in ("lsqr", "lsmr"):
                    continue
                sync()
                hostsync.HOST_SYNCS = 0
                before = S.sell_chunk_spmv.launches
                t0 = time.perf_counter()
                res = fn()
                sync()
                secs = time.perf_counter() - t0
                xs, its = res[0], res[1] if name not in ("lsqr", "lsmr") else res[2]
                rel, floor = f64_residual(A64, xs.cpu().numpy(), b_np)
                if prec == "f64":
                    floor *= float(np.finfo(np.float64).eps / np.finfo(np.float32).eps)
                key = name if prec == "f32" else name + "_f64"
                solvers[key] = solver_line(name, its, secs, hostsync.HOST_SYNCS,
                                           S.sell_chunk_spmv.launches - before, rel,
                                           f"; {prec}, floor {floor:.3g}")
                solvers[key].update(floor=floor, dtype=prec)
                check(bool(torch.isfinite(xs).all()), f"{name} ({prec}): finite x")
                if name in ("lsqr", "lsmr"):
                    est = res[3] / bn
                    solvers[key]["estimate"] = est
                    check(its == ls_iters and abs(rel - est) <= 0.01 * rel and rel < 1.0,
                          f"{name}: {ls_iters} iterations, its residual estimate {est:.6g} within "
                          f"1% of the true {rel:.6g}, below ||b||")
                elif prec == "f32":
                    # 1e-6 lies at this operator's f32 accuracy: the f32 solves
                    # are measured, the tolerance is held in f64 below
                    solvers[key]["reached_tol"] = bool(rel <= tol + np.sqrt(max(its, 1)) * floor)
                else:
                    check(its < cap and rel <= tol + np.sqrt(max(its, 1)) * floor,
                          f"{name} in f64 stops on tol after {its} iterations: true residual "
                          f"{rel:.4g} <= 1e-6 + sqrt({its}) x the f64 floor {floor:.3g}")
                del res, xs
        del A_d
        # lsqr and lsmr to the tolerance, in f64, where their normal
        # equations converge in a few thousand iterations
        S13 = skewed_nonsym_csr(ls_m).astype(np.float64)
        A13 = sparse.csr_array(S13, device=dev)
        b13_np = rng.standard_normal(ls_m)
        b13 = torch.tensor(b13_np, device=dev)
        for name, fn in (("lsqr", lambda: linalg.lsqr(A13, b13, atol=0.0, btol=tol, iter_lim=10000)),
                         ("lsmr", lambda: linalg.lsmr(A13, b13, atol=0.0, btol=tol, maxiter=10000))):
            sync()
            t0 = time.perf_counter()
            res = fn()
            sync()
            secs = time.perf_counter() - t0
            rel = float(np.linalg.norm(b13_np - S13 @ res[0].cpu().numpy()) / np.linalg.norm(b13_np))
            solvers[name + "_tol_f64"] = dict(m=ls_m, iters=res[2], s=secs, istop=res[1],
                                              rel_residual=rel)
            print(f"  {name} in f64 on skewed_nonsym_csr({ls_m}): {res[2]} iterations in {secs:.4f} s, "
                  f"istop {res[1]}, true ||b - A x|| / ||b|| = {rel:.4g}", flush=True)
            check(res[1] == 1 and rel <= 1.01 * tol,
                  f"{name} in f64 stops on tol (istop 1), true residual {rel:.4g} <= 1.01 x 1e-6")
            del res
        del A13
        out["solvers"] = solvers
        del A, b
    finally:
        sparse.settings.spmv_mode = prev
    return out


# ---------------------------------------------------------------------------
# phase 11: the core sparse ops at full width
# ---------------------------------------------------------------------------
def banded_product_closed_form(i, j, n: int, h: int):
    """C[i, j] of A @ A, A the n x n matrix of ones on the 2h + 1 diagonals
    -h..h: #{k : |i - k| <= h, |k - j| <= h, 0 <= k < n}."""
    lo = np.maximum(np.maximum(i, j) - h, 0)
    hi = np.minimum(np.minimum(i, j) + h, n - 1)
    return np.maximum(hi - lo + 1, 0).astype(np.float64)


def rows_of(C, rows):
    """(row ids, columns, values) of the given rows of a CSR, on the host."""
    import torch

    ptr = C.indptr.cpu().numpy().astype(np.int64)
    starts, ends = ptr[rows], ptr[rows + 1]
    pos = np.concatenate([np.arange(a, b) for a, b in zip(starts, ends)])
    pos_t = torch.as_tensor(pos, device=C.device)
    return (np.repeat(rows, ends - starts), C.indices[pos_t].cpu().numpy().astype(np.int64),
            C.data[pos_t].cpu().numpy())


def same_csr(C1, C2) -> bool:
    import torch

    return all(bool(torch.equal(a, b)) for a, b in ((C1.indptr, C2.indptr),
                                                     (C1.indices, C2.indices), (C1.data, C2.data)))


def timed(dev, fn):
    """(result, seconds) of ``fn()`` on the host clock, the card drained
    before and after."""
    import torch

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    res = fn()
    sync()
    return res, time.perf_counter() - t0


def random_build(dev, m: int, per_row: int = 16, top: int = 4):
    """(A, seconds, the ``top`` entries of its cProfile by own time) of
    module.random(m, m, per_row / m, csr, seed 7, f32) on ``dev``: where
    the host spends phase 11b's build."""
    import cProfile
    import pstats

    import sparse_tpu_torch as sparse

    prof = cProfile.Profile()
    A, secs = timed(dev, lambda: prof.runcall(
        sparse.random, m, m, density=per_row / m, format="csr", random_state=7,
        dtype=np.float32, device=dev))
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (cc, nc, own, cumulative, callers)
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return A, secs, [(f"{Path(f).name}:{line}:{name}" if line else name, v[2])
                     for (f, line, name), v in rows]


def spgemm_microbench(dev, n: int, w: int, reps: int):
    """Phase 11a: examples/spgemm_microbenchmark.py's C = A @ B at n rows in
    f64 (A the ones on w diagonals, B = A.copy()): one warm product, then
    ``reps`` timed; the peak of allocated memory and the counted host
    fetches of one product (every other sync an error); two products
    equal bit for bit; one product under torch.profiler (busy share and
    its kernels); C exactly the closed form on sampled rows; the
    library's CSR @ CSR on the same A and B; C @ x through the DIA kernel
    against A @ (A @ x) in f64."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import hostsync

    h = w // 2
    print(f"phase 11a: spgemm_microbenchmark's A @ B at n = {n}, {w} nonzeros a row (float64)",
          flush=True)
    A, build_s = timed(dev, lambda: sparse.diags([1] * w, [x - h for x in range(w)], shape=(n, n),
                                                 format="csr", dtype=np.float64, device=dev))
    B = A.copy()
    check(A.nnz == w * n - h * (h + 1), f"A: {A.nnz} nonzeros = w n - h (h + 1), built in "
          f"{build_s:.3f} s")
    total = int((A.indptr[1:] - A.indptr[:-1])[A.indices.long()].sum())
    C, warm_s = timed(dev, lambda: A @ B)
    del C
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if dev == "cuda" else 0
    hostsync.HOST_SYNCS = 0
    with fetches_only(dev, from_start=True):
        C1 = A @ B
    syncs = hostsync.HOST_SYNCS
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    check(syncs == 2, f"one product makes {syncs} host fetches (the expansion total and the "
          f"unique count), and no other sync")
    C2 = A @ B
    check(same_csr(C1, C2), "two products equal bit for bit (indptr, indices, data)")
    del C2
    nnz_c = (2 * w - 1) * n - 2 * sum(range(2 * h + 1))
    check(C1.nnz == nnz_c, f"C: {C1.nnz} nonzeros = (2w - 1) n - 2 h (2h + 1)")
    secs = []
    for _ in range(reps):
        C1, s = timed(dev, lambda: A @ B)
        secs.append(s)
    rng = np.random.default_rng(21)
    rows = np.unique(np.concatenate([rng.choice(n, min(4096, n), replace=False),
                                     [0, 1, h, n - 2, n - 1]]))
    ri, cj, v = rows_of(C1, rows)
    want = banded_product_closed_form(ri, cj, n, h)
    check(bool(np.array_equal(v, want)) and bool(np.all(want > 0)),
          f"C exactly the closed form on {len(rows)} sampled rows ({len(v)} entries)")
    busy = device_share("one A @ B product", lambda: A @ B) if dev == "cuda" else None
    x = torch.tensor(rng.standard_normal(n), device=dev)
    y = C1 @ x
    z = A @ (A @ x)
    mag = (C1 @ x.abs()).double()
    err = float(((y - z).abs() / mag.clamp_min(1e-300)).max())
    kbound = 2 * (2 * w - 1) * float(np.finfo(np.float64).eps)
    check(err <= kbound, f"C @ x (DIA kernel) vs A @ (A @ x) in f64: max |diff| / (|C| |x|) = "
          f"{err:.3g} <= 2 (2w - 1) eps = {kbound:.3g}")
    del x, y, z, mag, C1
    # the library yardstick: cuSPARSE's SpGEMM behind torch's sparse CSR
    Ac = torch.sparse_csr_tensor(A.indptr.long(), A.indices.long(), A.data, A.shape)
    Bc = torch.sparse_csr_tensor(B.indptr.long(), B.indices.long(), B.data, B.shape)
    Cl, lib_warm = timed(dev, lambda: Ac @ Bc)
    lib_nnz = int(Cl._nnz())
    del Cl
    lib = []
    for _ in range(3):
        Cl, s = timed(dev, lambda: Ac @ Bc)
        lib.append(s)
        del Cl
    check(lib_nnz == nnz_c, f"the library's product has the same {lib_nnz} nonzeros")
    del Ac, Bc, A, B
    out = dict(n=n, w=w, nnz_a=w * n - h * (h + 1), expansion=total, nnz_c=nnz_c,
               build_s=build_s, warm_s=warm_s, s_per_product=float(np.mean(secs)),
               iters_per_s=reps / float(np.sum(secs)), peak_bytes=peak - base,
               peak_allocated=peak, host_syncs=syncs, busy_share=busy,
               library_s=float(np.mean(lib)), library_warm_s=lib_warm)
    print(f"  A @ B at n = {n}: {out['iters_per_s']:.3f} iterations / s ({out['s_per_product']:.4f} "
          f"s a product, mean of {reps}; warm {warm_s:.3f} s); expansion {total} entries, C "
          f"{nnz_c} nonzeros; peak allocated {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} "
          f"GiB over the operands); host fetches a product {syncs}; library "
          f"(torch.sparse_csr_tensor @ torch.sparse_csr_tensor) {out['library_s']:.4f} s a "
          f"product (warm {lib_warm:.3f} s)", flush=True)
    return out


def spgemm_random(dev, m: int, per_row: int = 16):
    """Phase 11b: module.random(m, m, density per_row / m, csr, seed 7, f32)
    @ itself, twice bit for bit; then (A @ A) @ x through sell_chunk_spmv
    (spmv_mode 'sell') against A @ (A @ x), within the deterministic
    summation bound k u sum |terms| (k the longest chain of additions)."""
    import torch
    import sparse_tpu_torch as sparse

    print(f"phase 11b: module.random({m}, {m}, density={per_row}/{m}) @ itself (float32)",
          flush=True)
    A, build_s, prof = random_build(dev, m, per_row)
    check(A.nnz == per_row * m, f"A: {A.nnz} nonzeros, built in {build_s:.2f} s (host draw "
          f"included); own time by cProfile: " + ", ".join(f"{k} {v:.3f} s" for k, v in prof))
    lens = A.indptr[1:] - A.indptr[:-1]
    total = int(lens[A.indices.long()].sum())
    C1, warm_s = timed(dev, lambda: A @ A)
    C2, prod_s = timed(dev, lambda: A @ A)
    check(same_csr(C1, C2), f"A @ A twice bit for bit (expansion {total}, C {C1.nnz} nonzeros, "
          f"{prod_s:.4f} s a product)")
    del C2
    prev = sparse.settings.spmv_mode
    sparse.settings.spmv_mode = "sell"
    try:
        x = torch.tensor(np.random.default_rng(22).standard_normal(m).astype(np.float32),
                         device=dev)
        y = C1 @ x
        z = A @ (A @ x)
        mag = (C1 @ x.abs()).double()
    finally:
        sparse.settings.spmv_mode = prev
    u = float(np.finfo(np.float32).eps) / 2
    ka = int(lens.max())
    kc = int((C1.indptr[1:] - C1.indptr[:-1]).max())
    # C's entries carry up to ka terms, C @ x adds kc, A @ (A @ x) 2 ka
    k = kc + 3 * ka + 2
    err = ((y.double() - z.double()).abs() / mag.clamp_min(1e-30)).max().item()
    check(err <= k * u, f"(A @ A) @ x (sell_chunk_spmv) vs A @ (A @ x): max |diff| / (|C| |x|) "
          f"= {err:.3g} <= k u = {k * u:.3g} (k = {k}); {err / (np.sqrt(k) * u):.2f} sqrt(k) u")
    del x, y, z, mag, C1, A
    return dict(m=m, nnz_a=per_row * m, expansion=total, build_s=build_s, build_profile=prof,
                warm_s=warm_s,
                s_per_product=prod_s, rel_err=err, k=k)


def unit_laplacian_diagonals(n: int, dtype=np.float32):
    """pde.py's five diagonals with the stencil scaled to (4, -1): the
    n^2 Laplacian that kron(l1, I) + kron(I, l1) builds."""
    N = n * n
    side = np.full(N - 1, -1.0, dtype=dtype)
    side[n - 1::n] = 0.0
    far = np.full(N - n, -1.0, dtype=dtype)
    return [far, side, np.full(N, 4.0, dtype=dtype), side, far], [-n, -1, 0, 1, n]


def laplacian_kron(dev, grid: int, iters: int):
    """Phase 11c: models.poisson.laplacian_2d_csr(grid) on the card (kron,
    then the union add), its A @ x bit for bit the product of the operator
    built as pde.py builds it, and ``iters`` iterations of linalg.cg on it
    (the fused kernels A and B)."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import linalg
    from sparse_tpu_torch.models import laplacian_2d_csr

    print(f"phase 11c: laplacian_2d_csr({grid}) through kron and the union add (float32)",
          flush=True)
    L, build_s = timed(dev, lambda: laplacian_2d_csr(grid, np.float32, device=dev))
    N = grid * grid
    check(L.nnz == 5 * N - 4 * grid, f"{L}: 5 N - 4 grid nonzeros, built in {build_s:.3f} s")
    diagonals, offsets = unit_laplacian_diagonals(grid)
    P = sparse.diags(diagonals, offsets, shape=(N, N), dtype=np.float32, device=dev).tocsc().T
    P = P.tocsr()
    x = torch.tensor(np.random.default_rng(23).standard_normal(N).astype(np.float32), device=dev)
    check(bool(torch.equal(L @ x, P @ x)), "L @ x equals the pde.py-built operator's, bit for bit")
    del P
    b = torch.ones((N,), dtype=torch.float32, device=dev)
    (xs, its), cg_s = timed(dev, lambda: linalg.cg(L, b, maxiter=iters, conv_test_iters=10**9))
    Lx = (L @ xs).double()
    rel = float(torch.linalg.vector_norm(b.double() - Lx)) / float(np.sqrt(N))
    # CG lowers phi(x) = x.Ax / 2 - b.x from phi(0) = 0 (the residual norm need not fall)
    phi = float(0.5 * torch.dot(xs.double(), Lx) - torch.dot(b.double(), xs.double()))
    check(its == iters and bool(torch.isfinite(xs).all()) and phi < 0,
          f"cg: {its} iterations in {cg_s:.4f} s ({its / cg_s:.2f} iters/s), phi(x) = {phi:.6g} "
          f"< 0, ||b - A x|| / ||b|| = {rel:.4g}")
    return L, dict(grid=grid, nnz=L.nnz, build_s=build_s, cg_iters=its, cg_s=cg_s,
                   cg_iters_per_s=its / cg_s, phi=phi, rel_residual=rel)


def elementwise_ops(dev, A, mis_grid: int, k: int = 8):
    """Phase 11d: on phase 11c's matrix, A + A.T, A - A.T (all zero after
    eliminate_zeros), A.multiply(A), the column sums, the row maxima, the
    diagonal, A.sddmm(C, D) with C, D of width k, and x @ A twice bit for
    bit, each timed; then mis_tropical(k=1, seed=0) on the mis_grid^2
    Laplacian, checked on the host as a maximal independent set and equal
    on a repeat."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import hostsync
    from sparse_tpu_torch.models import laplacian_2d_csr

    N = A.shape[0]
    print(f"phase 11d: elementwise ops on the {N}-row Laplacian (float32)", flush=True)
    out = {}

    def op(name, fn, nnz=None):
        res, secs = timed(dev, fn)
        out[name] = dict(s=secs)
        if nnz is not None:
            out[name]["nnz"] = nnz(res)
        print(f"  {name}: {secs:.4f} s" + ("" if nnz is None else f", nnz {out[name]['nnz']}"),
              flush=True)
        return res

    S = op("A + A.T", lambda: A + A.T, lambda r: r.nnz)
    check(S.nnz == A.nnz and bool(torch.equal(S.data, 2 * A.data)), "A + A.T = 2 A (symmetric)")
    del S

    def diff():
        D = A - A.T
        D.eliminate_zeros()
        return D

    check(op("A - A.T, eliminate_zeros", diff, lambda r: r.nnz).nnz == 0, "A - A.T is all zero")
    M = op("A.multiply(A)", lambda: A.multiply(A), lambda r: r.nnz)
    check(M.nnz == A.nnz and bool(torch.equal(M.data, A.data * A.data)), "A.multiply(A) = A^2 "
          "entrywise")
    del M
    ones = torch.ones((N,), dtype=A.dtype, device=dev)
    s0 = op("A.sum(axis=0)", lambda: A.sum(axis=0))
    check(bool(torch.equal(s0, A @ ones)), "column sums equal A @ ones (symmetric, integers)")
    mx = op("A.max(axis=1)", lambda: A.max(axis=1))
    dg = op("A.diagonal()", lambda: A.diagonal())
    check(bool((mx == 4).all()) and bool((dg == 4).all()), "row maxima and the diagonal are 4")
    del s0, mx, dg
    g = torch.Generator(device=dev).manual_seed(24)
    C = torch.randn((N, k), device=dev, generator=g)
    D = torch.randn((k, N), device=dev, generator=g)
    R = op(f"A.sddmm(C, D), k = {k}", lambda: A.sddmm(C, D), lambda r: r.nnz)
    pos = np.random.default_rng(25).choice(A.nnz, 4096, replace=False)
    post = torch.as_tensor(pos, device=dev)
    rows = torch.searchsorted(A.indptr.long(), post, right=True) - 1
    cols = A.indices[post].long()
    Ch, Dh = C[rows].double().cpu().numpy(), D[:, cols].double().cpu().numpy()
    a = A.data[post].double().cpu().numpy()
    want = a * np.einsum("ek,ke->e", Ch, Dh)
    mag = np.abs(a) * np.einsum("ek,ke->e", np.abs(Ch), np.abs(Dh))
    err = np.abs(R.data[post].double().cpu().numpy() - want)
    check(bool(np.all(err <= (k + 2) * np.finfo(np.float32).eps * mag)),
          f"sddmm on {len(pos)} sampled nonzeros vs f64 (bound (k + 2) eps |a| sum |c d|)")
    del R, C, D
    x = torch.tensor(np.random.default_rng(26).standard_normal(N).astype(np.float32), device=dev)
    y1 = op("x @ A", lambda: x @ A)
    y2 = x @ A
    check(bool(torch.equal(y1, y2)) and bool(torch.equal(y1, A @ x)),
          "x @ A twice bit for bit, and equal to A @ x (A symmetric)")
    del y1, y2, x
    L = laplacian_2d_csr(mis_grid, np.float32, device=dev)
    hostsync.HOST_SYNCS = 0
    f1 = op(f"mis_tropical(k=1, seed=0) at {mis_grid}^2", lambda: L.mis_tropical(k=1, seed=0))
    out["mis_host_fetches"] = hostsync.HOST_SYNCS
    f2 = L.mis_tropical(k=1, seed=0)
    check(bool(torch.equal(f1, f2)), "the MIS flags equal on a repeat")
    flags = f1.cpu().numpy()
    ptr = L.indptr.cpu().numpy().astype(np.int64)
    nbr = L.indices.cpu().numpy().astype(np.int64)
    row = np.repeat(np.arange(L.shape[0]), np.diff(ptr))
    off = nbr != row
    member = flags == 2
    adjacent = member[row[off]] & member[nbr[off]]
    covered = np.zeros(L.shape[0], dtype=bool)
    covered[row[off][member[nbr[off]]]] = True
    check(bool(np.all((flags == 0) | member)) and not adjacent.any()
          and bool(np.all(covered[~member])),
          f"a maximal independent set: {int(member.sum())} members, none adjacent, every other "
          f"node next to one ({out['mis_host_fetches']} host fetches)")
    out["mis_members"] = int(member.sum())
    return out


def core_ops(dev, n_mb: int = 2**22, w: int = 11, reps: int = 10, m_rand: int = 2**20,
             grid: int = 6000, cg_iters: int = 100, mis_grid: int = 1000):
    """Phase 11 (a)-(d)."""
    out = {"spgemm_microbench": spgemm_microbench(dev, n_mb, w, reps),
           "spgemm_random": spgemm_random(dev, m_rand)}
    L, out["laplacian_kron"] = laplacian_kron(dev, grid, cg_iters)
    out["elementwise"] = elementwise_ops(dev, L, mis_grid)
    return out


# ---------------------------------------------------------------------------
# phase 12: the rest of linalg
# ---------------------------------------------------------------------------
def pde_laplacian(dev, grid: int, dtype=np.float32):
    """pde.py's grid^2 Laplacian built as pde.py builds it (diags -> tocsc
    -> .T -> tocsr), its scale a = 1/dx^2 as stored, and its closed-form
    spectrum (lo, hi): LaplacianNd's 1-D Dirichlet extremes, twice, times a
    (the stored operator is exactly a times the integer stencil)."""
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch.linalg import LaplacianNd

    diagonals, offsets, n = laplacian_diagonals(grid + 2, grid + 2, dtype=dtype)
    A = sparse.diags(diagonals, offsets, shape=(n, n), dtype=dtype, device=dev).tocsc().T.tocsr()
    a = float(diagonals[1][0])
    lam1 = LaplacianNd((grid,), boundary_conditions="dirichlet").eigenvalues()
    return A, a, (2 * a * lam1[0], 2 * a * lam1[-1])


def reorth_bytes(n: int, itemsize: int, cycles) -> int:
    """Bytes eigsh's full reorthogonalization reads over ``cycles``
    ((start, ncv) pairs): step j reads basis rows 0..j twice (the
    projection and the update)."""
    return sum(2 * (j + 1) * n * itemsize for start, ncv in cycles for j in range(start, ncv))


def spectra(dev, grid: int, small: int = 100, cycles: int = 3, k: int = 6):
    """Phase 12a: eigsh(k, 'LM') on phase 3's grid^2 Laplacian (f32) for a
    fixed ``cycles`` thick-restart cycles (maxiter: the products of the
    first cycles plus one), twice bit for bit; ms a cycle, products a
    second, the products' share of a cycle, HOST_SYNCS a cycle (1: the
    first run adds the DIA layout's build, the second runs under
    ``fetches_only`` from its start, so any other sync fails it); every
    Ritz value inside the closed-form spectrum; each residual estimate
    |beta s_last| against the true ||A y - theta y|| (one product each).
    Then eigsh at small^2 in f64 against the closed form, 1e-8 relative."""
    import torch
    from sparse_tpu_torch import hostsync, linalg
    from sparse_tpu_torch.kernels import dia_spmv as D

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    eps = float(np.finfo(np.float32).eps)
    print(f"phase 12a: eigsh(k={k}, which='LM') on pde.py's {grid}^2 Laplacian (float32), "
          f"{cycles} thick-restart cycles", flush=True)
    A, _, (lo, hi) = pde_laplacian(dev, grid)
    n = A.shape[0]
    ncv = min(max(2 * k + 1, 20), n)
    maxiter = ncv + (cycles - 2) * (ncv - k) + 1  # cycle 1 makes ncv products, then ncv - k
    runs = []
    for rep in range(2):
        stats = {}
        hostsync.HOST_SYNCS = 0
        before = D.dia_spmv_packed.launches
        with fetches_only(dev, from_start=True) if rep else contextlib.nullcontext():
            (w, V), secs = timed(dev, lambda: linalg.eigsh(A, k=k, which="LM", maxiter=maxiter,
                                                            _stats=stats))
        runs.append((w, V, stats, secs, hostsync.HOST_SYNCS, D.dia_spmv_packed.launches - before))
        print(f"  run {rep}: {stats['cycles']} cycles, {stats['matvecs']} products in {secs:.4f} s "
              f"({secs / stats['cycles'] * 1e3:.3f} ms a cycle, {stats['matvecs'] / secs:.1f} "
              f"products/s); HOST_SYNCS {runs[-1][4]}; dia_spmv_packed launches {runs[-1][5]}; "
              f"final ncv {stats['ncv']}", flush=True)
    (w, V, stats, secs, syncs, launched), (w2, V2) = runs[1], runs[0][:2]
    check(runs[0][4] == cycles + 1, f"the first run makes {runs[0][4]} host fetches: one a cycle "
          f"and one for the DIA layout's build (csr._maybe_dia, once a matrix)")
    check(stats["cycles"] == cycles and syncs == cycles
          and (launched == stats["matvecs"] or dev != "cuda"),
          f"{cycles} cycles, one host fetch each ({syncs}) and no other sync (fetches_only from "
          f"the start), one dia_spmv_packed launch a product")
    check(bool(np.array_equal(w, w2)) and bool(torch.equal(V, V2)),
          "two eigsh runs give bit-identical Ritz values and vectors")
    x = V[:, 0].contiguous()
    spmv_ms = cuda_ms(lambda: A @ x, 20, sync) if dev == "cuda" else float("nan")
    rb = reorth_bytes(n, 4, [(0, ncv)] + [(k, ncv)] * (cycles - 2) + [(k, stats["ncv"])])
    cyc_ms = secs / cycles * 1e3
    prod_ms = spmv_ms * stats["matvecs"] / cycles
    print(f"  a cycle {cyc_ms:.3f} ms: products {prod_ms:.3f} ms ({stats['matvecs'] / cycles:.1f} x "
          f"{spmv_ms:.4f} ms, share {prod_ms / cyc_ms:.3f}); the reorthogonalization reads "
          f"{rb / cycles / 1e9:.2f} GB a cycle of the [{ncv}, {n}] basis "
          f"({ncv * n * 4 / 1e9:.2f} GB; {rb / cycles / 3.35e12 * 1e3:.3f} ms at 3.35 TB/s)",
          flush=True)
    margin = 16 * eps * abs(lo)
    check(bool(np.all((w >= lo - margin) & (w <= hi + margin))),
          f"Ritz values {np.sort(w)} inside the closed-form spectrum [{lo:.8g}, {hi:.8g}] "
          f"(+- 16 eps |lo|)")
    true = []
    for i in range(k):
        y = V[:, i].contiguous()
        true.append(float(torch.linalg.vector_norm((A @ y).double() - float(w[i]) * y.double())))
    true, est = np.array(true), np.asarray(stats["resid"])
    floor = 64 * eps * abs(lo)  # f32 rounding of A y and of y itself (||y|| = 1)
    print(f"  residuals: estimate |beta s_last| {est} vs true ||A y - theta y|| {true} "
          f"(floor {floor:.4g})", flush=True)
    check(bool(np.all(np.abs(true - est) <= 0.02 * est + floor)),
          "each residual estimate agrees with the true residual within 2% + 64 eps |lo|")
    As, a_s, _ = pde_laplacian(dev, small, np.float64)
    ws, _ = linalg.eigsh(As, k=k, which="LM")
    lam1 = linalg.LaplacianNd((small,), boundary_conditions="dirichlet").eigenvalues()
    full = np.sort((lam1[:, None] + lam1[None, :]).ravel()) * a_s
    rel = float(np.max(np.abs(np.sort(ws) - full[:k]) / np.abs(full[:k])))
    check(rel <= 1e-8, f"eigsh(k={k}) at {small}^2 (float64): the eigenvalues of largest "
          f"magnitude within {rel:.3g} of the closed form (bound 1e-8)")
    return dict(grid=grid, cycles=stats["cycles"], matvecs=stats["matvecs"], s=secs,
                ms_per_cycle=cyc_ms, products_per_s=stats["matvecs"] / secs, spmv_ms=spmv_ms,
                products_share=prod_ms / cyc_ms, reorth_gb_per_cycle=rb / cycles / 1e9,
                host_syncs_per_cycle=syncs / cycles, ritz=np.asarray(w).tolist(),
                true_resid=true.tolist(), est_resid=est.tolist(), small_rel_err=rel)


def dirichlet_mode(grid: int, k: int):
    """The (k, k) Dirichlet sine mode of the grid^2 Laplacian (unit norm,
    f32, built on the host) and its eigenvalue over a: twice LaplacianNd's
    1-D eigenvalue of mode k."""
    from sparse_tpu_torch._laplacian import _eigvals_1d

    v = np.sin(np.pi * k * np.arange(1, grid + 1) / (grid + 1))
    v /= np.linalg.norm(v)
    return np.outer(v, v).astype(np.float32).reshape(-1), 2 * _eigvals_1d(grid, "dirichlet")[k - 1]


def matrix_functions(dev, grid: int, power_grid: int = 2000):
    """Phase 12b: on phase 3's grid^2 Laplacian (f32), ||A||_1 = 8 a
    (a = 1/dx^2), so t = dx^2 gives ||tA||_1 = 8 and (m, s) = (40, 1).
    expm_multiply(A, u0, t) with u0 the (grid/2, grid/2) sine mode
    (t lambda ~ -4) against e^{t lambda} u0, and the time grid (0, t, 5
    points), in f32 to eps e^{||tA||_1} ||u0|| (the rounding of the
    series' largest partial sums); the products made against the two-term
    test's count. norm (fro, 1, inf) and onenormest (exact; an operator's
    estimate and its certificate) against the closed forms.
    matrix_power(A, 3) at power_grid^2: (A^3) x against A (A (A x)) within
    32 eps |A|^3 |x|, with its peak memory."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import linalg
    from sparse_tpu_torch.kernels import dia_spmv as D

    eps = float(np.finfo(np.float32).eps)
    print(f"phase 12b: expm_multiply, norm, onenormest on the {grid}^2 Laplacian, "
          f"matrix_power at {power_grid}^2 (float32)", flush=True)
    A, a, _ = pde_laplacian(dev, grid)
    n = A.shape[0]
    t = 1.0 / a
    u0_np, lam = dirichlet_mode(grid, grid // 2)
    u0 = torch.tensor(u0_np, device=dev)
    bound = eps * np.exp(8.0)  # ||tA||_1 = 8
    out = {"grid": grid, "t_lambda": lam}
    stats = {}
    before = D.dia_spmv_packed.launches
    F, secs = timed(dev, lambda: linalg.expm_multiply(A, u0, t=t, _stats=stats))
    made = D.dia_spmv_packed.launches - before
    err = float(torch.linalg.vector_norm(F.double() - np.exp(lam) * u0.double()))
    (m_, s_, terms), = stats["stages"]
    print(f"  expm_multiply(A, u0, t=dx^2): (m, s) = ({m_}, {s_}), {terms} terms by the two-term "
          f"test, {made} products made, {secs:.4f} s; ||F - e^(t lambda) u0|| = {err:.4g} "
          f"(e^(t lambda) = {np.exp(lam):.6g})", flush=True)
    check((m_, s_) == (40, 1) and (made >= terms or dev != "cuda") and err <= bound,
          f"(m, s) = (40, 1), at least the test's terms as products, within eps e^8 = "
          f"{bound:.3g} of e^(t lambda) u0")
    out.update(expm_s=secs, m=m_, s=s_, terms=terms, products=made, expm_err=err)
    stats = {}
    before = D.dia_spmv_packed.launches
    G, gsecs = timed(dev, lambda: linalg.expm_multiply(A, u0, start=0.0, stop=t, num=5,
                                                        _stats=stats))
    made = D.dia_spmv_packed.launches - before
    fr = np.linspace(0.0, 1.0, 5)
    errs = [float(torch.linalg.vector_norm(G[i].double() - np.exp(lam * fr[i]) * u0.double()))
            for i in range(5)]
    terms = sum(stage[2] for stage in stats["stages"])
    print(f"  time grid (0, dx^2, 5 points): stages (m, s, terms) {stats['stages']}, {made} "
          f"products made against {terms} by the test, {gsecs:.4f} s; errors {errs}", flush=True)
    check(tuple(G.shape) == (5, n) and max(errs) <= bound,
          f"every grid point within eps e^8 = {bound:.3g} of its closed form")
    out.update(grid_s=gsecs, grid_products=made, grid_terms=terms, grid_errs=errs)
    del F, G

    g = grid
    fro = a * np.sqrt(16.0 * g * g + 4.0 * g * (g - 1))  # 4a on the diagonal, a a neighbor
    got = {o: float(linalg.norm(A, ord=o)) for o in ("fro", 1, np.inf)}
    want = {"fro": fro, 1: 8 * a, np.inf: 8 * a}
    rel = {str(o): abs(got[o] - want[o]) / want[o] for o in got}
    print(f"  norm: {got} against {want}: relative {rel}", flush=True)
    check(rel["fro"] <= 1e-5 and rel["1"] <= 8 * eps and rel["inf"] <= 8 * eps,
          "norm: fro within 1e-5, 1 and inf within 8 eps of the closed forms")
    est = linalg.onenormest(A)
    op = linalg.aslinearoperator(A)
    est_op, v, wv = linalg.onenormest(op, compute_v=True, compute_w=True)
    j = int(torch.argmax(v.abs()))
    ix, iy = j % g, j // g
    col_j = a * (4 + (ix > 0) + (ix < g - 1) + (iy > 0) + (iy < g - 1))
    print(f"  onenormest: exact {est:.8g} (8a = {8 * a:.8g}); operator estimate {est_op:.8g}, "
          f"certificate column {j} (||A e_j||_1 = {col_j:.8g})", flush=True)
    check(abs(est - 8 * a) <= 8 * eps * 8 * a, "the exact 1-norm is 8a")
    check(abs(est_op - col_j) <= 8 * eps * col_j and est_op <= 8 * a * (1 + 8 * eps)
          and abs(est_op - float(wv.abs().sum())) <= 8 * eps * col_j,
          "the operator estimate is ||A e_j||_1 of its certificate column, at most ||A||_1")
    out.update(norms={str(o): v_ for o, v_ in got.items()}, onenormest=est,
               onenormest_op=est_op, onenormest_col=j)
    del A, op, v, wv

    P, _, _ = pde_laplacian(dev, power_grid)
    x = torch.tensor(np.random.default_rng(31).uniform(-1, 1, P.shape[0]).astype(np.float32),
                     device=dev)
    base = 0
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    P3, psecs = timed(dev, lambda: linalg.matrix_power(P, 3))
    peak = (torch.cuda.max_memory_allocated() - base) if dev == "cuda" else 0
    y3 = P3 @ x
    y1 = P @ (P @ (P @ x))
    Pa = sparse.csr_array((P.data.abs(), P.indices, P.indptr), shape=P.shape)
    bound = (Pa @ (Pa @ (Pa @ x.abs()))).double()
    diff = (y3.double() - y1.double()).abs()
    print(f"  matrix_power(A, 3) at {power_grid}^2: {P3} in {psecs:.4f} s, peak {peak / 2**30:.2f} "
          f"GiB over the operands; max |A^3 x - A (A (A x))| / (|A|^3 |x|) "
          f"{float((diff / bound).max()):.3g}", flush=True)
    check(bool((diff <= 32 * eps * bound).all()),
          "(A^3) @ x equals A @ (A @ (A @ x)) within 32 eps |A|^3 |x|")
    out.update(power_s=psecs, power_peak_gib=peak / 2**30, power_nnz=P3.nnz)
    return out


def laplacian_nd(dev, grid: int):
    """Phase 12c: LaplacianNd((grid, grid), 'dirichlet', float32): matvec
    (plain torch shifts) against tosparse() @ x (kronsum, then the DIA
    kernel) on an integer-valued x, where every sum is exact: equal."""
    import torch
    from sparse_tpu_torch import linalg

    print(f"phase 12c: LaplacianNd(({grid}, {grid}), 'dirichlet', float32)", flush=True)
    L = linalg.LaplacianNd((grid, grid), boundary_conditions="dirichlet", dtype=np.float32,
                           device=dev)
    x = torch.tensor(np.random.default_rng(37).integers(-8, 9, grid * grid).astype(np.float32),
                     device=dev)
    y, mv_s = timed(dev, lambda: L.matvec(x))
    S, build_s = timed(dev, L.tosparse)
    ys, sp_s = timed(dev, lambda: S @ x)
    print(f"  matvec {mv_s:.4f} s; tosparse {S} in {build_s:.4f} s; tosparse() @ x {sp_s:.4f} s",
          flush=True)
    check(bool(torch.equal(y, ys)), "matvec equals tosparse() @ x bit for bit")
    return dict(grid=grid, matvec_s=mv_s, tosparse_s=build_s, product_s=sp_s, nnz=S.nnz)


def svds_general(dev, m: int, small_m: int, cycles: int = 3, k: int = 6):
    """Phase 12d (i): svds(k) on skewed_nonsym_csr(m) (f32) under spmv_mode
    'sell' (the A and A^T products through sell_chunk_spmv) for ``cycles``
    Lanczos cycles, timed, with each triplet's true residuals: ||A v - s u||
    is small by construction (U = A V / s), ||A^T u - s v|| / s is eigsh's
    relative residual on A^T A, held to 1e-4 (f32 Lanczos after 3 cycles;
    a wrong product leaves O(1)); svds at small_m in f64 against
    scipy.sparse.linalg.svds on the host, 1e-6 relative."""
    import scipy.sparse.linalg as sla
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import linalg

    t0 = time.perf_counter()
    A_s = skewed_nonsym_csr(m)
    host_s = time.perf_counter() - t0
    print(f"phase 12d: svds(k={k}) on skewed_nonsym_csr({m}) (float32, nnz {A_s.nnz}, built on the "
          f"host in {host_s:.2f} s), spmv_mode 'sell', {cycles} Lanczos cycles", flush=True)
    prev = sparse.settings.spmv_mode
    sparse.settings.spmv_mode = "sell"
    try:
        A = sparse.csr_array(A_s, device=dev)
        del A_s
        ncv = max(2 * k + 1, 20)
        maxiter = ncv + (cycles - 2) * (ncv - k) + 1
        (U, s, Vh), secs = timed(dev, lambda: linalg.svds(A, k=k, maxiter=maxiter))
        res = []
        for i in range(k):
            u, v = U[:, i].contiguous(), Vh[i].contiguous()
            res.append((float(torch.linalg.vector_norm(A @ v - float(s[i]) * u)),
                        float(torch.linalg.vector_norm(A.T @ u - float(s[i]) * v))))
        print(f"  {secs:.4f} s; sigma {s}; (||A v - s u||, ||A^T u - s v||) {res}", flush=True)
        check(bool(np.all(np.isfinite(s))) and bool(np.all(np.diff(s) <= 0)) and s[-1] > 0
              and bool(np.all(np.isfinite(res))), "finite, positive, descending singular values")
        adj = max(r[1] / float(si) for r, si in zip(res, s))
        check(adj <= 1e-4, f"every ||A^T u - s v|| / s within 1e-4 ({adj:.3g})")
        B_s = skewed_nonsym_csr(small_m).astype(np.float64)
        sb = linalg.svds(sparse.csr_array(B_s, device=dev), k=k, return_singular_vectors=False)
        ref = np.sort(sla.svds(B_s, k=k, return_singular_vectors=False))[::-1]
        rel = float(np.max(np.abs(sb - ref) / ref))
        check(rel <= 1e-6, f"svds(k={k}) at m = {small_m} (float64) within {rel:.3g} of scipy's "
              f"(bound 1e-6)")
    finally:
        sparse.settings.spmv_mode = prev
    return dict(m=m, s=secs, sigma=np.asarray(s).tolist(), residuals=res, adjoint_rel=adj,
                small_rel=rel)


def lobpcg_eigs(dev, grid: int, k_lob: int = 4, lob_iters: int = 20, k: int = 6,
                eigs_tol: float = 1e-4, eigs_restarts: int = 300):
    """Phase 12d (ii): lobpcg (k_lob vectors, lob_iters iterations) on the
    grid^2 Laplacian (f32; its block products are matmat, which has no
    kernel), timed, with true residuals, held against the same call on CPU
    tensors (the plain products; same X0): Ritz values within 1e-4
    relative, |X_cpu^T X| within 1e-2 of I (at 1000^2 the CPU's f32 and f64
    runs differ by 1.7e-6 and 3.1e-4, one iteration more moves the values
    by 9%); and eigs(k) on the grid^2 upwind convection-diffusion operator
    (f32; a complex product is two real DIA products) to ``eigs_tol``:
    timed, with true residuals."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import linalg

    print(f"phase 12d: lobpcg(k={k_lob}, {lob_iters} iterations) on the {grid}^2 Laplacian, "
          f"eigs(k={k}, tol={eigs_tol}) on the {grid}^2 convection-diffusion operator (float32)",
          flush=True)
    A, _, (lo, hi) = pde_laplacian(dev, grid)
    n = A.shape[0]
    X0 = np.random.default_rng(41).standard_normal((n, k_lob)).astype(np.float32)
    (lam, X), lsecs = timed(dev, lambda: linalg.lobpcg(A, X0, maxiter=lob_iters, tol=0.0))
    Xd = torch.tensor(X, device=dev)
    lres = [float(torch.linalg.vector_norm(A @ Xd[:, i].contiguous() - float(lam[i]) * Xd[:, i]))
            / abs(float(lam[i])) for i in range(k_lob)]
    print(f"  lobpcg: {lsecs:.4f} s; lambda {lam}; ||A x - lambda x|| / |lambda| {lres}",
          flush=True)
    check(bool(np.all((lam >= lo * (1 + 1e-6)) & (lam <= hi * (1 - 1e-6))))
          and bool(np.all(np.isfinite(lres))), "lobpcg's Ritz values inside the spectrum")
    Ac, _, _ = pde_laplacian("cpu", grid)
    (lam_c, X_c), csecs = timed("cpu", lambda: linalg.lobpcg(Ac, X0, maxiter=lob_iters, tol=0.0))
    lrel = float(np.max(np.abs(lam - lam_c) / np.abs(lam_c)))
    vdiff = float(np.max(np.abs(np.abs(X_c.astype(np.float64).T @ X.astype(np.float64))
                                - np.eye(k_lob))))
    print(f"  lobpcg on CPU tensors (the plain products): {csecs:.4f} s; lambda {lam_c}; the "
          f"card's within {lrel:.3g} relative, |X_cpu^T X| within {vdiff:.3g} of I", flush=True)
    check(lrel <= 1e-4 and vdiff <= 1e-2,
          "lobpcg on the card equals the CPU's: Ritz values within 1e-4, vectors within 1e-2")
    del A, Ac, Xd
    diagonals, offsets, n = convection_diffusion_diagonals(grid, grid)
    C = sparse.diags(diagonals, offsets, shape=(n, n), dtype=np.float32, device=dev).tocsc().T
    C = C.tocsr()
    (vals, vecs), esecs = timed(dev, lambda: linalg.eigs(C, k=k, tol=eigs_tol,
                                                        maxiter=eigs_restarts))
    V = torch.tensor(vecs, device=dev)
    eres = []
    for i in range(k):
        v = V[:, i]
        Av = torch.complex(C @ v.real.contiguous(), C @ v.imag.contiguous())
        eres.append(float(torch.linalg.vector_norm(Av - complex(vals[i]) * v)) / abs(vals[i]))
    print(f"  eigs: {esecs:.4f} s; lambda {vals}; ||A v - lambda v|| / |lambda| {eres}", flush=True)
    check(bool(np.all(np.array(eres) <= 10 * eigs_tol)),
          "eigs' true residuals within 10 tol (its own gate)")
    return dict(lobpcg_s=lsecs, lobpcg_lambda=np.asarray(lam).tolist(), lobpcg_resid=lres,
                lobpcg_cpu_s=csecs, lobpcg_cpu_rel=lrel, lobpcg_cpu_vec=vdiff,
                eigs_s=esecs, eigs_lambda=[[float(v.real), float(v.imag)] for v in vals],
                eigs_resid=eres)


def kernel_launches(fn) -> int:
    """The device events (kernels and memory operations) one call of ``fn``
    makes, by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def direct_solvers(dev, lu_grid: int = 256, ilu_grid: int = 1000, tri_n: int = 10**6,
                   dense_n: int = 2048, gmres_cycles: int = 1):
    """Phase 12e: splu of the lu_grid^2 Laplacian in f64 (the native
    factor, then triangular solves on the card: a loop, a capture, a
    replay), residual <= 1e-10, and the device events of a step (by
    torch.profiler, on its L solve as a loop); spilu (ILU(0)) of the ilu_grid^2
    convection-diffusion operator in f32, one apply as a loop and as a
    CUDA graph (bit for bit, timed; its device events counted as 2 K times
    splu's events a step, the same step code), as gmres's M
    (restart 20, tol 1e-6 ||b||) for gmres_cycles cycles against gmres
    without M for as many, and without M to the tolerance (an apply takes
    a graph replay of 2 K sequential steps, so ILU-preconditioned gmres to
    1e-6 here, ~1500 iterations, would take ~1000 s); the tri_n-row
    tridiagonal ILU, whose one-shot solve (a loop) is S^-1 b; dense splu,
    inv and expm at dense_n against scipy."""
    import scipy.linalg
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import linalg, native

    print(f"phase 12e: direct solvers: splu at {lu_grid}^2 (float64), spilu + gmres at "
          f"{ilu_grid}^2 (float32), ILU(0) of a {tri_n}-row tridiagonal, dense at n = {dense_n}",
          flush=True)
    check(native.lib() is not None, "the native host library is built (the factorizations run)")
    out = {}
    A, _, _ = pde_laplacian(dev, lu_grid, np.float64)
    n = A.shape[0]
    lu, fsecs = timed(dev, lambda: linalg.splu(A))
    b = torch.tensor(np.random.default_rng(43).standard_normal(n), device=dev)
    # the first solve runs the steps as a loop, the second captures graphs
    (x, first), (_, second), (x3, third) = (timed(dev, lambda: lu.solve(b)) for _ in range(3))
    rel = float(torch.linalg.vector_norm(b - A @ x) / torch.linalg.vector_norm(b))
    fill = lu._Lcsc[2].size + lu._Ucsc[2].size
    steps = lu._Lprep.K
    events = kernel_launches(lambda: lu._Lprep.apply(b[:, None], graph=False)) \
        if dev == "cuda" else 0
    print(f"  splu: mode {lu._mode}, factor {fsecs:.3f} s, nnz(L) + nnz(U) = {fill}; solve "
          f"{first * 1e3:.2f} ms as a loop, {second * 1e3:.2f} ms capturing, {third * 1e3:.2f} ms "
          f"replayed (K = {lu._Lprep.K} steps of nb = {lu._Lprep.nb} a factor; its L solve as a loop "
          f"makes {events} device events, {events / steps:.2f} a step); "
          f"||b - A x|| / ||b|| = {rel:.3g}", flush=True)
    check(lu._mode == "sparse" and rel <= 1e-10 and bool(torch.equal(x, x3)),
          "the sparse splu solves to 1e-10, its graph replay equal to its loop")
    out["splu"] = dict(n=n, factor_s=fsecs, fill=int(fill), loop_ms=first * 1e3,
                       capture_ms=second * 1e3, graph_ms=third * 1e3, events=events,
                       events_per_step=events / steps, rel=rel)
    del A, lu

    diagonals, offsets, n = convection_diffusion_diagonals(ilu_grid, ilu_grid)
    C = sparse.diags(diagonals, offsets, shape=(n, n), dtype=np.float32, device=dev).tocsc().T
    C = C.tocsr()
    ilu, isecs = timed(dev, lambda: linalg.spilu(C))
    bc = torch.tensor(np.random.default_rng(47).standard_normal(n).astype(np.float32), device=dev)

    def apply(graph):
        return ilu._Usolve.apply(ilu._Lsolve.apply(bc[:, None], graph=graph), graph=graph)[:, 0]

    y_loop, loop_s = timed(dev, lambda: apply(False))
    _, capture_s = timed(dev, lambda: apply(True))  # captures both graphs
    y_graph, graph_s = timed(dev, lambda: apply(True))
    check(bool(torch.equal(y_graph, y_loop)), "the graph-replayed apply equals the loop bit for bit")
    prep = ilu._Lsolve
    launches = 2 * prep.K * out["splu"]["events_per_step"]
    print(f"  spilu: factor {isecs:.3f} s; nb {prep.nb}, K {prep.K} steps a triangular solve; one "
          f"apply (L then U) {loop_s * 1e3:.2f} ms as a loop, {graph_s * 1e3:.2f} ms as a graph "
          f"(capture {capture_s:.3f} s); device events an apply ~ 2 K x {launches / (2 * prep.K):.2f} "
          f"(splu's a step) = {launches:.0f}", flush=True)
    M = linalg.LinearOperator((n, n), matvec=ilu.solve, dtype=torch.float32)
    M.device = bc.device
    res = {}
    for label, kw, cycles in (("M", {"M": M}, gmres_cycles), ("plain", {}, gmres_cycles),
                              ("plain to tol", {}, 10**4)):
        (xg, its), gs = timed(dev, lambda: linalg.gmres(C, bc, tol=1e-6, restart=20,
                                                         maxiter=cycles, **kw))
        r = float(torch.linalg.vector_norm(bc.double() - (C @ xg).double())
                  / torch.linalg.vector_norm(bc.double()))
        res[label] = dict(iters=its, s=gs, rel=r)
        print(f"  gmres ({label}, restart 20, at most {cycles} cycles): {its} iterations in "
              f"{gs:.3f} s ({gs / max(its, 1) * 1e3:.2f} ms an iteration), true ||b - A x|| / ||b|| "
              f"= {r:.4g}", flush=True)
    check(res["M"]["rel"] < res["plain"]["rel"] and res["plain to tol"]["iters"] < 20 * 10**4,
          "at equal iterations ILU(0) leaves the smaller residual; without M gmres stops on tol")
    out["spilu_gmres"] = dict(n=n, factor_s=isecs, nb=prep.nb, K=prep.K, apply_loop_ms=loop_s * 1e3,
                              apply_graph_ms=graph_s * 1e3, capture_s=capture_s,
                              apply_events=launches, **res)
    del C, ilu, M

    S = sp.diags([np.full(tri_n - 1, -1.0), np.full(tri_n, 4.0), np.full(tri_n - 1, -1.0)],
                 [-1, 0, 1], format="csr")
    St = sparse.csr_array(S, device=dev)
    ilu, tsecs = timed(dev, lambda: linalg.spilu(St))
    bt = torch.ones((tri_n,), dtype=torch.float64, device=dev)
    xt, tsol = timed(dev, lambda: ilu.solve(bt))
    rt = float(torch.linalg.vector_norm(St @ xt - bt) / torch.linalg.vector_norm(bt))
    print(f"  tridiagonal ILU(0) at {tri_n} rows: factor {tsecs:.3f} s, solve (a loop) {tsol:.3f} s "
          f"(K = {ilu._Lsolve.K}); ||S x - b|| / ||b|| = {rt:.3g}", flush=True)
    check(rt <= 1e-12, "the tridiagonal ILU(0) solve is S^-1 b (an exact LU) to 1e-12")
    out["tridiagonal"] = dict(n=tri_n, factor_s=tsecs, solve_s=tsol, rel=rt)
    del ilu, St, xt

    rng = np.random.default_rng(53)
    D_s = (sp.random(dense_n, dense_n, 8 / dense_n, random_state=rng)
           + 4 * sp.identity(dense_n)).tocsr()
    Dm = sparse.csr_array(D_s, device=dev)
    bd = rng.standard_normal(dense_n)
    xd, dsecs = timed(dev, lambda: linalg.splu(Dm).solve(torch.tensor(bd, device=dev)))
    ref = sla.spsolve(D_s.tocsc(), bd)
    rel_lu = float(np.linalg.norm(xd.cpu().numpy() - ref) / np.linalg.norm(ref))
    Ainv, inv_s = timed(dev, lambda: linalg.inv(Dm))
    ref = np.linalg.inv(D_s.toarray())
    rel_inv = float(np.linalg.norm(Ainv.toarray().cpu().numpy() - ref) / np.linalg.norm(ref))
    E_s = (D_s * 0.1).tocsr()
    E, exp_s = timed(dev, lambda: linalg.expm(sparse.csr_array(E_s, device=dev)))
    ref = scipy.linalg.expm(E_s.toarray())
    rel_exp = float(np.linalg.norm(E.toarray().cpu().numpy() - ref) / np.linalg.norm(ref))
    print(f"  dense at n = {dense_n}: splu + solve {dsecs:.3f} s (rel {rel_lu:.3g}), inv {inv_s:.3f} "
          f"s (rel {rel_inv:.3g}), expm {exp_s:.3f} s (rel {rel_exp:.3g}) against scipy", flush=True)
    check(max(rel_lu, rel_inv, rel_exp) <= 1e-10, "dense splu, inv and expm within 1e-10 of scipy")
    out["dense"] = dict(n=dense_n, splu_s=dsecs, inv_s=inv_s, expm_s=exp_s, rel_lu=rel_lu,
                        rel_inv=rel_inv, rel_expm=rel_exp)
    return out


def linalg_rest(dev, drive, grid: int = 6000, small: int = 100, power_grid: int = 2000,
                skew_m: int = 2**21, small_m: int = 2**13, lob_grid: int = 1000,
                lu_grid: int = 256, tri_n: int = 10**6, dense_n: int = 2048,
                gmres_cycles: int = 1):
    """Phase 12 (a)-(e), each operator run by ``drive`` with the launch
    counters at 0; prints its seconds on the host clock."""
    t0 = time.perf_counter()
    dia, sell = ("dia_spmv_packed",), ("sell_chunk_spmv",)
    out = {"spectra": drive("spectra (12a)", dia, spectra, dev, grid, small)}
    out["matrix_functions"] = drive("matrix functions (12b)", dia, matrix_functions, dev, grid,
                                    power_grid)
    out["laplacian_nd"] = drive("LaplacianNd (12c)", dia, laplacian_nd, dev, grid)
    out["svds"] = drive("svds (12d)", sell, svds_general, dev, skew_m, small_m)
    out["lobpcg_eigs"] = drive("lobpcg and eigs (12d)", dia, lobpcg_eigs, dev, lob_grid)
    out["direct"] = drive("direct solvers (12e)", dia, direct_solvers, dev, lu_grid, lob_grid,
                          tri_n, dense_n, gmres_cycles)
    out["s"] = time.perf_counter() - t0
    print(f"phase 12 took {out['s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: the remaining formats and application modules
# ---------------------------------------------------------------------------
def ring_adjacency(n: int) -> np.ndarray:
    """The dense 0/1 adjacency of the n-atom ring C_n (the card machine has
    no networkx; quantum takes a dense adjacency as it takes a graph)."""
    adj = np.zeros((n, n), dtype=np.int8)
    i = np.arange(n)
    adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1
    return adj


def ring_hamiltonians(dev, nodes: int, dtype):
    """(H_driver, H_cost, the MIS Hamiltonian, build seconds) of the
    nodes-atom ring on ``dev``, built as examples/quantum_evolution.py
    builds them, in ``dtype`` (their values are integers)."""
    from sparse_tpu_torch import quantum

    adj = ring_adjacency(nodes)

    def build():
        drv = quantum.HamiltonianDriver(graph=adj, dtype=dtype, device=dev)
        mis = quantum.HamiltonianMIS(graph=adj, poly=drv.ip, dtype=dtype, device=dev)
        return drv.hamiltonian, mis.hamiltonian, mis

    (Hd, Hc, mis), secs = timed(dev, build)
    return Hd, Hc, mis, secs


def stacked_rhs(Hc, Hd, T: float):
    """examples/quantum_evolution.py's accelerator form: both Hamiltonians
    are real, so i y' = H(t) y, H(t) = (t/T) H_cost + (1 - t/T) H_driver,
    is the stacked real system (yr, yi)' = (H yi, -H yr)."""
    import torch

    nst = Hc.shape[0]

    def rhs(t, y):
        a, b = t / T, 1.0 - t / T
        yr, yi = y[:nst], y[nst:]
        return torch.cat([a * (Hc @ yi) + b * (Hd @ yi), -(a * (Hc @ yr) + b * (Hd @ yr))])

    return rhs


def evolve(dev, rhs, y0, T: float, rtol: float, atol: float):
    """(solve_ivp's DOP853 result, seconds, HOST_SYNCS) from 0 to T, every
    sync outside the counted fetches an error (``fetches_only`` from the
    start)."""
    from sparse_tpu_torch import hostsync, integrate

    hostsync.HOST_SYNCS = 0
    with fetches_only(dev, from_start=True):
        out, secs = timed(dev, lambda: integrate.solve_ivp(rhs, (0.0, T), y0, method="DOP853",
                                                          rtol=rtol, atol=atol))
    return out, secs, hostsync.HOST_SYNCS


def quantum_ring(dev, nodes: int = 30, small: int = 16, T: float = 1.0):
    """Phase 13a: examples/quantum_evolution.py's f32 stacked-real form on
    the nodes-atom ring (``-graph cycle``): the Hamiltonian build, then
    DOP853 from 0 to T at rtol 1e-5, atol 1e-7 (dia_spmv_packed on the
    diagonal cost, ELL on H_driver under 'auto'), with one counted
    fetch a step attempt past the setup's three and no other sync, twice
    bit for bit; steps, nfev, steps/s, the norm drift, the MIS overlap and
    cost; the card's busy share over RHS_PROFILED right-hand sides. Then the
    small-ring check: the same form in f64 on the card at rtol 1e-10
    against scipy's DOP853 in complex128 on the host."""
    import scipy.integrate as si
    import scipy.sparse as sp
    import torch
    from sparse_tpu_torch import integrate

    print(f"phase 13a: quantum evolution on the {nodes}-atom ring (examples/quantum_evolution.py "
          f"-graph cycle -nodes {nodes}, stacked real f32, DOP853 to T = {T})", flush=True)
    Hd, Hc, mis, build_s = ring_hamiltonians(dev, nodes, np.float32)
    nst = Hc.shape[0]
    print(f"  Hamiltonian build {build_s:.2f} s: {nst} states, H_driver nnz {Hd.nnz}", flush=True)
    rhs = stacked_rhs(Hc, Hd, T)
    y0 = torch.zeros((2 * nst,), dtype=torch.float32, device=dev)
    y0[nst - 1] = 1.0  # the empty-set state, real part
    _, warm_s = timed(dev, lambda: rhs(0.0, y0))  # the layouts: DIA planes, ELL
    runs = [evolve(dev, rhs, y0, T, 1e-5, 1e-7) for _ in range(2)]
    (out, secs, syncs), (out2, secs2, syncs2) = runs
    steps = len(out.t) - 1
    attempts = (out.nfev - 2) // integrate.DOP853.n_stages
    yh = out.y[:, -1].cpu().numpy().astype(np.float64)
    final = yh[:nst] + 1j * yh[nst:]
    res = dict(nodes=nodes, nstates=nst, nnz_driver=Hd.nnz, build_s=build_s, warm_rhs_s=warm_s,
               steps=steps, nfev=out.nfev, attempts=attempts, s=secs, s_repeat=secs2,
               steps_per_s=steps / secs, host_syncs=syncs,
               norm_drift=abs(float(np.linalg.norm(final)) - 1.0),
               mis_size=int(mis.optimum), overlap=mis.optimum_overlap(final),
               cost=mis.cost_function(final))
    print(f"  DOP853: {steps} steps, nfev {out.nfev} ({attempts} step attempts) in {secs:.3f} s = "
          f"{res['steps_per_s']:.3f} steps/s (repeat {secs2:.3f} s); HOST_SYNCS {syncs}; norm drift "
          f"{res['norm_drift']:.3e}; MIS size {res['mis_size']}, optimum overlap "
          f"{res['overlap']:.4f}, cost {res['cost']:.4f}", flush=True)
    check(out.status == 0 and steps > 0, "the evolution reaches T")
    check(syncs == syncs2 == 3 + attempts,
          "one counted fetch a step attempt past the setup's three, and no other sync")
    check(bool(torch.equal(out.y, out2.y)) and np.array_equal(out.t, out2.t),
          "the evolution repeats bit for bit")
    check(res["norm_drift"] <= 1e-3 and np.isfinite(res["cost"]),
          "the norm holds to 1e-3 in f32 and the cost is finite")
    res["busy_share"] = device_share(f"{RHS_PROFILED} right-hand sides under 'auto' ({nodes}-atom "
                                     "ring)", lambda: [rhs(0.5, y0) for _ in range(RHS_PROFILED)]
                                     ) if dev == "cuda" else None
    res["final"], res["t"] = out.y[:, -1].clone(), out.t
    res["H"] = (Hd, Hc)  # the SELL rerun's operators (its chunk packs are plan-cached apart)
    del out, out2, runs

    Hd64, Hc64, _, _ = ring_hamiltonians(dev, small, np.float64)
    ns = Hc64.shape[0]
    rhs64 = stacked_rhs(Hc64, Hd64, T)
    y064 = torch.zeros((2 * ns,), dtype=torch.float64, device=dev)
    y064[ns - 1] = 1.0
    rhs64(0.0, y064)
    out64, _, _ = evolve(dev, rhs64, y064, T, 1e-10, 1e-12)
    yc = out64.y[:, -1].cpu().numpy()
    yc = yc[:ns] + 1j * yc[ns:]

    def host(H):
        H = H.tocsr()
        return sp.csr_matrix(tuple(a.cpu().numpy() for a in (H.data, H.indices, H.indptr)),
                             shape=H.shape)

    Hds, Hcs = host(Hd64), host(Hc64)
    yc0 = np.zeros(ns, dtype=np.complex128)
    yc0[-1] = 1.0
    ref = si.solve_ivp(lambda t, y: -1j * ((t / T) * (Hcs @ y) + (1 - t / T) * (Hds @ y)),
                       (0.0, T), yc0, method="DOP853", rtol=1e-10, atol=1e-12)
    err = float(np.abs(yc - ref.y[:, -1]).max())
    res["small"] = dict(nodes=small, nstates=ns, steps=len(out64.t) - 1, ref_steps=len(ref.t) - 1,
                        max_abs_err=err)
    print(f"  {small}-atom ring in f64 ({ns} states): {len(out64.t) - 1} steps against scipy's "
          f"{len(ref.t) - 1}; max |y - y_scipy| = {err:.3e}", flush=True)
    check(err <= QUANTUM_SMALL_BOUND,
          f"the {small}-atom evolution within {QUANTUM_SMALL_BOUND:g} of scipy's DOP853, each "
          "component")
    return res


# right-hand sides under one profile: the profiler misses the first few
# kernels after it starts, most of one 'sell' right-hand side's (~1.5 ms)
RHS_PROFILED = 10
# the cycle-16 f64 evolution against scipy's: both at rtol 1e-10, atol
# 1e-12, each component within 1e-9 (the CPU rehearsal: 3.9e-13)
QUANTUM_SMALL_BOUND = 1e-9


def quantum_sell(dev, ring, T: float = 1.0):
    """Phase 13a under spmv_mode 'sell': the same evolution on the same
    operators with both Hamiltonians through sell_chunk_spmv, timed beside
    the ELL run, its final state equal to the ELL run's bit for bit. Both
    products sum a row as acc + v * x[c], each product and each sum
    rounded, over the row's CSR order with zero pads at the end, and no
    row of the ring's is wider than a chunk segment (SELL_SEGMENT), so no
    partial sums; the diagonal H_cost is one product a row either way."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch.kernels.sell_spmv import SELL_SEGMENT

    Hd, Hc = ring["H"]
    nst = Hc.shape[0]
    check(max(Hd._ell_width(), Hc._ell_width()) <= SELL_SEGMENT,
          f"every row of the ring's Hamiltonians fits one SELL segment ({SELL_SEGMENT})")
    prev = sparse.settings.spmv_mode
    sparse.settings.spmv_mode = "sell"
    try:
        rhs = stacked_rhs(Hc, Hd, T)
        y0 = torch.zeros((2 * nst,), dtype=torch.float32, device=dev)
        y0[nst - 1] = 1.0
        _, warm_s = timed(dev, lambda: rhs(0.0, y0))  # the chunk packs
        out, secs, syncs = evolve(dev, rhs, y0, T, 1e-5, 1e-7)
        busy = device_share(f"{RHS_PROFILED} right-hand sides under 'sell' ({ring['nodes']}-atom "
                            "ring)", lambda: [rhs(0.5, y0) for _ in range(RHS_PROFILED)]
                            ) if dev == "cuda" else None
    finally:
        sparse.settings.spmv_mode = prev
    diff = float((out.y[:, -1] - ring["final"]).abs().max())
    steps = len(out.t) - 1
    res = dict(steps=steps, nfev=out.nfev, s=secs, steps_per_s=steps / secs, host_syncs=syncs,
               pack_s=warm_s, busy_share=busy, max_abs_diff_vs_ell=diff)
    print(f"  under spmv_mode 'sell': {steps} steps, nfev {out.nfev} in {secs:.3f} s = "
          f"{res['steps_per_s']:.3f} steps/s (ELL: {ring['steps_per_s']:.3f}); chunk packs "
          f"{warm_s:.2f} s; max |y_sell - y_ell| = {diff:.3e}", flush=True)
    check(np.array_equal(out.t, ring["t"]) and bool(torch.equal(out.y[:, -1], ring["final"])),
          "the SELL run's times and final state equal the ELL run's bit for bit")
    return res


def heat_equation(dev, n_bdf: int = 64, n_radau: int = 32, t_end: float = 0.1):
    """Phase 13b: examples/heat_implicit.py's problem, u' = L u with L the
    5-point Laplacian over h^2 (f64, banded: dia_spmv_packed), BDF at
    n_bdf^2 unknowns (a dense LU on the card) and Radau at n_radau^2, to
    t_end with jac=L: the mode-1 decay within 1e-4 relative of
    exp(-lambda_1 t)."""
    from sparse_tpu_torch import integrate
    from sparse_tpu_torch.models.poisson import laplacian_2d_csr_host

    print(f"phase 13b: heat equation (examples/heat_implicit.py): BDF at {n_bdf}^2, Radau at "
          f"{n_radau}^2, to t = {t_end} (float64)", flush=True)
    out = {}
    for method, n in (("BDF", n_bdf), ("Radau", n_radau)):
        L = (laplacian_2d_csr_host(n, device=dev) * (-(n + 1) ** 2)).tocsr()
        x = np.linspace(0, 1, n + 2)[1:-1]
        y0 = (np.sin(np.pi * x)[:, None] * np.sin(np.pi * x)[None, :]).ravel()
        sol, secs = timed(dev, lambda: integrate.solve_ivp(
            lambda t, y: L @ y, (0.0, t_end), y0, method=method, jac=L, rtol=1e-6, atol=1e-9,
            device=dev))
        lam1 = 4 * (n + 1) ** 2 * (1 - np.cos(np.pi / (n + 1)))
        decay = float(sol.y[:, -1].cpu().numpy() @ y0 / (y0 @ y0))
        rel = abs(decay / np.exp(-lam1 * t_end) - 1)
        out[method] = dict(n=n, steps=len(sol.t) - 1, nfev=sol.nfev, nlu=sol.nlu, s=secs,
                           decay=decay, rel=rel)
        print(f"  {method} at {n}^2 = {n * n} unknowns: status {sol.status}, {len(sol.t) - 1} steps, "
              f"nfev {sol.nfev}, nlu {sol.nlu}, {secs:.2f} s; mode-1 decay {decay:.8f} against "
              f"exp(-lambda_1 t) {np.exp(-lam1 * t_end):.8f} (rel {rel:.2e})", flush=True)
        check(sol.status == 0 and rel <= 1e-4, f"{method}'s mode-1 decay within 1e-4 of the "
              "closed form")
    return out


def grid_graph(dev, n: int, cut: bool = False):
    """The n^2 5-point grid graph with unit weights (both directions of
    each edge), built on ``dev``; ``cut`` drops the edges between the
    middle two columns."""
    import torch
    import sparse_tpu_torch as sparse

    ids = torch.arange(n * n, device=dev).view(n, n)
    h0, h1 = ids[:, :-1], ids[:, 1:]
    if cut:
        keep = torch.arange(n - 1, device=dev) != n // 2 - 1
        h0, h1 = h0[:, keep], h1[:, keep]
    h0, h1 = h0.reshape(-1), h1.reshape(-1)
    v0, v1 = ids[:-1].reshape(-1), ids[1:].reshape(-1)
    rows, cols = torch.cat([h0, h1, v0, v1]), torch.cat([h1, h0, v1, v0])
    w = torch.ones(rows.shape, dtype=torch.float64, device=dev)
    return sparse.coo_array((w, (rows, cols)), shape=(n * n, n * n)).tocsr()


def twice(dev, fn):
    """(first result, seconds, its counted fetches, second result)."""
    from sparse_tpu_torch import hostsync

    hostsync.HOST_SYNCS = 0
    first, secs = timed(dev, fn)
    fetches = hostsync.HOST_SYNCS
    return first, secs, fetches, fn()


def csgraph_grid(dev, n: int = 2000, rcm_grid: int = 256, natural_fill=None):
    """Phase 13c: csgraph on the n^2 grid graph: connected_components (1,
    and 2 with the middle column's edges cut), breadth_first_order from
    vertex 0 and dijkstra from the four corners against the closed form
    |di| + |dj|, each call twice bit for bit with its counted fetches;
    reverse_cuthill_mckee of a randomly permuted rcm_grid^2 Laplacian
    (its bandwidth back to at most rcm_grid), and splu(permc_spec='RCM')
    of it in f64: a solve's residual, and its fill against NATURAL's on
    the unpermuted operator (phase 12e's ``natural_fill``)."""
    import scipy.sparse as sp
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import csgraph, linalg

    N = n * n
    print(f"phase 13c: csgraph on the {n}^2 grid graph ({N} vertices), RCM and splu(RCM) at "
          f"{rcm_grid}^2", flush=True)
    G, build_s = timed(dev, lambda: grid_graph(dev, n))
    Gc = grid_graph(dev, n, cut=True)
    ii, jj = np.divmod(np.arange(N), n)
    out = {"n": n, "edges": G.nnz, "build_s": build_s}
    print(f"  built on the card in {build_s:.2f} s: {G.nnz} directed edges", flush=True)

    (k, lab), cc_s, cc_f, (k2, lab2) = twice(dev, lambda: csgraph.connected_components(G))
    (kc, labc), cut_s, _, (kc2, labc2) = twice(dev, lambda: csgraph.connected_components(Gc))
    print(f"  connected_components: {k} in {cc_s:.2f} s ({cc_f} fetches); cut: {kc} in {cut_s:.2f} s",
          flush=True)
    check(k == k2 == 1 and kc == kc2 == 2 and np.array_equal(lab, lab2)
          and np.array_equal(labc, labc2) and (labc == (jj >= n // 2)).all(),
          "one component, two with the middle column cut, labels as the closed form, bit for bit")

    hop0 = ii + jj
    (order, pred), bfs_s, bfs_f, (order2, pred2) = twice(
        dev, lambda: csgraph.breadth_first_order(G, 0, directed=False))
    v = order[1:]
    p = pred[v].astype(np.int64)
    print(f"  breadth_first_order from 0: {order.shape[0]} vertices in {bfs_s:.2f} s ({bfs_f} "
          "fetches)", flush=True)
    check(np.array_equal(order, order2) and np.array_equal(pred, pred2)
          and order.shape[0] == N and (np.diff(hop0[order]) >= 0).all()
          and (hop0[p] == hop0[v] - 1).all() and (np.abs(ii[p] - ii[v]) + np.abs(jj[p] - jj[v]) == 1).all(),
          "the BFS order runs by hop distance |i| + |j|, each predecessor a neighbor one hop "
          "nearer, bit for bit")

    corners = [0, n - 1, N - n, N - 1]
    d, dij_s, dij_f, d2 = twice(dev, lambda: csgraph.dijkstra(G, indices=corners))
    want = np.stack([np.abs(ii - ii[c]) + np.abs(jj - jj[c]) for c in corners]).astype(np.float64)
    print(f"  dijkstra from the four corners: {dij_s:.2f} s ({dij_f} fetches; hop diameter "
          f"{2 * (n - 1)} within the {min(N, max(64, 2 * int(np.sqrt(N)) + 16))}-sweep bound)",
          flush=True)
    check(np.array_equal(d, d2) and np.array_equal(d, want),
          "dijkstra's distances are the closed form exactly, bit for bit")
    out.update(components_s=cc_s, components_fetches=cc_f, cut_s=cut_s, bfs_s=bfs_s,
               bfs_fetches=bfs_f, dijkstra_s=dij_s, dijkstra_fetches=dij_f)
    del G, Gc, d, d2, order, order2, pred, pred2

    T1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(rcm_grid, rcm_grid))
    S = (sp.kron(T1, sp.identity(rcm_grid)) + sp.kron(sp.identity(rcm_grid), T1)).tocsr()
    q = np.random.default_rng(61).permutation(rcm_grid**2)
    P = S[q][:, q].tocsr()
    Pd = sparse.csr_array(P, device=dev)
    perm, rcm_s = timed(dev, lambda: csgraph.reverse_cuthill_mckee(Pd))
    R = P[perm][:, perm].tocoo()
    band, band_p = int(np.abs(R.row - R.col).max()), int(np.abs(P.tocoo().row - P.tocoo().col).max())
    print(f"  reverse_cuthill_mckee at {rcm_grid}^2: {rcm_s:.2f} s; bandwidth {band_p} permuted, "
          f"{band} reordered", flush=True)
    check(band <= rcm_grid, f"RCM brings the bandwidth back to at most {rcm_grid}")
    lu, fsecs = timed(dev, lambda: linalg.splu(Pd, permc_spec="RCM"))
    b = np.random.default_rng(62).standard_normal(rcm_grid**2)
    x = lu.solve(b).cpu().numpy()
    rel = float(np.linalg.norm(P @ x - b) / np.linalg.norm(b))
    fill = int(lu._Lcsc[2].size + lu._Ucsc[2].size)
    print(f"  splu(permc_spec='RCM') of the permuted operator: factor {fsecs:.2f} s, nnz(L) + "
          f"nnz(U) = {fill} (NATURAL on the unpermuted operator, phase 12e: {natural_fill}); "
          f"||P x - b|| / ||b|| = {rel:.3g}", flush=True)
    check(rel <= 1e-10 and (natural_fill is None or fill < natural_fill),
          "the RCM factor solves to 1e-10 with less fill than NATURAL's on the banded order")
    out.update(rcm_s=rcm_s, bandwidth_permuted=band_p, bandwidth_rcm=band, splu_rcm_s=fsecs,
               splu_rcm_fill=fill, splu_natural_fill=natural_fill, splu_rcm_rel=rel)
    return out


def formats_distances(dev, m: int = 16384, k: int = 64, grid: int = 6000, nd: int = 10**5):
    """Phase 13d: cdist at m x m, k features in f32 against host f64 on
    sampled rows (|d^2 - d_ref^2| within the expansion's summation bound);
    phase 3's grid^2 operator .tobsr((2, 2)): its product against the CSR
    product within the f32 summation bound of a block row and its
    tocsr() equal to the operator exactly; dok/lil round trips of nd
    entries, exact."""
    import scipy.sparse as sp
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch import spatial

    print(f"phase 13d: cdist at {m} x {m} (k = {k}, float32), tobsr((2, 2)) of the {grid}^2 "
          f"Laplacian, dok/lil round trips of {nd} entries", flush=True)
    u = float(np.finfo(np.float32).eps) / 2
    gen = torch.Generator(device=dev).manual_seed(71)
    XA = torch.randn((m, k), generator=gen, device=dev)
    XB = torch.randn((m, k), generator=gen, device=dev)
    spatial.cdist(XA, XB)  # warm: the allocator's segments, cuBLAS's workspace
    D, cd_s = timed(dev, lambda: spatial.cdist(XA, XB))
    _, lib_s = timed(dev, lambda: torch.cdist(XA, XB))  # the library call, for comparison
    rows = np.random.default_rng(72).choice(m, 64, replace=False)
    A64, B64 = XA[rows].cpu().double().numpy(), XB.cpu().double().numpy()
    ref2 = ((A64[:, None, :] - B64[None, :, :]) ** 2).sum(-1)
    got2 = D[rows].cpu().double().numpy() ** 2
    # each of |a|^2, |b|^2 and a.b within gamma_k of its terms' sum, two
    # more roundings to combine them (|a.b| <= (|a|^2 + |b|^2) / 2), then
    # the square root's and the host square's
    norms = (A64**2).sum(1)[:, None] + (B64**2).sum(1)[None, :]
    gamma = (k + 2) * u / (1 - (k + 2) * u)
    bound = 2 * gamma * norms + 3 * u * ref2
    worst = float((np.abs(got2 - ref2) / bound).max())
    print(f"  cdist: {cd_s * 1e3:.2f} ms ({m * m * 4 / 2**30:.2f} GiB out; torch.cdist "
          f"{lib_s * 1e3:.2f} ms); worst |d^2 - d_ref^2| over its bound {worst:.3g} on 64 sampled "
          "rows", flush=True)
    check(worst <= 1.0, "cdist within the f32 expansion bound of host f64 on sampled rows")
    out = {"cdist_ms": cd_s * 1e3, "torch_cdist_ms": lib_s * 1e3, "cdist_worst_over_bound": worst}
    del D, XA, XB

    A, _, _ = pde_laplacian(dev, grid)
    B, bsr_s = timed(dev, lambda: A.tobsr((2, 2)))
    x = torch.randn((A.shape[1],), generator=gen, device=dev)
    B @ x  # warm
    yb, bmv_s = timed(dev, lambda: B @ x)
    ya = A @ x
    gamma = 10 * u / (1 - 10 * u)  # a block row sums 10 stored values, the CSR row 5
    ab = abs(A) @ x.abs()
    over = float(((yb - ya).abs() / (2 * gamma * ab).clamp_min(1e-30)).max())
    C = B.tocsr()
    same = (C.nnz == A.nnz and bool(torch.equal(C.indptr.long(), A.indptr.long()))
            and bool(torch.equal(C.indices.long(), A.indices.long()))
            and bool(torch.equal(C.data, A.data)))
    print(f"  tobsr((2, 2)): {bsr_s:.2f} s, {B.data.shape[0]} blocks ({B.nnz} stored values for "
          f"{A.nnz} nonzeros); B @ x {bmv_s * 1e3:.2f} ms, |B x - A x| over 2 gamma_10 |A||x| "
          f"{over:.3g}; tocsr() equal to A: {same}", flush=True)
    check(over <= 1.0 and same, "the BSR product within the f32 summation bound of the CSR one, "
          "and its tocsr() the operator exactly")
    out.update(tobsr_s=bsr_s, bsr_blocks=int(B.data.shape[0]), bsr_spmv_ms=bmv_s * 1e3,
               bsr_over_bound=over)
    del A, B, C, x, yb, ya, ab

    S = sp.random(20000, 30000, nd / 6e8, random_state=np.random.default_rng(73), format="csr",
                  dtype=np.float64)
    S.data += 0.5  # no stored zeros
    Sd = sparse.csr_array(S, device=dev)
    for fmt in ("todok", "tolil"):
        back, secs = timed(dev, lambda: getattr(Sd, fmt)().tocsr())
        exact = (bool(torch.equal(back.indptr.long(), Sd.indptr.long()))
                 and bool(torch.equal(back.indices.long(), Sd.indices.long()))
                 and bool(torch.equal(back.data, Sd.data)))
        print(f"  {fmt}().tocsr() of {Sd.nnz} entries: {secs:.2f} s, exact: {exact}", flush=True)
        check(exact, f"the {fmt[2:]} round trip is exact")
        out[f"{fmt}_s"] = secs
    return out


def apps(dev, drive, nodes: int = 30, small: int = 16, n_bdf: int = 64, n_radau: int = 32,
         graph_n: int = 2000, rcm_grid: int = 256, natural_fill=None, cd_m: int = 16384,
         grid: int = 6000, nd: int = 10**5):
    """Phase 13 (a)-(d), each part run by ``drive`` with the launch
    counters at 0; prints its seconds on the host clock."""
    t0 = time.perf_counter()
    dia, sell = ("dia_spmv_packed",), ("sell_chunk_spmv",)
    everything = ("dia_spmv_packed", "cg_kernel_a", "cg_kernel_b", "sell_chunk_spmv",
                  "sell_chunk_spmv_batched", "dia_spmv_direct", "cgcg_kernel", "cgcg_kernel_wide")
    ring = drive("quantum ring, ELL (13a)", dia, quantum_ring, dev, nodes, small, absent=sell)
    out = {"quantum": ring}
    out["quantum_sell"] = drive("quantum ring, SELL (13a)", sell, quantum_sell, dev, ring,
                                absent=dia)
    for key in ("final", "t", "H"):
        ring.pop(key)
    out["heat"] = drive("heat equation (13b)", dia, heat_equation, dev, n_bdf, n_radau)
    out["csgraph"] = drive("csgraph (13c)", (), csgraph_grid, dev, graph_n, rcm_grid,
                           natural_fill, absent=everything)
    out["formats"] = drive("formats and distances (13d)", dia, formats_distances, dev, cd_m, 64,
                           grid, nd)
    out["s"] = time.perf_counter() - t0
    print(f"phase 13 took {out['s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------
def timings(dev, A, cg_state, bw, flops):
    import torch
    from sparse_tpu_torch.kernels import cg_dia as C
    from sparse_tpu_torch.kernels import dia_spmv as D

    sync = torch.cuda.synchronize
    reps = 20
    planes_scipy, offsets = A._maybe_dia()
    n = A.shape[0]
    plan = D.dia_plan(offsets, A.shape)
    planes = D.dia_pack(planes_scipy, plan)
    x = torch.rand((n,), dtype=torch.float32, device=dev)
    xpad = D.dia_pad_x(x, plan)
    Dn, mp, Bh = plan.D, plan.m_pad, plan.B
    t = {}
    t["dia_spmv_packed"] = dict(
        ms=cuda_ms(lambda: D.dia_spmv_packed(planes, xpad, plan), reps, sync),
        plain_ms=cuda_ms(lambda: D.dia_spmv_packed_plain(planes, xpad, plan), reps, sync),
        bytes=4 * (Dn * mp + (mp + 2 * Bh) + mp), ops=2 * Dn * mp,
    )
    csr = torch.sparse_csr_tensor(A.indptr, A.indices, A.data, size=A.shape)
    y_lib = csr @ x
    sync()
    t["dia_spmv_packed"]["library_ms"] = cuda_ms(lambda: csr @ x, reps, sync)
    y_k = D.dia_spmv_packed(planes, xpad, plan)[:n]
    lib_err = float((y_lib - y_k).abs().max() / y_k.abs().max())
    print(f"  library (torch.sparse_csr_tensor @ x) vs kernel: max |diff| / max |y| = "
          f"{lib_err:.3g}", flush=True)
    del csr, y_lib

    plan_c, planes_c, xc, rc, pc, sc, ws = cg_state
    pn, q = torch.zeros_like(pc), torch.zeros_like(pc)
    L = plan_c.m_pad + 2 * plan_c.B
    mpc = plan_c.m_pad
    t["cg_kernel_a"] = dict(
        ms=cuda_ms(lambda: C.cg_kernel_a(planes_c, rc, pc, pn, q, sc, plan_c, ws), reps, sync),
        plain_ms=cuda_ms(lambda: C.cg_kernel_a_plain(planes_c, rc, pc, pn, q, sc, plan_c), reps, sync),
        bytes=4 * (plan_c.D * mpc + 2 * L + 2 * mpc), ops=(4 * plan_c.D + 4) * mpc,
        library_ms=None,
    )
    t["cg_kernel_b"] = dict(
        ms=cuda_ms(lambda: C.cg_kernel_b(xc, rc, pn, q, sc, plan_c, ws), reps, sync),
        plain_ms=cuda_ms(lambda: C.cg_kernel_b_plain(xc, rc, pn, q, sc, plan_c), reps, sync),
        bytes=4 * (4 * mpc + 2 * mpc), ops=6 * mpc, library_ms=None,
    )
    for name, r in t.items():
        byte_ms, op_ms = r["bytes"] / bw * 1e3, r["ops"] / flops * 1e3
        r["bound_ms"] = max(byte_ms, op_ms)
        r["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    return t


def sell_timings(dev, A, prep, bc, bw, flops):
    """Times of the two chunked SELL kernels at the full-size layouts of
    phases 5 and 6, one launch a product: the kernel (the batched wrapper's
    time includes its one transpose of X, timed apart too), its plain
    version, and one PyTorch call computing the same function:
    ``torch.sparse_csr_tensor @ x``, and for the batch the block-diagonal
    2-D CSR of its lanes (B m x B n, B nnz) @ ``X.reshape(-1)`` (a 3-D CSR
    through ``torch.bmm`` raises on the card), held against the kernel path
    within 2 gamma_k sum|a x| a row (k its nonzeros, two f32 sums of the
    same products). Bytes are the function's, counted from the nonzeros:
    each nonzero's index and value read once, x read once, y written once,
    perm read once (for the batch the shared indices and perm once, values,
    x and y per lane). The layout's pad slots, work list and cptr are its
    overhead, kept beside the bound. Also: the x gather's 32-byte sectors a
    product (single: the distinct sectors of each warp's slot step, counted
    from the layout; batched: 32 lanes of x are 128 contiguous bytes) and
    the single kernel on the same layout with lane-contiguous columns (the
    same HBM bytes, a coalesced gather)."""
    import torch
    from sparse_tpu_torch.kernels import sell_spmv as S

    sync = torch.cuda.synchronize
    reps = 20
    t = {}
    f32 = torch.float32
    ch = prep.chunks
    val, ws = prep._chunk_vals(f32), prep._ws[f32]
    m, n, nnz = ch.m, ch.n, ch.nnz
    ib = ch.idx.element_size()
    x = torch.randn((n,), dtype=f32, device=dev)
    r = t["sell_chunk_spmv"] = dict(
        ms=cuda_ms(lambda: S.sell_chunk_spmv(ch, val, x, ws), reps, sync),
        plain_ms=cuda_ms(lambda: S.sell_chunk_spmv_plain(ch, val, x), 1, sync),
        bytes=nnz * (ib + 4) + ib * m + 4 * (n + m), ops=2 * nnz,
        layout_overhead_bytes=(ch.slots - nnz) * (ib + 4) + 16 * ch.nwork + 8 * (ch.nchunks + 1),
    )
    csr = torch.sparse_csr_tensor(A.indptr, A.indices, A.data, size=A.shape)
    y_lib, y_k = csr @ x, A @ x
    r["library_ms"] = cuda_ms(lambda: csr @ x, reps, sync)
    r["a_at_x_ms"] = cuda_ms(lambda: A @ x, reps, sync)
    print(f"  general A @ x end to end: {r['a_at_x_ms']:.4f} ms; library (torch.sparse_csr_tensor @ "
          f"x) vs kernel path: max |diff| / max |y| = "
          f"{float((y_lib - y_k).abs().max() / y_k.abs().max()):.3g}", flush=True)
    del csr, y_lib, y_k
    key = (torch.arange(ch.slots, device=dev) // 32) * (n // 8 + 1) + ch.idx.to(torch.int64) // 8
    sectors = int(torch.unique(key).numel())
    del key
    lane_cols = (torch.arange(ch.slots, device=dev) % n).to(ch.idx.dtype)
    ch_c = S.SellChunks(ch.m, ch.n, ch.nnz, ch.seg, ch.slots, ch.perm, ch.cptr, lane_cols, val,
                        None, ch.work, ch.npart)
    ms_c = cuda_ms(lambda: S.sell_chunk_spmv(ch_c, val, x, ws), reps, sync)
    del ch_c, lane_cols
    r["gather"] = dict(sectors=sectors, sector_bytes=32 * sectors, hbm_bytes=r["bytes"],
                       layout_overhead_bytes=r["layout_overhead_bytes"],
                       ms_lane_contiguous_columns=ms_c)
    print(f"  sell_chunk_spmv: {nnz} nonzeros in {ch.slots} slots; the function moves "
          f"{r['bytes'] / 1e9:.4f} GB, the layout adds {r['layout_overhead_bytes'] / 1e9:.4f} GB "
          f"(pad slots, work list, cptr); x gather {sectors} sectors ({32 * sectors / 1e9:.3f} GB "
          f"through L2); the same layout with lane-contiguous columns {ms_c:.4f} ms against "
          f"{r['ms']:.4f} ms", flush=True)

    ch_b, vals, ws_b = bc._chunk_packed(f32)
    B, m_b, n_b = bc.shape
    nnz_b, ib = ch_b.nnz, ch_b.idx.element_size()
    X = torch.randn((B, n_b), dtype=f32, device=dev)
    r = t["sell_chunk_spmv_batched"] = dict(
        ms=cuda_ms(lambda: S.sell_chunk_spmv_batched(ch_b, vals, X, ws_b), reps, sync),
        plain_ms=cuda_ms(lambda: S.sell_chunk_spmv_batched_plain(ch_b, vals, X), 1, sync),
        bytes=nnz_b * ib + ib * m_b + B * (4 * nnz_b + 4 * (n_b + m_b)), ops=2 * B * nnz_b,
        layout_overhead_bytes=((ch_b.slots - nnz_b) * (ib + 4 * B) + 16 * ch_b.nwork
                               + 8 * (ch_b.nchunks + 1)),
    )
    tr_ms = cuda_ms(lambda: X.t().contiguous(), reps, sync)
    sectors_b = ch_b.slots * -(-4 * B // 32)
    r["gather"] = dict(sectors=sectors_b, sector_bytes=32 * sectors_b, hbm_bytes=r["bytes"],
                       layout_overhead_bytes=r["layout_overhead_bytes"], transpose_ms=tr_ms)
    print(f"  sell_chunk_spmv_batched: {r['ms']:.4f} ms a product, of which the transpose of X "
          f"{tr_ms:.4f} ms; the function moves {r['bytes'] / 1e9:.4f} GB, the layout adds "
          f"{r['layout_overhead_bytes'] / 1e9:.4f} GB; x gather {sectors_b} sectors "
          f"({32 * sectors_b / 1e9:.3f} GB, contiguous per 32 lanes)", flush=True)
    pat = bc.pattern
    it = torch.int32 if B * max(nnz_b, m_b, n_b) < 2**31 else torch.int64
    ip = torch.as_tensor(np.asarray(pat.indptr), device=dev).to(it)
    lane = torch.arange(B, dtype=it, device=dev)[:, None]
    crow = torch.cat([(ip[None, :-1] + lane * nnz_b).reshape(-1),
                      torch.full((1,), B * nnz_b, dtype=it, device=dev)])
    col = (torch.as_tensor(np.asarray(pat.indices), device=dev).to(it)[None, :]
           + lane * n_b).reshape(-1)
    lv = bc.values.to(f32).reshape(-1)
    Ad = torch.sparse_csr_tensor(crow, col, lv, size=(B * m_b, B * n_b))
    xf = X.reshape(-1)
    Yl, Yk = Ad @ xf, bc.matvec(X).reshape(-1)
    r["library_ms"] = cuda_ms(lambda: Ad @ xf, reps, sync)
    del Ad
    Aabs = torch.sparse_csr_tensor(crow, col, lv.abs().double(), size=(B * m_b, B * n_b))
    mag = Aabs @ xf.abs().double()
    k = torch.diff(ip).double().repeat(B)
    u = float(np.finfo(np.float32).eps) / 2
    bound = 2 * k * u / (1 - k * u) * mag
    diff = (Yl.double() - Yk.double()).abs()
    check(bool((diff <= bound).all()),
          f"batched library call (block-diagonal torch.sparse_csr_tensor of {B} lanes @ "
          f"X.reshape(-1)) equals the kernel path within 2 gamma_k sum|a x| on all {B * m_b} "
          f"rows (max |diff| / bound {float((diff / bound.clamp(min=1e-300)).max()):.3g}); "
          f"{r['library_ms']:.4f} ms")
    del Aabs, mag, k, bound, diff, Yl, Yk, crow, col, lv
    for name, r in t.items():
        byte_ms, op_ms = r["bytes"] / bw * 1e3, r["ops"] / flops * 1e3
        r["bound_ms"] = max(byte_ms, op_ms)
        r["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    return t


def segment_sweep(dev, A, bc, segs=(32, 64, 128, 256, 512, 1024)):
    """Both chunked SELL kernels at each segment length in ``segs`` (slots
    a row a work item) on the full-size layouts of phases 5 and 6, f32, ms
    a product by CUDA events: the experiment that chose ``SELL_SEGMENT``.
    The two kernels must share one work list, so one length serves both.
    Runs with ``python3 chip_smoke.py --segment-sweep``."""
    import torch
    from sparse_tpu_torch.kernels import sell_spmv as S

    sync = torch.cuda.synchronize
    f32 = torch.float32
    x = torch.randn((A.shape[1],), dtype=f32, device=dev)
    B = bc.batch
    X = torch.randn((B, bc.shape[2]), dtype=f32, device=dev)
    pat = bc.pattern
    out = {"single": {}, "batched": {}}
    for seg in segs:
        c = S.sell_chunk_pack(A.indptr, A.indices, A.data.to(f32), A.shape, seg=seg)
        w = S.SellWorkspace(c, f32)
        out["single"][seg] = cuda_ms(lambda: S.sell_chunk_spmv(c, c.val, x, w), 20, sync)
        del c, w
        c = S.sell_chunk_pack(torch.as_tensor(np.asarray(pat.indptr), device=dev),
                              torch.as_tensor(np.asarray(pat.indices), device=dev), None,
                              pat.shape, seg=seg, with_src=True)
        v, w = c.pack_values(bc.values.to(f32)), S.SellWorkspace(c, f32, B)
        out["batched"][seg] = cuda_ms(lambda: S.sell_chunk_spmv_batched(c, v, X, w), 20, sync)
        del c, v, w
    for kind, ms in out.items():
        print(f"  segment sweep, {kind} kernel (ms a product): "
              + ", ".join(f"{k}: {v:.4f}" for k, v in ms.items()), flush=True)
    return out


def window_sweep(dev, bw, sizes2=(500, 1000, 1500, 2000, 3000, 4500),
                 sizes3=(32, 48, 64, 80, 96, 112, 128, 144, 160)):
    """``--window-sweep``: one one-pass iteration through the windowed and
    the wide kernel, CUDA events over 20 launches of the running recurrence
    from a random b, on the 5-point Laplacian at n^2 for ``sizes2`` and the
    7-point one at n^3 for ``sizes3``, f32 and f64 (the windowed kernel
    where its window fits a block's shared memory). Printed with the
    window's span, the rows a block owns, their ratio and the byte bound:
    the experiment behind ``cgcg_iteration``'s windowed-or-wide choice."""
    import torch
    from sparse_tpu_torch.kernels import cg_dia as C
    from sparse_tpu_torch.kernels import dia_spmv as D
    from sparse_tpu_torch.models import laplacian_2d_dia

    sync = torch.cuda.synchronize
    out = []
    shapes = [(2, n) for n in sizes2] + [(3, n) for n in sizes3]
    for dt in (torch.float32, torch.float64):
        for dim, n in shapes:
            planes, offs = (laplacian_2d_dia(n, dtype=dt, device=dev) if dim == 2 else
                            laplacian_3d_dia(n, dev, dtype=dt))
            N = n**dim
            plan = D.dia_plan(offs, (N, N))
            packed = D.dia_pack(planes, plan)
            del planes
            b = torch.randn((N,), dtype=dt, device=dev)
            ws = C.CgWorkspace(plan, dt, dev)
            geo = ws.window(dt)[0]
            isz = torch.finfo(dt).bits // 8
            e = dict(dtype=str(dt).split(".")[1], shape=f"{n}^{dim}", span=geo.span,
                     fits=geo.fits, bound_ms=onepass_bytes(plan, isz, isz) / bw * 1e3)
            step = lambda k: cuda_ms(onepass_stepper(k, packed, packed, b, plan, ws), 20, sync)  # noqa: E731
            e["wide_ms"] = step(C.cgcg_kernel_wide)
            if geo.fits:
                rows = -(-geo.ntiles // geo.nblocks) * geo.tile
                e.update(blocks=geo.nblocks, rows_per_block=rows, ratio=rows / geo.span,
                         window_ms=step(C.cgcg_kernel))
            out.append(e)
            print("  window sweep: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in e.items()),
                flush=True)
            del packed, b, ws
    return out


def product_kernels(label, fn, kernel: str, most: int, reps: int = 3):
    """The CUDA kernels ``reps`` calls of ``fn`` launch, by torch.profiler:
    the kernel named ``kernel`` once a call and at most ``most`` kernels a
    call in all (no ticket fill, no gather pass). A profile that records no
    device event is taken again, twice at most; if none does, this fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [(e.key, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if seen:
            break
    check(bool(seen), f"torch.profiler records the card's kernels for {reps} x {label}")
    ours = sum(c for k, c in seen if kernel in k)
    check(ours == reps and sum(c for _, c in seen) <= most * reps,
          f"{reps} x {label} launch {seen} on the card: {kernel} once a call, {most} kernel(s) a "
          f"call at most")


def onepass_bytes(plan, vec_bytes: int, plane_bytes: int) -> int:
    """Bytes one one-pass iteration must move: r, w, s read over their
    padded length (halo windows included), p, x and the D planes read, and
    r', w', s', p, x written."""
    mp, L = plan.m_pad, plan.m_pad + 2 * plan.B
    return plane_bytes * plan.D * mp + vec_bytes * (3 * L + 2 * mp + 5 * mp)


def slice3_timings(dev, grid: int, cgcg_state, wide_state, bw, flops):
    """Times of the column-indexed DIA SpMV at phase 7's shapes (the grid^2
    Laplacian's scipy planes [5, N], x [N]) against
    ``torch.sparse_csr_tensor @ x`` of the same matrix, and of one one-pass
    CG iteration (library: none, no single PyTorch call computes a CG
    iteration): the windowed kernel at phase 8's shapes, the wide kernel at
    phase 9's (the 3-D Laplacian). The one-pass launches, kernel and plain,
    run phase 2e's recurrence from its b (r, w and s swapped after each), so
    each timed launch is an iteration of the checked solve. Beside them
    (printed): the windowed kernel with bf16 planes and in f64, and the
    wide kernel at the same shapes (the kernel the windowed one replaced
    there); kernel A with bf16 planes."""
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch.kernels import cg_dia as C
    from sparse_tpu_torch.kernels import dia_spmv as D
    from sparse_tpu_torch.models import laplacian_2d_dia

    sync = torch.cuda.synchronize
    reps = 20
    t = {}
    planes, offs = laplacian_2d_dia(grid, device=dev)
    N, Dn = grid * grid, len(offs)
    x = torch.rand((N,), dtype=torch.float32, device=dev)
    r = t["dia_spmv_direct"] = dict(
        ms=cuda_ms(lambda: D.dia_spmv_direct(planes, offs, x, (N, N)), reps, sync),
        plain_ms=cuda_ms(lambda: D.dia_spmv_direct_plain(planes, offs, x, (N, N)), reps, sync),
        bytes=4 * (Dn * N + N + N), ops=2 * Dn * N,
    )
    A = sparse.dia_array((planes, offs), shape=(N, N)).tocsr()
    csr = torch.sparse_csr_tensor(A.indptr, A.indices, A.data, size=A.shape)
    y_lib, y_k = csr @ x, D.dia_spmv_direct(planes, offs, x, (N, N))
    r["library_ms"] = cuda_ms(lambda: csr @ x, reps, sync)
    print(f"  library (torch.sparse_csr_tensor @ x, nnz {A.nnz}) vs dia_spmv_direct: max |diff| / "
          f"max |y| = {float((y_lib - y_k).abs().max() / y_k.abs().max()):.3g}", flush=True)
    del A, csr, y_lib, y_k, planes, x

    def onepass_ms(kernel, stream, packed, b, plan, ws=None):
        return cuda_ms(onepass_stepper(kernel, stream, packed, b, plan, ws), reps, sync)

    plan, packed, b, ws = cgcg_state
    t["cgcg_kernel"] = dict(
        ms=onepass_ms(C.cgcg_kernel, packed, packed, b, plan, ws),
        plain_ms=onepass_ms(C.cgcg_kernel_plain, packed, packed, b, plan),
        bytes=onepass_bytes(plan, 4, 4), ops=(6 * plan.D + 12) * plan.m_pad, library_ms=None,
    )
    geo = ws.window(packed.dtype)[0]
    bf = packed.to(torch.bfloat16)
    packed64, b64 = packed.double(), b.double()
    ws64 = C.CgWorkspace(plan, torch.float64, dev)
    extra = dict(prefill_bytes=3 * 4 * geo.span * geo.nblocks, blocks=geo.nblocks,
                 shared_bytes=geo.shared_bytes)
    for label, stream, pk, bb, w_, vb, pb in (("f32", packed, packed, b, ws, 4, 4),
                                              ("bf16", bf, packed, b, ws, 4, 2),
                                              ("f64", packed64, packed64, b64, ws64, 8, 8)):
        g = w_.window(stream.dtype)[0]
        e = extra[label] = dict(bound_ms=onepass_bytes(plan, vb, pb) / bw * 1e3,
                                schedule=g.schedule, blocks=g.nblocks)
        e["window"] = onepass_ms(C.cgcg_kernel, stream, pk, bb, plan, w_)
        e["wide"] = onepass_ms(C.cgcg_kernel_wide, stream, pk, bb, plan, w_)
    # kernel A with bf16 planes at the two-pass state of cg_dia_fused from b
    rp = C._pad_vec(b, plan)
    pc, pn, q = torch.zeros_like(rp), torch.zeros_like(rp), torch.zeros_like(rp)
    scc = torch.zeros((4,), dtype=b.dtype, device=b.device)
    scc[C.RHO] = torch.dot(rp, rp)
    extra["bf16"]["cg_kernel_a_ms"] = cuda_ms(lambda: C.cg_kernel_a(bf, rp, pc, pn, q, scc, plan, ws),
                                              reps, sync)
    extra["bf16"]["cg_kernel_a_bound_ms"] = (2 * plan.D * plan.m_pad + 4 * (
        2 * (plan.m_pad + 2 * plan.B) + 2 * plan.m_pad)) / bw * 1e3
    del bf, rp, pc, pn, q, packed64, b64, ws64
    # the card's rate for a stream of the same bytes in the same 2:1 read/write
    # mix (torch.add of two vectors into a third): what a kernel of this mix
    # can reach; the windowed kernel also reads its prefill
    n = onepass_bytes(plan, 4, 4) // 12
    a_, b_ = torch.rand(n, device=dev), torch.rand(n, device=dev)
    c_ = torch.empty_like(a_)
    extra["stream_2to1_ms"] = cuda_ms(lambda: torch.add(a_, b_, out=c_), reps, sync)
    del a_, b_, c_
    plan3, packed3, b3, ws3 = wide_state
    t["cgcg_kernel_wide"] = dict(
        ms=onepass_ms(C.cgcg_kernel_wide, packed3, packed3, b3, plan3, ws3),
        plain_ms=onepass_ms(C.cgcg_kernel_plain, packed3, packed3, b3, plan3),
        bytes=onepass_bytes(plan3, 4, 4), ops=(6 * plan3.D + 12) * plan3.m_pad, library_ms=None,
    )
    for name, r in t.items():
        byte_ms, op_ms = r["bytes"] / bw * 1e3, r["ops"] / flops * 1e3
        r["bound_ms"] = max(byte_ms, op_ms)
        r["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    k = t["cgcg_kernel"]
    print(f"  one-pass at {grid}^2: {geo.nblocks} blocks, {geo.shared_bytes} B of shared memory, "
          f"prefill {extra['prefill_bytes']} B an iteration; the windowed and the wide kernel "
          f"(ms):", flush=True)
    for label in ("f32", "bf16", "f64"):
        e = extra[label]
        print(f"    {label} planes: windowed ({e['schedule']!r}, {e['blocks']} blocks) "
              f"{e['window']:.4f}, wide {e['wide']:.4f}; bound {e['bound_ms']:.4f}", flush=True)
    moved = onepass_bytes(plan, 4, 4) + extra["prefill_bytes"]
    print(f"  the windowed kernel moves {moved} B an iteration (the function's and the prefill): "
          f"{moved / k['ms'] / 1e9:.4f} TB/s; a 2:1 read/write stream of the function's bytes "
          f"(torch.add) takes {extra['stream_2to1_ms']:.4f} ms, "
          f"{12 * n / extra['stream_2to1_ms'] / 1e9:.4f} TB/s", flush=True)
    e = extra["bf16"]
    print(f"  cg_kernel_a with bf16 planes {e['cg_kernel_a_ms']:.4f} ms (bound "
          f"{e['cg_kernel_a_bound_ms']:.4f} ms)", flush=True)
    w = t["cgcg_kernel_wide"]
    print(f"  wide kernel at phase 9's {plan3.m}-row 3-D Laplacian: {w['ms']:.4f} ms (bound "
          f"{w['bound_ms']:.4f} ms)", flush=True)
    k["onepass"] = extra
    return t


def device_share(label, fn):
    """One call of ``fn`` under torch.profiler: the card's busy share (the
    sum of CUDA kernel times over the host wall time of the call, which
    the profiler's own host cost stretches) and the kernels that take most
    of it, summed by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kern)
    top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in kern[:6])
    print(f"  profile {label}: wall {wall_us / 1e3:.3f} ms, kernels {busy_us / 1e3:.3f} ms, busy "
          f"share {busy_us / wall_us:.3f}; by kernel: {top}", flush=True)
    return busy_us / wall_us


def run(dev: str = "cuda", grid: int = 6000, small_grid: int = 1000, skew_m: int = 2**21,
        batch_m: int = 2**16, lanes: int = 64, entry_grid: int = 64, iters: int = 300,
        wide_n: int = 200, wide_iters: int = 100, krylov_iters: int = 100,
        lg_grid: int | None = None) -> dict:
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch.kernels import _build
    from sparse_tpu_torch.kernels import cg_dia as C
    from sparse_tpu_torch.kernels import dia_spmv as D
    from sparse_tpu_torch.kernels import sell_spmv as S

    torch.manual_seed(0)
    card = card_line() if dev == "cuda" else "cpu"
    name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = _build.build_all() if dev == "cuda" else {}
    print(f"  kernels built in {time.perf_counter() - t0:.2f} s: "
          f"{', '.join(p.name for p in built.values())}", flush=True)
    for p in built.values():
        log = p.with_suffix(".log")
        if log.exists():
            regs = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln]
            print("  ptxas: " + " | ".join(regs), flush=True)

    diagonals, offsets, n = laplacian_diagonals(grid + 2, grid + 2)
    lap_dia = sparse.diags(diagonals, offsets, shape=(n, n), dtype=np.float32, device=dev)
    lap = (lap_dia.data, tuple(int(o) for o in lap_dia.offsets), lap_dia.shape)
    err_spmv = check_dia_spmv(dev, lap)
    err_a, err_b, cg_state = check_cg_kernels(dev, lap)
    del lap_dia, lap
    t0 = time.perf_counter()
    skew_s, lanes_s = skewed_degree_csr(skew_m), skewed_degree_csr(batch_m)
    host_build_s = time.perf_counter() - t0
    print(f"  skewed_degree_csr({skew_m}) and ({batch_m}) built on the host in {host_build_s:.2f} s",
          flush=True)
    errs = check_sell_kernels(dev, skew_s, lanes_s, lanes)
    err_direct = check_dia_direct(dev, grid)
    err_cgcg, err_wide, cgcg_state, wide_state = check_cgcg_kernel(dev, grid, wide_n)
    errs.update({"dia_spmv_packed": err_spmv, "cg_kernel_a": err_a, "cg_kernel_b": err_b,
                 "dia_spmv_direct": err_direct, "cgcg_kernel": err_cgcg,
                 "cgcg_kernel_wide": err_wide})

    # each path runs with every launch counter at 0 and is read just after
    counters = (D.dia_spmv_packed, C.cg_kernel_a, C.cg_kernel_b, S.sell_chunk_spmv,
                S.sell_chunk_spmv_batched, D.dia_spmv_direct, C.cgcg_kernel, C.cgcg_kernel_wide)
    launches = {}

    def drive(path, kernels, fn, *args, also=(), absent=(), exact=None):
        """Run ``fn(*args)`` with the counters at 0; each of ``kernels`` must
        launch and its count is added to the one reported (phase 10's
        operators add theirs to the earlier paths'); each of ``also`` must
        launch (its count is reported from another path); each of
        ``absent`` must not; ``exact`` gives counts that must be met."""
        for c in counters:
            c.launches = 0
        res = fn(*args)
        seen = {c.__name__: c.launches for c in counters}
        print(f"  launches on the {path}: {seen}", flush=True)
        for k in (*kernels, *also):
            check(seen[k] > 0, f"{k} launched on the {path} ({seen[k]} times)")
        for k in absent:
            check(seen[k] == 0, f"{k} did not launch on the {path}")
        for k, n in (exact or {}).items():
            check(seen[k] == n, f"{k} launched {n} times on the {path}")
        for k in kernels:
            launches[k] = launches.get(k, 0) + seen[k]
        return res

    A, out = drive("main path", ("dia_spmv_packed", "cg_kernel_a", "cg_kernel_b"),
                   main_path, dev, grid, small_grid)
    A_gen, prep, out_gen = drive("general path", ("sell_chunk_spmv",), general_path, dev, skew_s)
    out_gen["host_build_s"] = host_build_s
    bc, _X, out_b = drive("batched path", ("sell_chunk_spmv_batched",), batched_path, dev, lanes_s,
                          lanes)
    out_f = drive("flagship step", ("dia_spmv_direct",), flagship_path, dev, grid, entry_grid, iters)
    # two one-pass variants, each solved once to warm and three times timed
    out_s = drive("fused sweep", ("cgcg_kernel",), fused_sweep, dev, grid, iters,
                  also=("cg_kernel_a", "cg_kernel_b", "dia_spmv_packed"),
                  absent=("cgcg_kernel_wide",), exact={"cgcg_kernel": 2 * 4 * iters})
    # one warm-up solve of 2 iterations, then wide_iters
    out_w = drive("wide-band path", ("cgcg_kernel_wide",), wide_band_path, dev, wide_n, wide_iters,
                  absent=("cgcg_kernel",), exact={"cgcg_kernel_wide": 2 + wide_iters})
    out_k = {"banded": drive("Krylov solvers, banded nonsymmetric", ("dia_spmv_packed",),
                             krylov_banded, dev, grid, krylov_iters)}
    out_k["symmetric"] = drive("Krylov solvers, symmetric Laplacian",
                               ("dia_spmv_packed", "cg_kernel_a", "cg_kernel_b"), krylov_symmetric,
                               dev, A, grid, small_grid, krylov_iters, lg_grid)
    out_k["general"] = drive("Krylov solvers, general nonsymmetric", ("sell_chunk_spmv",),
                             krylov_general, dev, skew_m, batch_m)
    rel_f, rel_2 = out_f[f"{grid}^2"]["rel_residual"], out_s["twopass"]["rel_residual"]
    check(rel_f <= 10 * max(rel_2, float(np.finfo(np.float32).eps)),
          f"flagship step's true residual at {grid}^2 ({rel_f:.4g}) within 10x of the two-pass "
          f"fused CG's on the same b ({rel_2:.4g})")
    return dict(card=card, name=name, grid=grid, A=A, out=out, out_gen=out_gen, out_b=out_b, A_gen=A_gen,
                prep=prep, bc=bc, launches=launches, errs=errs, cg_state=cg_state,
                cgcg_state=cgcg_state, wide_state=wide_state, out_f=out_f, out_s=out_s,
                out_w=out_w, out_k=out_k, drive=drive)


_SOURCES = {
    "dia_spmv_packed": ("sparse_tpu_torch/csrc/dia_spmv.cu", "sparse_tpu/kernels/dia_spmv.py:207"),
    "cg_kernel_a": ("sparse_tpu_torch/csrc/cg_dia.cu", "sparse_tpu/kernels/cg_dia.py:501"),
    "cg_kernel_b": ("sparse_tpu_torch/csrc/cg_dia.cu", "sparse_tpu/kernels/cg_dia.py:536"),
    "sell_chunk_spmv": ("sparse_tpu_torch/csrc/sell_spmv.cu", "sparse_tpu/kernels/sell_spmv.py:226"),
    "sell_chunk_spmv_batched": ("sparse_tpu_torch/csrc/sell_spmv.cu",
                                "sparse_tpu/kernels/sell_spmv.py:293"),
    "dia_spmv_direct": ("sparse_tpu_torch/csrc/dia_spmv.cu", "sparse_tpu/kernels/dia_spmv.py:639"),
    "cgcg_kernel": ("sparse_tpu_torch/csrc/cg_dia.cu", "sparse_tpu/kernels/cg_dia.py:374"),
    "cgcg_kernel_wide": ("sparse_tpu_torch/csrc/cg_dia.cu", "sparse_tpu/kernels/cg_dia.py:374"),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "sparse_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no sparse_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    bw, flops = peaks(torch.cuda.get_device_name(0))  # an unknown card fails before any work
    res = run("cuda")
    print(f"phase 4: times on {res['card']} (peaks used: {bw / 1e12:g} TB/s, "
          f"{flops / 1e12:g} TFLOP/s fp32)", flush=True)
    t = timings("cuda", res["A"], res["cg_state"], bw, flops)
    t.update(sell_timings("cuda", res["A_gen"], res["prep"], res["bc"], bw, flops))
    sweep = (segment_sweep("cuda", res["A_gen"], res["bc"]) if "--segment-sweep" in sys.argv[1:]
             else None)
    if "--window-sweep" in sys.argv[1:]:
        res["out_w"]["window_sweep"] = window_sweep("cuda", bw)
    grid = res["grid"]
    t.update(slice3_timings("cuda", grid, res.pop("cgcg_state"), res.pop("wide_state"), bw, flops))
    from sparse_tpu_torch import linalg
    from sparse_tpu_torch.batch import batched_cg
    from sparse_tpu_torch.models import cg_dia, poisson_cg_state_dia

    A_gen, bc = res["A_gen"], res["bc"]
    bg = torch.randn((A_gen.shape[0],), device="cuda")
    Bb = torch.randn((bc.batch, bc.shape[2]), device="cuda")
    res["out_gen"]["busy_share_cg"] = device_share(
        "20 CG iterations, general path",
        lambda: linalg.cg(A_gen, bg, maxiter=20, tol=1e-30, conv_test_iters=200))
    res["out_b"]["busy_share_batched_cg"] = device_share(
        f"20 batched CG iterations, {bc.batch} lanes",
        lambda: batched_cg(bc, Bb, tol=0.0, maxiter=20, conv_test_iters=200))
    xg = torch.randn((A_gen.shape[1],), device="cuda")
    product_kernels("A @ x on the general path", lambda: A_gen @ xg, "sell_chunk_kernel", 1)
    product_kernels(f"batched product over {bc.batch} lanes", lambda: bc.matvec(Bb),
                    "sell_chunk_batched_kernel", 2)
    fstate, fstep = poisson_cg_state_dia(grid, device="cuda")
    res["out_f"]["busy_share"] = device_share(
        f"20 flagship steps at {grid}^2", lambda: cg_dia(fstep, *fstate, iters=20))
    del fstate
    o = res["out"]
    it_ms = o["cg_s"] / o["cg_iters"] * 1e3
    print(f"  CG at {grid}^2: {o['cg_iters'] / o['cg_s']:.2f} iters/s ({it_ms:.4f} ms per "
          f"iteration; kernels A + B alone {t['cg_kernel_a']['ms'] + t['cg_kernel_b']['ms']:.4f} ms, "
          f"bound {t['cg_kernel_a']['bound_ms'] + t['cg_kernel_b']['bound_ms']:.4f} ms)", flush=True)
    print(f"  tolerance cg at 1000^2: {o['small_cg_iters']} iterations in "
          f"{o['small_cg_s']:.4f} s, true relative residual {o['small_rel_residual']:.3g}", flush=True)
    g, bo = res["out_gen"], res["out_b"]
    print(f"  general path at m = {g['m']}: first A @ x {g['first_spmv_s']:.3f} s (chunk pack "
          f"included), A @ x {t['sell_chunk_spmv']['a_at_x_ms']:.4f} ms, CG {g['cg_iters_per_s']:.2f} "
          f"iters/s, tolerance cg {g['tol_cg_iters']} iterations in {g['tol_cg_s']:.4f} s", flush=True)
    print(f"  batched: {bo['batched_solves_per_s']:.2f} solves/s ({bo['lanes']} lanes) vs "
          f"{bo['sequential_solves_per_s']:.2f} solves/s one lane after another", flush=True)
    f, sw = res["out_f"][f"{grid}^2"], res["out_s"]
    print(f"  flagship step at {grid}^2: {f['iters_per_s']:.2f} iters/s ({f['s'] / f['iters'] * 1e3:.4f} "
          f"ms per iteration; dia_spmv_direct alone {t['dia_spmv_direct']['ms']:.4f} ms, bound "
          f"{t['dia_spmv_direct']['bound_ms']:.4f} ms), true residual {f['rel_residual']:.4g}",
          flush=True)
    print(f"  run_fused at {grid}^2 (best of 3): " + ", ".join(
        f"{k} {v['iters_per_s']:.2f} iters/s" for k, v in sw.items()) + f" on {res['card']}", flush=True)
    spmv_ms = t["dia_spmv_packed"]["ms"]
    print(f"  Krylov solvers at {grid}^2 (f32, {res['card']}): time an iteration against "
          f"dia_spmv_packed's {spmv_ms:.4f} ms x the products an iteration", flush=True)
    ok = res["out_k"]
    for name, r in [*ok["banded"]["solvers"].items(), ("minres", ok["symmetric"]["minres"])]:
        r["spmv_ms"] = r["matvecs"] * spmv_ms
        print(f"    {name}: {r['iters_per_s']:.2f} iters/s, {r['ms_per_iter']:.4f} ms an iteration vs "
              f"{r['matvecs']} x {spmv_ms:.4f} = {r['spmv_ms']:.4f} ms of products "
              f"({r['ms_per_iter'] / r['spmv_ms']:.2f}x)", flush=True)
    Al = res["A"]  # phase 3's Laplacian: where the solvers' iteration time goes
    bl = torch.randn((Al.shape[0],), device="cuda")
    ok["busy_share"] = {name: device_share(f"20 {name} iterations at {grid}^2", fn) for name, fn in (
        ("gmres", lambda: linalg.gmres(Al, bl, tol=0.0, restart=20, maxiter=1)),
        ("qmr", lambda: linalg.qmr(Al, bl, tol=0.0, maxiter=20, conv_test_iters=10**9)),
        ("lsqr", lambda: linalg.lsqr(Al, bl, atol=0.0, btol=0.0, conlim=0.0, iter_lim=20)))}
    # phase 11 last, on a card freed of every earlier phase's operators
    del Al, bl, bg, Bb, xg, A_gen, bc
    for key in ("A", "A_gen", "prep", "bc", "cg_state"):
        res.pop(key)
    gc.collect()
    torch.cuda.empty_cache()
    core = res["drive"]("core ops", ("dia_spmv_packed", "cg_kernel_a", "cg_kernel_b",
                                     "sell_chunk_spmv"), core_ops, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    rest = linalg_rest("cuda", res["drive"])
    gc.collect()
    torch.cuda.empty_cache()
    app = apps("cuda", res["drive"], natural_fill=rest["direct"]["splu"]["fill"])
    kernels = []
    for name, r in t.items():
        lib = r["library_ms"]
        print(f"  kernel {name}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
              f"launches={res['launches'][name]}", flush=True)
        src, rep = _SOURCES[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=res["launches"][name], max_abs_err=res["errs"][name],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=lib,
        ))
    g["a_at_x_ms"] = t["sell_chunk_spmv"].pop("a_at_x_ms")
    g["gather"] = t["sell_chunk_spmv"].pop("gather")
    bo["gather"] = t["sell_chunk_spmv_batched"].pop("gather")
    if sweep is not None:
        g["segment_sweep"], bo["segment_sweep"] = sweep["single"], sweep["batched"]
    print(json.dumps({"main_path": o, "general_path": g, "batched_path": bo,
                      "flagship_step": res["out_f"], "fused_sweep": sw,
                      "wide_band_path": res["out_w"], "onepass": t["cgcg_kernel"].pop("onepass"),
                      "krylov": res["out_k"], "core_ops": core, "linalg_rest": rest,
                      "apps": app}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(res["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
