#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (``sparse_tpu_torch``).

    python3 chip_smoke.py [--segment-sweep]

Needs one CUDA card, ``nvcc`` and the repository checkout beside this file;
exits non-zero without them, and on any failed check. Phases, in the order
they run (1, 2a-2e, 3, 5, 6, 7, 8, 4):

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
   a wide matrix and the 6000^2 planes; (e) the one-pass CG kernel at
   6000^2 with f32, bf16 and f64 planes: one iteration (vectors bit for
   bit, dots within their summation bound), 20 iterations, bf16 planes
   equal to f32 planes; a dtype with no kernel must raise;
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
   most 10x the two-pass rho) and timed best of 3;
4. times from CUDA events: each kernel, its plain version, its bound, and
   where one exists the PyTorch library call computing the same function;
   for the SELL kernels also the x gather's sectors, the layout's bytes
   beyond the function's, the single kernel on lane-contiguous columns and
   torch.profiler's list of the kernels one product launches; with
   ``--segment-sweep`` both SELL kernels at six segment lengths (the
   experiment that chose ``SELL_SEGMENT``).

Each of the five paths (3, 5, 6, 7, 8) runs with every kernel's launch
counter set to 0 just before it and read just after; each kernel of the
path must have launched.

The last lines are one JSON object listing the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def check_cgcg_kernel(dev, grid: int):
    """Phase 2e: the one-pass CG kernel at the grid^2 Laplacian of phase 8.

    One launch from the same random state for f32, bf16 and f64 planes:
    p, x, r', w', s' equal the plain version bit for bit (same elementwise
    operations, scalars formed the same way). The dots <r', r'> and
    <w', r'> sum in other orders: the kernel's, kt = ceil(m_pad / (nblocks
    * 256)) terms a thread in sequence, then a 256-lane tree, then each of
    256 threads over at most 4 block partials and a 256-lane tree, is held
    against the sum in f64 at (kt + 20) u S, u = eps / 2, S = sum |terms|
    (the recursive-summation bound); the plain version's distance to it
    is reported. Then 20 iterations of ``cg_dia_fused_onepass`` against
    the plain loop (x within 1e-4 of max |x|: the dots' last-bit
    differences move alpha and beta), f32 and bf16 planes giving the same
    x bit for bit (the Laplacian's values are exact in bf16), for the
    two-pass iteration too. Returns (max vector |kernel - plain| in f32,
    the timing state)."""
    import torch
    from sparse_tpu_torch.kernels import cg_dia as C
    from sparse_tpu_torch.kernels import dia_spmv as D
    from sparse_tpu_torch.models import laplacian_2d_dia

    print("phase 2e: one-pass CG kernel vs plain", flush=True)
    N = grid * grid
    worst, keep = 0.0, None
    for dt, pdt in ((torch.float32, None), (torch.float32, torch.bfloat16), (torch.float64, None)):
        planes, offs = laplacian_2d_dia(grid, dtype=dt, device=dev)
        plan = D.dia_plan(offs, (N, N))
        packed = D.dia_pack(planes, plan)
        del planes
        stream = packed if pdt is None else packed.to(pdt)
        gen = torch.Generator(device=dev).manual_seed(5)
        vec = lambda: C._pad_vec(torch.randn((N,), dtype=dt, device=dev, generator=gen), plan)
        r, w, s, p, x = vec(), vec(), vec(), vec(), vec()
        sc = torch.tensor([2.0, 1.5, 0.7, 0.9], dtype=dt, device=dev)
        ws = C.CgWorkspace(plan, dt, dev)
        outs = []
        for kernel in (True, False):
            pk, xk, sck = p.clone(), x.clone(), sc.clone()
            ro, wo, so = torch.zeros_like(r), torch.zeros_like(r), torch.zeros_like(r)
            if kernel:
                C.cgcg_kernel(stream, r, w, s, pk, xk, ro, wo, so, sck, plan, ws)
            else:
                C.cgcg_kernel_plain(stream, r, w, s, pk, xk, ro, wo, so, sck, plan)
            outs.append((pk, xk, ro, wo, so, sck))
        tag = f"{dt} vectors, {pdt or dt} planes"
        err = max(float((a - b).abs().max()) for a, b in zip(outs[0][:5], outs[1][:5]))
        check(all(torch.equal(a, b) for a, b in zip(outs[0][:5], outs[1][:5])),
              f"cgcg_kernel ({tag}): p, x, r', w', s' equal the plain version bit for bit")
        (_, _, ro, wo, _, scp), sck = outs[1], outs[0][5]
        B, mp = plan.B, plan.m_pad
        rm, wm = ro[B : B + mp].double(), wo[B : B + mp].double()
        kt = -(-mp // (ws.nblocks * 256))
        u = torch.finfo(dt).eps / 2
        for slot, label, terms in ((C.RHO, "<r', r'>", rm * rm), (C.MU, "<w', r'>", wm * rm)):
            exact, S = float(terms.sum()), float(terms.abs().sum())
            dk, dp = abs(float(sck[slot]) - exact), abs(float(scp[slot]) - exact)
            check(dk <= (kt + 20) * u * S,
                  f"cgcg_kernel ({tag}) {label}: |kernel - f64| = {dk / (u * S):.3g} u S <= "
                  f"(kt + 20) u S, kt = {kt} (plain: {dp / (u * S):.3g} u S; |kernel - plain| "
                  f"{abs(float(sck[slot]) - float(scp[slot])):.3g})")
            del terms
        check(bool(torch.equal(sck[[C.RHO_PREV, C.ALPHA_PREV]], scp[[C.RHO_PREV, C.ALPHA_PREV]])),
              f"cgcg_kernel ({tag}): rho_prev and alpha_prev equal the plain version")
        if dt == torch.float32 and pdt is None:
            worst, keep = err, (plan, packed, r[plan.B : plan.B + N].clone(), ws)
        del outs, rm, wm
    # 20 iterations, kernel against the plain loop, from b = r's rows
    plan, packed, b = keep[0], keep[1], keep[2]
    B, mp = plan.B, plan.m_pad
    planes, offs = laplacian_2d_dia(grid, dtype=torch.float32, device=dev)
    xk = C.cg_dia_fused_onepass(planes, offs, b, None, N, iters=20)[0].clone()
    step = onepass_stepper(C.cgcg_kernel_plain, packed, packed, b, plan)
    for _ in range(20):
        step()
    xpl = step.x[B : B + N]
    err20 = float((xk - xpl).abs().max())
    check(err20 <= 1e-4 * float(xpl.abs().max()),
          f"20 one-pass iterations: max |kernel - plain| = {err20:.3g} (max |x| "
          f"{float(xpl.abs().max()):.3g}; bound 1e-4 of it)")
    del step
    for fn, label in ((C.cg_dia_fused_onepass, "one-pass"), (C.cg_dia_fused, "two-pass")):
        x32 = fn(planes, offs, b, None, N, iters=20)[0].clone()
        xbf = fn(planes, offs, b, None, N, iters=20, plane_dtype=torch.bfloat16)[0]
        check(bool(torch.equal(x32, xbf)), f"{label}: 20 iterations with bf16 planes give x equal "
                                           f"to f32 planes bit for bit")
    del planes, x32, xbf
    return worst, keep


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
    ref = np.zeros(len(rows))
    mag = np.zeros(len(rows))
    for d, o in zip(diagonals, offsets):
        # row i holds d at column i + o (d is indexed by min(i, i + o))
        j = rows + o
        ok = (j >= 0) & (j < n)
        v = np.where(ok, d[np.clip(np.minimum(rows, j), 0, len(d) - 1)].astype(np.float64), 0.0)
        ref += v
        mag += np.abs(v)
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


def slice3_timings(dev, grid: int, cgcg_state, bw, flops):
    """Times of the column-indexed DIA SpMV at phase 7's shapes (the grid^2
    Laplacian's scipy planes [5, N], x [N]) against
    ``torch.sparse_csr_tensor @ x`` of the same matrix, and of one one-pass
    CG iteration at phase 8's shapes (library: none, no single PyTorch call
    computes a CG iteration). The one-pass launches, kernel and plain,
    run phase 2e's recurrence from its b (r, w and s swapped after each),
    so each timed launch is an iteration of the checked solve. Bytes: the
    D planes, x and y once for the SpMV; for the one-pass iteration r, w,
    s read over their padded length (halo windows included), p, x and the
    D planes read, and r', w', s', p, x written. The bf16-plane variants
    of the one-pass kernel and of kernel A are timed beside them
    (printed)."""
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

    plan, packed, b, ws = cgcg_state
    mp, L = plan.m_pad, plan.m_pad + 2 * plan.B
    t["cgcg_kernel"] = dict(
        ms=cuda_ms(onepass_stepper(C.cgcg_kernel, packed, packed, b, plan, ws), reps, sync),
        plain_ms=cuda_ms(onepass_stepper(C.cgcg_kernel_plain, packed, packed, b, plan), reps,
                         sync),
        bytes=4 * (plan.D * mp + 3 * L + 2 * mp + 5 * mp), ops=(6 * plan.D + 12) * mp,
        library_ms=None,
    )
    bf = packed.to(torch.bfloat16)
    ms_bf = cuda_ms(onepass_stepper(C.cgcg_kernel, bf, packed, b, plan, ws), reps, sync)
    bound_bf = (2 * plan.D * mp + 4 * (3 * L + 2 * mp + 5 * mp)) / bw * 1e3
    # kernel A with bf16 planes at the two-pass state of cg_dia_fused from b
    rp = C._pad_vec(b, plan)
    pc, pn, q = torch.zeros_like(rp), torch.zeros_like(rp), torch.zeros_like(rp)
    scc = torch.zeros((4,), dtype=b.dtype, device=b.device)
    scc[C.RHO] = torch.dot(rp, rp)
    ms_a = cuda_ms(lambda: C.cg_kernel_a(bf, rp, pc, pn, q, scc, plan, ws), reps, sync)
    bound_a = (2 * plan.D * mp + 4 * (2 * L + 2 * mp)) / bw * 1e3
    print(f"  bf16 planes: cgcg_kernel {ms_bf:.4f} ms (bound {bound_bf:.4f} ms), cg_kernel_a "
          f"{ms_a:.4f} ms (bound {bound_a:.4f} ms)", flush=True)
    t["cgcg_kernel"]["bf16"] = dict(cgcg_ms=ms_bf, cgcg_bound_ms=bound_bf, cg_kernel_a_ms=ms_a,
                                    cg_kernel_a_bound_ms=bound_a)
    for name, r in t.items():
        byte_ms, op_ms = r["bytes"] / bw * 1e3, r["ops"] / flops * 1e3
        r["bound_ms"] = max(byte_ms, op_ms)
        r["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
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
        batch_m: int = 2**16, lanes: int = 64, entry_grid: int = 64, iters: int = 300) -> dict:
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
    err_cgcg, cgcg_state = check_cgcg_kernel(dev, grid)
    errs.update({"dia_spmv_packed": err_spmv, "cg_kernel_a": err_a, "cg_kernel_b": err_b,
                 "dia_spmv_direct": err_direct, "cgcg_kernel": err_cgcg})

    # each path runs with every launch counter at 0 and is read just after
    counters = (D.dia_spmv_packed, C.cg_kernel_a, C.cg_kernel_b, S.sell_chunk_spmv,
                S.sell_chunk_spmv_batched, D.dia_spmv_direct, C.cgcg_kernel)
    launches = {}

    def drive(path, kernels, fn, *args, also=()):
        """Run ``fn(*args)`` with the counters at 0; each of ``kernels`` must
        launch and its count is the one reported; each of ``also`` must
        launch (its count is reported from another path)."""
        for c in counters:
            c.launches = 0
        res = fn(*args)
        seen = {c.__name__: c.launches for c in counters}
        print(f"  launches on the {path}: {seen}", flush=True)
        for k in (*kernels, *also):
            check(seen[k] > 0, f"{k} launched on the {path} ({seen[k]} times)")
        launches.update({k: seen[k] for k in kernels})
        return res

    A, out = drive("main path", ("dia_spmv_packed", "cg_kernel_a", "cg_kernel_b"),
                   main_path, dev, grid, small_grid)
    A_gen, prep, out_gen = drive("general path", ("sell_chunk_spmv",), general_path, dev, skew_s)
    out_gen["host_build_s"] = host_build_s
    bc, _X, out_b = drive("batched path", ("sell_chunk_spmv_batched",), batched_path, dev, lanes_s,
                          lanes)
    out_f = drive("flagship step", ("dia_spmv_direct",), flagship_path, dev, grid, entry_grid, iters)
    out_s = drive("fused sweep", ("cgcg_kernel",), fused_sweep, dev, grid, iters,
                  also=("cg_kernel_a", "cg_kernel_b", "dia_spmv_packed"))
    rel_f, rel_2 = out_f[f"{grid}^2"]["rel_residual"], out_s["twopass"]["rel_residual"]
    check(rel_f <= 10 * max(rel_2, float(np.finfo(np.float32).eps)),
          f"flagship step's true residual at {grid}^2 ({rel_f:.4g}) within 10x of the two-pass "
          f"fused CG's on the same b ({rel_2:.4g})")
    return dict(card=card, name=name, grid=grid, A=A, out=out, out_gen=out_gen, out_b=out_b, A_gen=A_gen,
                prep=prep, bc=bc, launches=launches, errs=errs, cg_state=cg_state,
                cgcg_state=cgcg_state, out_f=out_f, out_s=out_s)


_SOURCES = {
    "dia_spmv_packed": ("sparse_tpu_torch/csrc/dia_spmv.cu", "sparse_tpu/kernels/dia_spmv.py:207"),
    "cg_kernel_a": ("sparse_tpu_torch/csrc/cg_dia.cu", "sparse_tpu/kernels/cg_dia.py:501"),
    "cg_kernel_b": ("sparse_tpu_torch/csrc/cg_dia.cu", "sparse_tpu/kernels/cg_dia.py:536"),
    "sell_chunk_spmv": ("sparse_tpu_torch/csrc/sell_spmv.cu", "sparse_tpu/kernels/sell_spmv.py:226"),
    "sell_chunk_spmv_batched": ("sparse_tpu_torch/csrc/sell_spmv.cu",
                                "sparse_tpu/kernels/sell_spmv.py:293"),
    "dia_spmv_direct": ("sparse_tpu_torch/csrc/dia_spmv.cu", "sparse_tpu/kernels/dia_spmv.py:639"),
    "cgcg_kernel": ("sparse_tpu_torch/csrc/cg_dia.cu", "sparse_tpu/kernels/cg_dia.py:374"),
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
    grid = res["grid"]
    t.update(slice3_timings("cuda", grid, res.pop("cgcg_state"), bw, flops))
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
    g["a_at_x_ms"] = t["sell_chunk_spmv"].pop("a_at_x_ms")
    g["gather"] = t["sell_chunk_spmv"].pop("gather")
    bo["gather"] = t["sell_chunk_spmv_batched"].pop("gather")
    if sweep is not None:
        g["segment_sweep"], bo["segment_sweep"] = sweep["single"], sweep["batched"]
    print(json.dumps({"main_path": o, "general_path": g, "batched_path": bo,
                      "flagship_step": res["out_f"], "fused_sweep": sw,
                      "bf16_planes": t["cgcg_kernel"].pop("bf16")}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(res["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
