#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (``sparse_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout beside this file;
exits non-zero without them, and on any failed check. Phases:

1. card name and power limit; build the CUDA kernels (csrc/*.cu) and time it;
2. each kernel against its plain torch version on the card, at the main
   path's shapes (the 6000^2 Laplacian) and on the edge cases of
   tests/test_dia_spmv.py; one fused solve run twice must be bit-identical;
3. the main path, as examples/pde.py drives it, at the reference's per-GPU
   size (6000^2 = 36e6 unknowns, float32): diags -> tocsc -> .T -> tocsr,
   y = A @ ones against a host f64 reference on sampled rows, a 300-iteration
   throughput CG, and a tolerance-driven CG at 1000^2 whose true residual is
   computed in f64 on the host; every kernel's launch counter must move;
4. times from CUDA events: each kernel, its plain version, its bound, and
   where one exists the PyTorch library call computing the same function.

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
    cases.append(("6000^2 Laplacian", lap[0], lap[1], lap[2]))
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
        if label.startswith("6000"):
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


def run(dev: str = "cuda", grid: int = 6000, small_grid: int = 1000) -> dict:
    import torch
    import sparse_tpu_torch as sparse
    from sparse_tpu_torch.kernels import _build
    from sparse_tpu_torch.kernels import cg_dia as C
    from sparse_tpu_torch.kernels import dia_spmv as D

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

    counters = (D.dia_spmv_packed, C.cg_kernel_a, C.cg_kernel_b)
    for fn in counters:
        fn.launches = 0
    A, out = main_path(dev, grid, small_grid)
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"  launches on the main path: {launches}", flush=True)
    for k, v in launches.items():
        check(v > 0, f"{k} launched on the main path ({v} times)")
    return dict(card=card, name=name, A=A, out=out, launches=launches,
                errs={"dia_spmv_packed": err_spmv, "cg_kernel_a": err_a, "cg_kernel_b": err_b},
                cg_state=cg_state)


_SOURCES = {
    "dia_spmv_packed": ("sparse_tpu_torch/csrc/dia_spmv.cu", "sparse_tpu/kernels/dia_spmv.py:207"),
    "cg_kernel_a": ("sparse_tpu_torch/csrc/cg_dia.cu", "sparse_tpu/kernels/cg_dia.py:501"),
    "cg_kernel_b": ("sparse_tpu_torch/csrc/cg_dia.cu", "sparse_tpu/kernels/cg_dia.py:536"),
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
    print(f"  CG at 6000^2: {o['cg_iters'] / o['cg_s']:.2f} iters/s ({it_ms:.4f} ms per "
          f"iteration; kernels A + B alone {t['cg_kernel_a']['ms'] + t['cg_kernel_b']['ms']:.4f} ms, "
          f"bound {t['cg_kernel_a']['bound_ms'] + t['cg_kernel_b']['bound_ms']:.4f} ms)", flush=True)
    print(f"  tolerance cg at 1000^2: {o['small_cg_iters']} iterations in "
          f"{o['small_cg_s']:.4f} s, true relative residual {o['small_rel_residual']:.3g}", flush=True)
    print(json.dumps({"main_path": {k: v for k, v in o.items()}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(res["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
