"""The windowed one-pass CG kernel's geometry and schedule, on the CPU.

The kernel (``csrc/cg_dia.cu``, ``cgcg_window_kernel``) runs only on the
card. What surrounds it is plain Python the CPU reaches: the launch
geometry (:class:`CgcgWindow`: the window's extent, the ring, the block
ranges, the windowed-or-wide choice) and the plan's 4-row halo. These tests
check that geometry at small sizes and run a torch emulation of the
kernel's schedules (prefill, slide, owner-only writes, the same ring slots
with the same wrap) at a 40^2 grid with 64-row tiles: its p, x, r', w' and
s' must equal ``cgcg_kernel_plain``'s bit for bit, and a solve through it
tracks ``sparse_tpu``'s one-pass CG. The kernel's schedule follows the
vectors' dtype ("async" for f32, "ahead" for f64); the emulation runs
each.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_tpu.models.poisson import laplacian_2d_dia

from sparse_tpu_torch.kernels import cg_dia as C
from sparse_tpu_torch.kernels import dia_spmv as D

H100_SMEM = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
CASES = [
    # (m, offsets): the 2-D Laplacian, one-sided bands, a ragged m, no main diagonal
    (1600, (-40, -1, 0, 1, 40)),
    (999, (1, 2)),
    (1000, (-3, -1)),
    (777, (-5, 0, 7)),
    (300, (0,)),
    (5000, (-1030, -1, 0, 1, 1030)),
]


def _geo(m, offsets, tile=64, sm=3, bps=2, itemsize=4):
    plan = D.dia_plan(offsets, (m, m))
    return plan, C.CgcgWindow(plan, itemsize, sm, bps, H100_SMEM, tile=tile)


@pytest.mark.parametrize("m,offsets", CASES)
def test_plan_halo_is_aligned_and_holds_the_band(m, offsets):
    plan = D.dia_plan(offsets, (m, m))
    band = max(abs(o) for o in offsets)
    assert plan.B % C.WINDOW_ROWS == 0 and band <= plan.B < band + C.WINDOW_ROWS
    assert plan.m_pad % C.WINDOW_ROWS == 0


@pytest.mark.parametrize("sm,bps", [(3, 2), (1, 1), (132, 4), (50, 8)])
@pytest.mark.parametrize("m,offsets", CASES)
def test_every_interior_row_is_owned_by_one_block(m, offsets, sm, bps):
    plan, geo = _geo(m, offsets, sm=sm, bps=bps)
    assert 1 <= geo.nblocks <= min(geo.ntiles, sm * bps)
    owners = np.zeros(plan.m_pad, dtype=int)
    prev_end = 0
    for b in range(geo.nblocks):
        R0, R1 = geo.block_range(b)
        assert R0 == prev_end and R0 % geo.tile == 0 and R0 < R1  # contiguous, no empty block
        owners[R0:R1] += 1
        prev_end = R1
    assert prev_end == plan.m_pad and np.all(owners == 1)
    tiles = [-(-(R1 - R0) // geo.tile) for R0, R1 in map(geo.block_range, range(geo.nblocks))]
    assert max(tiles) - min(tiles) <= 1
    assert geo.terms_per_thread == max(tiles) * geo.tile // 256


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("m,offsets", CASES)
def test_window_covers_the_offsets_and_the_row(m, offsets, itemsize):
    """For every owned row i of every tile step, rows i + o_k and i itself
    lie in the positions the ring holds at that step, which stay inside the
    padded vector; the ring never holds two live positions in one slot."""
    plan, geo = _geo(m, offsets, itemsize=itemsize)
    g = C.WINDOW_ROWS
    assert geo.lo % g == 0 and geo.hi % g == 0
    assert geo.lo <= min(0, *offsets) and geo.hi >= max(0, *offsets)
    assert -plan.B <= geo.lo and geo.hi <= plan.B
    assert geo.ring >= geo.span + 2 * geo.tile and geo.ring % g == 0
    for b in range(geo.nblocks):
        R0, R1 = geo.block_range(b)
        assert R0 + geo.lo >= -plan.B and R1 + geo.hi <= plan.m_pad + plan.B
        for t in range(R0, R1, geo.tile):
            rows = np.arange(t, min(t + geo.tile, R1))
            first, last = t + geo.lo, t + geo.tile + geo.hi  # window [first, last)
            for o in (0, *offsets):
                assert np.all(rows + o >= first) and np.all(rows + o < last)
            assert last - first <= geo.ring


@pytest.mark.parametrize("itemsize", [4, 8])
def test_wide_choice_flips_at_the_capacity_edge(itemsize):
    """The window (span + 7 x 1024 values in f32: the ring and the "async"
    staging area; span + 2 x 1024 in f64: the ring) fits a block's shared
    memory up to the last span that is a multiple of 4; one row more takes
    the wide kernel. Symmetric and one-sided bands alike."""

    def fits(offsets):
        m = 4 * max(abs(o) for o in offsets)
        geo = C.CgcgWindow(D.dia_plan(offsets, (m, m)), itemsize, 132, 1, H100_SMEM)
        assert geo.schedule == {4: "async", 8: "ahead"}[itemsize]
        assert (geo.nblocks > 0) == geo.fits
        return geo.fits

    edge = (H100_SMEM - C.window_shared_bytes(0, itemsize)) // itemsize // 4 * 4
    half = edge // 8 * 4
    assert fits((0, edge)) and not fits((0, edge + 1))
    assert fits((-half, half)) and not fits((-half - 1, half + 1))
    assert fits((-edge, -1)) and not fits((-edge - 1, 0))
    # f32 past ~51,000 rows of span runs the wide kernel, f64 past ~27,000
    assert edge == {4: 50944, 8: 27008}[itemsize]
    # so the 7-point Laplacian at 128^3 (span 32,768) fits in f32 only, at 160^3 in neither
    assert fits((-128 * 128, -128, -1, 0, 1, 128, 128 * 128)) == (itemsize == 4)
    assert not fits((-160 * 160, -160, -1, 0, 1, 160, 160 * 160))


@pytest.mark.parametrize("shape,itemsize,bps,windowed", [
    ((6000, 2), 4, 3, True),    # 91,136 rows a block, span 12,000
    ((6000, 2), 8, 2, True),
    ((1000, 2), 4, 3, True),    # 3 tiles a block, span 2,000: 1.536
    ((1000, 2), 8, 2, True),    # 4 tiles, 2.048
    ((500, 2), 4, 3, False),    # 1 tile a block, span 1,000: 1.024
    ((64, 3), 4, 3, False),     # 1 tile, span 8,192
    ((128, 3), 4, 1, False),    # 16 tiles, span 32,768: 0.5
    ((96, 3), 8, 1, False),     # 7 tiles, span 18,432: 0.39
])
def test_windowed_choice_follows_rows_per_span(shape, itemsize, bps, windowed):
    """The one-pass iteration takes the windowed kernel where a block owns
    at least WINDOW_MIN_RATIO spans of rows (the Laplacians of
    chip_smoke.py's --window-sweep, at the H100's 132 SMs and the resident
    blocks the card gave there), else the wide kernel."""
    n, dim = shape
    N = n**dim
    offsets = (-n, -1, 0, 1, n) if dim == 2 else (-n * n, -n, -1, 0, 1, n, n * n)
    geo = C.CgcgWindow(D.dia_plan(offsets, (N, N)), itemsize, 132, bps, H100_SMEM)
    assert geo.fits and geo.windowed == windowed
    assert geo.windowed == (geo.rows_per_block >= C.WINDOW_MIN_RATIO * geo.span)


@pytest.mark.parametrize("tiles,windowed", [(3, True), (2, False)])
def test_windowed_choice_flips_at_the_ratio(tiles, windowed):
    """One block, a 2048-row span: 3 tiles (3072 rows, exactly 1.5 spans)
    take the windowed kernel, 2 tiles the wide one; a window that does not
    fit is never chosen."""
    m = tiles * C.WINDOW_TILE - 4
    geo = C.CgcgWindow(D.dia_plan((-1024, 0, 1024), (m, m)), 4, 1, 1, H100_SMEM)
    assert geo.rows_per_block == tiles * C.WINDOW_TILE and geo.windowed == windowed
    geo = C.CgcgWindow(D.dia_plan((-1024, 0, 1024), (m, m)), 4, 1, 1, 1000)
    assert not geo.fits and geo.rows_per_block == 0 and not geo.windowed


def test_geometry_at_6000_squared():
    """The numbers PERF.md and the kernel's note quote: a 12000-row span;
    in f32 a 56 KB ring and a 20 KB staging area, 396 blocks at 3 an SM;
    in f64 a 112 KB ring, 264 blocks at 2."""
    N = 6000 * 6000
    plan = D.dia_plan((-6000, -1, 0, 1, 6000), (N, N))
    geo = C.CgcgWindow(plan, 4, 132, 3, H100_SMEM)
    assert (geo.lo, geo.hi, geo.span) == (-6000, 6000, 12000) and geo.schedule == "async"
    assert geo.shared_bytes == (12000 + 7 * 1024) * 4 and geo.fits
    assert geo.nblocks == 396 and geo.ntiles == 35157 and geo.terms_per_thread == 4 * 89
    geo = C.CgcgWindow(plan, 8, 132, 2, H100_SMEM)
    assert geo.schedule == "ahead" and geo.shared_bytes == (12000 + 2048) * 8
    assert geo.nblocks == 264


# ---------------------------------------------------------------------------
# the kernel's schedule, emulated in torch
# ---------------------------------------------------------------------------
def emulate_window(planes, r, w, s, p, x, r_out, w_out, s_out, sc, plan, geo, writes):
    """cgcg_window_kernel's schedule, block by block: the prefill, then the
    tile steps in the order ``geo.schedule`` runs them (an entering group's
    loads, including the "async" copies two steps ahead, before its
    commit), with the kernel's ring slots (one conditional wrap) and its
    owner-only writes; ``writes`` counts the writes of each padded row. The
    dots are summed per block in row order (not the kernel's order)."""
    alpha, beta = C.cgcg_scalars(sc)
    B, T, L, lo, span, schedule = plan.B, geo.tile, geo.ring, geo.lo, geo.span, geo.schedule
    hi = lo + span
    j = torch.arange(T)
    rr = torch.zeros((), dtype=r.dtype)
    wr = torch.zeros((), dtype=r.dtype)

    def wrap(slot):
        assert slot.numel() == 0 or int(slot.max()) < 2 * L  # one subtraction wraps it
        return torch.where(slot >= L, slot - L, slot)

    for b in range(geo.nblocks):
        R0, R1 = geo.block_range(b)
        ring = torch.full((L,), float("nan"), dtype=r.dtype)

        def load(rows):
            """An entering group's loads: r, w, s where an output row of the
            range reads them, p and x where the block owns the row."""
            rows = rows[rows < R1 + hi]
            c = B + rows
            own = (rows >= R0) & (rows < R1)
            return rows, r[c], w[c], s[c], p[c[own]], x[c[own]]

        def commit(loaded, slots):
            rows, rv, wv, sv, pv, xv = loaded
            slots = slots[: rows.numel()]
            c = B + rows
            sn = wv + beta * sv
            rn = rv - alpha * sn
            ring[slots] = rn
            own = (rows >= R0) & (rows < R1)
            co = c[own]
            r_out[co], s_out[co] = rn[own], sn[own]
            pn = rv[own] + beta * pv
            x[co] = xv + alpha * pn
            p[co] = pn
            writes[co] += 1

        def output(t, head):
            nonlocal rr, wr
            rows = t + j[t + j < R1]
            acc = torch.zeros(rows.shape, dtype=r.dtype)
            for k, o in enumerate(plan.offsets):
                rv = ring[wrap(head + (o - lo) + (rows - t))]
                acc = acc + planes[k * plan.m_pad + rows].to(r.dtype) * rv
            rm = ring[wrap(head - lo + (rows - t))]
            w_out[B + rows] = acc
            rr = rr + torch.dot(rm, rm)
            wr = wr + torch.dot(acc, rm)

        commit(load(R0 + lo + torch.arange(span)), torch.arange(span))  # the prefill
        first = load(R0 + hi + j)
        staged = load(R0 + T + hi + j) if schedule == "async" else None
        commit(first, span + j)
        head = 0
        for t in range(R0, R1, T):
            nx = staged if schedule == "async" else load(t + T + hi + j)
            output(t, head)
            commit(nx, wrap(head + T + span + j))
            if schedule == "async":
                staged = load(t + 2 * T + hi + j)
            head = head + T - (L if head + T >= L else 0)
    sc[C.RHO_PREV] = sc[C.RHO]
    sc[C.RHO], sc[C.MU] = rr, wr
    sc[C.ALPHA_PREV] = torch.where(alpha == 0, torch.ones_like(alpha), alpha)


def _state(m, offsets, dtype, seed):
    rng = np.random.default_rng(seed)
    plan = D.dia_plan(offsets, (m, m))
    data = torch.tensor(rng.standard_normal((len(offsets), m)), dtype=dtype)
    packed = D.dia_pack(data, plan)
    vec = lambda: C._pad_vec(torch.tensor(rng.standard_normal(m), dtype=dtype), plan)  # noqa: E731
    sc = torch.tensor([2.0, 1.5, 0.7, 0.9], dtype=dtype)
    return plan, packed, [vec() for _ in range(5)], sc


@pytest.mark.parametrize("dtype,pdt", [(torch.float32, None), (torch.float32, torch.bfloat16),
                                       (torch.float64, None)])
@pytest.mark.parametrize("m,offsets", CASES[:5])
def test_emulated_schedule_equals_plain_bit_for_bit(m, offsets, dtype, pdt):
    plan, packed, (r, w, s, p, x), sc = _state(m, offsets, dtype, seed=m)
    planes = packed if pdt is None else packed.to(pdt)
    _, geo = _geo(m, offsets, itemsize=r.element_size())
    outs = []
    for emulated in (True, False):
        pk, xk, sck = p.clone(), x.clone(), sc.clone()
        ro, wo, so = (torch.zeros_like(r) for _ in range(3))
        if emulated:
            writes = torch.zeros(r.shape, dtype=torch.int64)
            emulate_window(planes, r, w, s, pk, xk, ro, wo, so, sck, plan, geo, writes)
            mid = slice(plan.B, plan.B + plan.m_pad)
            assert torch.all(writes[mid] == 1) and writes.sum() == plan.m_pad  # halos never
        else:
            C.cgcg_kernel_plain(planes, r, w, s, pk, xk, ro, wo, so, sck, plan)
        outs.append((pk, xk, ro, wo, so, sck))
    for a, b in zip(outs[0][:5], outs[1][:5]):
        assert torch.equal(a, b)
    sce, scp = outs[0][5], outs[1][5]
    assert torch.equal(sce[[C.RHO_PREV, C.ALPHA_PREV]], scp[[C.RHO_PREV, C.ALPHA_PREV]])
    torch.testing.assert_close(sce, scp, rtol=1e-5 if dtype == torch.float32 else 1e-12, atol=0)


def test_emulated_solve_tracks_reference_onepass():
    """20 iterations at 40^2 through the emulated schedule from
    ``cg_dia_fused_onepass``'s start (x0 = 0) against sparse_tpu's one-pass
    CG (Pallas in interpret mode): the same recurrence with dots in other
    orders, 1e-4 absolute (tests/test_torch_cg.py's tolerance)."""
    from sparse_tpu.kernels.cg_dia import cg_dia_fused_onepass as jax_onepass

    n, iters = 40, 20
    data, offsets = laplacian_2d_dia(n)
    data = np.array(data)
    N = n * n
    b = np.random.default_rng(9).standard_normal(N).astype(np.float32)
    xj = np.asarray(jax_onepass(jnp.asarray(data), offsets, jnp.asarray(b), None, N, iters=iters,
                                tile=1024, interpret=True)[0])
    plan = D.dia_plan(offsets, (N, N))
    packed = D.dia_pack(torch.from_numpy(data), plan)
    geo = C.CgcgWindow(plan, 4, 3, 2, H100_SMEM, tile=64)
    assert geo.schedule == "async"
    r0 = C._pad_vec(torch.from_numpy(b), plan)
    w0 = C._pad_vec(D.dia_spmv_packed_plain(packed, r0, plan), plan)
    sc = torch.zeros(4)
    sc[C.RHO], sc[C.MU], sc[C.ALPHA_PREV] = torch.dot(r0, r0), torch.dot(w0, r0), 1
    r, w = [r0, torch.zeros_like(r0)], [w0, torch.zeros_like(r0)]
    s = [torch.zeros_like(r0), torch.zeros_like(r0)]
    p, x = torch.zeros_like(r0), torch.zeros_like(r0)
    writes = torch.zeros(r0.shape, dtype=torch.int64)
    for _ in range(iters):
        emulate_window(packed, r[0], w[0], s[0], p, x, r[1], w[1], s[1], sc, plan, geo, writes)
        r.reverse(), w.reverse(), s.reverse()
    np.testing.assert_allclose(x[plan.B : plan.B + N].numpy(), xj, atol=1e-4)
    x_port = C.cg_dia_fused_onepass(torch.from_numpy(data), offsets, torch.from_numpy(b), None, N,
                                    iters=iters)[0]
    np.testing.assert_allclose(x[plan.B : plan.B + N].numpy(), x_port.numpy(), atol=1e-4)


def test_iteration_on_cpu_runs_the_plain_version():
    """cgcg_iteration takes the plain version for CPU tensors and launches
    neither kernel."""
    plan, packed, (r, w, s, p, x), sc = _state(200, (-3, 0, 3), torch.float32, seed=1)
    before = (C.cgcg_kernel.launches, C.cgcg_kernel_wide.launches)
    ws = C.CgWorkspace(plan, torch.float32, "cpu")
    pk, xk, sck = p.clone(), x.clone(), sc.clone()
    outs = [torch.zeros_like(r) for _ in range(3)]
    C.cgcg_iteration(packed, r, w, s, pk, xk, *outs, sck, plan, ws)
    want = [p.clone(), x.clone(), *(torch.zeros_like(r) for _ in range(3)), sc.clone()]
    C.cgcg_kernel_plain(packed, r, w, s, *want, plan)
    for a, b in zip((pk, xk, *outs, sck), want):
        assert torch.equal(a, b)
    assert (C.cgcg_kernel.launches, C.cgcg_kernel_wide.launches) == before
